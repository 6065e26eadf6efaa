"""Unit tests for the small auxiliary subsystems (SURVEY.md section 5):
metrics registry, prefetch pipeline, profiling wrapper, compile cache."""

import os
import subprocess
import sys
import time

import pytest

from seekmer_tpu.utils.metrics import Metrics
from seekmer_tpu.utils.prefetch import prefetch
from seekmer_tpu.utils.profiling import annotate, maybe_trace


def test_metrics_counters_and_rates():
    m = Metrics()
    m.count("reads", 100)
    m.count("reads", 50)
    with m.timer("map"):
        time.sleep(0.01)
    snap = m.snapshot()
    assert snap["reads"] == 150
    assert snap["map_s"] >= 0.01
    assert snap["reads_per_s"] == pytest.approx(150 / snap["map_s"])
    m.log_summary()  # must not raise


def test_prefetch_preserves_order_and_values():
    assert list(prefetch(range(100), depth=3)) == list(range(100))


def test_prefetch_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_prefetch_empty():
    assert list(prefetch([], depth=1)) == []


def test_maybe_trace_disabled_is_noop():
    with maybe_trace(None, "x"):
        pass


def test_annotate_runs():
    with annotate("stage"):
        pass


def test_trace_writes_profile(tmp_path):
    import numpy as np
    import jax.numpy as jnp

    with maybe_trace(str(tmp_path), "smoke"):
        _ = np.asarray(jnp.arange(8) * 2)
    files = list(tmp_path.rglob("*"))
    assert files, "profiler produced no output"


def _cache_dir_in_fresh_process(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, seekmer_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=repo, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1], repo


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed .jax_cache directory of the checkout, whatever HOME says."""
    want = None if env_dir is None else str(tmp_path / env_dir)
    got, repo = _cache_dir_in_fresh_process(want)
    assert got == (want or os.path.join(repo, ".jax_cache"))
