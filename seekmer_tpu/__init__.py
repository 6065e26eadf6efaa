"""seekmer_tpu: RNA-seq quantification on an accelerator.

A from-scratch JAX/XLA framework with the capabilities of GuanLab/seekmer
(see SURVEY.md): transcriptome k-mer indexing, k-mer pseudoalignment of
reads to transcript equivalence classes, and EM-based transcript abundance
inference with bootstrap uncertainty — scaled over device meshes via
shard_map.
"""

import os

__version__ = "0.1.0"

# Persistent XLA compilation cache used when JAX_COMPILATION_CACHE_DIR is
# not set: one fixed directory in the checkout (gitignored), so every
# process of a checkout finds what an earlier one compiled.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def _enable_compilation_cache() -> None:
    """Point JAX's persistent compilation cache at DEFAULT_CACHE_DIR unless
    JAX_COMPILATION_CACHE_DIR is set, in which case JAX reads that
    variable itself and nothing is configured here."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


_enable_compilation_cache()

from .config import (  # noqa: F401
    EMConfig,
    IndexConfig,
    MapConfig,
    PipelineConfig,
    ShardConfig,
)
