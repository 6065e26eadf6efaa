"""End-to-end pipeline tests: CLI + Quantifier vs oracle on simulated data —
the config-1 golden-parity harness (SURVEY.md section 4 item 1, BASELINE
config 1: single-end reads, ~1k-transcript-scale subset, k=25)."""

import subprocess
import sys

import numpy as np
import pytest

from seekmer_tpu.config import EMConfig, MapConfig, PipelineConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.writer import read_abundance
from seekmer_tpu.models.quantifier import Quantifier
from seekmer_tpu.utils.simulate import (
    random_transcriptome,
    simulate_reads,
    write_fasta,
    write_fastq,
)
from tests.oracle import oracle


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(2024)
    names, seqs = random_transcriptome(
        rng, num_transcripts=60, min_len=300, max_len=1500,
        shared_prefix_frac=0.5,
    )
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=2000, read_len=100,
                         error_rate=0.005)
    return names, seqs, index, sim


def test_quantifier_matches_oracle_single_end(world):
    names, seqs, index, sim = world
    map_cfg = MapConfig(batch_size=256, sig_table_bits=14)
    em_cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    cfg = PipelineConfig().replace(map=map_cfg, em=em_cfg)

    q = Quantifier(index, cfg)
    res = q.quantify_reads(sim.reads1)
    o = oracle.quantify(sim.reads1, index, map_cfg, em_cfg)

    assert res.total_reads == len(sim.reads1)
    assert res.unmapped == o["unmapped"]
    np.testing.assert_allclose(res.est_counts, o["est_counts"],
                               rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(res.tpm, o["tpm"], rtol=5e-3, atol=5e-1)
    # counts roughly track simulation ground truth on mapped mass
    true_counts = np.bincount(sim.true_transcript, minlength=len(names))
    corr = np.corrcoef(res.est_counts, true_counts)[0, 1]
    assert corr > 0.95, f"est_counts poorly correlated with truth: {corr}"


def test_quantifier_paired_end_matches_oracle(world):
    names, seqs, index, _ = world
    rng = np.random.default_rng(77)
    sim = simulate_reads(rng, seqs, num_reads=800, read_len=80, paired=True,
                         mean_frag=220.0, error_rate=0.005)
    map_cfg = MapConfig(batch_size=128, sig_table_bits=14, paired_end=True)
    em_cfg = EMConfig(rel_tol=1e-6, mean_fragment_length=220.0)
    cfg = PipelineConfig().replace(map=map_cfg, em=em_cfg)

    q = Quantifier(index, cfg)
    res = q.quantify_reads(sim.reads1, mates=sim.reads2)
    o = oracle.quantify(sim.reads1, index, map_cfg, em_cfg, mates=sim.reads2)

    assert res.unmapped == o["unmapped"]
    np.testing.assert_allclose(res.est_counts, o["est_counts"],
                               rtol=5e-3, atol=5e-2)


@pytest.mark.slow
def test_cli_end_to_end(tmp_path, world):
    names, seqs, index, sim = world
    fa = str(tmp_path / "ref.fa")
    fq = str(tmp_path / "reads.fq.gz")
    idx = str(tmp_path / "index.npz")
    out = str(tmp_path / "quant")
    write_fasta(fa, names, seqs)
    write_fastq(fq, sim.reads1)

    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"}
    import os
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    r = subprocess.run(
        [sys.executable, "-m", "seekmer_tpu", "index", fa, idx],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 0, r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "seekmer_tpu", "infer", idx, out, fq,
         "--batch-size", "256", "--bootstrap", "8"],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 0, r.stderr

    tab = read_abundance(out + "/abundance.tsv")
    assert tab["target_id"].tolist() == list(names)
    assert tab["est_counts"].sum() > 0
    import json
    info = json.load(open(out + "/run_info.json"))
    assert info["total_reads"] == len(sim.reads1)
    boot = np.load(out + "/bootstrap.npz")
    assert boot["est_counts"].shape == (8, len(names))


def test_simulate_packed_pairs_mates_consistent(rng):
    """Paired simulator: mates map to the same transcript (error-free)."""
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.index.build import build_index_from_seqs
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import Mapper, resolve_signatures
    from seekmer_tpu.utils.simulate import (
        random_transcriptome, simulate_packed_pairs,
    )
    import numpy as np

    names, seqs = random_transcriptome(rng, num_transcripts=30, min_len=300,
                                       max_len=1200)
    index = build_index_from_seqs(names, seqs)
    c1, c2, true = simulate_packed_pairs(rng, seqs, 1, 256, read_len=80,
                                         error_rate=0.0)
    cfg = MapConfig(batch_size=256, paired_end=True, sig_table_bits=12)
    m = Mapper(index, cfg)
    L = np.full(256, 80, np.int32)
    m.feed(ReadBatch(c1[0], L, np.ones(256, np.int32), codes2=c2[0],
                     lengths2=L))
    res = m.finalize()
    assert res.mapped == 256
    members, counts, dropped = resolve_signatures(res, index)
    assert dropped == 0  # mates from one fragment never conflict
    # estimated distribution tracks the truth
    est = np.zeros(len(names))
    for mem, n in zip(members, counts):
        est[mem] += n / mem.size
    assert np.corrcoef(est, true)[0, 1] > 0.8


def test_quantifier_fast_mode_abundances_match_dense(world):
    """Pipeline-level guard for the FAST mode (MapConfig.probe_sample):
    quantification from fast-mode mapping must agree with dense-mode
    quantification at the abundance level — total mass, mapped counts
    (within the documented complex-read nuance), and per-transcript
    est_counts within a 2% total-L1 budget (benchmarks/micro_fast_acc.py
    measured GENCODE-scale total-L1 0.9% at stride 8 and 1.9% at stride
    16 in an earlier round; this guard pins the 2% bound for strides
    <= 16)."""
    names, seqs, index, sim = world
    em_cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    res = {}
    for sample in (0, 4, 16):
        cfg = PipelineConfig().replace(
            map=MapConfig(batch_size=256, sig_table_bits=14,
                          probe_sample=sample),
            em=em_cfg)
        res[sample] = Quantifier(index, cfg).quantify_reads(sim.reads1)
    d = res[0]
    for sample in (4, 16):
        f = res[sample]
        assert f.total_reads == d.total_reads
        assert abs(f.mapped - d.mapped) <= max(2, d.total_reads // 1000)
        np.testing.assert_allclose(f.est_counts.sum(), d.est_counts.sum(),
                                   rtol=2e-3)
        l1 = np.abs(f.est_counts - d.est_counts).sum() / d.est_counts.sum()
        assert l1 < 0.02, (sample, l1)
        corr = np.corrcoef(
            f.est_counts,
            np.bincount(sim.true_transcript, minlength=len(names)))[0, 1]
        assert corr > 0.95, (sample, corr)
