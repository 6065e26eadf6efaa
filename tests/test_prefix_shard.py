"""Prefix-sharded index mode (config 4): sharded build round-trip and
all_to_all routed mapping vs the single-chip mapper (SURVEY.md section 4
item 4 — fake-device mesh exercises the routing collectives)."""

import numpy as np
import pytest

from seekmer_tpu.config import MapConfig, ShardConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.index.store import EMPTY
from seekmer_tpu.io.fastq import batch_reads
from seekmer_tpu.map.driver import Mapper
from seekmer_tpu.map.signature import SIG_PAD
from seekmer_tpu.parallel.mesh import make_mesh
from seekmer_tpu.parallel.prefix_shard import (
    PrefixShardedMapper,
    shard_index_by_prefix,
)
from seekmer_tpu.utils.simulate import random_transcriptome, simulate_reads


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(654)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=200, max_len=900,
        shared_prefix_frac=0.5,
    )
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=1024, read_len=96,
                         error_rate=0.005)
    return index, sim


def test_shard_build_preserves_keys(world):
    index, _ = world
    sdi = shard_index_by_prefix(index, 4)
    G = sdi.bucket
    total = 0
    for d in range(4):  # slab device layout: row = [hi*G|lo*G|ecaux*G|meta*G]
        total += int((np.asarray(sdi.table[d])[:, :G] != EMPTY).sum())
        total += int((np.asarray(sdi.stash[d])[:, :G] != EMPTY).sum())
    assert total == index.num_kmers


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2)])
def test_prefix_sharded_matches_single(world, mesh_shape):
    index, sim = world
    d_ax, i_ax = mesh_shape
    cfg = MapConfig(batch_size=512, sig_table_bits=12)
    shard_cfg = ShardConfig(data_axis=d_ax, index_axis=i_ax,
                            index_mode="prefix")
    mesh = make_mesh(shard_cfg)
    ps = PrefixShardedMapper(index, cfg, shard_cfg, mesh=mesh)
    reads_b = [r.encode() for r in sim.reads1]
    res_ps = ps.run(batch_reads(reads_b, cfg))

    single = Mapper(index, cfg)
    res_1 = single.run(batch_reads(reads_b, cfg))

    assert res_ps.total_reads == res_1.total_reads
    assert _as_dict(res_ps) == _as_dict(res_1)


def _as_dict(res):
    return {
        tuple(r[r != int(SIG_PAD)].tolist()): int(n)
        for r, n in zip(res.sigs, res.sig_counts)
    }


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sampled_routing_matches_replicated_fast(world, mesh_shape):
    """SAMPLED ROUTING (round-5: fast mode under prefix sharding —
    phase 1 routes only sampled windows through the all_to_all, fallback
    units re-route densely in psum-agreed collective rounds): results
    must equal the replicated single-chip FAST mapper exactly — the
    approximation is the fast mode's, never the routing's."""
    index, sim = world
    d_ax, i_ax = mesh_shape
    cfg = MapConfig(batch_size=512, sig_table_bits=12, probe_sample=4,
                    sample_fallback_frac=0.125)
    shard_cfg = ShardConfig(data_axis=d_ax, index_axis=i_ax,
                            index_mode="prefix")
    ps = PrefixShardedMapper(index, cfg, shard_cfg,
                             mesh=make_mesh(shard_cfg))
    reads_b = [r.encode() for r in sim.reads1]
    res_ps = ps.run(batch_reads(reads_b, cfg))

    res_1 = Mapper(index, cfg).run(batch_reads(reads_b, cfg))
    assert res_ps.total_reads == res_1.total_reads
    assert res_ps.mapped == res_1.mapped
    assert _as_dict(res_ps) == _as_dict(res_1)


def test_sampled_routing_low_capacity_exact(world):
    """Sampled routing under capacity pressure: a tiny routing capacity
    forces residual all_to_all rounds inside BOTH phases; the psum-agreed
    loop conditions must keep every shard in lockstep and the result
    exact vs the replicated fast mapper."""
    index, sim = world
    cfg = MapConfig(batch_size=512, sig_table_bits=12, probe_sample=4,
                    sample_fallback_frac=0.125)
    shard_cfg = ShardConfig(data_axis=2, index_axis=4, index_mode="prefix")
    ps = PrefixShardedMapper(index, cfg, shard_cfg,
                             mesh=make_mesh(shard_cfg),
                             capacity_factor=0.3)
    reads_b = [r.encode() for r in sim.reads1]
    res_ps = ps.run(batch_reads(reads_b, cfg))
    res_1 = Mapper(index, cfg).run(batch_reads(reads_b, cfg))
    assert _as_dict(res_ps) == _as_dict(res_1)


def test_low_capacity_is_exact(world):
    """capacity_factor ~0.3 forces residual all_to_all rounds; results
    must still match the dense mapper exactly (VERDICT round-1 item 4 —
    routing overflow used to DROP lanes)."""
    index, sim = world
    cfg = MapConfig(batch_size=512, sig_table_bits=12)
    shard_cfg = ShardConfig(data_axis=2, index_axis=4, index_mode="prefix")
    mesh = make_mesh(shard_cfg)
    ps = PrefixShardedMapper(index, cfg, shard_cfg, mesh=mesh,
                             capacity_factor=0.3)
    reads_b = [r.encode() for r in sim.reads1]
    res_ps = ps.run(batch_reads(reads_b, cfg))
    assert ps.extra_routing_rounds > 0, \
        "fixture did not exercise capacity pressure"

    single = Mapper(index, cfg)
    res_1 = single.run(batch_reads(reads_b, cfg))
    assert _as_dict(res_ps) == _as_dict(res_1)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_prefix_sharded_paired_matches_dp(world, mesh_shape):
    """Paired-end x prefix-sharded (VERDICT round-1 item 3): identical
    merged signature counts vs the replicated single-chip mapper on the
    same paired batches."""
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.utils.simulate import simulate_packed_pairs

    index, _ = world
    rng = np.random.default_rng(99)
    d_ax, i_ax = mesh_shape
    B, L = 512, 96
    # pairs must come from the transcriptome the fixture indexed: rebuild
    # it with the fixture's seed
    rng2 = np.random.default_rng(654)
    _, seqs_idx = random_transcriptome(
        rng2, num_transcripts=40, min_len=200, max_len=900,
        shared_prefix_frac=0.5,
    )
    c1, c2, _ = simulate_packed_pairs(rng, seqs_idx, 2, B, read_len=L,
                                      mean_frag=150.0, sd_frag=15.0,
                                      error_rate=0.005)
    lengths = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    batches = [ReadBatch(c1[i], lengths, w, codes2=c2[i], lengths2=lengths)
               for i in range(2)]

    cfg = MapConfig(batch_size=B, sig_table_bits=12, paired_end=True)
    shard_cfg = ShardConfig(data_axis=d_ax, index_axis=i_ax,
                            index_mode="prefix")
    ps = PrefixShardedMapper(index, cfg, shard_cfg,
                             mesh=make_mesh(shard_cfg))
    res_ps = ps.run(iter(batches))

    single = Mapper(index, cfg)
    res_1 = single.run(iter(batches))
    assert res_ps.total_reads == res_1.total_reads
    assert _as_dict(res_ps) == _as_dict(res_1)


def test_sampled_routing_paired_matches_replicated_fast(world):
    """Paired fast mode under sampled routing: per-mate resolution +
    per-unit dense fallback, all lookups through the all_to_all — exact
    vs the replicated paired fast mapper."""
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.utils.simulate import simulate_packed_pairs

    index, _ = world
    rng = np.random.default_rng(77)
    rng2 = np.random.default_rng(654)
    _, seqs_idx = random_transcriptome(
        rng2, num_transcripts=40, min_len=200, max_len=900,
        shared_prefix_frac=0.5,
    )
    B, L = 512, 96
    c1, c2, _ = simulate_packed_pairs(rng, seqs_idx, 2, B, read_len=L,
                                      mean_frag=150.0, sd_frag=15.0,
                                      error_rate=0.005)
    lengths = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    batches = [ReadBatch(c1[i], lengths, w, codes2=c2[i], lengths2=lengths)
               for i in range(2)]

    cfg = MapConfig(batch_size=B, sig_table_bits=12, paired_end=True,
                    probe_sample=4, sample_fallback_frac=0.125)
    shard_cfg = ShardConfig(data_axis=2, index_axis=4, index_mode="prefix")
    ps = PrefixShardedMapper(index, cfg, shard_cfg,
                             mesh=make_mesh(shard_cfg))
    res_ps = ps.run(iter(batches))
    res_1 = Mapper(index, cfg).run(iter(batches))
    assert res_ps.total_reads == res_1.total_reads
    assert _as_dict(res_ps) == _as_dict(res_1)
