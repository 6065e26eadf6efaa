"""P5 — pod-wide collective EM (SURVEY.md 2.2): the EM fixed point as one
`lax.while_loop` whose E-step work is sharded over the mesh and reduced with
`psum` every iteration [BASELINE.json:5].

Sharding layout: the flat EC-membership arrays (the nnz axis of em.ECTable)
are split evenly across chips; alpha, eff and the per-EC denominators stay
replicated. Each iteration does two psums: the (E,) partial
denominators and the (T,) partial alpha updates. The convergence predicate
is computed on the replicated alpha, so every chip exits in lockstep.

The reference's EM is a single-process numpy loop (infer.py, SURVEY.md 3.4);
this subsystem has no reference counterpart by design.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import EMConfig, ShardConfig
from ..em.em import (
    ECTable,
    _block_body,
    _chunked_fixed_point,
    accel_schedule,
    effective_lengths,
    run_blocked_fixed_point,
    squarem_cycle,
    use_chunked,
)

log = logging.getLogger(__name__)


def shard_ec_table(ec: ECTable, n_shards: int) -> ECTable:
    """Pad the nnz axis to a multiple of n_shards (pad entries point at a
    synthetic zero-count EC, so they are inert)."""
    nnz = int(ec.txp_ids.shape[0])
    pad_to = -(-max(nnz, 1) // n_shards) * n_shards
    if pad_to == nnz:
        return ec
    pad = pad_to - nnz
    E = ec.num_ecs
    counts = jnp.concatenate([ec.counts, jnp.zeros(1, ec.counts.dtype)])
    ec_ids = jnp.concatenate([ec.ec_ids, jnp.full(pad, E, jnp.int32)])
    txp_ids = jnp.concatenate([ec.txp_ids, jnp.zeros(pad, jnp.int32)])
    return ECTable(counts, ec_ids, txp_ids, E + 1, ec.num_transcripts)


def run_em_collective(
    ec: ECTable,
    lengths,
    cfg: EMConfig,
    mesh: Mesh,
    shard_cfg: ShardConfig = ShardConfig(),
    chunked: Optional[bool] = None,
    alpha_init=None,
    it_init: int = 0,
    on_sync=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """EM to convergence with the membership axis sharded over the mesh's
    data axis. Returns (alpha float[T], iterations).

    ``chunked`` = None follows em.em.use_chunked: a snapshot hook selects
    host-driven per-block shard_map executions (the same
    _chunked_fixed_point machinery as the single-device CSR EM, with
    identical state semantics). Multi-process callers pass ``chunked``
    explicitly, agreed across hosts: the hook lives on process 0 only, and
    hosts running different modes would deadlock the collectives.

    ``alpha_init``/``it_init``/``on_sync(alpha_np, it)`` wire EM-stage
    snapshots (resume + mid-run saves on the chunked path; the
    single-execution path honors the warm start but cannot fire mid-run
    hooks), mirroring em.em.run_em.
    """
    axis = shard_cfg.data_axis_name
    n_shards = mesh.shape[axis]
    ec = shard_ec_table(ec, n_shards)
    E, T = ec.num_ecs, ec.num_transcripts
    dtype = ec.counts.dtype

    nnz_spec = P(axis)
    rep = P()

    def make_one_iter(counts, ec_ids, txp_ids, eff):
        def one_iter(alpha):
            w = alpha[txp_ids] / eff[txp_ids]
            denom_part = jax.ops.segment_sum(w, ec_ids, num_segments=E)
            denom = jax.lax.psum(denom_part, axis)
            d = denom[ec_ids]
            r = jnp.where(d > 0, counts[ec_ids] * w / d, 0.0)
            part = jax.ops.segment_sum(r, txp_ids, num_segments=T)
            return jax.lax.psum(part, axis)

        return one_iter

    chunked = use_chunked(chunked, snapshots=on_sync is not None)

    # SQUAREM acceleration (em.em.squarem_cycle) applies to the psum'd
    # iterate unchanged: each chip computes the identical REPLICATED alpha
    # (the psums close every partial sum), so the secant norms and
    # steplength are replicated too and all chips extrapolate in lockstep.
    # cfg_eff rescales the blocked budget to cycles (3 EM steps each);
    # reported iteration counts stay in EM-step units (x ``per``).
    accel = cfg.accel == "squarem"
    cfg_eff, per = (accel_schedule(cfg), 3) if accel else (cfg, 1)

    def make_iterate(counts, ec_ids, txp_ids, eff):
        base = make_one_iter(counts, ec_ids, txp_ids, eff)
        return (lambda a: squarem_cycle(base, a)) if accel else base

    if not chunked:
        if on_sync is not None:
            # contract narrowing a caller cannot see from the signature:
            # a forced single execution honors the warm start but fires no
            # mid-run snapshot hooks
            log.info(
                "collective EM running as a single execution; mid-run "
                "snapshots (on_sync) will not fire for this stage")

        def em_collective(counts, ec_ids, txp_ids, lengths, a_init):
            eff = effective_lengths(lengths, cfg, dtype)
            N = counts.sum()
            alpha0 = jnp.where(a_init.sum() > 0, a_init,
                               jnp.full((T,), N / T, dtype=dtype))
            it, _, alpha = run_blocked_fixed_point(
                make_iterate(counts, ec_ids, txp_ids, eff), alpha0, cfg_eff,
                it_init=it_init // per)
            return alpha, it * per

        sm = jax.shard_map(
            em_collective,
            mesh=mesh,
            in_specs=(rep, nnz_spec, nnz_spec, rep, rep),
            out_specs=(rep, rep),
            check_vma=False,
        )
        fn = jax.jit(sm)
        a_init = (jnp.zeros((T,), dtype) if alpha_init is None
                  else jnp.asarray(alpha_init, dtype))
        return fn(ec.counts, ec.ec_ids, ec.txp_ids, jnp.asarray(lengths),
                  a_init)

    # chunked: one blocked round per XLA execution, driven from the host
    def em_block(counts, ec_ids, txp_ids, eff, it, conv, alpha):
        return _block_body(make_iterate(counts, ec_ids, txp_ids, eff),
                           cfg_eff)((it, conv, alpha))

    sm = jax.shard_map(
        em_block,
        mesh=mesh,
        in_specs=(rep, nnz_spec, nnz_spec, rep) + (rep,) * 3,
        out_specs=(rep,) * 3,
        check_vma=False,
    )
    blk = jax.jit(sm, donate_argnums=(4, 5, 6))

    eff = effective_lengths(jnp.asarray(lengths), cfg, dtype)
    N = ec.counts.sum()
    alpha0 = (jnp.full((T,), N / T, dtype=dtype)
              if alpha_init is None else jnp.asarray(alpha_init, dtype))
    hook = None
    if on_sync is not None:
        hook = lambda state, it: on_sync(np.asarray(state[2]), it * per)
    state0 = (jnp.int32(it_init // per), jnp.bool_(False), alpha0)
    state, it_v = _chunked_fixed_point(
        lambda s: blk(ec.counts, ec.ec_ids, ec.txp_ids, eff, *s),
        state0, cfg_eff, on_sync=hook)
    return state[2], jnp.int32(it_v * per)
