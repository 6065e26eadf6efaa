"""P4 — bootstrap replicates sharded across chips (SURVEY.md 2.2): config 5
runs 100 EM bootstrap replicates as a vmapped batch [BASELINE.json:11]; here
the replicate axis is split over the mesh's data axis, each chip resampling
with an axis-folded PRNG key and running its replicates' batched EM locally.

Convergence is the single shared rule of em/bootstrap.py ("iterates until
every replicate meets the shared convergence rule"): each chip's local
convergence test is combined with one tiny psum per blocked round, so all
chips leave in lockstep at the same iteration count — which also makes the
single-execution and chunked execution modes state-for-state identical and
keeps the stage snapshot a plain (alpha[T, B], it) pair.

Checkpointed and resumed runs execute CHUNKED (blocked rounds driven from
the host, em.em.use_chunked): the host sync points are the bootstrap-stage
snapshot hook (SURVEY.md 5.3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EMConfig, ShardConfig
from ..em.bootstrap import _batched_iter, resample_counts
from ..em.em import (
    ECTable,
    _chunked_fixed_point,
    accel_schedule,
    convergence_check,
    effective_lengths,
    squarem_cycle,
    use_chunked,
)


def _global_step(em_iter, cfg_eff: EMConfig, axis: str, n_shards: int):
    """One blocked round with the convergence test POD-GLOBAL: every chip
    computes its local test, a psum ANDs them, and the replicated flag
    gates the identity-once-converged behavior — the sharded analog of
    em.em._block_body with one scalar psum per round."""
    C = max(cfg_eff.check_every, 1)

    def body(state):
        it, _, alpha = state
        alpha_m = jax.lax.fori_loop(0, C - 1, lambda i, a: em_iter(a), alpha)
        alpha_new = em_iter(alpha_m)
        ok = convergence_check(alpha_m, alpha_new, cfg_eff)
        ok_all = jax.lax.psum(ok.astype(jnp.int32), axis) == n_shards
        return it + C, ok_all & (it + C >= cfg_eff.min_iters), alpha_new

    def step(state):
        return jax.lax.cond(state[1], lambda s: s, body, state)

    return step


def run_bootstrap_sharded(
    ec: ECTable,
    lengths,
    cfg: EMConfig,
    mesh: Mesh,
    shard_cfg: ShardConfig = ShardConfig(),
    alpha_init=None,
    it_init: int = 0,
    on_sync=None,
    snapshots: bool = False,
    chunked: bool | None = None,
):
    """Returns est_counts float[B, T], replicate axis sharded over the mesh.

    Replicate b on shard d uses key fold_in(seed_key, d), so results are
    reproducible for a fixed mesh size (and a resumed run regenerates the
    identical resamples).

    ``alpha_init`` (replicate-major (T, B), host/global) / ``it_init``
    warm-start from a bootstrap-stage snapshot; ``on_sync(alpha_TB_np,
    it)`` fires at the chunked driver's host sync points. ``snapshots``
    must be True on EVERY process when any process wants snapshots: the
    hook allgathers the replicate-sharded alpha to the host, which is
    collective on multi-process meshes — only hosts with ``on_sync`` set
    (process 0 in the quantifier) write. It also selects the chunked mode
    (em.em.use_chunked), as does a resume (the single-execution form has
    no warm start); ``chunked`` forces a mode.
    """
    axis = shard_cfg.data_axis_name
    D = mesh.shape[axis]
    B = cfg.bootstrap_samples
    if B % D:
        raise ValueError(f"bootstrap_samples {B} not divisible by {D} shards")
    B_local = B // D
    E, T = ec.num_ecs, ec.num_transcripts
    dtype = ec.counts.dtype

    accel = cfg.accel == "squarem"
    cfg_eff, per = (accel_schedule(cfg), 3) if accel else (cfg, 1)

    def make_iter(counts_nnz, inv_eff_nnz):
        base = _batched_iter(counts_nnz, inv_eff_nnz, ec.ec_ids, ec.txp_ids,
                             E, T)
        return (lambda a: squarem_cycle(base, a)) if accel else base

    chunked = use_chunked(chunked, snapshots=snapshots,
                          resume=alpha_init is not None or it_init > 0)

    if not chunked:
        def local(counts, ec_ids, txp_ids, lengths):
            d = jax.lax.axis_index(axis)
            key = jax.random.fold_in(jax.random.PRNGKey(cfg.bootstrap_seed),
                                     d)
            cmat = resample_counts(key, counts, B_local)  # [B_local, E]
            eff = effective_lengths(lengths, cfg, dtype)
            counts_nnz = cmat.T.astype(dtype)[ec_ids]
            inv_eff_nnz = (1.0 / eff)[txp_ids][:, None]
            em_iter = make_iter(counts_nnz, inv_eff_nnz)
            alpha0 = jnp.broadcast_to(cmat.sum(axis=1)[None, :] / T,
                                      (T, B_local)).astype(dtype)
            step = _global_step(em_iter, cfg_eff, axis, D)
            cond = lambda s: (~s[1]) & (s[0] < cfg_eff.max_iters)
            _, _, alpha = jax.lax.while_loop(
                cond, step, (jnp.int32(0), jnp.bool_(False), alpha0))
            return alpha.T  # [B_local, T]

        sm = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=P(axis),
            check_vma=False,
        )
        return jax.jit(sm)(ec.counts, ec.ec_ids, ec.txp_ids,
                           jnp.asarray(lengths))

    # chunked: materialize the loop-constant resample once (replicate axis
    # sharded), then drive one blocked round per bounded XLA execution
    def consts_local(counts, ec_ids, txp_ids, lengths):
        d = jax.lax.axis_index(axis)
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.bootstrap_seed), d)
        cmat = resample_counts(key, counts, B_local)  # [B_local, E]
        counts_nnz = cmat.T.astype(dtype)[ec_ids]  # (nnz, B_local)
        alpha0 = jnp.broadcast_to(cmat.sum(axis=1)[None, :] / T,
                                  (T, B_local)).astype(dtype)
        return counts_nnz, alpha0

    consts = jax.jit(jax.shard_map(
        consts_local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(None, axis), P(None, axis)),
        check_vma=False,
    ))
    counts_nnz, alpha0 = consts(ec.counts, ec.ec_ids, ec.txp_ids,
                                jnp.asarray(lengths))
    eff = effective_lengths(jnp.asarray(lengths), cfg, dtype)
    inv_eff_nnz = (1.0 / eff)[ec.txp_ids][:, None]

    if alpha_init is not None:
        from .ckpt_mp import place_global

        alpha0 = place_global(np.asarray(alpha_init, dtype),
                              NamedSharding(mesh, P(None, axis)))

    def block_local(counts_nnz, inv_eff_nnz, it, conv, alpha):
        em_iter = make_iter(counts_nnz, inv_eff_nnz)
        return _global_step(em_iter, cfg_eff, axis, D)((it, conv, alpha))

    sm = jax.shard_map(
        block_local,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P(), P(None, axis)),
        out_specs=(P(), P(), P(None, axis)),
        check_vma=False,
    )
    blk = jax.jit(sm, donate_argnums=(4,))

    hook = None
    if snapshots:
        from .ckpt_mp import allgather_host

        def hook(state, it):
            # collective on multi-process meshes — every process joins the
            # allgather; only hosts given an on_sync (process 0) write
            host_alpha = allgather_host(state[2])
            if on_sync is not None:
                on_sync(host_alpha, it * per)

    state0 = (jnp.int32(it_init // per), jnp.bool_(False), alpha0)
    state, _ = _chunked_fixed_point(
        lambda s: blk(counts_nnz, inv_eff_nnz, *s), state0, cfg_eff,
        on_sync=hook)
    return state[2].T  # [B, T], replicate axis sharded
