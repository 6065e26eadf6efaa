"""Bootstrap uncertainty quantification: multinomially resampled EC counts,
EM re-run per replicate (reference: infer.py's bootstrap loop, SURVEY.md 2.1
C8 / call stack 3.5).

The reference loops replicates serially; here all B replicates run as ONE
batched while_loop over a replicate-major (T, B) iterate (SURVEY.md 2.2
P4), and the replicate axis can additionally be sharded across devices
(parallel/ wiring). The fixed point iterates until every replicate meets
the shared convergence rule. The batched step is the flat CSR (gathers +
segment sums over the nnz membership entries); a dense form (two matrix
products against the (E, T) membership matrix) measured slower on the
H100 at every size tried (PERF.md), so it is not kept.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import EMConfig
from .em import (
    ECTable,
    _block_body,
    _chunked_fixed_point,
    accel_schedule,
    effective_lengths,
    run_blocked_fixed_point,
    squarem_cycle,
    use_chunked,
)


def resample_counts(key, counts, num_samples: int):
    """Multinomial resample of the EC count vector: n^(b) ~ Mult(N, n/N).

    jax.random.multinomial lowers to a sequential binomial scan over the E
    categories; unroll amortizes its per-step overhead (it dominated the
    bootstrap wall clock at E ~ 1400)."""
    N = counts.sum()
    p = counts / N
    keys = jax.random.split(key, num_samples)
    draw = lambda k: jax.random.multinomial(k, N, p, unroll=16)
    return jax.vmap(draw)(keys).astype(counts.dtype)


def bootstrap_core(counts, ec_ids, txp_ids, lengths, key, n_replicates: int,
                   num_ecs: int, num_transcripts: int, cfg: EMConfig):
    """Resample + batched EM for ``n_replicates`` replicates (shared by the
    single-chip jit below and the sharded wrapper in parallel/)."""
    cmat = resample_counts(key, counts, n_replicates)  # [B, E]
    return batched_em(cmat, counts.dtype, ec_ids, txp_ids, lengths,
                      num_ecs, num_transcripts, cfg)


def batched_em(cmat, dtype, ec_ids, txp_ids, lengths,
               num_ecs: int, num_transcripts: int, cfg: EMConfig):
    """Batched CSR EM over pre-resampled count rows [B, E], replicate-major.

    The replicate axis lives in the ROW (minor) dimension of every gather
    and segment-sum — (nnz, B)-shaped operands indexed by nnz lanes — so
    each EM iteration gathers nnz rows of B contiguous values instead of
    B*nnz scattered ones. Plain 2-D segment_sum, no vmap; oracle-validated
    per replicate.
    """
    eff = effective_lengths(lengths, cfg, dtype)
    B, T = cmat.shape[0], num_transcripts
    counts_nnz = cmat.T.astype(dtype)[ec_ids]  # (nnz, B), loop-constant
    inv_eff_nnz = (1.0 / eff)[txp_ids][:, None]  # (nnz, 1)
    em_iter = _batched_iter(counts_nnz, inv_eff_nnz, ec_ids, txp_ids,
                            num_ecs, T)
    n_per = cmat.sum(axis=1)  # (B,)
    alpha0 = jnp.broadcast_to(n_per[None, :] / T, (T, B)).astype(dtype)
    if cfg.accel == "squarem":
        it, _, alpha = run_blocked_fixed_point(
            lambda a: squarem_cycle(em_iter, a), alpha0, accel_schedule(cfg))
        return alpha.T, it * 3
    it, _, alpha = run_blocked_fixed_point(em_iter, alpha0, cfg)
    return alpha.T, it


def _batched_iter(counts_nnz, inv_eff_nnz, ec_ids, txp_ids,
                  num_ecs: int, num_transcripts: int):
    def em_iter(alpha):  # (T, B)
        w = alpha[txp_ids] * inv_eff_nnz
        denom = jax.ops.segment_sum(
            w, ec_ids, num_segments=num_ecs, indices_are_sorted=True)
        d = denom[ec_ids]
        r = jnp.where(d > 0, counts_nnz * w / d, 0.0)
        return jax.ops.segment_sum(r, txp_ids, num_segments=num_transcripts)
    return em_iter


@functools.partial(
    jax.jit, static_argnames=("num_ecs", "num_transcripts", "cfg"),
    donate_argnums=(6,),
)
def _batched_block_jit(counts_nnz, inv_eff_nnz, ec_ids, txp_ids, it, conv,
                       alpha, num_ecs, num_transcripts, cfg):
    base = _batched_iter(counts_nnz, inv_eff_nnz, ec_ids, txp_ids,
                         num_ecs, num_transcripts)
    em_iter = ((lambda a: squarem_cycle(base, a))
               if cfg.accel == "squarem" else base)
    return _block_body(em_iter, cfg)((it, conv, alpha))


def _batched_em_chunked(cmat, ec_ids, txp_ids, lengths,
                        num_ecs: int, num_transcripts: int, cfg: EMConfig,
                        alpha_init=None, it_init: int = 0, on_sync=None):
    """Chunked host-driven variant of batched_em: same blocked schedule,
    one XLA execution per few blocks, host syncs in between.

    ``alpha_init`` (replicate-major (T, B)) / ``it_init`` warm-start the
    batched fixed point from a bootstrap-stage snapshot; ``on_sync
    (alpha_TB_np, it)`` fires at host sync points (the snapshot hook —
    resampling is seeded, so a resumed run sees the identical cmat and
    replays the identical iterate sequence)."""
    cfg_eff, per = ((accel_schedule(cfg), 3) if cfg.accel == "squarem"
                    else (cfg, 1))
    dtype = cmat.dtype
    eff = effective_lengths(jnp.asarray(lengths), cfg, dtype)
    B, T = cmat.shape[0], num_transcripts
    counts_nnz = cmat.T.astype(dtype)[ec_ids]
    inv_eff_nnz = (1.0 / eff)[txp_ids][:, None]
    n_per = cmat.sum(axis=1)
    alpha0 = (jnp.broadcast_to(n_per[None, :] / T, (T, B)).astype(dtype)
              if alpha_init is None else jnp.asarray(alpha_init, dtype))

    def block(state):
        it, conv, alpha = state
        return _batched_block_jit(counts_nnz, inv_eff_nnz, ec_ids, txp_ids,
                                  it, conv, alpha, num_ecs=num_ecs,
                                  num_transcripts=T, cfg=cfg_eff)

    hook = None
    if on_sync is not None:
        import numpy as np

        hook = lambda state, it: on_sync(np.asarray(state[2]), it * per)
    state0 = (jnp.int32(it_init // per), jnp.bool_(False), alpha0)
    state, it_v = _chunked_fixed_point(block, state0, cfg_eff, on_sync=hook)
    return state[2].T, jnp.int32(it_v * per)


@functools.partial(
    jax.jit, static_argnames=("num_ecs", "num_transcripts", "cfg")
)
def _bootstrap_jit(counts, ec_ids, txp_ids, lengths, num_ecs,
                   num_transcripts, cfg: EMConfig):
    key = jax.random.PRNGKey(cfg.bootstrap_seed)
    return bootstrap_core(counts, ec_ids, txp_ids, lengths, key,
                          cfg.bootstrap_samples, num_ecs, num_transcripts,
                          cfg)


def run_bootstrap(ec: ECTable, lengths, cfg: EMConfig,
                  alpha_init=None, it_init: int = 0, on_sync=None,
                  chunked: bool | None = None):
    """Returns est_counts per replicate: float[B, T].

    ``alpha_init`` ((T, B) replicate-major) / ``it_init`` / ``on_sync``
    wire bootstrap-stage snapshots on the CHUNKED execution path, which
    they select (em.use_chunked); resampling is seeded by
    cfg.bootstrap_seed, so a resumed run regenerates the identical cmat.
    ``chunked`` forces a mode.
    """
    B = cfg.bootstrap_samples
    # ONE shared jitted resample for both execution modes, so they are
    # numerically comparable (and the sequential multinomial scan
    # compiles once)
    counts = ec.counts.astype(jnp.float32)
    key = jax.random.PRNGKey(cfg.bootstrap_seed)
    cmat = _resample_jit(key, counts, B)  # [B, E]
    if use_chunked(chunked, snapshots=on_sync is not None,
                   resume=alpha_init is not None or it_init > 0):
        alpha, _ = _batched_em_chunked(
            cmat, ec.ec_ids, ec.txp_ids, lengths,
            ec.num_ecs, ec.num_transcripts, cfg,
            alpha_init=alpha_init, it_init=it_init, on_sync=on_sync)
        return alpha
    alpha, _ = _batched_em_jit(cmat, ec.ec_ids, ec.txp_ids,
                               jnp.asarray(lengths), ec.num_ecs,
                               ec.num_transcripts, cfg)
    return alpha


@functools.partial(jax.jit, static_argnames=("n",))
def _resample_jit(key, counts, n: int):
    return resample_counts(key, counts, n)


@functools.partial(
    jax.jit, static_argnames=("num_ecs", "num_transcripts", "cfg")
)
def _batched_em_jit(cmat, ec_ids, txp_ids, lengths, num_ecs,
                    num_transcripts, cfg: EMConfig):
    return batched_em(cmat, cmat.dtype, ec_ids, txp_ids, lengths,
                      num_ecs, num_transcripts, cfg)
