"""EM transcript-abundance inference on device (reference: seekmer infer.py,
SURVEY.md 2.1 C7 and call stack 3.4; exact upstream constants are open
parameters pinned in EMConfig until the reference mount is readable).

Device formulation: the EC membership structure is a flat CSR —
``txp_ids[nnz]`` / ``ec_ids[nnz]`` (sorted by EC) — so one EM iteration is
two segment-sums and elementwise work, all static shapes, wrapped in a
``jax.lax.while_loop`` fixed point:

  E: w = alpha[txp] / eff[txp];  denom_c = segsum_ec(w)
     r = n_c * w / denom_c
  M: alpha'_t = segsum_txp(r)

The same function runs single-chip, vmapped over bootstrap replicates
(em/bootstrap.py), and under shard_map with psum reductions
(parallel/collective_em.py).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EMConfig


class ECTable(NamedTuple):
    """Flat equivalence-class structure for EM (host-built, device-resident)."""

    counts: jnp.ndarray  # float[E] reads per EC
    ec_ids: jnp.ndarray  # int32[nnz] EC id per membership entry (sorted)
    txp_ids: jnp.ndarray  # int32[nnz] transcript id per membership entry
    num_ecs: int  # static E
    num_transcripts: int  # static T


def build_ec_table(
    member_lists: List[np.ndarray],
    counts: np.ndarray,
    num_transcripts: int,
    dtype=jnp.float32,
    pad_to: int | None = None,
) -> ECTable:
    """Flatten per-EC member lists into the CSR used on device.

    ``pad_to`` rounds nnz up (padding entries point at EC E-1 with weight 0
    via a zero-count pad EC) to stabilize compiled shapes across runs.
    """
    E = len(member_lists)
    nnz_list = [m.size for m in member_lists]
    ec_ids = np.repeat(np.arange(E, dtype=np.int32), nnz_list)
    txp_ids = (
        np.concatenate(member_lists).astype(np.int32)
        if member_lists
        else np.empty(0, np.int32)
    )
    c = np.asarray(counts, dtype=np.float64)
    if pad_to is not None and txp_ids.size < pad_to:
        pad = pad_to - txp_ids.size
        # pad entries belong to a synthetic zero-count EC so they are inert
        ec_ids = np.concatenate([ec_ids, np.full(pad, E, np.int32)])
        txp_ids = np.concatenate([txp_ids, np.zeros(pad, np.int32)])
        c = np.concatenate([c, [0.0]])
        E += 1
    return ECTable(
        counts=jnp.asarray(c, dtype=dtype),
        ec_ids=jnp.asarray(ec_ids),
        txp_ids=jnp.asarray(txp_ids),
        num_ecs=E,
        num_transcripts=num_transcripts,
    )


def effective_lengths(lengths: jnp.ndarray, cfg: EMConfig, dtype=jnp.float32):
    """Effective transcript lengths under the fragment-length model.

    cfg.fragment_length_sd == 0 is the degenerate model
    ``max(len - mean + 1, 1)``; sd > 0 is the truncated-normal FLD
    expectation ``E_f[len - f + 1 | f <= len]`` (kallisto/salmon-class;
    reference infer.py's exact form is an open parameter, SURVEY.md 3.4).
    Computed via cumulative sums over the static fragment grid — O(T)
    gathers, no (T, F) transient.
    """
    l = lengths.astype(dtype)
    mu = jnp.asarray(cfg.mean_fragment_length, dtype)
    if cfg.fragment_length_sd <= 0.0:
        return jnp.maximum(l - mu + 1.0, 1.0)
    sd = cfg.fragment_length_sd
    F = int(np.ceil(cfg.mean_fragment_length + 5.0 * sd))
    f = jnp.arange(1, F + 1, dtype=dtype)
    pdf = jnp.exp(-0.5 * ((f - mu) / jnp.asarray(sd, dtype)) ** 2)
    c0 = jnp.cumsum(pdf)
    c1 = jnp.cumsum(pdf * f)
    # E[len - f + 1 | f <= min(len, F)] = (len + 1) - C1/C0 at min(len, F)
    idx = jnp.clip(lengths.astype(jnp.int32), 1, F) - 1
    eff = (l + 1.0) - c1[idx] / c0[idx]
    return jnp.maximum(eff, 1.0)


def em_step(alpha, ec: ECTable, eff):
    """One E+M iteration in counts space."""
    w = alpha[ec.txp_ids] / eff[ec.txp_ids]
    denom = jax.ops.segment_sum(
        w, ec.ec_ids, num_segments=ec.num_ecs, indices_are_sorted=True
    )
    d = denom[ec.ec_ids]
    r = jnp.where(d > 0, ec.counts[ec.ec_ids] * w / d, 0.0)
    return jax.ops.segment_sum(r, ec.txp_ids, num_segments=ec.num_transcripts)


def squarem_cycle(em_iter, alpha, eps=1e-30, step_cap=64.0):
    """One SQUAREM (S3 / Varadhan & Roland 2008) acceleration cycle of the
    EM fixed-point map: two EM steps give the secant pair, a steplength
    ``-max(|r|/|v|, 1)`` extrapolates, and a trailing EM step stabilizes
    and restores feasibility (our counts-space EM maps any nonnegative
    vector to one with total mass N, so clamping the extrapolation at 0
    is the only projection needed). Same fixed points as plain EM; near
    one, |v| -> 0, the step is capped, and the cycle degenerates to plain
    EM steps. Works on (T,) single runs and (T, B) replicate-major
    batches (per-replicate steplengths).
    """
    a1 = em_iter(alpha)
    a2 = em_iter(a1)
    r = a1 - alpha
    v = (a2 - a1) - r
    axes = 0 if alpha.ndim == 2 else None
    rn = jnp.sqrt(jnp.sum(r * r, axis=axes))
    vn = jnp.sqrt(jnp.sum(v * v, axis=axes))
    step = -jnp.clip(rn / jnp.maximum(vn, eps), 1.0, step_cap)
    ext = alpha - 2.0 * step * r + (step * step) * v
    ext = jnp.maximum(ext, 0.0)
    ext = jnp.where(jnp.isfinite(ext), ext, a2)
    return em_iter(ext)


def accel_schedule(cfg: EMConfig) -> EMConfig:
    """Rescale the blocked-fixed-point budget to SQUAREM cycles (3 EM
    steps per cycle) so user-facing max_iters/min_iters keep EM-step
    units."""
    import dataclasses

    return dataclasses.replace(
        cfg,
        max_iters=-(-cfg.max_iters // 3),
        min_iters=-(-cfg.min_iters // 3),
        check_every=max(cfg.check_every // 3, 1),
    )


def convergence_check(alpha_m, alpha_new, cfg: EMConfig):
    """max relative change over active transcripts < rel_tol. active.any()
    guards vacuous convergence (a collapsed alpha would otherwise pass the
    test with no active transcripts)."""
    active = alpha_new > cfg.count_floor
    rel = jnp.abs(alpha_new - alpha_m) / (alpha_new + cfg.abs_floor)
    return active.any() & (jnp.where(active, rel, 0.0).max() < cfg.rel_tol)


def run_blocked_fixed_point(em_iter, alpha0, cfg: EMConfig,
                            it_init: int = 0):
    """Iterate ``alpha -> em_iter(alpha)`` to convergence, checking every
    cfg.check_every iterations. Returns (it, converged, alpha).
    ``it_init`` warm-starts the iteration counter (snapshot resume), so
    the max_iters budget counts TOTAL iterations across restarts.

    Data-dependent control flow costs a device<->runtime sync per
    evaluation, so each while_loop round runs check_every-1 raw counted EM
    steps plus one monitored step, and tests convergence between the
    block's last two iterates. Iteration counts are therefore multiples of
    check_every and max_iters is rounded up to a whole block — the numpy
    oracle (tests/oracle) implements the identical rule, so device/oracle
    parity is exact. Shared by the CSR EM, the batched bootstrap EM, and
    the collective (psum) EM.
    """
    def cond(state):
        it, converged, _ = state
        return (~converged) & (it < cfg.max_iters)

    # one shared block implementation with the chunked host driver
    # (_block_body); its converged-identity gate is dead code here (cond
    # stops the loop first) but keeps the two paths state-for-state equal
    return jax.lax.while_loop(
        cond, _block_body(em_iter, cfg),
        (jnp.int32(it_init), jnp.bool_(False), alpha0))


def _block_body(em_iter, cfg: EMConfig):
    """One blocked round (check_every-1 raw + 1 monitored step) as a state
    transformer; identity once converged — so running extra blocks past
    convergence leaves (it, converged, alpha) unchanged and the chunked
    host driver below matches the device while_loop state-for-state."""
    C = max(cfg.check_every, 1)

    def body(state):
        it, _, alpha = state
        alpha_m = jax.lax.fori_loop(0, C - 1, lambda i, a: em_iter(a), alpha)
        alpha_new = em_iter(alpha_m)
        converged = (convergence_check(alpha_m, alpha_new, cfg)
                     & (it + C >= cfg.min_iters))
        return it + C, converged, alpha_new

    def step(state):
        return jax.lax.cond(state[1], lambda s: s, body, state)

    return step


@functools.partial(
    jax.jit, static_argnames=("num_ecs", "num_transcripts", "cfg"),
    donate_argnums=(6,),
)
def _em_block_jit(counts, ec_ids, txp_ids, eff, it, conv, alpha,
                  num_ecs, num_transcripts, cfg):
    ec = ECTable(counts, ec_ids, txp_ids, num_ecs, num_transcripts)
    base = lambda a: em_step(a, ec, eff)
    em_iter = ((lambda a: squarem_cycle(base, a))
               if cfg.accel == "squarem" else base)
    return _block_body(em_iter, cfg)((it, conv, alpha))


def use_chunked(chunked: bool | None, snapshots: bool,
                resume: bool = False) -> bool:
    """Execution-mode policy of every EM fixed point (single-run,
    bootstrap, collective, sharded bootstrap): one while_loop execution,
    unless the caller wants mid-run snapshots (checkpointed runs — the
    chunked driver's host syncs are the snapshot points) or resumes a
    form that only the chunked driver can warm-start. ``chunked`` forces
    a mode. Both modes give identical results: post-convergence blocks
    are the identity (_block_body)."""
    if chunked is not None:
        return chunked
    return snapshots or resume


def _chunked_fixed_point(block_fn, state, cfg_eff: EMConfig,
                         target_sync_s: float = 2.0, on_sync=None):
    """Drive blocked fixed-point rounds from the host: enqueue k blocks
    asynchronously (each its own bounded XLA execution), then one scalar
    readback; adapt k so syncs cost ~target_sync_s of enqueued compute.
    Semantics identical to lax.while_loop over the same block (post-
    convergence blocks are identity).

    ``on_sync(state, it)`` fires at every host sync point that does NOT
    finish the run — the EM-stage snapshot hook (SURVEY.md 5.3: "EM
    restarts from last alpha snapshot"); the state it sees is a genuine
    block boundary, so resuming from it replays the identical iterate
    sequence."""
    import time

    C = max(cfg_eff.check_every, 1)
    k = 1
    while True:
        t0 = time.perf_counter()
        for _ in range(k):
            state = block_fn(state)
        it_v = int(state[0])  # sync point
        conv_v = bool(state[1])
        dt = time.perf_counter() - t0
        if conv_v or it_v >= cfg_eff.max_iters:
            return state, it_v
        if on_sync is not None:
            on_sync(state, it_v)
        per_block = max(dt / k, 1e-4)
        remaining = max((cfg_eff.max_iters - it_v) // C, 1)
        k = max(1, min(int(target_sync_s / per_block), remaining))
        if jax.process_count() > 1:
            # k adapts from LOCAL timing; when the block is a collective
            # program (collective EM, sharded bootstrap) hosts that picked
            # different k would enqueue different execution counts between
            # syncs and deadlock the collectives — agree on process 0's k
            from jax.experimental import multihost_utils as mhu

            k = int(np.asarray(mhu.broadcast_one_to_all(np.int64(k))))


def _run_em_chunked(ec: ECTable, lengths, cfg: EMConfig, alpha_init=None,
                    it_init: int = 0, on_sync=None):
    cfg_eff, per = ((accel_schedule(cfg), 3) if cfg.accel == "squarem"
                    else (cfg, 1))
    dtype = ec.counts.dtype
    eff = effective_lengths(jnp.asarray(lengths), cfg, dtype)
    T = ec.num_transcripts
    N = ec.counts.sum()
    alpha0 = (jnp.full((T,), N / T, dtype=dtype)
              if alpha_init is None else jnp.asarray(alpha_init, dtype))

    def block(state):
        it, conv, alpha = state
        return _em_block_jit(ec.counts, ec.ec_ids, ec.txp_ids, eff,
                             it, conv, alpha,
                             num_ecs=ec.num_ecs, num_transcripts=T,
                             cfg=cfg_eff)

    hook = None
    if on_sync is not None:
        # report EM-step units (internal counter is in iterate units: 1
        # SQUAREM cycle = 3 EM steps)
        hook = lambda state, it: on_sync(np.asarray(state[2]), it * per)
    state0 = (jnp.int32(it_init // per), jnp.bool_(False), alpha0)
    state, it_v = _chunked_fixed_point(block, state0, cfg_eff,
                                       on_sync=hook)
    return state[2], jnp.int32(it_v * per)


@functools.partial(
    jax.jit, static_argnames=("num_ecs", "num_transcripts", "cfg", "it_init")
)
def _run_em_jit(counts, ec_ids, txp_ids, lengths, num_ecs, num_transcripts,
                cfg, alpha_init=None, it_init: int = 0):
    ec = ECTable(counts, ec_ids, txp_ids, num_ecs, num_transcripts)
    dtype = counts.dtype
    eff = effective_lengths(lengths, cfg, dtype)
    N = counts.sum()
    T = num_transcripts
    alpha0 = (jnp.full((T,), N / T, dtype=dtype)
              if alpha_init is None else alpha_init.astype(dtype))

    em_iter = lambda a: em_step(a, ec, eff)
    if cfg.accel == "squarem":
        it, _, alpha = run_blocked_fixed_point(
            lambda a: squarem_cycle(em_iter, a), alpha0, accel_schedule(cfg),
            it_init=it_init // 3)
        return alpha, it * 3
    it, _, alpha = run_blocked_fixed_point(em_iter, alpha0, cfg,
                                           it_init=it_init)
    return alpha, it


def run_em(
    ec: ECTable, lengths, cfg: EMConfig = EMConfig(), alpha_init=None,
    it_init: int = 0, on_sync=None, chunked: bool | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """EM to convergence on the flat CSR. Returns (alpha float[T],
    iterations int32).

    ``alpha_init``/``it_init`` warm-start the fixed point (checkpoint
    resume, SURVEY.md 5.3: "EM restarts from last alpha snapshot"; the
    max_iters budget counts total iterations across restarts).
    ``on_sync(alpha_np, it)`` fires at host sync points of the CHUNKED
    execution path — the snapshot hook; giving it selects that path
    (use_chunked). ``chunked`` forces a mode.
    """
    if use_chunked(chunked, snapshots=on_sync is not None):
        return _run_em_chunked(ec, lengths, cfg, alpha_init=alpha_init,
                               it_init=it_init, on_sync=on_sync)
    return _run_em_jit(
        ec.counts,
        ec.ec_ids,
        ec.txp_ids,
        jnp.asarray(lengths),
        ec.num_ecs,
        ec.num_transcripts,
        cfg,
        alpha_init=alpha_init,
        it_init=it_init,
    )


def log_likelihood(ec: ECTable, alpha, eff) -> jnp.ndarray:
    """Final data log-likelihood under the multinomial read model
    (reference progress metric, SURVEY.md 5.5: "final likelihood"):

        L = sum_c n_c * log( sum_{t in c} theta_t / eff_t )
        theta = alpha / sum(alpha)   (read-generating rates, normalized)

    Empty-denominator ECs (all member transcripts at zero abundance)
    contribute -inf-free 0 via masking — they carry no mass at a fixed
    point anyway.
    """
    theta = alpha / jnp.maximum(alpha.sum(), 1e-300)
    w = theta[ec.txp_ids] / eff[ec.txp_ids]
    denom = jax.ops.segment_sum(w, ec.ec_ids, num_segments=ec.num_ecs,
                                indices_are_sorted=True)
    return jnp.where(
        (ec.counts > 0) & (denom > 0),
        ec.counts * jnp.log(jnp.maximum(denom, 1e-300)), 0.0).sum()


def tpm_from_alpha(alpha, lengths, cfg: EMConfig):
    eff = effective_lengths(jnp.asarray(lengths), cfg, alpha.dtype)
    rate = jnp.where(alpha > 0, alpha / eff, 0.0)
    s = rate.sum()
    return jnp.where(s > 0, 1e6 * rate / s, 0.0)
