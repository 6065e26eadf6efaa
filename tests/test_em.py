"""EM inference tests: hand-solvable fixed points, oracle parity, bootstrap
(SURVEY.md section 4 item 2)."""

import jax
import numpy as np
import pytest

from seekmer_tpu.config import EMConfig
from seekmer_tpu.em import bootstrap as bs
from seekmer_tpu.em.em import build_ec_table, run_em, tpm_from_alpha
from tests.oracle import oracle

F64 = EMConfig(use_x64=False)  # device runs f32 by default; oracle is f64


def test_unique_ecs_are_exact():
    """Every EC has one member -> EM must return raw counts immediately."""
    members = [np.array([0]), np.array([1]), np.array([2])]
    counts = np.array([10.0, 30.0, 60.0])
    lengths = np.array([500, 500, 500], np.int32)
    ec = build_ec_table(members, counts, 3)
    alpha, it = run_em(ec, lengths, EMConfig())
    np.testing.assert_allclose(np.asarray(alpha), counts, rtol=1e-6)


def test_two_transcript_split_by_length():
    """One shared EC over two transcripts: EM splits by effective length.

    Fixed point of alpha_t = n * (a_t/l_t) / sum(a/l) with equal priors is
    degenerate (any split is a fixed point when only one EC exists), so add
    unique ECs to anchor: n_unique gives the analytic solution."""
    members = [np.array([0]), np.array([1]), np.array([0, 1])]
    counts = np.array([90.0, 10.0, 100.0])
    lengths = np.array([1199, 1199], np.int32)  # eff 1000 each
    ec = build_ec_table(members, counts, 2)
    alpha, _ = run_em(ec, lengths, EMConfig(rel_tol=1e-8, max_iters=5000))
    alpha = np.asarray(alpha)
    # oracle solves the same system in float64
    o_alpha, _ = oracle.run_em(members, counts, lengths,
                               EMConfig(rel_tol=1e-8, max_iters=5000))
    np.testing.assert_allclose(alpha, o_alpha, rtol=1e-4)
    # shared reads go ~90/10 at the fixed point (proportional to unique evidence)
    assert alpha[0] > alpha[1]
    np.testing.assert_allclose(alpha.sum(), 200.0, rtol=1e-5)


def test_em_matches_oracle_random(rng):
    T, E = 50, 120
    lengths = rng.integers(250, 3000, size=T).astype(np.int32)
    members = []
    for _ in range(E):
        size = int(rng.integers(1, 6))
        members.append(np.sort(rng.choice(T, size=size, replace=False)).astype(np.int32))
    counts = rng.integers(1, 500, size=E).astype(np.float64)
    cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    o_alpha, o_it = oracle.run_em(members, counts, lengths, cfg)
    ec = build_ec_table(members, counts, T)
    alpha, it = run_em(ec, lengths, cfg)
    np.testing.assert_allclose(np.asarray(alpha), o_alpha, rtol=5e-3, atol=1e-3)
    # TPM parity
    o_tpm = oracle.tpm_from_alpha(o_alpha, lengths, cfg)
    tpm = np.asarray(tpm_from_alpha(alpha, lengths, cfg))
    np.testing.assert_allclose(tpm, o_tpm, rtol=5e-3, atol=1e-2)


def test_effective_length_floor():
    cfg = EMConfig(mean_fragment_length=200.0)
    lengths = np.array([100, 199, 200, 1000], np.int32)
    eff = oracle.effective_lengths(lengths, cfg)
    np.testing.assert_allclose(eff, [1.0, 1.0, 1.0, 801.0])


def test_effective_length_fld_matches_oracle():
    """Truncated-normal FLD model: device f32 matches the f64 oracle."""
    from seekmer_tpu.em.em import effective_lengths as dev_eff

    cfg = EMConfig(mean_fragment_length=200.0, fragment_length_sd=25.0)
    lengths = np.array([50, 150, 200, 250, 400, 1000, 5000], np.int32)
    o = oracle.effective_lengths(lengths, cfg)
    d = np.asarray(dev_eff(lengths, cfg))
    np.testing.assert_allclose(d, o, rtol=2e-5, atol=1e-3)


def test_effective_length_fld_properties():
    cfg = EMConfig(mean_fragment_length=200.0, fragment_length_sd=20.0)
    lengths = np.arange(30, 4000, 7, dtype=np.int32)
    eff = oracle.effective_lengths(lengths, cfg)
    # monotone nondecreasing in transcript length, always >= 1
    assert (np.diff(eff) >= -1e-9).all()
    assert (eff >= 1.0).all()
    # far above the FLD support, the expectation equals len - mean + 1
    long = oracle.effective_lengths(np.array([100000], np.int32), cfg)
    np.testing.assert_allclose(long, [100000 - 200.0 + 1.0], rtol=1e-9)
    # short transcripts only admit short fragments: eff < degenerate model's
    # floor region is replaced by a positive conditional expectation
    short = oracle.effective_lengths(np.array([120], np.int32), cfg)
    assert 1.0 <= short[0] < 120


def test_em_with_fld_matches_oracle(rng):
    T, E = 30, 70
    lengths = rng.integers(150, 2500, size=T).astype(np.int32)
    members = [
        np.sort(rng.choice(T, size=int(rng.integers(1, 5)),
                           replace=False)).astype(np.int32)
        for _ in range(E)
    ]
    counts = rng.integers(1, 300, size=E).astype(np.float64)
    cfg = EMConfig(rel_tol=1e-6, max_iters=2000,
                   mean_fragment_length=180.0, fragment_length_sd=30.0)
    o_alpha, _ = oracle.run_em(members, counts, lengths, cfg)
    ec = build_ec_table(members, counts, T)
    alpha, _ = run_em(ec, lengths, cfg)
    np.testing.assert_allclose(np.asarray(alpha), o_alpha, rtol=5e-3,
                               atol=1e-3)


def test_bootstrap_shapes_and_mass(rng):
    T, E, B = 20, 40, 16
    lengths = rng.integers(300, 2000, size=T).astype(np.int32)
    members = [np.sort(rng.choice(T, size=int(rng.integers(1, 4)),
                                  replace=False)).astype(np.int32)
               for _ in range(E)]
    counts = rng.integers(1, 100, size=E).astype(np.float64)
    cfg = EMConfig(bootstrap_samples=B, bootstrap_seed=7)
    ec = build_ec_table(members, counts, T)
    boot = np.asarray(bs.run_bootstrap(ec, lengths, cfg))
    assert boot.shape == (B, T)
    # each replicate conserves total read mass
    np.testing.assert_allclose(boot.sum(axis=1), counts.sum(), rtol=1e-4)
    # replicates differ (resampling actually happened)
    assert np.std(boot, axis=0).max() > 0


def test_bootstrap_deterministic_seed(rng):
    T, E = 10, 15
    lengths = rng.integers(300, 2000, size=T).astype(np.int32)
    members = [np.sort(rng.choice(T, size=2, replace=False)).astype(np.int32)
               for _ in range(E)]
    counts = rng.integers(1, 50, size=E).astype(np.float64)
    cfg = EMConfig(bootstrap_samples=4, bootstrap_seed=42)
    ec = build_ec_table(members, counts, T)
    b1 = np.asarray(bs.run_bootstrap(ec, lengths, cfg))
    b2 = np.asarray(bs.run_bootstrap(ec, lengths, cfg))
    np.testing.assert_array_equal(b1, b2)


def test_squarem_same_fixed_point(rng):
    """SQUAREM reaches the plain-EM fixed point in fewer EM steps."""
    T, E = 40, 90
    lengths = rng.integers(250, 3000, size=T).astype(np.int32)
    members = [
        np.sort(rng.choice(T, size=int(rng.integers(1, 6)),
                           replace=False)).astype(np.int32)
        for _ in range(E)
    ]
    counts = rng.integers(1, 400, size=E).astype(np.float64)
    ec = build_ec_table(members, counts, T)
    # rel_tol above the f32 noise floor so BOTH runs actually converge
    # rather than hitting max_iters
    plain = EMConfig(rel_tol=1e-5, max_iters=20000)
    fast = EMConfig(rel_tol=1e-5, max_iters=20000,
                    accel="squarem")
    a0, it0 = run_em(ec, lengths, plain)
    a1, it1 = run_em(ec, lengths, fast)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), rtol=2e-3,
                               atol=5e-3)
    assert int(it0) < plain.max_iters, "plain EM failed to converge"
    assert int(it1) < int(it0), (int(it1), int(it0))


def test_squarem_matches_oracle(rng):
    T, E = 25, 60
    lengths = rng.integers(200, 2000, size=T).astype(np.int32)
    members = [
        np.sort(rng.choice(T, size=int(rng.integers(1, 4)),
                           replace=False)).astype(np.int32)
        for _ in range(E)
    ]
    counts = rng.integers(1, 200, size=E).astype(np.float64)
    cfg = EMConfig(rel_tol=1e-6, max_iters=5000,
                   accel="squarem")
    o_alpha, o_it = oracle.run_em(members, counts, lengths, cfg)
    ec = build_ec_table(members, counts, T)
    alpha, it = run_em(ec, lengths, cfg)
    np.testing.assert_allclose(np.asarray(alpha), o_alpha, rtol=5e-3,
                               atol=1e-2)


def test_squarem_bootstrap_mass(rng):
    T, E, B = 15, 30, 8
    lengths = rng.integers(300, 1500, size=T).astype(np.int32)
    members = [
        np.sort(rng.choice(T, size=int(rng.integers(1, 4)),
                           replace=False)).astype(np.int32)
        for _ in range(E)
    ]
    counts = rng.integers(1, 100, size=E).astype(np.float64)
    ec = build_ec_table(members, counts, T)
    cfg = EMConfig(bootstrap_samples=B, accel="squarem",
                   max_iters=200)
    boot = np.asarray(bs.run_bootstrap(ec, lengths, cfg))
    assert boot.shape == (B, T)
    np.testing.assert_allclose(boot.sum(axis=1), counts.sum(), rtol=1e-3)


def test_chunked_fixed_point_matches_device_loop(rng):
    """The host-driven chunked driver (the snapshot path of checkpointed
    runs) produces the same result and iteration count as the in-device
    while_loop."""
    from seekmer_tpu.em.em import _run_em_chunked

    T, E = 30, 60
    lengths = rng.integers(250, 2500, size=T).astype(np.int32)
    members = [
        np.sort(rng.choice(T, size=int(rng.integers(1, 5)),
                           replace=False)).astype(np.int32)
        for _ in range(E)
    ]
    counts = rng.integers(1, 300, size=E).astype(np.float64)
    ec = build_ec_table(members, counts, T)
    for accel in ("none", "squarem"):
        cfg = EMConfig(rel_tol=1e-6, max_iters=3000,
                       accel=accel)
        a_dev, it_dev = run_em(ec, lengths, cfg)
        a_chk, it_chk = _run_em_chunked(ec, lengths, cfg)
        np.testing.assert_allclose(np.asarray(a_chk), np.asarray(a_dev),
                                   rtol=1e-6, atol=1e-6)
        if accel == "none":
            assert int(it_chk) == int(it_dev), (int(it_chk), int(it_dev))
        else:
            # squarem at the f32 tolerance floor: differently-fused
            # programs can flip the convergence block by a few rounds
            blocks = 3 * max(cfg.check_every // 3, 1)
            assert abs(int(it_chk) - int(it_dev)) <= 4 * blocks


def test_chunked_batched_matches_device_loop(rng):
    from seekmer_tpu.em.bootstrap import _batched_em_chunked, _batched_em_jit
    import jax.numpy as jnp

    T, E, B = 20, 40, 6
    lengths = rng.integers(300, 2000, size=T).astype(np.int32)
    members = [
        np.sort(rng.choice(T, size=int(rng.integers(1, 4)),
                           replace=False)).astype(np.int32)
        for _ in range(E)
    ]
    counts = rng.integers(1, 100, size=E).astype(np.float64)
    ec = build_ec_table(members, counts, T)
    cmat = jnp.asarray(
        rng.integers(1, 100, size=(B, ec.num_ecs)).astype(np.float32))
    cfg = EMConfig(rel_tol=1e-5, max_iters=1000)
    a_dev, it_dev = _batched_em_jit(cmat, ec.ec_ids, ec.txp_ids,
                                    jnp.asarray(lengths), ec.num_ecs, T, cfg)
    a_chk, it_chk = _batched_em_chunked(cmat, ec.ec_ids, ec.txp_ids,
                                        lengths, ec.num_ecs, T, cfg)
    np.testing.assert_allclose(np.asarray(a_chk), np.asarray(a_dev),
                               rtol=1e-5, atol=1e-4)
    assert int(it_chk) == int(it_dev)


def test_log_likelihood_matches_oracle_and_improves():
    """Device log-likelihood (SURVEY.md 5.5 'final likelihood') matches
    the float64 oracle and the EM solution beats the uniform start."""
    import jax.numpy as jnp

    from seekmer_tpu.em.em import (build_ec_table, effective_lengths,
                                   log_likelihood, run_em)
    from tests.oracle import oracle as orc

    rng = np.random.default_rng(5)
    T, E = 30, 80
    lengths = rng.integers(300, 2000, T).astype(np.int32)
    members = [np.sort(rng.choice(T, size=int(rng.integers(1, 4)),
                                  replace=False)).astype(np.int32)
               for _ in range(E)]
    counts = rng.integers(1, 100, E).astype(np.float64)
    cfg = EMConfig(rel_tol=1e-6)
    ec = build_ec_table(members, counts, T)
    eff = effective_lengths(jnp.asarray(lengths), cfg, jnp.float32)

    alpha, _ = run_em(ec, lengths, cfg)
    ll_dev = float(log_likelihood(ec, alpha, eff))
    o_eff = orc.effective_lengths(lengths, cfg)
    ll_orc = orc.log_likelihood(members, counts, np.asarray(alpha, np.float64),
                                o_eff)
    np.testing.assert_allclose(ll_dev, ll_orc, rtol=1e-4)

    N = counts.sum()
    uniform = jnp.full((T,), N / T, jnp.float32)
    ll_uniform = float(log_likelihood(ec, uniform, eff))
    assert ll_dev >= ll_uniform


def _random_system(rng, T, E, max_members=5):
    lengths = rng.integers(250, 3000, size=T).astype(np.int32)
    members = [
        np.sort(rng.choice(T, size=int(rng.integers(1, max_members + 1)),
                           replace=False)).astype(np.int32)
        for _ in range(E)
    ]
    counts = rng.integers(1, 500, size=E).astype(np.float64)
    return lengths, members, counts


def _group_sums(members, T, alpha):
    """Mass per set of transcripts with IDENTICAL EC membership: such
    transcripts are EM-degenerate (any split among them is a fixed
    point), so only their summed mass is pinned."""
    sig_of_t = [tuple() for _ in range(T)]
    for e, mem in enumerate(members):
        for t in mem:
            sig_of_t[t] = sig_of_t[t] + (e,)
    groups = {}
    for t, sig in enumerate(sig_of_t):
        groups.setdefault(sig, []).append(t)
    return np.stack([alpha[..., ts].sum(axis=-1) for ts in groups.values()],
                    axis=-1)


def test_run_em_warm_start(rng):
    """A run started from a converged alpha stops at the first block
    boundary at/after min_iters."""
    T = 40
    lengths, members, counts = _random_system(rng, T, 90)
    cfg = EMConfig(rel_tol=1e-5, max_iters=5000)
    ec = build_ec_table(members, counts, T)
    alpha, _ = run_em(ec, lengths, cfg)
    _, it2 = run_em(ec, lengths, cfg, alpha_init=np.asarray(alpha))
    assert int(it2) <= cfg.min_iters + cfg.check_every


@pytest.mark.parametrize("accel", ["none", "squarem"])
def test_bootstrap_matches_oracle_per_replicate(accel):
    """Batched bootstrap EM, per replicate, against the float64 oracle EM
    run on that replicate's resampled counts."""
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    T, B = 20, 4
    lengths, members, counts = _random_system(rng, T, 45, max_members=3)
    cfg = EMConfig(rel_tol=1e-5, max_iters=1000, bootstrap_samples=B,
                   bootstrap_seed=3, accel=accel)
    ec = build_ec_table(members, counts, T)
    boot = np.asarray(bs.run_bootstrap(ec, lengths, cfg))
    assert boot.shape == (B, T)
    cmat = np.asarray(bs._resample_jit(jax.random.PRNGKey(3),
                                       ec.counts.astype(jnp.float32), B))
    o = np.stack([oracle.run_em(members, cmat[b].astype(np.float64),
                                lengths, cfg)[0] for b in range(B)])
    np.testing.assert_allclose(_group_sums(members, T, boot),
                               _group_sums(members, T, o),
                               rtol=5e-3, atol=5e-2)


def test_batched_matches_single_runs(rng):
    """The replicate-major batched EM is B independent EMs: with a fixed
    iteration budget each replicate equals run_em on its own counts."""
    import jax.numpy as jnp

    from seekmer_tpu.em.bootstrap import _batched_em_jit

    T, B = 30, 5
    lengths, members, counts = _random_system(rng, T, 70)
    ec = build_ec_table(members, counts, T)
    cmat = rng.integers(1, 100, size=(B, ec.num_ecs)).astype(np.float32)
    cfg = EMConfig(rel_tol=0.0, min_iters=96, max_iters=96)
    boot, it = _batched_em_jit(jnp.asarray(cmat), ec.ec_ids, ec.txp_ids,
                               jnp.asarray(lengths), ec.num_ecs, T, cfg)
    assert int(it) == 96
    for b in range(B):
        alpha, it_b = run_em(build_ec_table(members, cmat[b], T), lengths,
                             cfg)
        assert int(it_b) == 96
        np.testing.assert_allclose(np.asarray(boot)[b], np.asarray(alpha),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("chunked,snapshots,resume,expect", [
    (None, False, False, False),  # plain run: one while_loop execution
    (None, True, False, True),    # snapshot hook: chunked syncs
    (None, False, True, True),    # resume of a chunked-only form
    (False, True, True, False),   # forced single execution
    (True, False, False, True),   # forced chunked
])
def test_chunking_policy(chunked, snapshots, resume, expect):
    from seekmer_tpu.em.em import use_chunked

    assert use_chunked(chunked, snapshots, resume) is expect
