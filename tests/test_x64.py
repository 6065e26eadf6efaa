"""float64 EM path (--x64): near-bit parity with the float64 oracle
[BASELINE.json:5 'bit-tolerance-identical abundance estimates']."""

import numpy as np
import pytest

from seekmer_tpu.config import EMConfig
from tests.oracle import oracle


def test_x64_em_bit_parity(rng):
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        from seekmer_tpu.em.em import build_ec_table, run_em
        import jax.numpy as jnp

        T, E = 40, 90
        lengths = rng.integers(250, 3000, size=T).astype(np.int32)
        members = [
            np.sort(rng.choice(T, size=int(rng.integers(1, 5)),
                               replace=False)).astype(np.int32)
            for _ in range(E)
        ]
        counts = rng.integers(1, 300, size=E).astype(np.float64)
        cfg = EMConfig(rel_tol=1e-8, max_iters=5000, use_x64=True)
        ec = build_ec_table(members, counts, T, dtype=jnp.float64)
        alpha, it = run_em(ec, lengths, cfg)
        o_alpha, o_it = oracle.run_em(members, counts, lengths, cfg)
        # float64 on both sides: agreement to ~1e-9 relative (summation
        # order differs, so not literally bit-identical)
        np.testing.assert_allclose(np.asarray(alpha), o_alpha,
                                   rtol=1e-9, atol=1e-9)
    finally:
        jax.config.update("jax_enable_x64", False)
