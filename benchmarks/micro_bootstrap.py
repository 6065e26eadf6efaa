"""Batched-bootstrap EM: dense form vs CSR form, same process, in turns.

The config-5 system (the configs.py config-1 world, two 65,536-read
batches mapped, 100 replicates) runs 256 fixed EM iterations (rel_tol 0,
so both forms do identical work) through two batched forms: the flat CSR
of em/bootstrap.py (gathers + segment sums) and the dense form below (two
membership-matrix products at HIGHEST precision, the package's former
bootstrap path, kept here as the A/B arm). Larger systems are the same EC
table tiled block-diagonally ``--tile`` times: the CSR grows linearly,
the dense matrix quadratically.

Each form is compiled once, then timed csr, dense, dense, csr; every
timing ends in block_until_ready. Prints one JSON line per system.

Run on the GPU: python benchmarks/micro_bootstrap.py [--tile 1 4 16]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def dense_batched_em(cmat, ec_ids, txp_ids, lengths, num_ecs: int,
                     num_transcripts: int, cfg):
    """Batched EM over a replicate-major (T, B) iterate as two products
    against the 0/1 membership matrix M [E, T]:
    x = alpha / eff; denom = M x; alpha' = x * (M^T (n / denom)).
    HIGHEST precision keeps float32 products out of TF32. Same blocked
    schedule as em/bootstrap.batched_em."""
    import jax
    import jax.numpy as jnp

    from seekmer_tpu.em.em import effective_lengths, run_blocked_fixed_point

    dtype, T = cmat.dtype, num_transcripts
    M = jnp.zeros((num_ecs, T), dtype).at[ec_ids, txp_ids].set(1.0)
    inv_eff = (1.0 / effective_lengths(lengths, cfg, dtype))[:, None]
    n = cmat.T
    hi = jax.lax.Precision.HIGHEST

    def em_iter(alpha):  # (T, B)
        x = alpha * inv_eff
        denom = jax.lax.dot_general(M, x, (((1,), (0,)), ((), ())),
                                    precision=hi)
        r = jnp.where(denom > 0, n / jnp.where(denom > 0, denom, 1.0), 0.0)
        return x * jax.lax.dot_general(M, r, (((0,), (0,)), ((), ())),
                                       precision=hi)

    alpha0 = jnp.broadcast_to(cmat.sum(axis=1)[None, :] / T,
                              (T, cmat.shape[0])).astype(dtype)
    it, _, alpha = run_blocked_fixed_point(em_iter, alpha0, cfg)
    return alpha.T, it


def config5_members(batch: int = 65536):
    """(member_lists, counts, lengths) of the config-5 EC table."""
    from benchmarks.configs import _world
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import Mapper, resolve_signatures
    from seekmer_tpu.utils.simulate import simulate_packed_batches

    rng, index, seqs, _ = _world(1000)
    codes, _ = simulate_packed_batches(rng, seqs, 2, batch, 100)
    mapper = Mapper(index, MapConfig(batch_size=batch))
    for i in range(2):
        mapper.feed(ReadBatch(codes[i], np.full(batch, 100, np.int32),
                              np.ones(batch, np.int32)))
    members, counts, _ = resolve_signatures(mapper.finalize(), index)
    return members, counts, np.asarray(index.lengths)


def tiled(members, counts, lengths, k: int):
    """The EC table repeated k times on disjoint transcript blocks."""
    T = lengths.shape[0]
    return ([m + i * T for i in range(k) for m in members],
            np.tile(counts, k), np.tile(lengths, k))


def time_forms(members, counts, lengths, replicates: int, iters: int,
               turns=("csr", "dense", "dense", "csr")):
    import jax
    import jax.numpy as jnp

    from seekmer_tpu.config import EMConfig
    from seekmer_tpu.em import bootstrap as bs
    from seekmer_tpu.em.em import build_ec_table

    T = lengths.shape[0]
    ec = build_ec_table(members, counts, T)
    cfg = EMConfig(max_iters=iters, min_iters=iters, rel_tol=0.0)
    cmat = bs._resample_jit(jax.random.PRNGKey(1),
                            ec.counts.astype(jnp.float32), replicates)
    run = {"csr": bs._batched_em_jit,
           "dense": jax.jit(dense_batched_em, static_argnums=(4, 5, 6))}
    args = (cmat, ec.ec_ids, ec.txp_ids, jnp.asarray(lengths), ec.num_ecs,
            T, cfg)
    out = {}
    for form, fn in run.items():
        t0 = time.perf_counter()
        alpha, it = fn(*args)
        jax.block_until_ready(alpha)
        out[form] = {"compile_and_first_s": time.perf_counter() - t0,
                     "iterations": int(it), "times_s": [],
                     "alpha": np.asarray(alpha)}
    for form in turns:
        t0 = time.perf_counter()
        alpha, _ = run[form](*args)
        jax.block_until_ready(alpha)
        out[form]["times_s"].append(time.perf_counter() - t0)
    diff = float(np.abs(out["dense"].pop("alpha")
                        - out["csr"].pop("alpha")).max())
    return {"E": ec.num_ecs, "T": T, "nnz": int(ec.txp_ids.shape[0]),
            "dense_matrix_bytes": 4 * ec.num_ecs * T,
            "replicates": replicates, "fixed_iterations": iters,
            "max_abs_diff_dense_vs_csr": diff, **out}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile", type=int, nargs="*", default=[1, 4, 16])
    ap.add_argument("--replicates", type=int, default=100)
    ap.add_argument("--iters", type=int, default=256)
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU found ({jax.devices()}); not timing",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    members, counts, lengths = config5_members()
    for k in args.tile:
        res = time_forms(*tiled(members, counts, lengths, k),
                         args.replicates, args.iters)
        res.update(tile=k, card=card.strip().splitlines()[0],
                   device_kind=jax.devices()[0].device_kind)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
