"""Fast-mode abundance error at GENCODE scale, through the FULL pipeline
(round-5 verdict item 4): map a GENCODE-class paired library in dense
mode and in fast mode (probe_sample in {8, 16, 32}), run the identical
EM on each, and report TPM max-abs / count-weighted relative error plus
mapped and est_counts deltas.

The fast mode's approximation is signature-level (a resolved read's
signature can be a SUBSET of its dense one); this measures what that
does to the ABUNDANCE a user actually consumes, at the scale where the
approximation bites hardest (short EC runs on isoform-dense
transcriptomes).

EM notes: both arms run the same fixed convergence budget from the same
uniform init; transcripts sharing identical EC membership are
EM-degenerate (any within-group split is a fixed point), but a
deterministic schedule from uniform init splits them identically in
both arms, so the per-transcript comparison is meaningful — errors
reported are differences the fast mode introduces, not degeneracy noise.

Run on the GPU: python benchmarks/micro_fast_acc.py [--samples 8 16 32]
     [--batches 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

log = lambda *a: print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--transcripts", type=int, default=60000)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--samples", type=int, nargs="*", default=[8, 16, 32])
    ap.add_argument("--em-iters", type=int, default=2000)
    args = ap.parse_args()

    import jax

    from benchmarks.configs import _world
    from seekmer_tpu.config import EMConfig, MapConfig
    from seekmer_tpu.em.em import (build_ec_table, run_em, tpm_from_alpha)
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import Mapper, resolve_signatures
    from seekmer_tpu.utils.simulate import simulate_packed_pairs

    log(f"[fast-acc] devices: {jax.devices()}")
    rng, index, seqs, _ = _world(args.transcripts, isoform=True)
    B, L = args.batch, args.read_len
    c1, c2, true_counts = simulate_packed_pairs(
        rng, seqs, args.batches, B, read_len=L)
    lengths = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    batches = [ReadBatch(c1[i], lengths, w, codes2=c2[i], lengths2=lengths)
               for i in range(args.batches)]
    n_pairs = args.batches * B
    T = index.num_transcripts
    em_cfg = EMConfig(max_iters=args.em_iters, accel="squarem")

    from benchmarks.configs import _CACHE_DIR as cache_dir

    def membership_groups(members):
        """Group id per transcript by identical EC membership (transcripts
        in one group are EM-degenerate: any within-group mass split is a
        fixed point, so per-transcript comparisons inside a group measure
        degeneracy noise, not abundance error). Position-mixed 64-bit
        fingerprint of each transcript's sorted EC list (collision odds
        ~G^2/2^64 — a diagnostic, like the index builder's grouping)."""
        ec_ids = np.concatenate([np.full(len(m), i, np.int64)
                                 for i, m in enumerate(members)])
        txp = np.concatenate(members).astype(np.int64)
        order = np.lexsort((ec_ids, txp))
        txp_s = txp[order]
        ec_s = ec_ids[order].astype(np.uint64)
        # rank of each entry within its transcript's sorted EC list
        counts = np.bincount(txp_s, minlength=T)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = (np.arange(txp_s.size, dtype=np.int64)
                - first[txp_s]).astype(np.uint64)
        mixed = ((ec_s + np.uint64(1))
                 * (rank * np.uint64(0x9E3779B97F4A7C15) + np.uint64(1)))
        h = np.zeros(T, np.uint64)
        np.add.at(h, txp_s, mixed)
        hx = np.zeros(T, np.uint64)
        np.bitwise_xor.at(hx, txp_s, mixed * np.uint64(2654435761))
        key = (h << np.uint64(1)) ^ hx
        # transcripts in no EC at all share key 0 — one group, fine
        _, gid = np.unique(key, return_inverse=True)
        return gid

    def arm(sample):
        tag = os.path.join(cache_dir,
                           f"fastacc_{T}_{n_pairs}_{sample}.npz")
        if os.path.exists(tag):
            z = np.load(tag, allow_pickle=True)
            log(f"[fast-acc] sample={sample}: cached arm ({tag})")
            return {k: z[k] for k in z.files}
        cfg = MapConfig(batch_size=B, paired_end=True, probe_sample=sample,
                        sig_table_bits=22)
        m = Mapper(index, cfg)
        t0 = time.perf_counter()
        for b in batches:
            m.feed(b)
        res = m.finalize()
        t_map = time.perf_counter() - t0
        members, counts, dropped = resolve_signatures(res, index)
        ec = build_ec_table(members, counts, T)
        alpha, iters = run_em(ec, index.lengths, em_cfg)
        tpm = np.asarray(tpm_from_alpha(alpha, index.lengths, em_cfg))
        log(f"[fast-acc] sample={sample}: mapped {res.mapped}/{n_pairs} "
            f"({res.mapped / n_pairs:.4%}), {len(members)} ECs, "
            f"EM iters {int(iters)}, map wall {t_map:.1f}s")
        out = {"mapped": np.int64(res.mapped), "est": np.asarray(alpha),
               "tpm": tpm, "sample": np.int64(sample),
               "groups": membership_groups(members)}
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(tag, **out)
        return out

    def agg(x, gid, n):
        out = np.zeros(n, x.dtype)
        np.add.at(out, gid, x)
        return out

    dense = arm(0)
    rows = []
    for s in args.samples:
        f = arm(s)
        d_mapped = f["mapped"] - dense["mapped"]
        d_est = np.abs(f["est"] - dense["est"])
        d_tpm = np.abs(f["tpm"] - dense["tpm"])
        # count-weighted relative TPM error over expressed transcripts
        expr = dense["tpm"] > 1.0
        rel = (np.abs(f["tpm"][expr] - dense["tpm"][expr])
               / dense["tpm"][expr])
        # aggregate over the DENSE table's EM-degeneracy groups: fast mode
        # perturbs EC memberships, so within-group splits diverge
        # arbitrarily — raw per-transcript p99 above measures that
        # degeneracy noise, the group-level numbers the real error
        gid = dense["groups"]
        G = int(gid.max()) + 1
        g_dense = agg(dense["tpm"], gid, G)
        g_fast = agg(f["tpm"], gid, G)
        g_expr = g_dense > 1.0
        g_rel = np.abs(g_fast[g_expr] - g_dense[g_expr]) / g_dense[g_expr]
        row = {
            "sample": s,
            "mapped_delta": int(d_mapped),
            "mapped_delta_frac": round(d_mapped / max(dense["mapped"], 1), 6),
            "est_counts_max_abs": round(float(d_est.max()), 3),
            "est_counts_total_l1_frac": round(
                float(d_est.sum() / max(dense['est'].sum(), 1)), 6),
            "tpm_max_abs": round(float(d_tpm.max()), 3),
            "tpm_rel_err_median_expressed": round(float(np.median(rel)), 6),
            "tpm_rel_err_p99_expressed": round(
                float(np.percentile(rel, 99)), 6),
            "expressed_transcripts": int(expr.sum()),
            "degeneracy_groups": G,
            "group_tpm_rel_err_median": round(float(np.median(g_rel)), 6),
            "group_tpm_rel_err_p99": round(
                float(np.percentile(g_rel, 99)), 6),
            "group_tpm_max_abs": round(
                float(np.abs(g_fast - g_dense).max()), 3),
        }
        rows.append(row)
        log(f"[fast-acc] sample={s} vs dense: {row}")
    print(json.dumps({"metric": "fast_mode_gencode_abundance_error",
                      "pairs": n_pairs, "transcripts": T, "rows": rows}))


if __name__ == "__main__":
    main()
