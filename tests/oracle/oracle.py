"""Pure-numpy float64 oracle for pseudoalignment + EM.

This is the provisional golden reference mandated by SURVEY.md section 4
item 1: the reference Seekmer source/outputs are unavailable (mount empty,
SURVEY.md section 0), so the pipeline's semantics are pinned HERE in the
simplest possible form (dicts, sets, float64) and the device path must
match it. If reference goldens become available, they replace this oracle's
outputs in tests/golden/ (a one-file swap by design).

Shared semantics (identical to the device path; see seekmer_tpu/config.py):
  * a read's k-mer hits are looked up at EVERY valid position (no skipping
    heuristic — SURVEY.md 7.4);
  * read signature = sorted distinct index-EC ids of its hits; zero hits or
    more than ``max_ecs_per_read`` distinct ids => unmapped;
  * paired-end: signature = union over both mates; an empty mate is a
    wildcard; both empty => unmapped [BASELINE.json:8];
  * a signature's transcript set = intersection of its ECs' member sets;
    empty intersection => read dropped at resolve time;
  * EM in counts space with eff_len = max(len - mean_frag + 1, 1).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from seekmer_tpu import encoding as enc
from seekmer_tpu.config import EMConfig, MapConfig
from seekmer_tpu.index.store import KMerIndex


def build_kmer_dict(index: KMerIndex) -> Dict[int, int]:
    """key64 -> EC id from the index tables (both main and stash)."""
    out: Dict[int, int] = {}
    for table in (index.table, index.stash):
        occ = table[:, 0] >= 0
        keys = enc.join_key(table[occ, 0], table[occ, 1], index.k)
        for key, ec in zip(keys.tolist(), table[occ, 2].tolist()):
            out[key] = ec
    return out


def map_read(
    codes: np.ndarray, kdict: Dict[int, int], k: int
) -> set[int]:
    """Distinct EC ids hit by a read's canonical k-mers."""
    keys, valid = enc.canonical_kmers(codes, k)
    ecs: set[int] = set()
    for key in keys[valid].tolist():
        ec = kdict.get(key)
        if ec is not None:
            ecs.add(ec)
    return ecs


def map_reads(
    reads: List[str],
    index: KMerIndex,
    cfg: MapConfig,
    mates: Optional[List[str]] = None,
) -> Tuple[Counter, int]:
    """Pseudoalign reads; returns (signature counter, unmapped count).

    Signature key = sorted tuple of distinct EC ids.
    """
    kdict = build_kmer_dict(index)
    sig_counts: Counter = Counter()
    unmapped = 0
    for i, read in enumerate(reads):
        ecs = map_read(enc.seq_to_codes(read), kdict, index.k)
        if mates is not None:
            ecs |= map_read(enc.seq_to_codes(mates[i]), kdict, index.k)
        if not ecs or len(ecs) > cfg.max_ecs_per_read:
            unmapped += 1
            continue
        sig_counts[tuple(sorted(ecs))] += 1
    return sig_counts, unmapped


def resolve_signatures(
    sig_counts: Counter, index: KMerIndex
) -> Tuple[List[np.ndarray], np.ndarray, int]:
    """Signatures -> final ECs (distinct transcript sets) with counts.

    Returns (member_lists, counts, dropped) where dropped counts reads whose
    EC intersection is empty.
    """
    agg: Dict[tuple, int] = {}
    dropped = 0
    for sig, n in sig_counts.items():
        members = index.ec_members(sig[0])
        for ec in sig[1:]:
            members = np.intersect1d(members, index.ec_members(ec))
        if members.size == 0:
            dropped += n
            continue
        key = tuple(members.tolist())
        agg[key] = agg.get(key, 0) + n
    member_lists = [np.array(k, dtype=np.int32) for k in agg]
    counts = np.array(list(agg.values()), dtype=np.float64)
    return member_lists, counts, dropped


def build_fld_dict(seqs: List[str], k: int) -> Dict[int, Tuple[int, int]]:
    """key64 -> (tid, transcript-local window pos) for GLOBALLY UNIQUE
    canonical k-mers (one occurrence in the whole transcriptome) — the
    dict twin of the index's per-slot FLD payload (index/build.py)."""
    seen: Dict[int, Tuple[int, int]] = {}
    dup: set[int] = set()
    for t, s in enumerate(seqs):
        keys, valid = enc.canonical_kmers(enc.seq_to_codes(s), k)
        for p in np.flatnonzero(valid).tolist():
            key = int(keys[p])
            if key in dup:
                continue
            if key in seen:
                del seen[key]
                dup.add(key)
            else:
                seen[key] = (t, p)
    return seen


def estimate_fld(
    codes1: np.ndarray, codes2: np.ndarray,
    fld_dict: Dict[int, Tuple[int, int]], k: int,
    offsets: Tuple[int, ...] = (0, 7, 15, 23), max_len: int = 1024,
) -> np.ndarray:
    """float64 oracle of map/fld.fld_step: per pair, the first sampled
    window offset per mate whose k-mer is globally unique; same-transcript
    pairs contribute f = |q1 - q2| + k + o1 + o2 to the histogram."""
    hist = np.zeros(max_len + 1, np.int64)

    def first_unique(codes: np.ndarray):
        keys, valid = enc.canonical_kmers(codes, k)
        for o in offsets:
            if o >= keys.size:
                break
            if not valid[o]:
                continue
            hit = fld_dict.get(int(keys[o]))
            if hit is not None:
                return hit[0], hit[1], o
        return None

    for c1, c2 in zip(codes1, codes2):
        m1, m2 = first_unique(c1), first_unique(c2)
        if m1 is None or m2 is None or m1[0] != m2[0]:
            continue
        f = abs(m1[1] - m2[1]) + k + m1[2] + m2[2]
        if max(len(c1), len(c2)) <= f <= max_len:
            hist[f] += 1
    return hist


def effective_lengths(lengths: np.ndarray, cfg: EMConfig) -> np.ndarray:
    """float64 mirror of em.effective_lengths (same two fragment-length
    models, selected by cfg.fragment_length_sd)."""
    l = lengths.astype(np.float64)
    if cfg.fragment_length_sd <= 0.0:
        return np.maximum(l - cfg.mean_fragment_length + 1.0, 1.0)
    sd = float(cfg.fragment_length_sd)
    mu = float(cfg.mean_fragment_length)
    F = int(np.ceil(mu + 5.0 * sd))
    f = np.arange(1, F + 1, dtype=np.float64)
    pdf = np.exp(-0.5 * ((f - mu) / sd) ** 2)
    c0 = np.cumsum(pdf)
    c1 = np.cumsum(pdf * f)
    idx = np.clip(lengths.astype(np.int64), 1, F) - 1
    return np.maximum((l + 1.0) - c1[idx] / c0[idx], 1.0)


def run_em(
    member_lists: List[np.ndarray],
    counts: np.ndarray,
    lengths: np.ndarray,
    cfg: EMConfig,
) -> Tuple[np.ndarray, int]:
    """Counts-space EM to convergence. Returns (alpha, iterations)."""
    T = lengths.shape[0]
    eff = effective_lengths(lengths, cfg)
    N = counts.sum()
    alpha = np.full(T, N / T if T else 0.0, dtype=np.float64)

    def em_iter(a):
        a_new = np.zeros(T, dtype=np.float64)
        for members, n in zip(member_lists, counts):
            w = a[members] / eff[members]
            s = w.sum()
            if s > 0:
                a_new[members] += n * (w / s)
        return a_new

    # blocked convergence schedule, identical to the device's
    # em.run_blocked_fixed_point: check_every-1 raw steps + one monitored
    # step per block; convergence tested between the block's last two
    # iterates; iteration counts are multiples of check_every
    step_fn, per, C, max_c, min_c = em_iter, 1, max(cfg.check_every, 1), \
        cfg.max_iters, cfg.min_iters
    if getattr(cfg, "accel", "none") == "squarem":
        # float64 mirror of em.squarem_cycle + em.accel_schedule
        def step_fn(a):
            a1 = em_iter(a)
            a2 = em_iter(a1)
            r = a1 - a
            v = (a2 - a1) - r
            rn = np.sqrt((r * r).sum())
            vn = np.sqrt((v * v).sum())
            step = -np.clip(rn / max(vn, 1e-30), 1.0, 64.0)
            ext = np.maximum(a - 2.0 * step * r + (step * step) * v, 0.0)
            if not np.isfinite(ext).all():
                ext = a2
            return em_iter(ext)

        per = 3
        C = max(cfg.check_every // 3, 1)
        max_c = -(-cfg.max_iters // 3)
        min_c = -(-cfg.min_iters // 3)
    it = 0
    while it < max_c:
        for _ in range(C - 1):
            alpha = step_fn(alpha)
        alpha_new = step_fn(alpha)
        active = alpha_new > cfg.count_floor
        rel = np.abs(alpha_new - alpha) / (alpha_new + cfg.abs_floor)
        converged = (active.any() and rel[active].max() < cfg.rel_tol
                     and it + C >= min_c)
        alpha = alpha_new
        it += C
        if converged:
            break
    return alpha, it * per


def log_likelihood(
    member_lists: List[np.ndarray], counts: np.ndarray,
    alpha: np.ndarray, eff: np.ndarray,
) -> float:
    """float64 mirror of em.log_likelihood (SURVEY.md 5.5 final
    likelihood): sum_c n_c log(sum_{t in c} theta_t / eff_t)."""
    theta = alpha / max(alpha.sum(), 1e-300)
    ll = 0.0
    for m, n in zip(member_lists, counts):
        if n <= 0:
            continue
        denom = float((theta[m] / eff[m]).sum())
        if denom > 0:
            ll += float(n) * np.log(denom)
    return ll


def tpm_from_alpha(alpha: np.ndarray, lengths: np.ndarray, cfg: EMConfig) -> np.ndarray:
    eff = effective_lengths(lengths, cfg)
    rate = np.where(alpha > 0, alpha / eff, 0.0)
    s = rate.sum()
    return np.where(s > 0, 1e6 * rate / s, 0.0)


def quantify(
    reads: List[str],
    index: KMerIndex,
    map_cfg: MapConfig = MapConfig(),
    em_cfg: EMConfig = EMConfig(),
    mates: Optional[List[str]] = None,
) -> Dict[str, np.ndarray]:
    """Full oracle pipeline: reads -> est_counts/TPM table."""
    sig_counts, unmapped = map_reads(reads, index, map_cfg, mates=mates)
    member_lists, counts, dropped = resolve_signatures(sig_counts, index)
    alpha, iters = run_em(member_lists, counts, index.lengths, em_cfg)
    return {
        "est_counts": alpha,
        "tpm": tpm_from_alpha(alpha, index.lengths, em_cfg),
        "eff_length": effective_lengths(index.lengths, em_cfg),
        "unmapped": unmapped + dropped,
        "em_iterations": iters,
        "sig_counts": sig_counts,
    }
