"""ctypes loader for the compiled single-core CPU baseline mapper.

This exists so bench.py's vs_baseline (>= 10x one CPU core,
BASELINE.json:5) is measured against a COMPILED single-threaded loop of
the reference's algorithm class (its Cython mapper kernel, SURVEY.md 2.1
C4) instead of the much slower numpy/dict oracle — VERDICT round-2 weak
item 1. Built from cpu_baseline.c on first use, packer.py-style.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cpu_baseline.c")
_SO = os.path.join(_HERE, "libseekmer_cpu.so")

_lib = None
_tried = False


def _build() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", _SRC, "-o", _SO],
                check=True, capture_output=True, timeout=60,
            )
            return _SO
        except (FileNotFoundError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            log.debug("cpu baseline build with %s failed: %s", cc, e)
    return None


def get_lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        log.warning("compiled CPU baseline unavailable (no C toolchain)")
        return None
    lib = ctypes.CDLL(so)
    lib.seekmer_cpu_build.restype = ctypes.c_void_p
    lib.seekmer_cpu_build.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int,
    ]
    lib.seekmer_cpu_free.restype = None
    lib.seekmer_cpu_free.argtypes = [ctypes.c_void_p]
    lib.seekmer_cpu_map.restype = ctypes.c_long
    lib.seekmer_cpu_map.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]
    _lib = lib
    return _lib


class CpuBaselineMapper:
    """Single-threaded compiled mapper over a KMerIndex's key/EC tables.

    Same per-read semantics as tests/oracle/oracle.py map_reads (probe
    every valid window, sorted distinct EC signature, per-signature
    counts); see cpu_baseline.c.
    """

    def __init__(self, index, sig_bits: int = 20):
        from ..encoding import join_key

        lib = get_lib()
        if lib is None:
            raise RuntimeError("no C toolchain for the compiled baseline")
        self._lib = lib
        rows = np.concatenate([index.table, index.stash])
        occ = rows[:, 0] >= 0
        keys = np.ascontiguousarray(
            join_key(rows[occ, 0], rows[occ, 1], index.k))
        ecs = np.ascontiguousarray(rows[occ, 2].astype(np.int32))
        # per-key EC run lengths (aux column) power the optional skipping
        # heuristic — the reference's contig-match-length jump
        aux = np.ascontiguousarray(
            np.clip(rows[occ, 3], 0, 255).astype(np.uint8))
        self._h = lib.seekmer_cpu_build(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ecs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            aux.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            keys.size, index.k)
        if not self._h:
            raise MemoryError("cpu baseline index allocation failed")
        self.sig_size = 1 << sig_bits
        self.sig_keys = np.zeros(self.sig_size, np.uint64)
        self.sig_counts = np.zeros(self.sig_size, np.int64)
        # cumulative occupancy, carried across map() calls so the C side's
        # load-0.5 overflow bound holds for the table's whole lifetime
        self._sig_used = np.zeros(1, np.int64)

    def map(self, codes: np.ndarray, max_ecs: int = 16,
            use_skip: bool = False) -> int:
        """Map uint8[B, L] code rows; returns mapped-read count and
        accumulates per-distinct-signature counts internally.

        ``use_skip`` enables the reference's skipping heuristic
        (SURVEY.md 3.3: jump by the hit's EC run length) — same
        signature sets up to the ~1e-7/window error-collision caveat of
        the strided-exact device mode; probes saved scale with run length."""
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        B, L = codes.shape
        n = self._lib.seekmer_cpu_map(
            self._h,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            B, L, max_ecs,
            self.sig_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self.sig_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.sig_size,
            self._sig_used.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            1 if use_skip else 0)
        if n < 0:
            raise RuntimeError("baseline signature table overflow; "
                               "raise sig_bits")
        return int(n)

    @property
    def distinct_signatures(self) -> int:
        return int((self.sig_keys != 0).sum())

    @property
    def total_mapped(self) -> int:
        return int(self.sig_counts.sum())

    def close(self):
        if self._h:
            self._lib.seekmer_cpu_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
