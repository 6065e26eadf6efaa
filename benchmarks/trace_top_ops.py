#!/usr/bin/env python
"""Top device operations of a jax.profiler trace (e.g. one written by
``seekmer_tpu infer --trace-dir DIR``).

For every device plane of the newest ``*.xplane.pb`` under DIR, sums the
event durations per name on each line and prints the top entries, plus
the device's busy share: the union of its op intervals over the window
from the first op's start to the last op's end.

  python benchmarks/trace_top_ops.py DIR [--top 15] [--json OUT]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def newest_xplane(path: str) -> str:
    if path.endswith(".xplane.pb"):
        return path
    found = glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                      recursive=True)
    if not found:
        raise FileNotFoundError(f"no .xplane.pb under {path}")
    return max(found, key=os.path.getmtime)


def busy_share(intervals) -> float:
    """Union length of [start, end) intervals over their window."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    busy, cur_s, cur_e = 0, intervals[0][0], intervals[0][1]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in intervals) - intervals[0][0]
    return busy / window if window > 0 else 0.0


def summarize(path: str, top: int = 15) -> dict:
    """{plane: {"lines": {line: [(name, total_ns, count), ...]},
    "busy_share": float, "window_ms": float}} for device planes."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(newest_xplane(path))
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines, spans = {}, []
        for line in plane.lines:
            acc = {}
            for ev in line.events:
                t, n = acc.get(ev.name, (0.0, 0))
                acc[ev.name] = (t + ev.duration_ns, n + 1)
                if line.name.startswith("Stream"):
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
            ranked = sorted(acc.items(), key=lambda kv: -kv[1][0])[:top]
            lines[line.name] = [(k, v[0], v[1]) for k, v in ranked]
        window = (max(e for _, e in spans) - min(s for s, _ in spans)
                  if spans else 0.0)
        out[plane.name] = {"lines": lines, "busy_share": busy_share(spans),
                           "window_ms": window / 1e6}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    s = summarize(args.trace, args.top)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(s, fh, indent=1)
    for plane, d in s.items():
        print(f"{plane}: window {d['window_ms']:.1f} ms, busy share "
              f"{d['busy_share']:.3f}")
        for line, ops in d["lines"].items():
            tot = sum(t for _, t, _ in ops) or 1.0
            print(f"  [{line}]")
            for name, t, n in ops:
                print(f"    {t / 1e6:10.3f} ms {100 * t / tot:5.1f}% "
                      f"x{n:<6d} {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
