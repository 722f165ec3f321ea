#!/usr/bin/env python3
"""The cost of one program span (pactpu_torch.utils.metrics.span) on the
host, in ns: with recording off (the path every Engine call takes unless
a profiler records or metrics.tracing() is on), on under tracing(), and
on under a CPU torch.profiler; against a loop of empty `with` blocks of
a shared null context.

    python3 tools/span_cost.py [--n 1000000]

Prints one JSON line: ns a span in each state, the best of five rounds
(the loop's own cost subtracted).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def per_call_ns(body, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        body(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile

    from pactpu_torch.utils import metrics as M
    null = contextlib.nullcontext()
    span = M.span

    def empty(n):
        for _ in range(n):
            with null:
                pass

    def plain(n):
        for _ in range(n):
            with span("final"):
                pass

    def counted(n):
        for b in range(n):
            with span("replay:final", blocks=b):
                pass

    base = per_call_ns(empty, args.n)
    out = {"empty_with_ns": base,
           "off_ns": per_call_ns(plain, args.n) - base,
           "off_with_count_ns": per_call_ns(counted, args.n) - base}
    on = max(args.n // 100, 1000)
    with M.tracing():
        out["tracing_ns"] = per_call_ns(counted, on) - base
        M.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out["profiler_ns"] = per_call_ns(counted, on) - base
        M.reset()
    print(json.dumps({k: round(v, 1) for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
