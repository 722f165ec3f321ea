"""One traced run of a cell, as `run.py --trace 1` makes it, and the
device's idle time in its trace put down to the span the host was in:
the benchmark's spans (harness/trace.py) and the program's own
(pactpu_torch.utils.metrics.span, innermost first).  From the root of a
checkout, on the card:

    python3 portbench/tools/idle_by_span.py --workload wak-default.tracks \
        --seed 5 --seconds 20

Prints two JSON lines: the run's result (as run.py's last line, with its
metrics), then "idle": the traced window's idle seconds, by benchmark
span and by program span; `inside_calls_s`, the idle time inside the
benchmark's encode, decode and push spans, and `named_share`, the share
of it that lies inside a program span below the program's own call (not
in the call's root span alone); and the program's span seconds by name
and its push spans' median.
"""

import argparse
import json
import os
import statistics
import sys
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

CALLS = ("encode", "decode", "push")


def idle(events) -> dict:
    from harness.program import BENCH_PREFIX
    from pactpu_torch.utils import metrics as M
    gaps = M.idle_gaps(events, (BENCH_PREFIX,))
    bench = M.host_ranges(events, BENCH_PREFIX)
    out = {"idle_s": sum(g1 - g0 for g0, g1 in gaps) / 1e6,
           "by_bench_span": M.idle_by_range(gaps, M.innermost(bench))}
    if not bench:
        return out
    pieces = M.innermost(M.host_ranges(events))
    by_prog = M.idle_by_range(gaps, pieces)
    # the idle time in a call's root span alone, by the spans on either
    # side of the host's stretch there
    beside = []
    for k, (t0, t1, name) in enumerate(pieces):
        if name in CALLS:
            before = (pieces[k - 1][2] if k and pieces[k - 1][1] == t0
                      else "-")
            after = (pieces[k + 1][2] if k + 1 < len(pieces)
                     and pieces[k + 1][0] == t1 else "-")
            beside.append((t0, t1, f"{name}:{before}|{after}"))
    root_only = M.idle_by_range(gaps, beside)
    root_only.pop("outside", None)
    # the idle time inside the benchmark's call spans
    calls = [r for r in bench if r[2] in CALLS]
    in_calls = M.idle_by_range(gaps, M.innermost(calls))
    inside = sum(in_calls.get(n, 0.0) for n in CALLS)
    named = sum(v for k, v in by_prog.items()
                if k not in CALLS and k != "outside")
    out.update(by_program_span=by_prog, root_only=root_only,
               inside_calls_s=inside,
               named_s=named,
               named_share=named / inside if inside > 0 else None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    import run as R
    R.environment()
    from harness import core, program
    from harness.manifest import Manifest
    from pactpu_torch.utils.metrics import host_ranges
    m = Manifest(os.path.dirname(HERE), HERE)
    held = {}
    res = core.run_cell(m, args.workload, args.seed, args.seconds, True,
                        hook=lambda run: held.update(run=run))
    run = held["run"]
    res.pop("_info", None)
    print(json.dumps(res), flush=True)
    events = run.trace.prof.events()
    out = idle(events)
    spans = program.traced_spans(run)
    by_name = defaultdict(float)
    for s in spans:
        by_name[s.name] += s.ms / 1e3
    pushes = [r.ms for r, _ in program.calls(spans, "push")]
    # the benchmark's own spans over the same traced calls
    bench = defaultdict(list)
    for t0, t1, name in host_ranges(events, program.BENCH_PREFIX):
        bench[name].append((t1 - t0) / 1e3)
    blocks = {n: sum(r.counts.get("blocks", 0)
                     for r, _ in program.calls(spans, n))
              for n in ("encode", "decode")}
    out["traced"] = {
        "bench_push_ms_p50": (statistics.median(bench["push"])
                              if bench["push"] else None),
        **{f"{n}_ms_per_kblock": {
            "bench": sum(bench[n]) / (blocks[n] / 1e3),
            "program": sum(r.ms for r, _ in program.calls(spans, n))
            / (blocks[n] / 1e3)} for n in blocks if blocks[n]}}
    out.update(span_s=dict(by_name), spans=len(spans),
               push_ms_p50=statistics.median(pushes) if pushes else None,
               window_s=run.trace.t1 - run.trace.t0)
    print("idle " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
