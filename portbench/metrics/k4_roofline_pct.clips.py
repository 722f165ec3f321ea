"""K4 (spread_up_kernel) against its roofline in the clips cell: the least
time the card could take for the (row, peak masker, upslope line) triples
of the traced calls' clips (counts/k4.py, as k4_roofline_pct.encode counts
whole tracks), over the kernel's device time inside the trace, in %.  The
blocks encode_many pads each clip's chunk to do no work the count credits."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "counts"))
import k4  # noqa: E402


def read(run):
    if run.trace is None or run.trace.t1 is None:
        return None
    t = run.trace.summarise()["kernels"].get("spread_up_kernel", 0.0)
    traced = [r for r in run.items if r.get("traced") and "calls" in r]
    if t <= 0 or not traced:
        return None
    pool = run.state["pool"]
    pcms = [pool[p][s:s + n] for r in traced for p, s, n in r["calls"]]
    return 100.0 * k4.bound_s(pcms) / t
