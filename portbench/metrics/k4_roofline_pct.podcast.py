"""K4 (spread_up_kernel) against its roofline in the podcast cell: the
least time the card could take for the (row, peak masker, upslope line)
triples of the traced episodes (counts/k4_mono.py: one row a mono block,
the configuration's rate and Bark grid), over the kernel's device time
inside the trace, in %."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "counts"))
import k4_mono  # noqa: E402


def read(run):
    if run.trace is None or run.trace.t1 is None:
        return None
    t = run.trace.summarise()["kernels"].get("spread_up_kernel", 0.0)
    traced = [r for r in run.items if r.get("traced") and "off" in r]
    if t <= 0 or not traced:
        return None
    pool = run.state["pool"]
    pcms = [pool[r["pool"]][r["off"]:r["off"] + r["n"], None]
            for r in traced]
    fs = int(run.config.get("codec", {}).get("sample_rate", 44100))
    return 100.0 * k4_mono.bound_s(pcms, fs) / t
