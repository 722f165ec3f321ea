"""The program's own spans in a traced run: what pactpu_torch's recorder
(pactpu_torch.utils.metrics.span) kept inside the run's trace window, and
the profiler ranges it opened, named PREFIX + span, on the profiler's
clock beside the kernels and copies.  The trace-reading helpers
(device_by_correlation and its kin) are the program's, in the same
module.

A program without the recorder records nothing: every function here then
returns an empty result, and the readers that use them return None.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional

# the benchmark's own ranges (harness/trace.py), which the profiler also
# draws on the device's timeline over their kernels
BENCH_PREFIX = "pb:"


def recorder():
    """The program's metrics module where it records spans, else None."""
    try:
        from pactpu_torch.utils import metrics
    except ImportError:
        return None
    return metrics if hasattr(metrics, "spans") else None


def traced_spans(run) -> list:
    """The spans the program recorded inside a traced run's window (the
    recorder is on while the run's profiler records; spans of an earlier
    run in the same process lie before it), with their parents, by start;
    [] otherwise."""
    m = recorder()
    tr = run.trace
    if m is None or tr is None or tr.t1 is None:
        return []
    t0, t1 = tr.t0 * 1e9, tr.t1 * 1e9            # perf_counter, in ns
    out, kept = [], set()
    for s in m.spans():
        if (t0 <= s.start_ns and s.end_ns <= t1
                and (s.parent is None or s.parent in kept)):
            out.append(s)
            kept.add(s.id)
    return out


def roots(spans: list) -> Dict[int, object]:
    """Each span's root: {span id: the root Span it lies under (itself for
    a root)}.  Spans come by start, so a parent comes before its
    children."""
    out = {}
    for s in spans:
        out[s.id] = out.get(s.parent, s) if s.parent is not None else s
    return out


def calls(spans: list, name: str) -> List[tuple]:
    """The root spans named `name` (the program's encode, decode or push
    calls), each with the spans under it: [(root, [descendants])]."""
    top = roots(spans)
    under = defaultdict(list)
    for s in spans:
        r = top[s.id]
        if r is not s:
            under[r.id].append(s)
    return [(s, under[s.id]) for s in spans
            if s.parent is None and s.name == name]


def ms_of(spans: list, names) -> float:
    """The summed milliseconds of the spans named in `names` (none of
    which lies inside another)."""
    return sum(s.ms for s in spans if s.name in names)


def per_kblock(spans: list, name: str, minus=(), only=None) -> Optional[float]:
    """Milliseconds per 1,000 blocks over the traced calls named `name`:
    their own time less that of the spans under them named in `minus`, or
    with `only` the time of the spans under them named there; the blocks
    are what the calls count."""
    cs = calls(spans, name)
    blocks = sum(r.counts.get("blocks", 0) for r, _ in cs)
    if not cs or not blocks:
        return None
    if only is not None:
        ms = sum(ms_of(under, only) for _, under in cs)
    else:
        ms = sum(r.ms - ms_of(under, minus) for r, under in cs)
    return ms / (blocks / 1e3)


def median_of(values: list) -> Optional[float]:
    return statistics.median(values) if values else None


def prefix() -> Optional[str]:
    m = recorder()
    return getattr(m, "PREFIX", None) if m is not None else None


def program_ranges(events, name: str) -> list:
    """The profiler ranges of the program's span `name`: [(start us, end
    us, thread)]."""
    p = prefix()
    if p is None:
        return []
    want = p + name
    return [(ev.time_range.start, ev.time_range.end, ev.thread)
            for ev in events
            if ev.device_type.name == "CPU" and ev.name == want]


def launched_in(events, ranges: list) -> float:
    """Device seconds of the operations whose runtime call the host made
    inside one of `ranges` (on the range's thread), matched by the
    profiler's correlation id: a graph launch's kernels by its
    cudaGraphLaunch."""
    if not ranges:
        return 0.0
    device = recorder().device_by_correlation(events, (BENCH_PREFIX,))
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    us = 0.0
    for ev in events:
        if ev.device_type.name != "CPU" or not ev.name.startswith("cu"):
            continue
        t = ev.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            continue
        s, e, thread = ranges[i]
        if t <= e and ev.thread == thread:
            us += sum(k.time_range.elapsed_us() for k in device.get(ev.id,
                                                                    ()))
    return us / 1e6
