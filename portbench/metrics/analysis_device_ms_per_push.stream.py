"""Device time of the analysis a push runs, per traced push: the kernels
and copies whose runtime call (a replay's cudaGraphLaunch, a copy) the
host made inside the program's `analyze` ranges under its `push` ranges,
matched to the device's operations by the profiler's correlation id, ms
per push."""

from harness import program


def read(run):
    if run.trace is None or run.trace.t1 is None:
        return None
    events = run.trace.prof.events()
    pushes = program.program_ranges(events, "push")
    analyses = [r for r in program.program_ranges(events, "analyze")
                if any(p[0] <= r[0] and r[1] <= p[1] and p[2] == r[2]
                       for p in pushes)]
    if not pushes or not analyses:
        return None
    s = program.launched_in(events, analyses)
    return s * 1e3 / len(pushes) if s > 0 else None
