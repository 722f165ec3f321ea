"""Device time of the analysis the traced encode calls ran, per 1,000
blocks encoded: the kernels and copies whose runtime call (a replay's
cudaGraphLaunch, a launch, a copy) the host made inside the program's
`analyze` and `replay:analyze` ranges under its `encode` ranges, matched
to the device's operations by the profiler's correlation id (the mono
psychoacoustic model's cost with the MDCT and the glue around it)."""

from harness import program


def outermost(ranges: list) -> list:
    """The ranges that lie inside no other of the same thread."""
    out = []
    for r in sorted(ranges, key=lambda r: (r[0], -r[1])):
        if not any(o[0] <= r[0] and r[1] <= o[1] and o[2] == r[2]
                   for o in out):
            out.append(r)
    return out


def read(run):
    if run.trace is None or run.trace.t1 is None:
        return None
    events = run.trace.prof.events()
    encodes = program.program_ranges(events, "encode")
    inner = [r for name in ("analyze", "replay:analyze")
             for r in program.program_ranges(events, name)
             if any(e[0] <= r[0] and r[1] <= e[1] and e[2] == r[2]
                    for e in encodes)]
    blocks = sum(r.counts.get("blocks", 0) for r, _ in program.calls(
        program.traced_spans(run), "encode"))
    if not inner or not blocks:
        return None
    s = program.launched_in(events, outermost(inner))
    return s * 1e3 / (blocks / 1e3) if s > 0 else None
