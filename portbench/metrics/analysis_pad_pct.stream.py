"""Share of the rows the traced pushes analysed that hold no block of the
push (a push analyses its blocks at their rows of the Engine's batches):
the `analyze` spans under the program's `push` spans, (rows - real rows)
over rows, in %."""

from harness import program


def read(run):
    rows = real = 0
    for _, under in program.calls(program.traced_spans(run), "push"):
        for s in under:
            if s.name == "analyze":
                rows += s.counts.get("rows", 0)
                real += s.counts.get("real_rows", 0)
    return 100.0 * (rows - real) / rows if rows else None
