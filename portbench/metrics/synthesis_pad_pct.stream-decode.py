"""Share of the rows the traced streamed decodes synthesized that hold no
block of the push (a push synthesizes its blocks at their rows of a batch
of the Engine's size, as a live push analyses them): over the program's
`decode_push` roots, the blocks of their synthesis stage
(`replay:synthesize`, or `capture:` or `direct:`) less the roots' own
blocks, over the former, in %.  A program without the root span reads
nothing."""

from harness import program

STAGES = ("replay:synthesize", "capture:synthesize", "direct:synthesize")


def read(run):
    rows = real = 0
    for root, under in program.calls(program.traced_spans(run),
                                     "decode_push"):
        n = sum(s.counts.get("blocks", 0) for s in under if s.name in STAGES)
        if n:
            rows += n
            real += root.counts.get("blocks", 0)
    return 100.0 * (rows - real) / rows if rows else None
