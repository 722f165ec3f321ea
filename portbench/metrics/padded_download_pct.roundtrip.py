"""Share of the chunks of the traced encode calls that downloaded their
padded payload rows because their words passed the dense download's
budget: the `frame` spans' `padded` counts over the chunks their calls'
`rate` spans count, in %."""

from harness import program


def read(run):
    chunks = fell = 0
    for _, under in program.calls(program.traced_spans(run), "encode"):
        for s in under:
            if s.name == "rate":
                chunks += s.counts.get("chunks", 0)
            elif s.name == "frame":
                fell += s.counts.get("padded", 0)
    return 100.0 * fell / chunks if chunks else None
