"""Share of the chunks of the traced encode calls whose final pass ran a
second time, wider and launch by launch, because a payload row passed the
packer's width: the `frame` spans' `wide` counts over the chunks their
calls' `rate` spans count, in %."""

from harness import program


def read(run):
    chunks = fell = 0
    for _, under in program.calls(program.traced_spans(run), "encode"):
        for s in under:
            if s.name == "rate":
                chunks += s.counts.get("chunks", 0)
            elif s.name == "frame":
                fell += s.counts.get("wide", 0)
    return 100.0 * fell / chunks if chunks else None
