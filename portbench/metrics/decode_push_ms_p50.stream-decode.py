"""Median host time of the traced streamed-decode calls: the program's
`decode_push` root spans (StreamingDecoder.push and flush: the byte scan,
the host parse and repack, the synthesis replays, the PCM's download),
ms.  A program without the span reads nothing."""

from harness import program


def read(run):
    return program.median_of([r.ms for r, _ in program.calls(
        program.traced_spans(run), "decode_push")])
