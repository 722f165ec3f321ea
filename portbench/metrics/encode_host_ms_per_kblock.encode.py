"""Host time of the program's traced encode calls outside their
`download` spans (the PCM's framing and upload, the dispatch of the
replays, the payload's framing) per 1,000 blocks encoded."""

from harness import program


def read(run):
    return program.per_kblock(program.traced_spans(run), "encode",
                              minus=("download",))
