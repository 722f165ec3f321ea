"""Host time of the program's traced decode calls outside their parse,
repack and download spans (the header, the compaction, the uploads, the
queue of replays, the assembly of the PCM) per 1,000 blocks decoded: the
program's own `decode` spans less their `parse`, `repack` and `download`
spans."""

from harness import program


def read(run):
    return program.per_kblock(program.traced_spans(run), "decode",
                              minus=("parse", "repack", "download"))
