"""Host time of the traced decode calls' blocking PCM download (the
program's `download` spans under its `decode` spans: the wait for the
device and the copy) per 1,000 blocks decoded."""

from harness import program


def read(run):
    return program.per_kblock(program.traced_spans(run), "decode",
                              only=("download",))
