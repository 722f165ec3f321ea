"""Chunk stages of the traced encode and decode calls that did not replay
a program: the program's `capture:<stage>` spans (a program built inside
the window) and `direct:<stage>` spans (a stage run launch by launch)."""

from harness import program


def read(run):
    spans = program.traced_spans(run)
    calls = program.calls(spans, "encode") + program.calls(spans, "decode")
    if not calls:
        return None
    return sum(1 for _, under in calls for s in under
               if s.name.startswith(("capture:", "direct:")))
