"""Median over the traced pushes of the host's blocking reads: the
payload's `download` and the reservoir's `carry` read under each of the
program's `push` spans, ms."""

from harness import program


def read(run):
    return program.median_of([
        program.ms_of(under, ("download", "carry"))
        for _, under in program.calls(program.traced_spans(run), "push")])
