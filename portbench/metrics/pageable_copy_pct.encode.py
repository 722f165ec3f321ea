"""Share of the bytes the traced encode calls copied between the host and
the device from or into pageable host memory: the `upload` and
`download` spans under the program's `encode` spans, by their bytes and
pinned counts, in %."""

from harness import program


def read(run):
    total = pageable = 0
    for _, under in program.calls(program.traced_spans(run), "encode"):
        for s in under:
            if s.name in ("upload", "download"):
                n = s.counts.get("bytes", 0)
                total += n
                pageable += 0 if s.counts.get("pinned") else n
    return 100.0 * pageable / total if total else None
