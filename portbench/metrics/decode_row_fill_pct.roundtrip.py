"""Share of the decode's repacked mantissa words that hold mantissa bits:
over the `repack` spans of the traced decode calls, their `bits` over
their rows times their row width (`words`) times 32, in %.  A program
whose repack span does not count them reads nothing."""

from harness import program


def read(run):
    bits = cap = 0
    for _, under in program.calls(program.traced_spans(run), "decode"):
        for s in under:
            if s.name == "repack":
                if "bits" not in s.counts or "words" not in s.counts:
                    return None
                bits += s.counts["bits"]
                cap += s.counts["rows"] * s.counts["words"] * 32
    return 100.0 * bits / cap if cap else None
