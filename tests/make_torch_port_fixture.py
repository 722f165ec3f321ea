"""Write tests/data/torch_port_fixture.npz and
tests/data/torch_port_fixture_weighted.npz: streams the JAX package encodes
on the CPU, for the PyTorch port to decode and re-encode.

    env JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py

Each file holds the seed and recipe of a 1.0 s stereo tone+noise input
(45 blocks), the input PCM, the stream `pactpu` encodes from it (reservoir
rate mode; the default config, and peak_mode="weighted" for the second
file) and `pactpu`'s decoded PCM.  tests/test_torch_fixture.py rebuilds
them and asserts that they equal the committed files; chip_smoke.py reads
them on the GPU.

The aidan peak modes of `pactpu` carry an argument-order fault:
`psycho._threshold_for_mode` hands `aidan_peaks`' (height, bark, keep) to
`masked_threshold`, which unpacks (mspl, peak, bark), so every masker lands
at 1 bark.  The port implements what both docstrings describe, and
everything here that runs `pactpu` in such a mode does so inside
`pactpu_maskers_in_order()`, which repairs the order for the duration.
"""

import contextlib
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PATH = os.path.join(_DATA, "torch_port_fixture.npz")
PATH_WEIGHTED = os.path.join(_DATA, "torch_port_fixture_weighted.npz")
SEED = 7
SECONDS = 1.0
RECIPE = ("int16 clip of [m, 0.8 m + o] + N(0, 150^2) noise per channel; "
          "m = sum of 5 tones (f ~ U(80, 9000) Hz, a ~ U(600, 3500), "
          "phase ~ U(0, 2 pi)), o = 1500 sin(2 pi f t), f ~ U(200, 5000) "
          "Hz; numpy default_rng(seed), 44.1 kHz")


def fixture_pcm(seed: int = SEED, seconds: float = SECONDS) -> np.ndarray:
    """The input signal of RECIPE."""
    rng = np.random.default_rng(seed)
    n = int(44100 * seconds)
    t = np.arange(n) / 44100.0
    mono = sum(a * np.sin(2 * np.pi * f * t + p) for f, a, p in zip(
        rng.uniform(80, 9000, 5), rng.uniform(600, 3500, 5),
        rng.uniform(0, 2 * np.pi, 5)))
    own = 1500 * np.sin(2 * np.pi * rng.uniform(200, 5000) * t)
    sig = np.stack([mono, 0.8 * mono + own], 1)
    sig = sig + rng.standard_normal((n, 2)) * 150
    return np.clip(sig, -32767, 32767).astype(np.int16)


@contextlib.contextmanager
def pactpu_maskers_in_order():
    """Inside, pactpu.ops.psycho.aidan_peaks returns (height, keep, bark),
    the order masked_threshold(maskers=...) unpacks, and the engine's
    cached analysis programs are traced anew (and dropped again on
    leaving, so that nothing outside sees the repaired order)."""
    from pactpu.codec import engine as je
    from pactpu.ops import psycho as jpsy
    real = jpsy.aidan_peaks

    def in_order(x, fs, mode="weighted"):
        height, bark, keep = real(x, fs, mode)
        return height, keep, bark

    def drop_traces():
        for fn in (je._encode_fn, je._chunk_analyze_fn, je._chunk_encode_fn):
            fn.cache_clear()

    drop_traces()
    jpsy.aidan_peaks = in_order
    try:
        yield
    finally:
        jpsy.aidan_peaks = real
        drop_traces()


def build_fixture(peak_mode: str = "ref") -> dict:
    if peak_mode != "ref":
        with pactpu_maskers_in_order():
            return _build_fixture(peak_mode)
    return _build_fixture(peak_mode)


def _build_fixture(peak_mode: str) -> dict:
    from pactpu.codec.engine import Engine
    from pactpu.utils.config import CodecConfig
    pcm = fixture_pcm()
    eng = Engine(cfg=CodecConfig(peak_mode=peak_mode), rate_mode="reservoir")
    stream = eng.encode(pcm)
    _, decoded = eng.decode(stream)
    return dict(seed=np.int64(SEED), seconds=np.float64(SECONDS),
                recipe=np.str_(RECIPE), pcm=pcm,
                stream=np.frombuffer(stream, np.uint8), decoded=decoded)


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(_DATA)))
    for path, mode in ((PATH, "ref"), (PATH_WEIGHTED, "weighted")):
        np.savez_compressed(path, **build_fixture(mode))
        print(path, os.path.getsize(path), "bytes")
