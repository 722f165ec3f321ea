"""Write tests/data/torch_port_fixture.npz,
tests/data/torch_port_fixture_weighted.npz,
tests/data/torch_port_fixture_modes.npz and
tests/data/torch_port_fixture_alloc.npz: streams the JAX package encodes
on the CPU, for the PyTorch port to decode and re-encode.

    env JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py

Each file holds the seed and recipe of a 1.0 s stereo tone+noise input
(45 blocks), the input PCM, the stream `pactpu` encodes from it (reservoir
rate mode; the default config, and peak_mode="weighted" for the second
file) and `pactpu`'s decoded PCM.  The modes file holds two such sets,
each array's name prefixed by its mode: `mono_wak_` (the input's first
channel, CodecConfig(n_channels=1)) and `stereo_pac_` (the baseline
coder, Engine(fmt="pac")).  The alloc file holds, for the same input (the
default fixture's `pcm`, not repeated), `pactpu`'s stream of each other
allocator in the cbr and reservoir rate modes (`{alloc}_{rate}_stream`)
with the SNR of `pactpu`'s decode (`{alloc}_{rate}_snr_db`), and a cbr
stream on a table set trained from `pactpu`'s own mantissas of the input
(`trained_cbr_stream`, `trained_cbr_snr_db`, the tables as `tables_*`);
its decoded PCM is left out to keep the file small (chip_smoke.py holds
the port's decode to the float64 oracle's, and the CPU tests hold that
to `pactpu`'s).  tests/test_torch_fixture.py rebuilds them and asserts
that they equal the committed files; chip_smoke.py reads them on the GPU.

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
PATH_MODES = os.path.join(_DATA, "torch_port_fixture_modes.npz")
PATH_ALLOC = os.path.join(_DATA, "torch_port_fixture_alloc.npz")
ALLOC_MODES = ("closed_form", "uniform", "const_snr", "const_mnr")
RATE_MODES = ("cbr", "reservoir")
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


def short_pcm(chans: int = 2, fs: int = 44100) -> np.ndarray:
    """The short tone pair of tests/test_variants.py:434-442 (3,985
    samples, 5 blocks), which the port's tests encode with both packages."""
    rng = np.random.default_rng(7)
    n = 1024 * 4 - 111
    t = np.arange(n) / fs
    sig = (0.45 * np.sin(2 * np.pi * 440 * t)
           + 0.12 * np.sin(2 * np.pi * 2900 * t)
           + 0.02 * rng.standard_normal(n))
    cols = [sig, 0.7 * sig][:chans]
    return np.clip(np.stack(cols, 1) * 32767, -32768, 32767).astype(np.int16)


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
    from pactpu.utils.config import CodecConfig
    return _encoded(fixture_pcm(), CodecConfig(peak_mode=peak_mode), "wak")


def _encoded(pcm: np.ndarray, cfg, fmt: str, prefix: str = "") -> dict:
    from pactpu.codec.engine import Engine
    eng = Engine(cfg=cfg, rate_mode="reservoir", fmt=fmt)
    stream = eng.encode(pcm)
    _, decoded = eng.decode(stream)
    return {prefix + k: v for k, v in dict(
        seed=np.int64(SEED), seconds=np.float64(SECONDS),
        recipe=np.str_(RECIPE), pcm=pcm,
        stream=np.frombuffer(stream, np.uint8), decoded=decoded).items()}


def build_modes_fixture() -> dict:
    """Mono .wak of the input's first channel and stereo .pac."""
    from pactpu.utils.config import CodecConfig
    pcm = fixture_pcm()
    return {**_encoded(np.ascontiguousarray(pcm[:, :1]),
                       CodecConfig(n_channels=1), "wak", "mono_wak_"),
            **_encoded(pcm, CodecConfig(), "pac", "stereo_pac_")}


def snr_db(ref: np.ndarray, out: np.ndarray) -> float:
    a = ref.astype(np.float64).ravel()
    d = out[:ref.shape[0]].astype(np.float64).ravel() - a
    return float(10 * np.log10(np.sum(a * a) / max(np.sum(d * d), 1e-30)))


def trained_tables(pcm: np.ndarray):
    """A table set trained from pactpu's own unsigned mantissas of `pcm`
    (the default config's first pass, no extra bits; every table id on
    the same histogram), as tests/test_huffman_train.py trains one."""
    import jax.numpy as jnp
    from pactpu.codec import engine as E
    from pactpu.ops import huffman_train as ht
    from pactpu.utils.config import CodecConfig
    cfg = CodecConfig()
    b = -(-pcm.shape[0] // cfg.n_mdct_lines) + 1
    frames = E.frame_blocks_np(pcm, cfg.n_mdct_lines, b)
    out = E.encode_body(cfg, return_syms=True)(
        jnp.asarray(frames), jnp.zeros(b, jnp.float32),
        E.engine_consts_np(cfg))
    syms = np.asarray(out["syms"]).ravel()
    freqs = np.zeros(ht.NUM_SYMBOLS, np.int64)
    np.add.at(freqs, syms[syms >= 0], 1)
    return ht.train_tables({tid: freqs for tid in range(1, 11)})


def build_alloc_fixture() -> dict:
    """pactpu's streams of the four other allocators (cbr and reservoir)
    and of a trained table set (cbr), with the SNR of pactpu's decodes."""
    from pactpu.codec.engine import Engine
    from pactpu.utils.config import CodecConfig
    pcm = fixture_pcm()
    out = dict(seed=np.int64(SEED), seconds=np.float64(SECONDS),
               recipe=np.str_(RECIPE))

    def put(name, eng):
        stream = eng.encode(pcm)
        out[f"{name}_stream"] = np.frombuffer(stream, np.uint8)
        out[f"{name}_snr_db"] = np.float64(snr_db(pcm, eng.decode(stream)[1]))

    for alloc in ALLOC_MODES:
        for rate in RATE_MODES:
            put(f"{alloc}_{rate}",
                Engine(cfg=CodecConfig(alloc_mode=alloc), rate_mode=rate))
    tabs = trained_tables(pcm)
    put("trained_cbr", Engine(rate_mode="cbr", tables=tabs))
    for key, t in zip(("lengths", "codes", "escape_lengths",
                       "escape_codes"), tabs):
        out[f"tables_{key}"] = t
    return out


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(_DATA)))
    for path, fields in ((PATH, build_fixture("ref")),
                         (PATH_WEIGHTED, build_fixture("weighted")),
                         (PATH_MODES, build_modes_fixture()),
                         (PATH_ALLOC, build_alloc_fixture())):
        np.savez_compressed(path, **fields)
        print(path, os.path.getsize(path), "bytes")
