"""The inputs of spoken-word cells: seeded synthetic speech, mono, made on
the device.

Each speaker of the pool talks in spurts separated by pauses.  A spurt is
voiced sound and fricatives: a glottal pulse train (Rosenberg's pulse,
differentiated for the lips' radiation) at the speaker's F0 with a slow
drift and a falling intonation over each spurt, shaped by three formant
resonators that move between vowel targets, and in some segments noise
in a high band in place of the voice.  The spectral shaping runs frame
by frame (a periodic Hann window at half overlap, which sums to one):
each frame's spectrum times the resonators' magnitude response at that
frame's formants, or times the fricative band.  Each spurt is scaled to
the stated RMS, its edges ramped, and a noise floor lies under
everything, so a pause is never digital zero.

The speakers' F0 and formant scale are a fixed table (every seed codes
the same voices and does the same kind of work); the seed draws the
spurts and pauses, the segments and their vowels, the phases and the
noise.  Every parameter is a key of the traffic's "speech" object:

  spurt_s, pause_s     uniform ranges of a talk spurt and of a pause (s)
  f0_hz                the range the speakers' F0 stays in (Hz)
  f0_drift_oct         the slow F0 drift's depth (octaves), over
  f0_drift_s           its period (s)
  intonation           the F0's fall over a spurt (a share, +- about 1)
  segment_s            uniform range of a vowel or fricative segment (s)
  fricative_share      the share of segments that are fricatives
  fricative_hz         the fricatives' band (Hz)
  syllable_hz          the rate of the voice's syllabic envelope (Hz)
  spurt_dbfs           a spurt's RMS (dB relative to full scale, 32,767)
  floor_dbfs           the noise floor's RMS (dB, the same scale)
  ramp_s               the fade at each spurt's edges (s)
"""

from __future__ import annotations

import numpy as np

# F1, F2, F3 (Hz) of five vowels (Peterson and Barney's averages for men)
VOWELS = np.asarray([[730, 1090, 2440], [530, 1840, 2480],
                     [270, 2290, 3010], [570, 840, 2410],
                     [300, 870, 2240]], np.float64)
BANDWIDTHS = (60.0, 90.0, 120.0)          # of the three resonators (Hz)
FRAME = 1024                              # the shaping's frame (samples)
HOP = FRAME // 2
FULL_SCALE = 32767.0
PIECE = 1 << 23                           # samples of per-sample work


def voices(n_speakers: int, f0_hz) -> tuple:
    """(F0 centre, formant scale) of each speaker: centres spread evenly
    in log frequency over the inner part of f0_hz (so the drift and the
    intonation stay inside it), the formants scaled up with F0 as
    voices' vocal tracts shorten (the same table for every seed)."""
    lo, hi = (float(v) for v in f0_hz)
    inner = np.log(lo) + (np.log(hi) - np.log(lo)) * (
        0.2 + 0.6 * (np.arange(n_speakers) + 0.5) / n_speakers)
    f0 = np.exp(inner)
    return f0, (f0 / f0.min()) ** 0.25


def timeline(rng, n: int, fs: int, p: dict) -> np.ndarray:
    """Talk spurts [k, 2] (first sample, end) over n samples: a pause,
    then a spurt, and so on, each drawn uniformly from its range."""
    mean = (np.mean(p["spurt_s"]) + np.mean(p["pause_s"])) * fs
    k = int(n / mean * 1.5) + 4
    pause = rng.uniform(*p["pause_s"], k) * fs
    spurt = rng.uniform(*p["spurt_s"], k) * fs
    ends = np.cumsum(pause + spurt)
    starts = ends - spurt
    keep = starts < n
    out = np.stack([starts[keep], np.minimum(ends[keep], n)], 1)
    return np.round(out).astype(np.int64)


def segments(rng, n_frames: int, fs: int, p: dict, scale: float) -> tuple:
    """Per frame: the three formant frequencies (Hz, moving linearly
    between targets at the segments' centres) and whether the frame's
    segment is a fricative."""
    t_end = (n_frames + 1) * HOP / fs
    k = int(t_end / np.mean(p["segment_s"]) * 1.5) + 4
    bounds = np.concatenate([[0.0], np.cumsum(rng.uniform(
        *p["segment_s"], k))])
    centre = (bounds[:-1] + bounds[1:]) / 2
    vowel = rng.integers(0, len(VOWELS), k)
    fric = rng.random(k) < p["fricative_share"]
    t = (np.arange(n_frames) * HOP + HOP) / fs
    formants = np.stack([np.interp(t, centre, VOWELS[vowel, j] * scale)
                         for j in range(3)], 1)
    seg = np.searchsorted(bounds, t, side="right") - 1
    return formants, fric[np.minimum(seg, k - 1)]


def resonators(torch, formants, fs: int, device):
    """|H| of three two-pole resonators at each frame's formants, unit
    gain at 0 Hz: [frames, FRAME // 2 + 1]."""
    w = torch.arange(FRAME // 2 + 1, device=device,
                     dtype=torch.float64) * (2 * np.pi / FRAME)
    f = torch.as_tensor(formants, device=device)
    out = torch.ones((f.shape[0], w.shape[0]), dtype=torch.float64,
                     device=device)
    for j, bw in enumerate(BANDWIDTHS):
        r = float(np.exp(-np.pi * bw / fs))
        c = torch.cos(2 * np.pi * f[:, j:j + 1] / fs)
        re = 1 - 2 * r * c * torch.cos(w) + r * r * torch.cos(2 * w)
        im = 2 * r * c * torch.sin(w) - r * r * torch.sin(2 * w)
        out *= (1 - 2 * r * c + r * r) / torch.sqrt(re * re + im * im)
    return out


def glottal(torch, phase):
    """Rosenberg's glottal pulse at each sample's cycle position, opening
    over 40% of the cycle and closing over 16%."""
    x = torch.frac(phase)
    rise = 0.5 * (1 - torch.cos(np.pi * x / 0.4))
    fall = torch.cos(np.pi * (x - 0.4) / 0.32)
    return torch.where(x < 0.4, rise, torch.where(x < 0.56, fall, 0.0))


def spans_of(torch, t64, starts, ends, ramp: float) -> tuple:
    """For samples t64 (float64 indices): the spurt each lies at or after
    (its index), whether it lies inside it, its position in it (0 to 1)
    and the gate that fades the spurt's edges over `ramp` samples."""
    seg = torch.searchsorted(starts, t64.to(torch.int64), right=True) - 1
    inside = (seg >= 0) & (t64 < ends[seg.clamp(min=0)])
    seg = seg.clamp(min=0)
    s0 = starts[seg].to(torch.float64)
    s1 = ends[seg].to(torch.float64)
    pos = ((t64 - s0) / (s1 - s0).clamp(min=1)).clamp(0, 1)
    gate = torch.where(inside, torch.minimum(t64 - s0, s1 - t64) / ramp,
                       0.0).clamp(0, 1)
    return seg, inside, pos, gate


def speaker(torch, seed: int, index: int, n: int, fs: int, p: dict,
            f0c: float, scale: float, device) -> tuple:
    """One speaker's int16 samples [n] and talk spurts [k, 2].  The
    per-sample work runs in pieces of PIECE samples, so that an hour's
    speech holds a few float32 arrays of its length on the device."""
    rng = np.random.default_rng([seed & ((1 << 64) - 1), 7, index])
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + index) % (1 << 63))
    spurts = timeline(rng, n, fs, p)
    starts, ends = (torch.as_tensor(np.ascontiguousarray(spurts[:, j]),
                                    device=device) for j in (0, 1))
    ramp = p["ramp_s"] * fs
    pieces = [(lo, min(n, lo + PIECE)) for lo in range(0, n, PIECE)]

    def t_of(lo, hi):
        return torch.arange(lo, hi, device=device, dtype=torch.float64)

    # the voice: a pulse train at a drifting, falling F0, under the
    # syllables' envelope
    phi = float(rng.uniform(0, 2 * np.pi))
    phase0 = float(rng.random())
    syll = float(rng.uniform(0, 2 * np.pi))
    pulse = torch.empty(n, device=device, dtype=torch.float32)
    env = torch.empty(n, device=device, dtype=torch.float32)
    for lo, hi in pieces:
        t64 = t_of(lo, hi)
        _, _, pos, _ = spans_of(torch, t64, starts, ends, ramp)
        f0 = f0c * torch.exp2(p["f0_drift_oct"] * torch.sin(
            2 * np.pi * t64 / (p["f0_drift_s"] * fs) + phi))
        f0 = (f0 * (1 + p["intonation"] * (0.5 - pos))).clamp(
            *[float(v) for v in p["f0_hz"]])
        phase = torch.cumsum(f0 / fs, 0) + phase0
        phase0 = float(phase[-1])
        pulse[lo:hi] = glottal(torch, phase)
        env[lo:hi] = 0.35 + 0.65 * torch.abs(torch.sin(
            np.pi * p["syllable_hz"] * t64 / fs + syll))
    voiced = torch.diff(pulse, prepend=pulse[:1]) * env
    del pulse, env
    noise = torch.randn(n, generator=g, device=device, dtype=torch.float32)

    # the tract, frame by frame
    n_frames = -(-n // HOP) + 1
    formants, fric = segments(rng, n_frames, fs, p, scale)
    # in float64: a float32 FFT's last bits can differ from call to call
    # (on the CPU its result depends on the buffers' alignment), and a
    # sample near a rounding edge would then differ by one step
    win = torch.hann_window(FRAME, periodic=True, device=device,
                            dtype=torch.float64)
    freqs = torch.arange(FRAME // 2 + 1, device=device) * (fs / FRAME)
    lo, hi = (float(v) for v in p["fricative_hz"])
    band = ((freqs >= lo) & (freqs <= hi)).to(torch.float64)
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x, (HOP, n_frames * HOP - n))
    vp, npd = pad(voiced), pad(noise)
    del voiced, noise
    out = torch.zeros(n_frames * HOP + HOP, device=device,
                      dtype=torch.float64)
    fric_t = torch.as_tensor(fric, device=device)
    step = 8192
    for f_lo in range(0, n_frames, step):
        f_hi = min(n_frames, f_lo + step)
        span = slice(f_lo * HOP, f_hi * HOP + HOP)
        fv = vp[span].to(torch.float64).unfold(0, FRAME, HOP) * win
        fn = npd[span].to(torch.float64).unfold(0, FRAME, HOP) * win
        env = resonators(torch, formants[f_lo:f_hi], fs, device)
        fr = fric_t[f_lo:f_hi, None]
        spec = torch.where(fr, torch.fft.rfft(fn) * band,
                           torch.fft.rfft(fv) * env)
        y = torch.fft.irfft(spec, n=FRAME)
        ola = y[:, :HOP].clone()
        ola[1:] += y[:-1, HOP:]
        out[f_lo * HOP:f_hi * HOP] += ola.reshape(-1)
        out[f_hi * HOP:f_hi * HOP + HOP] += y[-1, HOP:]
    del vp, npd
    sig = out[HOP:HOP + n]

    # each spurt at its RMS, the floor under everything
    k = spurts.shape[0]
    energy = torch.zeros(k, device=device, dtype=torch.float64)
    count = torch.zeros(k, device=device, dtype=torch.float64)
    for lo, hi in pieces:
        seg, inside, _, gate = spans_of(torch, t_of(lo, hi), starts, ends,
                                        ramp)
        x = sig[lo:hi].to(torch.float64) * gate
        energy.index_add_(0, seg, torch.where(inside, x * x, 0.0))
        count.index_add_(0, seg, inside.to(torch.float64))
    want = FULL_SCALE * 10 ** (p["spurt_dbfs"] / 20)
    gain = want / torch.sqrt(energy / count.clamp(min=1)).clamp(min=1e-9)
    floor = FULL_SCALE * 10 ** (p["floor_dbfs"] / 20)
    pcm = torch.empty(n, device=device, dtype=torch.int16)
    for lo, hi in pieces:
        seg, inside, _, gate = spans_of(torch, t_of(lo, hi), starts, ends,
                                        ramp)
        x = sig[lo:hi].to(torch.float64) * gate * torch.where(
            inside, gain[seg], 0.0)
        x = x + floor * torch.randn(hi - lo, generator=g, device=device,
                                    dtype=torch.float32).to(torch.float64)
        pcm[lo:hi] = x.round().clamp(-32767, 32767).to(torch.int16)
    return pcm.cpu().numpy(), spurts


def speaker_pool(torch, seed: int, n_speakers: int, p: dict,
                 seconds: float, fs: int, device) -> tuple:
    """(int16 [n_speakers, n], each speaker's spurts [k, 2]) on the host,
    n = seconds * fs; p: the traffic's "speech" object."""
    n = int(fs * seconds)
    f0, scale = voices(n_speakers, p["f0_hz"])
    pcm, spurts = [], []
    for i in range(n_speakers):
        x, s = speaker(torch, seed, i, n, fs, p, float(f0[i]),
                       float(scale[i]), device)
        pcm.append(x)
        spurts.append(s)
    return np.stack(pcm), spurts
