"""Uniform, floating-point and block-floating-point quantizers on tensors
(pactpu.ops.quantize).

Semantics follow the reference quantizer family (reference
codec/quantize.py): sign-magnitude midtread uniform quantization and its
inverse, the hidden-bit floating-point mantissas, block-floating-point
scale factors (leading zeros of the quantized band maximum) and BFP
mantissas with the half-LSB reconstruction offset.

Three details of the JAX reference's float32 arithmetic are reproduced, so
that the integer outputs (scale factors, mantissa codes) stay bit-identical
with it given the same float inputs (the third is in pcm16_to_float):

- ``2**k`` at an integer k is computed there as ``exp(ln2 * k)`` in float32
  (JAX lowers exp2 so), which is up to a few ulp away from the exact power
  of two.  ``exp2i`` returns that value: the correctly rounded
  exp(float32(ln2 * k)), which equals the reference at every k it uses.
- Its compiler contracts ``x * y + z`` into one fused multiply-add.
  ``fma32`` computes that in float64 (the product of two float32 values is
  exact there) and rounds once to float32.

Both are plain tensor ops, identical on the CPU and on the card.  Every
`floor` stays a floor, every float->int cast truncates, and signs are read
with `signbit`, so -0.0 is negative (quantize.py:54,165,208).

Under float64 (precision="f64", the reference under JAX's x64 mode) the
same three details hold one level up, and the helpers follow the dtype of
their operands:

- ``2**k`` is the correctly rounded exp(float64(ln2 * k)), which is not the
  exact power of two (it is one ulp off at most k); ``exp2i`` reads it from
  a table of those values for k in [-1100, 1100] (past float64's range at
  both ends, subnormal results flushed to zero as the reference does),
  computed once a device with 50 decimal digits (Python's decimal module).
- The fused multiply-add has no wider type to round from, so ``fma``
  computes it from error-free transformations (Dekker's product and
  Knuth's sum): the exact product and sum, rounded once, except in the
  rare case where the rounding of the error terms decides a tie.
- ``/ 65535`` is again a product with the float64 reciprocal.
"""

from __future__ import annotations

from decimal import Decimal, localcontext
from functools import lru_cache

import numpy as np
import torch

_LN2_F32 = float(np.float32(np.log(2.0)))
_INV_65535 = float(np.float32(1.0) / np.float32(65535.0))
_INV_65535_F64 = 1.0 / 65535.0
# the exponents of the float64 table of exp2i
_EXP2_LO, _EXP2_HI = -1100, 1100
# Veltkamp's splitting constant for float64, 2^27 + 1
_SPLIT = 134217729.0


# unbounded: a captured CUDA graph reads it by address (codec/programs.py)
@lru_cache(maxsize=None)
def _exp2_table_f64(device: torch.device) -> torch.Tensor:
    """exp(float64(ln2 * k)) correctly rounded to float64, k in [_EXP2_LO,
    _EXP2_HI]: the reference's float64 2**k (module docstring)."""
    ln2 = float(np.log(2.0))
    with localcontext() as ctx:
        ctx.prec = 50
        vals = [float(Decimal(k * ln2).exp())
                for k in range(_EXP2_LO, _EXP2_HI + 1)]
    # the reference flushes subnormal results to zero
    vals = [v if v >= np.finfo(np.float64).tiny else 0.0 for v in vals]
    return torch.tensor(vals, dtype=torch.float64, device=device)


def exp2i(e: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """2**e as `dtype` (float32 or float64) for an integer tensor e, with
    the reference's rounding (see the module docstring)."""
    if dtype == torch.float64:
        k = torch.clamp(e.long(), _EXP2_LO, _EXP2_HI) - _EXP2_LO
        # index_select: the table[k] indexing broke the capture of the
        # float64 stages into CUDA graphs on the card
        return _exp2_table_f64(e.device).index_select(
            0, k.reshape(-1)).reshape(k.shape)
    t = e.to(torch.float32) * _LN2_F32
    return torch.exp(t.double()).float()


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c with one float32 rounding (a fused multiply-add)."""
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    return (a.double() * b + c).float()


def _split(x: torch.Tensor):
    """Veltkamp's split of float64 x into two 26-bit halves, hi + lo = x."""
    t = _SPLIT * x
    hi = t - (t - x)
    return hi, x - hi


def fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in float64 with one rounding of the exact product and sum
    (module docstring): Dekker's product p + e = a * b exactly, Knuth's sum
    s + t = p + c exactly, then s + (t + e)."""
    b = b if torch.is_tensor(b) else torch.full_like(a, float(b))
    c = c if torch.is_tensor(c) else float(c)
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once, in a's dtype (float32 or float64)."""
    return fma64(a, b, c) if a.dtype == torch.float64 else fma32(a, b, c)


def _shl1(n: torch.Tensor) -> torch.Tensor:
    """1 << n for an int32 tensor, 0 where n < 0 (a negative shift)."""
    one = torch.ones_like(n)
    return torch.where(n >= 0, torch.bitwise_left_shift(
        one, torch.clamp(n, min=0)), 0)


def _shl(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """a << n with the count clamped to [0, 31]: torch's shifts of int32
    are undefined past them, XLA's are not; every caller selects the
    result only where its count is in range (pactpu clamps at the same
    places, quantize.py:101-104)."""
    return torch.bitwise_left_shift(a, torch.clamp(n, 0, 31))


def _i32(v, device) -> torch.Tensor:
    """An int or an integer tensor as int32 on `device`; an int is filled
    there (a host scalar copied up would wait for the device)."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.int32)
    return torch.full((), int(v), dtype=torch.int32, device=device)


def quantize_uniform(x: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """Sign-magnitude midtread uniform quantize to int32 codes
    (reference vQuantizeUniform, codec/quantize.py:91-117)."""
    a = torch.abs(x)
    largest = exp2i(nbits, a.dtype) - 1.0               # 2^R - 1
    sign_mask = _shl1(nbits - 1)
    code = torch.floor(fma(largest, a, 1.0) * 0.5).to(torch.int32)
    code = torch.where(a >= 1.0, sign_mask - 1, code)   # overload level
    code = torch.where(torch.signbit(x), code + sign_mask, code)
    return torch.where(nbits <= 0, 0, code)


def dequantize_uniform(code: torch.Tensor, nbits,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of quantize_uniform: |x| = 2|code| / (2^R - 1), 0 where
    R <= 0 (reference codec/quantize.py:120-145).  nbits: an int or an int
    tensor broadcastable to code (R <= 31).  Returns `dtype`."""
    nbits = _i32(nbits, code.device)
    code = code.to(torch.int32)
    sign_mask = _shl1(nbits - 1)
    largest = exp2i(nbits, dtype) - 1.0
    neg = (code & sign_mask) == sign_mask
    mag = torch.where(neg, code - sign_mask, code).to(dtype)
    val = 2.0 * mag / largest
    val = torch.where(neg, -val, val)
    return torch.where(nbits <= 0, 0.0, val)


def scale_factor(a: torch.Tensor, n_scale_bits: int, nmant) -> torch.Tensor:
    """Leading-zero count of the uniformly quantized |a|, capped at
    2^nScaleBits - 1 (reference codec/quantize.py:148-177).

    nmant may be an int or an int tensor (per-band allocations); a is |max|
    per band."""
    nmant = _i32(nmant, a.device)
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    q = quantize_uniform(torch.abs(a), r)
    # msb of q (-1 when q == 0): float64 holds every int32 exactly
    msb = torch.frexp(q.double()).exponent - 1
    scale = torch.clamp(r - 2 - msb, 0, largest_scale)
    return torch.where(nmant <= 0, 0, scale).to(torch.int32)


def fp_mantissa(x: torch.Tensor, scale, n_scale_bits: int,
                nmant) -> torch.Tensor:
    """Floating-point mantissa codes with a hidden leading bit (int32), as
    reference MantissaFP (codec/quantize.py:180-208): uniform-quantize at
    R = nmant + L bits (L = 2^nScaleBits - 1), drop `scale` leading zeros
    and the hidden leading 1 when scale < L, keep nmant - 1 magnitude bits
    and the sign.  The reference's shift chain reduces to the int32-safe
    (Q - 2^(R-scale-2)) >> (L-scale-1), as in pactpu.  scale and nmant:
    ints or int tensors broadcastable to x."""
    nmant, scale = _i32(nmant, x.device), _i32(scale, x.device)
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    q = quantize_uniform(torch.abs(x), r)
    one = torch.ones_like(q)
    mag_low = torch.bitwise_right_shift(
        q - _shl(one, r - scale - 2),
        torch.clamp(largest_scale - scale - 1, 0, 31))
    mag = torch.where(scale < largest_scale, mag_low, q)
    sign_mask = _shl1(nmant - 1)
    code = torch.where(torch.signbit(x), mag + sign_mask, mag)
    return torch.where(nmant <= 0, 0, code)


def fp_dequantize(scale, code: torch.Tensor, n_scale_bits: int,
                  nmant) -> torch.Tensor:
    """Inverse of fp_mantissa (float32): restore the hidden bit when
    scale < L, add the half step and zero-pad when scale < L - 1, then
    uniform-dequantize at R bits (reference DequantizeFP,
    codec/quantize.py:211-246)."""
    nmant, scale = _i32(nmant, code.device), _i32(scale, code.device)
    code = code.to(torch.int32)
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    sign_mask = _shl1(nmant - 1)
    neg = (code & sign_mask) == sign_mask
    mag = torch.where(neg, code - sign_mask, code)
    mag = torch.where(scale < largest_scale, mag + sign_mask, mag)
    padded = _shl(2 * mag + 1, largest_scale - scale - 2)
    mag = torch.where(scale < largest_scale - 1, padded, mag)
    full = torch.where(neg, mag + _shl1(r - 1), mag)
    return torch.where(nmant <= 0, 0.0, dequantize_uniform(full, r))


def bfp_mantissa(x: torch.Tensor, scale: torch.Tensor, n_scale_bits: int,
                 nmant: torch.Tensor) -> torch.Tensor:
    """Block-floating-point sign-magnitude mantissa codes (int32), as
    reference vMantissa (codec/quantize.py:315-342): magnitude =
    Q(|x|, R) >> (L - scale); sign bit = 2^(nmant-1).  scale/nmant are int32
    tensors broadcastable to x."""
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    a = torch.abs(x)
    # floor(((2^R-1)a + 1) / 2^(L-scale+1)) restructured for f32 precision,
    # as the reference does: floor(a*2^(nmant+scale-1) + (1-a)*2^(scale-L-1))
    low = (1.0 - a) * exp2i(scale - largest_scale - 1, a.dtype)
    mag = torch.floor(fma(a, exp2i(nmant + scale - 1, a.dtype), low)).to(
        torch.int32)
    # overload: Q clipped to 2^(R-1)-1 then shifted
    clip_mag = torch.bitwise_right_shift(_shl1(r - 1) - 1,
                                         largest_scale - scale)
    mag = torch.where(a >= 1.0, clip_mag, mag)
    sign_mask = _shl1(nmant - 1)
    code = torch.where(torch.signbit(x), mag + sign_mask, mag)
    return torch.where(nmant <= 0, 0, code)


def bfp_dequantize(scale: torch.Tensor, code: torch.Tensor,
                   n_scale_bits: int, nmant: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of bfp_mantissa with the reference's half-step reconstruction
    offset `1 << (L - scale - 1)` added when scale < L and magnitude > 0
    (reference codec/quantize.py:345-376).  Returns `dtype`."""
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    sign_mask = _shl1(nmant - 1)
    neg = (code & sign_mask) == sign_mask
    mag = torch.where(neg, code - sign_mask, code)
    shift = largest_scale - scale
    half = torch.where((scale < largest_scale) & (mag > 0),
                       exp2i(shift - 1, dtype), 0.0)
    num = fma(mag.to(dtype), exp2i(shift, dtype), half)
    val = 2.0 * num / (exp2i(r, dtype) - 1.0)
    val = torch.where(neg, -val, val)
    return torch.where(nmant <= 0, 0.0, val)


def pcm16_to_float(codes: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int16 PCM -> `dtype` signed fractions via the reference's
    sign-magnitude 16-bit dequantizer (reference codec/pcmfile.py:89-98):
    value = sign * 2*(|code| mod 2^15) / (2^16 - 1); -32768 maps to 0.0."""
    c = codes.to(torch.int32)
    mag = torch.abs(c) & 0x7FFF
    neg = (c < 0) & (mag > 0)
    # the reference's compiler turns the division by the constant into a
    # product with its reciprocal; so does this
    inv = _INV_65535_F64 if dtype == torch.float64 else _INV_65535
    val = 2.0 * mag.to(dtype) * inv
    return torch.where(neg, -val, val)


def float_to_pcm16(x: torch.Tensor) -> torch.Tensor:
    """Signed fractions -> int16 PCM codes via the reference's 16-bit
    sign-magnitude quantizer (reference codec/pcmfile.py:127-134)."""
    a = torch.abs(x)
    mag = torch.floor(fma(a, 65535.0, 1.0) * 0.5).to(torch.int32)
    mag = torch.where(a >= 1.0, 32767, mag)
    out = torch.where(torch.signbit(x), -mag, mag)
    return out.to(torch.int16)
