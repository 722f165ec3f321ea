"""pactpu_torch — the pactpu perceptual audio codec on PyTorch and CUDA.

A port of ``pactpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).  It reads and writes the same
`.wak` streams.  The JAX package stays beside it as the reference the
port is tested against; this package imports neither JAX nor ``pactpu``.

Layout (mirrors ``pactpu``)
---------------------------
- ``pactpu_torch.ops``    tensor ops: MDCT, quantizers, psychoacoustics,
                          water-fill allocation, Huffman selection, payload
                          packing, the device-side Huffman parse, and
                          ``kernels`` (the seven CUDA kernels with their
                          plain PyTorch versions)
- ``pactpu_torch.codec``  stream header, WAV I/O, the file ``Engine`` and
                          the exact serial reservoir (``exact``)
- ``pactpu_torch.compat`` ``refcodec``, the float64 oracle (numpy only)
- ``pactpu_torch.utils``  ``CodecConfig``
- ``pactpu_torch.native`` ctypes binding of the repository's csrc/wakbits.cc
- ``pactpu_torch/csrc``   the CUDA sources, built at first use into
                          ``pactpu_torch/_build/``

Usage::

    from pactpu_torch import Engine
    eng = Engine(device="cuda", rate_mode="reservoir")
    stream = eng.encode(pcm_int16_n_by_2)
    fs, pcm = eng.decode(stream)
"""

from pactpu_torch.utils.config import CodecConfig

__all__ = ["CodecConfig", "Engine"]


def __getattr__(name: str):
    """`Engine` is a lazy export: it pulls in torch and the op modules."""
    if name == "Engine":
        from pactpu_torch.codec.engine import Engine
        return Engine
    raise AttributeError(name)
