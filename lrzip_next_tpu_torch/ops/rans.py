"""Interleaved-rANS literal encode on PyTorch: the device literal coder.

Port of the encode half of ``lrzip_next_tpu/ops/rans.py``.  A block of
``n`` bytes, zero-padded to ``_bucket(n, K)``, is cut into K contiguous
lane spans of ``T`` bytes (lane ``l`` holds bytes ``[l*T, (l+1)*T)``);
the K rANS states advance together over span position ``t``, in reverse.
Each lane's context is its own previous byte ``>> (8 - ctx_bits)`` (0 at
``t = 0``).  The stages, all on the block's device:

1. K4 (``rans_kernels.joint_histogram``): (context, symbol) counts over
   the leading ``T // srate`` positions of every lane;
2. ``quantize_freqs``: 12-bit frequencies (M = 4096 per context, every
   symbol >= 1);
3. K5 (``rans_kernels.encode_scan``): the reverse scan, giving the final
   states and a (T, K) plane of ``word | flag << 16`` emissions;
4. K6 (``streampack.pack_plane``): the flagged words in step-major,
   lane-minor order, the wire stream.

Only the table, the K states and the packed words are read back; the
payload is assembled on the host in the ``CTYPE_RANS`` wire format,
byte-identical to ``lrzip_next_tpu.ops.rans.encode_block``.

The kernels take the padded block as it lies in memory (lane-major), so
no (T, K) transpose is built.  The TPU's bf16 one-hot table fetches and
f32 divide fixups are not carried over: integer loads and exact integer
division give the same numbers.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .rans_kernels import M, M_BITS, encode_scan, joint_histogram
from .streampack import pack_plane

MAGIC = 1                     # payload version byte
_SAMPLE_TARGET = 1 << 20      # histogram sample size (elements)

_HDR = struct.Struct("<BBBBQIII")


def pick_lanes(n: int) -> int:
    """Lane count: K doubles until spans shrink to ~2048 symbols, capped
    at 16384 (the block header stores K 4-byte states)."""
    k = 64
    while k < 16384 and k * 2048 <= n:
        k *= 2
    return k


def _bucket(n: int, k: int) -> int:
    """Padded block length: a multiple of K in coarse steps.  The span
    length ``T`` is part of the wire format, so the padding must equal
    the JAX package's."""
    step = max(k, 1 << 16)
    if n > (1 << 22):
        step = max(k, 1 << 21)
    return ((n + step - 1) // step) * step


def plan(n: int):
    """(K, T, srate) of an n-byte block."""
    k = pick_lanes(n)
    nb = _bucket(n, k)
    return k, nb // k, max(1, nb // _SAMPLE_TARGET)


def quantize_freqs(counts: torch.Tensor) -> torch.Tensor:
    """(C, 256) raw counts -> int32 frequencies summing to M per context,
    every symbol >= 1: floor, then the deficit to the most frequent
    symbol (the first one on ties, as ``jnp.argmax``)."""
    c = counts.to(torch.int64)
    total = c.sum(-1, keepdim=True)
    c2 = c >> torch.where(total > (1 << 18), 4, 0)
    t2 = c2.sum(-1, keepdim=True).clamp(min=1)
    f = 1 + c2 * (M - 256) // t2
    diff = M - f.sum(-1)
    cols = torch.arange(256, device=c.device)
    first_max = torch.where(c2 == c2.amax(-1, keepdim=True), cols,
                            256).amin(-1)
    rows = torch.arange(c.shape[0], device=c.device)
    f[rows, first_max] += diff
    return f.to(torch.int32)


def _padded(lit: torch.Tensor, nb: int) -> torch.Tensor:
    if lit.shape[0] == nb:
        return lit
    if lit.shape[0] > nb:
        return lit[:nb]
    out = torch.zeros(nb, dtype=torch.uint8, device=lit.device)
    out[:lit.shape[0]] = lit
    return out


def encode_arrays(lit: torch.Tensor, n: int, ctx_bits: int = 6,
                  clock=None):
    """Encode the first ``n`` bytes of the uint8 tensor ``lit`` on its
    device.  Returns (freqs (C, 256) int32, states (K,) int32 holding the
    uint32 bit patterns, packed (T*K,) int16 holding the uint16 words,
    n_words 0-dim int32, T); the first ``n_words`` packed words are the
    stream.  ``clock`` (a ``matcher.StageClock``) marks each stage."""
    k, t_len, srate = plan(n)
    mark = clock.mark if clock is not None else (lambda _name: None)
    lit = _padded(lit, k * t_len)
    counts = joint_histogram(lit, n, ctx_bits, srate, k)
    mark("histogram")
    freqs = quantize_freqs(counts)
    mark("quantize")
    states, plane = encode_scan(lit, n, freqs, ctx_bits, k)
    mark("encode")
    packed, n_words = pack_plane(plane, k * t_len)
    mark("pack_words")
    return freqs, states, packed, n_words, t_len


def _pack_table(freqs: np.ndarray) -> bytes:
    """12-bit pack + zlib of the (C, 256) frequency table."""
    f = freqs.reshape(-1).astype(np.uint32)
    a, b = f[0::2], f[1::2]
    tri = np.empty((f.size // 2, 3), np.uint8)
    tri[:, 0] = a & 0xFF
    tri[:, 1] = ((a >> 8) & 0x0F) | ((b & 0x0F) << 4)
    tri[:, 2] = b >> 4
    return zlib.compress(tri.tobytes(), 6)


def assemble_payload(freqs_h: np.ndarray, states_h: np.ndarray,
                     words_h: np.ndarray, n: int, ctx_bits: int,
                     t_len: int) -> bytes:
    """Wire payload from host copies of the coder outputs (uint32
    states, uint16 words)."""
    k = states_h.shape[0]
    table = _pack_table(freqs_h)
    hdr = _HDR.pack(MAGIC, ctx_bits, k.bit_length() - 1, 0, n,
                    words_h.shape[0], len(table), t_len)
    return b"".join([hdr, table, states_h.astype("<u4").tobytes(),
                     words_h.astype("<u2").tobytes()])


def read_back(freqs, states, packed, n_words):
    """Host copies of an ``encode_arrays`` result: n_words first, then
    the table, the states and only the first n_words words."""
    nw = int(n_words)
    return (freqs.cpu().numpy(), states.cpu().numpy().view(np.uint32),
            packed[:nw].cpu().numpy().view(np.uint16))


def encode_block(data, ctx_bits: int = 6, device="cpu") -> bytes:
    """Bytes in, payload bytes out, encoded on ``device``."""
    arr = np.frombuffer(data, np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(
            data, np.uint8)
    n = arr.shape[0]
    if n == 0:
        return _HDR.pack(MAGIC, 0, 6, 0, 0, 0, 0, 0)
    lit = torch.from_numpy(arr.copy()).to(device)
    freqs, states, packed, n_words, t_len = encode_arrays(lit, n, ctx_bits)
    return assemble_payload(*read_back(freqs, states, packed, n_words), n,
                            ctx_bits, t_len)
