"""Interleaved-rANS literal coder on PyTorch: the device literal codec.

Port of ``lrzip_next_tpu/ops/rans.py``, encode and decode.  A block of
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

Decode (``decode_arrays``, ``decode_block``) parses the payload on the
host, uploads the words, the K states and the table, and runs K7
(``rans_kernels.decode_scan``): T forward steps in which every lane
finds its symbol by the slot ``x & 4095`` and the renormalising lanes
take the next words of the stream in lane order.  All final states must
equal 2^16, else the stream was corrupt.

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

from .rans_kernels import L_INIT, M, M_BITS, decode_scan, encode_scan, \
    joint_histogram
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


def encode_block(data, ctx_bits: int = 6, device="cuda") -> bytes:
    """Bytes in, payload bytes out, encoded on ``device`` (the card unless
    the caller asks for the CPU; raises where there is no card)."""
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


# ---------------------------------------------------------------------------
# decode


def _unpack_table(blob: bytes, c_ctx: int) -> np.ndarray:
    try:
        raw = zlib.decompress(blob)
    except zlib.error as e:
        raise ValueError(f"corrupt rans frequency table: {e}") from e
    if len(raw) % 3 or len(raw) // 3 * 2 != c_ctx * 256:
        raise ValueError("corrupt rans frequency table (size)")
    tri = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    a = tri[:, 0].astype(np.uint32) | ((tri[:, 1] & 0x0F).astype(
        np.uint32) << 8)
    b = (tri[:, 1] >> 4).astype(np.uint32) | (tri[:, 2].astype(
        np.uint32) << 4)
    f = np.empty(tri.shape[0] * 2, np.int32)
    f[0::2] = a
    f[1::2] = b
    return f.reshape(c_ctx, 256)


def parse_payload(payload: bytes, u_len=None):
    """Header checks and host views of a ``CTYPE_RANS`` payload; with
    ``u_len``, the stored length must equal it.

    Returns (n, ctx_bits, K, T, freqs (C, 256) int32, states (K,) uint32,
    words (n_words,) uint16); for ``n == 0`` everything after ``n`` is
    None.  Raises ``ValueError`` on a malformed payload."""
    if len(payload) < _HDR.size:
        raise ValueError("rans payload truncated")
    magic, ctx_bits, klog, _, n, nw, tlen, t_len = _HDR.unpack_from(
        payload, 0)
    if magic != MAGIC or ctx_bits not in (0, 4, 6, 8) or klog > 14:
        raise ValueError("bad rans payload header")
    if u_len is not None and n != u_len:
        raise ValueError("rans payload length mismatch")
    if n == 0:
        return 0, ctx_bits, None, None, None, None, None
    k = 1 << klog
    # every encoder writes at least 64 lanes and spans no longer than the
    # padded block's; a longer span would only size the decoded plane
    if klog < 6 or t_len * k < n or \
            t_len > min(_bucket(n, k) // k, 1 << 26):
        raise ValueError("bad rans payload span length")
    off = _HDR.size
    freqs = _unpack_table(payload[off:off + tlen], 1 << ctx_bits)
    off += tlen
    if (freqs.sum(axis=1) != M).any() or (freqs < 1).any():
        raise ValueError("corrupt rans frequency table")
    states = np.frombuffer(payload[off:off + 4 * k], "<u4")
    off += 4 * k
    if states.shape[0] != k:
        raise ValueError("rans payload truncated (states)")
    words = np.frombuffer(payload[off:off + 2 * nw], "<u2")
    if words.shape[0] != nw:
        raise ValueError("rans payload truncated (words)")
    return n, ctx_bits, k, t_len, freqs, states, words


def decode_arrays(words: torch.Tensor, states: torch.Tensor,
                  freqs: torch.Tensor, n: int, ctx_bits: int, k: int,
                  t_len: int):
    """Decode on the tensors' device -> ((K*T,) uint8 plane in block
    order, final states (K,) int32 holding the uint32 bit patterns); the
    caller slices ``[:n]``.  ``words`` is int16 holding the uint16 words,
    ``states`` int32 holding the uint32 patterns, ``freqs`` (C, 256)
    int32."""
    if states.shape[0] != k:
        raise ValueError(f"decode_arrays: {states.shape[0]} states for "
                         f"{k} lanes")
    return decode_scan(words, states, freqs, n, ctx_bits, t_len)


def upload(freqs: np.ndarray, states: np.ndarray, words: np.ndarray,
           device):
    """Device tensors of a parsed payload, in ``decode_arrays``' types."""
    return (torch.from_numpy(words.astype("<u2").view(np.int16)).to(device),
            torch.from_numpy(states.astype("<u4").view(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(freqs, np.int32)
                             ).to(device))


def states_final(xf: torch.Tensor) -> bool:
    """True when every final state equals the initial 2^16."""
    return bool((xf == L_INIT).all())


def decode_block(payload: bytes, device="cuda") -> bytes:
    """Payload bytes in, the block's bytes out, decoded on ``device`` (the
    card unless the caller asks for the CPU; raises where there is no
    card)."""
    n, ctx_bits, k, t_len, freqs, states, words = parse_payload(payload)
    if n == 0:
        return b""
    plane, xf = decode_arrays(*upload(freqs, states, words, device), n,
                              ctx_bits, k, t_len)
    out = plane[:n].cpu().numpy()
    if not states_final(xf):
        raise ValueError("corrupt rans stream (final state check)")
    return out.tobytes()
