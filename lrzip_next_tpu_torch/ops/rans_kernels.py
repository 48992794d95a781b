"""K4 (sampled joint histogram), K5 (rANS encode scan) and K7 (rANS
decode scan).

K4 and K5 take the padded literal block ``lit`` as it lies in memory: K lanes
of ``T = len(lit) // K`` bytes each, lane ``l`` at ``lit[l*T : (l+1)*T]``
(the JAX package's (T, K) plane is this buffer transposed).  Position
``(l, t)`` is real when ``l*T + t < n``; its context is
``lit[l*T + t - 1] >> (8 - ctx_bits)``, 0 at ``t = 0`` and for
``ctx_bits = 0``.

- ``joint_histogram``: (2^ctx_bits, 256) int32 counts of (context,
  symbol) over the real positions of the leading ``T // srate`` span
  positions of every lane (``csrc/rans_hist.cu``: one C call; a thread a
  16-byte vector of a lane's samples, each sample's context the previous
  byte in registers; every CTA counts into its own copy of the table in
  shared memory, two 16-bit counters a word, so that no sample is a
  global atomic, at ctx_bits 8 too, and adds its nonzero cells to the
  output once; the C entry sizes the grid so that no CTA takes 2^16
  samples.  Bound: the launch and the atomics, not the 1 MB of samples).
- ``encode_scan``: the K-lane rANS encode, run from ``t = T-1`` down to
  0: states start at 2^16; a lane whose state ``x >= f << 20`` emits its
  low 16 bits and shifts; then ``x = (x // f) * M + cum + x % f``, the
  quotient taken as a multiply by a reciprocal (``reciprocals``,
  ``divide_by_reciprocal``).  Returns the final states (int32 holding the
  uint32 bit patterns) and a (T, K) int32 plane of ``word | flag << 16``
  (``csrc/rans_encode.cu``).

- ``decode_scan``: the K-lane rANS decode, run from ``t = 0`` up to
  T-1 on the stream of 16-bit words in consumption order.  At a real
  position the lane's slot ``x & 4095`` selects the symbol ``s`` with
  ``cum[ctx][s] <= slot < cum[ctx][s+1]``; then
  ``x = f * (x >> 12) + slot - cum``; a lane whose state fell below 2^16
  takes one word, ``x = x << 16 | word``, and the lanes that do so in one
  step take consecutive words in lane order.  A word past the end of the
  stream reads as 0.  Returns the (K*T,) uint8 block (lane-major, 0 at
  padding positions) and the final states (``csrc/rans_decode.cu``; on
  the card the lanes are spread over a thread-block cluster of
  ``decode_cluster(k, ctx_bits)`` CTAs).

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version.  Counterparts of ``lrzip_next_tpu/ops/rans_pallas.py``
(``joint_histogram_pallas``, ``encode_scan_fused``) and
``lrzip_next_tpu/ops/rans_decode_pallas.py`` (``decode_scan_fused``),
and of their XLA twins ``rans.joint_histogram``, ``rans._encode_scan``
and ``rans._decode_scan``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .anchor import _to_i32

M_BITS = 12
M = 1 << M_BITS
L_INIT = 1 << 16
_U32 = 0xFFFFFFFF

hist_launches = 0
encode_launches = 0
decode_launches = 0


def _lanes(lit: torch.Tensor, k: int) -> torch.Tensor:
    """(K, T) int64 view of the lane-major block."""
    return lit.view(k, lit.shape[0] // k).to(torch.int64)


def _contexts(spans: torch.Tensor, ctx_bits: int) -> torch.Tensor:
    """Context of every (lane, t): previous byte of the lane, 0 at t=0."""
    if ctx_bits == 0:
        return torch.zeros_like(spans)
    prev = torch.cat([torch.zeros_like(spans[:, :1]), spans[:, :-1]], 1)
    return prev >> (8 - ctx_bits)


def _check(lit: torch.Tensor, k: int, ctx_bits: int, what: str) -> None:
    if lit.dtype != torch.uint8 or lit.dim() != 1:
        raise TypeError(f"{what}: lit must be 1-D uint8, got {lit.dtype} "
                        f"{tuple(lit.shape)}")
    if not lit.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")
    if k <= 0 or lit.shape[0] == 0 or lit.shape[0] % k:
        raise ValueError(f"{what}: {lit.shape[0]} bytes do not split into "
                         f"{k} lanes")
    if ctx_bits not in (0, 4, 6, 8):
        raise ValueError(f"{what}: ctx_bits {ctx_bits} not in 0/4/6/8")
    if lit.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {lit.device}")


def joint_histogram_reference(lit: torch.Tensor, n: int, ctx_bits: int,
                              srate: int, k: int) -> torch.Tensor:
    """Plain PyTorch K4."""
    spans = _lanes(lit, k)
    t_len = spans.shape[1]
    r = max(t_len // srate, 1)
    ctx = _contexts(spans, ctx_bits)[:, :r]
    sym = spans[:, :r]
    pos = torch.arange(k, device=lit.device)[:, None] * t_len + \
        torch.arange(r, device=lit.device)[None, :]
    idx = (ctx * 256 + sym)[pos < n]
    counts = torch.bincount(idx, minlength=(1 << ctx_bits) * 256)
    return counts.view(1 << ctx_bits, 256).to(torch.int32)


def joint_histogram(lit: torch.Tensor, n: int, ctx_bits: int, srate: int,
                    k: int) -> torch.Tensor:
    """K4 on the block's own device (see the module docstring)."""
    global hist_launches
    _check(lit, k, ctx_bits, "joint_histogram")
    if srate < 1:
        raise ValueError(f"joint_histogram: srate {srate} < 1")
    if lit.device.type == "cpu":
        return joint_histogram_reference(lit, n, ctx_bits, srate, k)
    t_len = lit.shape[0] // k
    counts = torch.empty((1 << ctx_bits, 256), dtype=torch.int32,
                         device=lit.device)
    _build.check(_build.library().lrzt_rans_hist(
        lit.data_ptr(), t_len, k, max(t_len // srate, 1), n, ctx_bits,
        counts.data_ptr(), _build.stream_ptr(lit.device)), "rans_hist")
    hist_launches += 1
    return counts


def packed_table(freqs: torch.Tensor) -> torch.Tensor:
    """(C, 256) frequencies -> int32 ``cum * M + (f - 1)`` per entry
    (< 2^24), the one table load K5 makes per symbol (the kernel builds it
    on the card in a first launch)."""
    f = freqs.to(torch.int64)
    cum = torch.cumsum(f, -1) - f
    return (cum * M + f - 1).to(torch.int32).contiguous()


def reciprocals(device) -> torch.Tensor:
    """(4096, 2) int32 table of K5's division, built on ``device``: row
    f - 1 holds the low 32 bits of ``R = ceil(2^64 / f)`` and R's high 32
    bits less one (uint32 bit patterns), so that f = 1 (R = 2^64) fits."""
    f = torch.arange(1, M + 1, dtype=torch.int64, device=device)
    # floor((2^64 - 1) / f) = q_hi * 2^32 + q_lo, by 32-bit long division
    q_hi = _U32 // f
    q_lo = (((_U32 % f) << 32) | _U32) // f
    lo = q_lo + 1                       # R = floor((2^64 - 1) / f) + 1
    hi = q_hi + (lo >> 32)
    return _to_i32(torch.stack([lo & _U32, hi - 1], 1)).contiguous()


def divide_by_reciprocal(x: torch.Tensor, f: torch.Tensor,
                         rcp: torch.Tensor):
    """``(x // f, x % f)`` as K5 computes them, for int64 tensors with
    ``0 <= x < f * 2^20`` and ``1 <= f <= 4096``: ``q = (x * R) >> 64``
    with R from ``reciprocals``, taken as the kernel takes it,
    ``(x * (hi - 1) + x + umulhi(x, lo)) >> 32``; every product here stays
    below 2^63 in that range."""
    r = rcp[f - 1].to(torch.int64) & _U32
    lo, hi1 = r[..., 0], r[..., 1]
    # umulhi(x, lo) = (x * lo) >> 32, in 16-bit halves of lo
    p = (x * (lo >> 16) + ((x * (lo & 0xFFFF)) >> 16)) >> 16
    q = (x * hi1 + x + p) >> 32
    return q, x - q * f


def encode_scan_reference(lit: torch.Tensor, n: int, freqs: torch.Tensor,
                          ctx_bits: int, k: int):
    """Plain PyTorch K5: a Python loop over the T span positions on (K,)
    vectors, uint32 values held in int64 and masked, dividing as the
    kernel does (``divide_by_reciprocal``)."""
    spans = _lanes(lit, k)
    t_len = spans.shape[1]
    idx_all = _contexts(spans, ctx_bits) * 256 + spans
    tab = packed_table(freqs).to(torch.int64).reshape(-1)
    rcp = reciprocals(lit.device)
    base = torch.arange(k, device=lit.device) * t_len
    x = torch.full((k,), L_INIT, dtype=torch.int64, device=lit.device)
    plane = torch.empty((t_len, k), dtype=torch.int32, device=lit.device)
    for t in range(t_len - 1, -1, -1):
        v = tab[idx_all[:, t]]
        f = (v & (M - 1)) + 1
        cs = v >> M_BITS
        valid = base + t < n
        e = valid & (x >= ((f << 20) & _U32))
        x1 = torch.where(e, x >> 16, x)
        q, rem = divide_by_reciprocal(x1, f, rcp)
        x2 = (q * M + cs + rem) & _U32
        plane[t] = (torch.where(e, x & 0xFFFF, 0)
                    | (e.to(torch.int64) << 16)).to(torch.int32)
        x = torch.where(valid, x2, x1)
    return _to_i32(x), plane


def encode_scan(lit: torch.Tensor, n: int, freqs: torch.Tensor,
                ctx_bits: int, k: int):
    """K5 on the block's own device (see the module docstring)."""
    global encode_launches
    _check(lit, k, ctx_bits, "encode_scan")
    c = 1 << ctx_bits
    if freqs.dtype != torch.int32 or tuple(freqs.shape) != (c, 256):
        raise TypeError(f"encode_scan: freqs must be int32 ({c}, 256), got "
                        f"{freqs.dtype} {tuple(freqs.shape)}")
    if freqs.device != lit.device:
        raise ValueError("encode_scan: tensors on different devices")
    if lit.device.type == "cpu":
        return encode_scan_reference(lit, n, freqs, ctx_bits, k)
    t_len = lit.shape[0] // k
    freqs = freqs.contiguous()
    tab = torch.empty((c, 256), dtype=torch.int32, device=lit.device)
    rcp = _device_reciprocals(lit.device)
    states = torch.empty(k, dtype=torch.int32, device=lit.device)
    plane = torch.empty((t_len, k), dtype=torch.int32, device=lit.device)
    lib = _build.library()
    _build.check(lib.lrzt_rans_encode(
        lit.data_ptr(), t_len, k, n, ctx_bits, freqs.data_ptr(),
        tab.data_ptr(), rcp.data_ptr(), states.data_ptr(), plane.data_ptr(),
        _build.stream_ptr(lit.device)), "rans_encode")
    encode_launches += 1
    return states, plane


_rcp_cache = {}


def _device_reciprocals(device) -> torch.Tensor:
    """``reciprocals`` on a CUDA device, built there once per device (the
    table depends on nothing but M)."""
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _rcp_cache:
        _rcp_cache[key] = reciprocals(torch.device("cuda", key))
    return _rcp_cache[key]


def cum_table(freqs: torch.Tensor) -> torch.Tensor:
    """(C, 256) frequencies -> (C, 257) int16 cumulative table: entry s
    is the sum of the row's first s frequencies (the last is M), the
    table K7 searches (each CTA of the kernel builds it in shared memory
    from the frequencies)."""
    cum = torch.cumsum(freqs.to(torch.int64), -1)
    zero = torch.zeros_like(cum[:, :1])
    return torch.cat([zero, cum], 1).to(torch.int16).contiguous()


def decode_scan_reference(words: torch.Tensor, states: torch.Tensor,
                          freqs: torch.Tensor, n: int, ctx_bits: int,
                          t_len: int):
    """Plain PyTorch K7: a Python loop over the T span positions on (K,)
    vectors, uint32 values held in int64 and masked.  The symbol search
    is one ``searchsorted`` in the table of all contexts laid end to end
    (row c offset by c * M, so the whole table ascends)."""
    dev = words.device
    k = states.shape[0]
    nw = words.shape[0]
    # one zero behind the stream: every read past the end lands there
    w = torch.cat([words.to(torch.int64) & 0xFFFF,
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    f = freqs.to(torch.int64)
    cum = torch.cumsum(f, -1) - f
    c_ctx = f.shape[0]
    flat = (cum + M * torch.arange(c_ctx, device=dev)[:, None]).reshape(-1)
    f_flat = f.reshape(-1)
    cum_flat = cum.reshape(-1)
    base = torch.arange(k, device=dev) * t_len
    x = states.to(torch.int64) & _U32
    cq = torch.zeros(k, dtype=torch.int64, device=dev)
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    out = torch.zeros((k, t_len), dtype=torch.uint8, device=dev)
    for t in range(t_len):
        valid = base + t < n
        slot = x & (M - 1)
        pos = torch.searchsorted(flat, cq * M + slot, right=True) - 1
        s = pos - cq * 256
        x2 = (f_flat[pos] * (x >> M_BITS) + slot - cum_flat[pos]) & _U32
        e = valid & (x2 < L_INIT)
        ei = e.to(torch.int64)
        rank = torch.cumsum(ei, 0) - ei
        word = w[torch.clamp(ptr + rank, max=nw)]
        x3 = torch.where(e, ((x2 << 16) | word) & _U32, x2)
        x = torch.where(valid, x3, x)
        if ctx_bits:
            cq = torch.where(valid, s >> (8 - ctx_bits), cq)
        ptr = ptr + ei.sum()
        out[:, t] = torch.where(valid, s, 0).to(torch.uint8)
    return out.reshape(-1), _to_i32(x)


def decode_scan(words: torch.Tensor, states: torch.Tensor,
                freqs: torch.Tensor, n: int, ctx_bits: int, t_len: int):
    """K7 on the tensors' own device (see the module docstring).

    ``words``: (n_words,) int16 holding the uint16 words; ``states``:
    (K,) int32 holding the uint32 states, K a power of two from 64 to
    16384; ``freqs``: (C, 256) int32, every row summing to 4096 with
    every entry >= 1 (the caller checks: a row that does not is searched
    all the same, without a read outside the table)."""
    global decode_launches
    k = states.shape[0]
    c = 1 << ctx_bits if ctx_bits in (0, 4, 6, 8) else -1
    if c < 0:
        raise ValueError(f"decode_scan: ctx_bits {ctx_bits} not in 0/4/6/8")
    if words.dtype != torch.int16 or words.dim() != 1:
        raise TypeError(f"decode_scan: words must be 1-D int16, got "
                        f"{words.dtype} {tuple(words.shape)}")
    if states.dtype != torch.int32 or states.dim() != 1:
        raise TypeError(f"decode_scan: states must be 1-D int32, got "
                        f"{states.dtype} {tuple(states.shape)}")
    if freqs.dtype != torch.int32 or tuple(freqs.shape) != (c, 256):
        raise TypeError(f"decode_scan: freqs must be int32 ({c}, 256), got "
                        f"{freqs.dtype} {tuple(freqs.shape)}")
    if k < 64 or k > 16384 or k & (k - 1):
        raise ValueError(f"decode_scan: {k} lanes, not a power of two in "
                         "64..16384")
    if t_len < 1 or n < 0 or n > k * t_len:
        raise ValueError(f"decode_scan: n {n} does not fit {k} lanes of "
                         f"{t_len}")
    if not (words.device == states.device == freqs.device):
        raise ValueError("decode_scan: tensors on different devices")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_scan: unsupported device {words.device}")
    if not (words.is_contiguous() and states.is_contiguous()
            and freqs.is_contiguous()):
        raise ValueError("decode_scan needs contiguous tensors")
    if words.device.type == "cpu":
        return decode_scan_reference(words, states, freqs, n, ctx_bits,
                                     t_len)
    ctas = decode_cluster(k, ctx_bits, words.device)
    plane = torch.empty(k * t_len, dtype=torch.uint8, device=words.device)
    xf = torch.empty(k, dtype=torch.int32, device=words.device)
    lib = _build.library()
    _build.check(lib.lrzt_rans_decode(
        words.data_ptr(), words.shape[0], states.data_ptr(), freqs.data_ptr(),
        n, ctx_bits, t_len, k, ctas, plane.data_ptr(), xf.data_ptr(),
        _build.stream_ptr(words.device)), "rans_decode")
    decode_launches += 1
    return plane, xf


_cluster_cache = {}


def decode_cluster(k: int, ctx_bits: int, device=None) -> int:
    """The cluster size C that K7 takes for ``k`` lanes on a CUDA device:
    1 for K <= 1024 (one CTA of K threads); K / 1024 (one lane a thread)
    where that many CTAs of 1024 threads with the table in shared memory
    can be resident at once; else 8 (two lanes a thread) at K = 16384.
    Raises ``RuntimeError`` where no such cluster can be scheduled: there is
    no single-CTA K7 for K > 1024."""
    device = torch.device("cuda") if device is None else device
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (index, k, ctx_bits)
    if key not in _cluster_cache:
        ctas = ctypes.c_int(0)
        _build.check(_build.library().lrzt_rans_decode_cluster(
            k, ctx_bits, ctypes.byref(ctas)), "rans_decode_cluster")
        if ctas.value == 0:
            raise RuntimeError(
                f"decode_scan: no thread-block cluster for {k} lanes at "
                f"ctx_bits {ctx_bits} can be resident on "
                f"{torch.cuda.get_device_name(index)}")
        _cluster_cache[key] = ctas.value
    return _cluster_cache[key]
