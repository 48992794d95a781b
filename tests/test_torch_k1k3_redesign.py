"""The decompositions of the redesigned K1 (anchor fingerprints) and K3
(literal compaction), pinned down on the CPU against the JAX package.

- K1 (``csrc/anchor_fps.cu``): ``_k1_emulated`` follows the card kernel's
  index arithmetic: spans of 8192 hashed positions cut ``head`` bytes
  early, of which the middle 8160 are written; 32 consecutive positions a
  thread with the four tree levels rolled over the thread's 63 bytes; the
  window minimum as a forward minimum over h + 1 positions by doubling,
  over the thread's fingerprints and h more read from the neighbouring
  threads' rows; the CPU branch's edge rule.  It is held bit-equal to
  ``anchor_fps_reference`` and to the JAX package's CPU branch of
  ``_anchor_candidates_fporder``, and every position must be written
  exactly once.
- The look-back of ``csrc/lookback.cuh`` (32 predecessors a round, one a
  lane): ``_look_back_emulated`` sums back to the nearest prefix.
- K3 (``csrc/streampack.cu`` ``pack_bytes_kernel``): ``_k3_emulated``
  follows the one-pass kernel: tiles of 8192 flags cut at 16-byte
  boundaries of the flags' address, value vectors read only where their
  flags hold a set byte (the others stay garbage), the exclusive prefix by
  tile, each tile's run placed at its offset's place in a 16-byte group
  and stored clipped at ``cap``, and the zero tail split into the shares
  whose tickets come after the last tile's.  It is held against
  ``pack_stream_reference`` and the JAX package's ``pack_stream_pallas``
  (interpret mode), and every output byte must be written exactly once.

The kernels are integer arithmetic and data movement, so every comparison
is exact (tolerance 0).  The tile constants are read from the CUDA
sources, so the emulations follow them.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu.ops.streampack import pack_stream_pallas
from lrzip_next_tpu_torch.ops import anchor as A
from lrzip_next_tpu_torch.ops import streampack as SP

from test_torch_anchor import _cpu_branch, _repeating

_CSRC = Path(A.__file__).resolve().parent / "csrc"
BIG = 0x7FFFFFFF
_M = [np.uint32(m) for m in A._M1]


def _constant(src: str, name: str, after: str = "") -> int:
    text = (_CSRC / src).read_text()
    text = text[text.index(after):] if after else text
    return int(re.search(rf"constexpr int(?:64_t)? {name} = (\d+);",
                         text).group(1))


P = _constant("anchor_fps.cu", "kP")
THREADS = _constant("anchor_fps.cu", "kThreads")
MAXH = _constant("anchor_fps.cu", "kMaxH")
SPAN = THREADS * P
TILE1 = SPAN - 2 * MAXH
STAGE = SPAN + 32
TILE3 = _constant("streampack.cu", "kTile", "namespace k3")
ZERO_SHARE = _constant("streampack.cu", "kZeroShare")
MAX_ZERO_SHARES = _constant("streampack.cu", "kMaxZeroShares")


def test_constants_are_the_sources():
    assert (P, THREADS, MAXH, TILE1, STAGE) == (32, 256, 16, 8160, 8224)
    assert (TILE3, ZERO_SHARE, MAX_ZERO_SHARES) == (8192, 32768, 256)


# --- K1 ---------------------------------------------------------------------

def _forward_min(g: np.ndarray, w: int) -> None:
    """The kernel's ``forward_min``: g[:, k] = min(g[:, k : k+w]), in place,
    by doubling (the right-hand sides are read before the assignment, as
    the kernel's ascending in-place loop reads them)."""
    n = g.shape[1]
    levels = w.bit_length() - 1
    for e in range(levels):
        step = 1 << e
        g[:, :n - 2 * step + 1] = np.minimum(g[:, :n - 2 * step + 1],
                                             g[:, step:n - step + 1])
    top = 1 << levels
    if top < w:
        g[:, :n - w + 1] = np.minimum(g[:, :n - w + 1],
                                      g[:, w - top:n - top + 1])


def _k1_emulated(data: np.ndarray, stride: int, ma: int, head: int):
    h = max(stride // 2, 1)
    nbytes = len(data)
    fpa = np.zeros(ma, np.int32)
    fpb = np.zeros(ma, np.int32)
    writes = np.zeros(ma, np.int64)
    t = np.arange(THREADS)
    for b in range(-(-(ma + head) // TILE1)):
        start = b * TILE1 - head
        q_lo = start - MAXH
        idx = q_lo + np.arange(STAGE)
        inside = (idx >= 0) & (idx < nbytes)
        stage = np.where(inside, data[np.clip(idx, 0, nbytes - 1)], 0
                         ).astype(np.uint32)
        a = stage[t[:, None] * P + np.arange(P + 31)[None, :]]
        for k in range(4):
            off = 1 << k
            a = a[:, :-off] * _M[k] + a[:, off:]
        lo_, hi_ = a[:, :P], a[:, 16:16 + P]
        q = (q_lo + P * t)[:, None] + np.arange(P)[None, :]
        va = np.where((q >= 0) & (q < ma), (lo_ * _M[4] + hi_).view(np.int32),
                      BIG).astype(np.int32)
        vb = (lo_ * (_M[4] ^ np.uint32(1)) + hi_).view(np.int32)
        big = np.full((1, h), BIG, np.int32)
        g = np.concatenate([np.concatenate([big, va[:-1, P - h:]]), va,
                            np.concatenate([va[1:, :h], big])], axis=1)
        _forward_min(g, h + 1)
        j = np.arange(P)
        m = np.where(q >= h, np.minimum(g[:, j], g[:, j + h]), g[:, j + h])
        masked = np.where(va == m, va, BIG)
        lo, hi = max(start, 0), min(start + TILE1, ma)
        p = np.arange(lo, hi)
        row, col = (p - q_lo) // P, (p - q_lo) % P
        fpa[p] = masked[row, col]
        fpb[p] = vb[row, col]
        writes[p] += 1
    assert (writes == 1).all(), "a position is written not exactly once"
    return fpa, fpb


def _ma(n: int, stride: int) -> int:
    return ((n - 31) // stride) * stride


def _k1_case(data: np.ndarray, stride: int, head: int = 0) -> None:
    ma = _ma(len(data), stride)
    got_a, got_b = _k1_emulated(data, stride, ma, head)
    ref_a, ref_b = A.anchor_fps_reference(torch.from_numpy(data), stride, ma)
    assert np.array_equal(got_a, ref_a.numpy())
    assert np.array_equal(got_b, ref_b.numpy())
    jax_a, jax_b = _cpu_branch(data, stride)
    assert np.array_equal(got_a, jax_a) and np.array_equal(got_b, jax_b)


_STRIDES = [2, 4, 8, 16, 32]


@pytest.mark.parametrize("layout", ["one_span", "seams", "exact_ma"])
@pytest.mark.parametrize("stride", _STRIDES)
def test_k1_emulation_equals_reference_and_jax(stride, layout):
    """one span (p < h and the window at ma in one block), three tile
    seams and a ragged tail, and ma + 31 == nbytes exactly."""
    n = {"one_span": 5_000, "seams": 3 * TILE1 + 1_234,
         "exact_ma": 2 * TILE1 + 31 + 7 * 32}[layout]
    data = _repeating(n, 17 * stride + len(layout))
    if layout == "exact_ma":
        assert _ma(n, stride) + 31 == n
    _k1_case(data, stride)


@pytest.mark.parametrize("head", [1, 3, 8, 15])
def test_k1_emulation_at_an_unaligned_head(head):
    """A slice such as x[1:]: the spans are cut ``head`` bytes early; the
    first block writes from position 0 and the seams move."""
    _k1_case(_repeating(2 * TILE1 + 999, head), 8, head)


@pytest.mark.parametrize("stride", [2, 32])
def test_k1_emulation_ties(stride):
    """All-equal bytes: every window holds one value, so every position is
    an anchor (ties keep the value)."""
    data = np.full(TILE1 + 500, 0x61, np.uint8)
    _k1_case(data, stride)
    fpa, _ = _k1_emulated(data, stride, _ma(len(data), stride), 0)
    assert (fpa != BIG).all()


def test_k1_emulation_signed_order():
    """Fingerprints on both sides of 2^31: the minimum is the signed one."""
    data = np.concatenate([np.full(300, 255, np.uint8),
                           np.arange(256, dtype=np.uint8),
                           _repeating(TILE1, 5)])
    ma = _ma(len(data), 4)
    fpa, _ = _k1_emulated(data, 4, ma, 0)
    ref, _ = A.anchor_fps_reference(torch.from_numpy(data), 4, ma)
    assert np.array_equal(fpa, ref.numpy())
    assert (ref.numpy() < 0).any() and (ref.numpy()[ref.numpy() != BIG]
                                        > 0).any()


# --- K3 ---------------------------------------------------------------------

def _load16(src: np.ndarray, e: int) -> np.ndarray:
    """16 bytes from element e on, 0 outside [0, len(src))."""
    idx = e + np.arange(16)
    inside = (idx >= 0) & (idx < len(src))
    return np.where(inside, src[np.clip(idx, 0, len(src) - 1)], 0
                    ).astype(np.uint8)


def _k3_emulated(vals: np.ndarray, flags: np.ndarray, cap: int, head: int):
    m = len(vals)
    fl = flags.astype(np.uint8)
    tiles = -(-(head + m) // TILE3)
    out = np.full(cap, 0xEE, np.uint8)          # torch.empty's garbage
    writes = np.zeros(cap, np.int64)
    s_flags, s_vals, counts = [], [], []
    for tile in range(tiles):
        base = tile * TILE3 - head
        f = np.concatenate([_load16(fl, base + 16 * v)
                            for v in range(TILE3 // 16)])
        v = np.full(TILE3, 0xCD, np.uint8)       # values never loaded
        for g in range(TILE3 // 16):
            if f[16 * g:16 * g + 16].any():
                v[16 * g:16 * g + 16] = _load16(vals, base + 16 * g)
        s_flags.append(f)
        s_vals.append(v)
        counts.append(int(np.count_nonzero(f)))
    excl = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    total = int(sum(counts))
    for tile in range(tiles):
        f, v = s_flags[tile], s_vals[tile]
        shift = int(excl[tile] % 16)
        s_out = np.full(TILE3 + 16, 0xAB, np.uint8)
        warp_counts = f.reshape(8, -1).astype(bool).sum(1)
        warp_off = np.concatenate([[0], np.cumsum(warp_counts)[:-1]])
        for w in range(8):
            kept = v[w * 1024:(w + 1) * 1024][f[w * 1024:(w + 1) * 1024] != 0]
            o = shift + warp_off[w]
            s_out[o:o + len(kept)] = kept
        lo, hi = int(excl[tile]), min(int(excl[tile]) + counts[tile], cap)
        g0 = lo - shift
        assert g0 % 16 == 0
        for q in range(-(-(hi - g0) // 16) if hi > lo else 0):
            for jj in range(16):
                g = g0 + 16 * q + jj
                if lo <= g < hi:
                    out[g] = s_out[16 * q + jj]
                    writes[g] += 1
    shares = min(max(-(-cap // ZERO_SHARE), 1), MAX_ZERO_SHARES)
    lo = min(total, cap)
    share = (-(-(cap - lo) // shares) + 15) // 16 * 16
    for z in range(shares):
        a = lo + z * share
        b = min(a + share, cap)
        if a < b:
            out[a:b] = 0
            writes[a:b] += 1
    assert (writes == 1).all(), "an output byte is written not exactly once"
    return out, total


def _look_back_emulated(status: np.ndarray, value: np.ndarray,
                        tile: int) -> int:
    """lookback.cuh's ``look_back`` once every descriptor before ``tile``
    is set: rounds of 32 lanes, lane l reading tile - 1 - 32 * round - l
    (before tile 0 a prefix of 0), summed back to the nearest prefix."""
    excl, pred = 0, tile - 1
    while True:
        j = pred - np.arange(32)
        st = np.where(j >= 0, status[np.clip(j, 0, None)], 2)
        val = np.where(j >= 0, value[np.clip(j, 0, None)], 0)
        prefixes = np.flatnonzero(st == 2)
        if len(prefixes):
            return excl + int(val[:prefixes[0] + 1].sum())
        excl += int(val.sum())
        pred -= 32


@pytest.mark.parametrize("prefix_every", [1, 7, 100, 5_000])
def test_look_back_sums_back_to_the_nearest_prefix(prefix_every):
    """Descriptors of 3000 tiles, each an aggregate or (every
    ``prefix_every``-th on average, seeded) an inclusive prefix: the
    look-back gives every tile its exclusive prefix."""
    rng = np.random.default_rng(prefix_every)
    counts = rng.integers(0, 8193, 3000)
    incl = np.cumsum(counts)
    status = np.where(rng.random(3000) < 1 / prefix_every, 2, 1)
    value = np.where(status == 2, incl, counts)
    for tile in list(range(1, 80)) + list(rng.integers(80, 3000, 60)):
        assert _look_back_emulated(status, value, int(tile)) == \
            incl[tile] - counts[tile]


def _flags(kind: str, m: int, rng) -> np.ndarray:
    if kind == "none":
        return np.zeros(m, bool)
    if kind == "all":
        return np.ones(m, bool)
    if kind == "last":
        return np.arange(m) == m - 1
    if kind == "runs":
        # the literal mask's shape: runs of set and clear flags, 29% set
        lens = rng.geometric([1 / 40, 1 / 100] * (m // 70 + 2))
        on = np.repeat(np.arange(len(lens)) % 2 == 0, lens)
        return on[:m]
    return rng.random(m) < 0.3


def _k3_case(m: int, kind: str, cap_of, head: int, seed: int,
             pallas: bool = False) -> None:
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 256, m, dtype=np.uint8)
    flags = _flags(kind, m, rng)
    n = int(flags.sum())
    cap = cap_of(m, n)
    got, total = _k3_emulated(vals, flags, cap, head)
    assert total == n
    ref, ref_n = SP.pack_stream_reference(torch.from_numpy(vals),
                                          torch.from_numpy(flags), cap)
    assert int(ref_n) == n
    assert np.array_equal(got, ref.numpy())
    if pallas:
        pal, pal_n = pack_stream_pallas(jnp.asarray(vals), jnp.asarray(flags),
                                        cap, interpret=True)
        assert int(pal_n) == n
        assert np.array_equal(got, np.asarray(pal).astype(np.uint8))


_CAPS = {"below": lambda m, n: max(n // 3, 1), "at": lambda m, n: n,
         "above": lambda m, n: m + 40_000}


@pytest.mark.parametrize("cap", sorted(_CAPS))
@pytest.mark.parametrize("kind", ["none", "all", "last", "runs", "sparse"])
def test_k3_emulation_equals_reference(kind, cap):
    """Three tiles and a ragged tail; cap below, at and above the count
    (the zero tail then spans two shares)."""
    _k3_case(3 * TILE3 + 1_001, kind, _CAPS[cap], 0, len(kind) + len(cap))


@pytest.mark.parametrize("head", [1, 7, 15])
@pytest.mark.parametrize("kind", ["runs", "sparse"])
def test_k3_emulation_at_an_unaligned_head(kind, head):
    """Slices such as flags[1:]: tiles cut ``head`` bytes early, the head
    and tail vectors read byte by byte."""
    _k3_case(2 * TILE3 + 333, kind, _CAPS["above"], head, head)


@pytest.mark.parametrize("kind", ["runs", "sparse", "none"])
def test_k3_emulation_equals_pallas(kind):
    _k3_case(20_000, kind, lambda m, n: m + 77, 0, 3, pallas=True)


def test_k3_emulation_zero_tail_over_many_blocks():
    """An all-clear mask under a cap of many zero shares: the whole block
    is the zero tail, split over several tickets."""
    _k3_case(5_000, "none", lambda m, n: 5 * ZERO_SHARE + 3, 0, 1)
