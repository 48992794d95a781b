"""The decompositions of the redesigned K6 (emitted-word compaction) and K4
(sampled joint histogram), pinned down on the CPU against the JAX package.

- K6 (``csrc/streampack.cu`` ``pack_plane_kernel``): ``_k6_emulated``
  follows the one-pass kernel: tiles of 16384 int32 elements cut at
  16-byte boundaries of the plane's address (``head`` 0-3 elements early),
  a warp's 2048 elements as sixteen 16-byte vectors a lane, the exclusive
  prefix by tile through ``lookback.cuh``'s look-back, each warp's kept
  words ranked round by round by four ballots into a shared run that
  starts at ``excl & 7``, the run stored clipped at ``cap`` in 16-byte
  vectors, and the zero tail split into the shares whose tickets come
  after the last tile's.  It is held against ``pack_plane_reference`` and
  the JAX package's ``pack_plane_pallas`` (interpret mode), and every
  output word must be written exactly once.
- K4 (``csrc/rans_hist.cu`` ``hist_kernel``): ``_k4_emulated`` follows
  the kernel's walk: a work item a 16-byte vector of a lane's samples on
  the lane's 16-byte address grid (byte reads at an unaligned head or a
  short tail), the context carried from the previous byte (one byte read
  at an item's start, 0 at t = 0), the grid the C entry sizes and its
  grid-stride share of items a CTA, each CTA's own copy of the table in
  16-bit counters (two a word, none may overflow), and the flush (adds of
  the nonzero cells into the zeroed output).
  It is held against ``joint_histogram_reference`` and the JAX package's
  ``joint_histogram_pallas`` (interpret mode).

The kernels are integer arithmetic and data movement, so every comparison
is exact (tolerance 0).  The tile, thread and sample constants are read
from the CUDA sources, so the emulations follow them.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu.ops.rans_pallas import joint_histogram_pallas
from lrzip_next_tpu.ops.streampack import pack_plane_pallas
from lrzip_next_tpu_torch.ops import rans_kernels as RK
from lrzip_next_tpu_torch.ops import streampack as SP

from test_torch_k1k3_redesign import _flags, _look_back_emulated

_CSRC = Path(SP.__file__).resolve().parent / "csrc"


def _constant(src: str, name: str, after: str = "") -> int:
    text = (_CSRC / src).read_text()
    text = text[text.index(after):] if after else text
    return int(re.search(rf"constexpr int(?:64_t)? {name} = (\d+);",
                         text).group(1))


TILE6 = _constant("streampack.cu", "kTile", "namespace k6")
THREADS6 = _constant("streampack.cu", "kThreads", "namespace k6")
ZERO_SHARE6 = _constant("streampack.cu", "kZeroShare", "namespace k6")
MAX_ZERO_SHARES6 = _constant("streampack.cu", "kMaxZeroShares",
                             "namespace k6")
WARPS6 = THREADS6 // 32
SEG6 = TILE6 // WARPS6
VECS6 = SEG6 // 128
THREADS4 = _constant("rans_hist.cu", "kThreads")
MAX_SAMPLES = _constant("rans_hist.cu", "kMaxSamples")
MAX_CTAS4 = _constant("rans_hist.cu", "kMaxCtas")
MAX_ITEMS4 = _constant("rans_hist.cu", "kMaxItems")


def test_constants_are_the_sources():
    assert (TILE6, THREADS6, ZERO_SHARE6, MAX_ZERO_SHARES6) == \
        (16384, 256, 16384, 256)
    assert (SEG6, VECS6) == (2048, 16)
    assert (THREADS4, MAX_SAMPLES, MAX_CTAS4, MAX_ITEMS4) == \
        (512, 65535, 128, 7)
    assert MAX_ITEMS4 * THREADS4 * 16 <= MAX_SAMPLES


# --- K6 ---------------------------------------------------------------------

def _load(plane: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The elements at idx, 0 outside [0, len(plane))."""
    inside = (idx >= 0) & (idx < len(plane))
    return np.where(inside, plane[np.clip(idx, 0, len(plane) - 1)], 0
                    ).astype(np.int32)


def _popc(x: int) -> int:
    return bin(x).count("1")


def _k6_emulated(plane: np.ndarray, cap: int, head: int, seed: int = 0):
    m = len(plane)
    tiles = -(-(head + m) // TILE6)
    out = np.full(cap, 0xBEEF, np.uint16)        # torch.empty's garbage
    writes = np.zeros(cap, np.int64)
    regs, counts = [], []
    for tile in range(tiles):
        base = tile * TILE6 - head
        # v[warp, h, lane] = the lane's h-th 16-byte vector, elements
        # base + SEG6 warp + 128 h + 4 lane + [0, 4)
        v = _load(plane, base + np.arange(TILE6)).reshape(WARPS6, VECS6,
                                                          32, 4)
        regs.append(v)
        counts.append(int(((v >> 16) & 1).sum()))
    # the look-back: descriptors published as aggregates, some (seeded)
    # as inclusive prefixes, tile 0 always a prefix
    incl = np.cumsum(counts)
    rng = np.random.default_rng(seed)
    status = np.where(rng.random(tiles) < 0.3, 2, 1)
    status[0] = 2
    value = np.where(status == 2, incl, counts)
    for tile in range(tiles):
        v = regs[tile]
        agg = counts[tile]
        excl = _look_back_emulated(status, value, tile)
        assert excl == incl[tile] - agg
        shift = excl % 8
        s_out = np.full(TILE6 + 8, 0xABCD, np.uint16)
        flags = (v >> 16) & 1
        wcnt = flags.reshape(WARPS6, -1).sum(1)
        woff = np.concatenate([[0], np.cumsum(wcnt)[:-1]])
        for w in range(WARPS6):
            if wcnt[w] == 0:
                continue
            o = shift + int(woff[w])
            for h in range(VECS6):
                f = flags[w, h]                      # (32 lanes, 4)
                ballots = [sum(int(f[lane, j]) << lane for lane in range(32))
                           for j in range(4)]
                for lane in range(32):
                    below = (1 << lane) - 1
                    at = o + sum(_popc(b & below) for b in ballots)
                    for j in range(4):
                        if f[lane, j]:
                            s_out[at] = v[w, h, lane, j] & 0xFFFF
                            at += 1
                o += sum(_popc(b) for b in ballots)
        lo, hi = excl, min(excl + agg, cap)
        if lo >= hi:
            continue
        g0 = lo - shift
        assert g0 % 8 == 0
        for q in range(-(-(hi - g0) // 8)):
            for j in range(8):
                g = g0 + 8 * q + j
                if lo <= g < hi:
                    out[g] = s_out[8 * q + j]
                    writes[g] += 1
    total = int(incl[-1])
    shares = min(max(-(-cap // ZERO_SHARE6), 1), MAX_ZERO_SHARES6)
    lo = min(total, cap)
    share = (-(-(cap - lo) // shares) + 7) // 8 * 8
    for z in range(shares):
        a = lo + z * share
        b = min(a + share, cap)
        if a < b:
            out[a:b] = 0
            writes[a:b] += 1
    assert (writes == 1).all(), "an output word is written not exactly once"
    return out, total


def _plane(m: int, kind: str, seed: int) -> np.ndarray:
    """K5's fused plane: word | 1 << 16 at a flag, 0 elsewhere."""
    rng = np.random.default_rng(seed)
    flags = _flags(kind, m, rng)
    words = rng.integers(0, 1 << 16, m, dtype=np.int64)
    return np.where(flags, words | (1 << 16), 0).astype(np.int32)


def _k6_case(m: int, kind: str, cap_of, head: int, seed: int,
             pallas: bool = False) -> None:
    plane = _plane(m, kind, seed)
    n = int(((plane >> 16) & 1).sum())
    cap = cap_of(m, n)
    got, total = _k6_emulated(plane, cap, head, seed)
    assert total == n
    ref, ref_n = SP.pack_plane_reference(torch.from_numpy(plane), cap)
    assert int(ref_n) == n
    assert np.array_equal(got, ref.numpy().view(np.uint16))
    if pallas:
        pal, pal_n = pack_plane_pallas(jnp.asarray(plane), cap,
                                       interpret=True)
        assert int(pal_n) == n
        assert np.array_equal(got, np.asarray(pal).astype(np.uint16))


_CAPS = {"below": lambda m, n: max(n // 3, 1), "at": lambda m, n: n,
         "above": lambda m, n: m + 40_000}


@pytest.mark.parametrize("cap", sorted(_CAPS))
@pytest.mark.parametrize("kind", ["none", "all", "last", "runs", "sparse"])
def test_k6_emulation_equals_reference(kind, cap):
    """Three tiles and a ragged tail; cap below, at and above the count
    (the zero tail then spans two shares)."""
    _k6_case(3 * TILE6 + 1_001, kind, _CAPS[cap], 0, len(kind) + len(cap))


@pytest.mark.parametrize("head", [1, 2, 3])
@pytest.mark.parametrize("kind", ["runs", "sparse"])
def test_k6_emulation_at_an_unaligned_head(kind, head):
    """A plane that is a view 4, 8 or 12 bytes past alignment: tiles cut
    ``head`` elements early, the head and tail vectors read element by
    element."""
    _k6_case(2 * TILE6 + 333, kind, _CAPS["above"], head, head)


@pytest.mark.parametrize("kind", ["runs", "sparse", "none"])
def test_k6_emulation_equals_pallas(kind):
    _k6_case(20_000, kind, lambda m, n: m, 0, 3, pallas=True)


def test_k6_emulation_zero_tail_over_many_blocks():
    """An all-clear plane under a cap of many zero shares: the whole
    stream is the zero tail, split over several tickets."""
    _k6_case(5_000, "none", lambda m, n: 5 * ZERO_SHARE6 + 3, 0, 1)


def test_k6_emulation_count_crosses_tiles_at_odd_offsets():
    """Tiles whose counts leave every excl & 7 from 0 to 7 among them, so
    that the shared run starts at each place of a 16-byte group."""
    rng = np.random.default_rng(77)
    m = 9 * TILE6 + 5
    plane = _plane(m, "sparse", 77)
    for t in range(9):     # one more or fewer flag a tile, seeded
        i = t * TILE6 + int(rng.integers(0, TILE6))
        plane[i] = 0 if plane[i] else (1 << 16) | t
    counts = [int(((plane[t * TILE6:(t + 1) * TILE6] >> 16) & 1).sum())
              for t in range(10)]
    excl = np.concatenate([[0], np.cumsum(counts)[:-1]])
    assert len(set(int(e) % 8 for e in excl)) >= 5
    n = int(((plane >> 16) & 1).sum())
    got, total = _k6_emulated(plane, n + 9, 0)
    ref, _ = SP.pack_plane_reference(torch.from_numpy(plane), n + 9)
    assert total == n and np.array_equal(got, ref.numpy().view(np.uint16))


# --- K4 ---------------------------------------------------------------------

def _k4_grid(k: int, t_len: int, srate: int, addr: int = 0):
    """(vectors a lane, work items, CTAs) as the C entry sizes them:
    a thread a vector, at most ``kMaxCtas`` CTAs unless a thread would
    take more than ``kMaxItems`` vectors.  ``addr``: the block's address
    mod 16."""
    r = max(t_len // srate, 1)
    head = addr if t_len % 16 == 0 else 15
    vecs = (head + r + 15) // 16
    items = k * vecs
    ctas = max(min(-(-items // THREADS4), MAX_CTAS4),
               -(-items // (THREADS4 * MAX_ITEMS4)))
    return vecs, items, ctas


def _k4_emulated(lit: np.ndarray, n: int, ctx_bits: int, srate: int, k: int,
                 addr: int = 0) -> np.ndarray:
    """``addr``: the block's address mod 16."""
    t_len = len(lit) // k
    r = max(t_len // srate, 1)
    cells = 256 << ctx_bits
    words = cells // 2
    vecs, items, ctas = _k4_grid(k, t_len, srate, addr)
    # no CTA's table takes 2^16 samples
    per_thread = -(-items // (ctas * THREADS4))
    assert per_thread * THREADS4 * 16 <= MAX_SAMPLES
    i = np.arange(items, dtype=np.int64)
    lane = i // vecs
    lane0 = lane * t_len
    t0 = 16 * (i - lane * vecs) - (addr + lane0) % 16
    lim = np.minimum(n - lane0, r)
    live = t0 < lim
    i, lane0, t0, lim = i[live], lane0[live], t0[live], lim[live]
    # each item's 16 samples and its first context (one byte read at its
    # start, 0 where it starts at or before t = 0)
    t = t0[:, None] + np.arange(16)[None, :]
    valid = (t >= 0) & (t < lim[:, None])
    full = (t0 >= 0) & (t0 + 16 <= lim)
    assert (valid.all(1) == full).all()     # the 16-byte loads
    sym = np.where(valid, lit[np.clip(lane0[:, None] + t, 0,
                                      len(lit) - 1)], 0).astype(np.int64)
    first = np.where(t0 > 0, lit[np.clip(lane0 + t0 - 1, 0, None)], 0)
    prev = np.concatenate([first[:, None], sym[:, :-1]], 1)
    cell = ((prev >> (8 - ctx_bits)) << 8) | sym
    # the CTA of an item under the grid-stride loop counts it into its own
    # copy of the table: cell c in half c & 1 of word c >> 1
    block = np.broadcast_to(((i // THREADS4) % ctas)[:, None], sym.shape)
    tables = np.zeros((ctas, words), np.int64)
    np.add.at(tables, (block[valid], cell[valid] >> 1),
              1 << (16 * (cell[valid] & 1)))
    lo, hi = tables & 0xFFFF, tables >> 16
    assert (hi < 1 << 16).all()             # no counter overflowed
    # flush: word q of each CTA's copy added to cells 2q and 2q + 1 of
    # the zeroed output
    out = np.stack([lo, hi], 2).reshape(ctas, cells).sum(0)
    return out.reshape(1 << ctx_bits, 256).astype(np.int32)


def _k4_case(lit: np.ndarray, n: int, ctx_bits: int, srate: int, k: int,
             addr: int = 0, pallas: bool = True) -> None:
    t_len = len(lit) // k
    got = _k4_emulated(lit, n, ctx_bits, srate, k, addr)
    ref = RK.joint_histogram_reference(torch.from_numpy(lit), n, ctx_bits,
                                       srate, k).numpy()
    assert np.array_equal(got, ref)
    r = max(t_len // srate, 1)
    assert int(got.sum()) == sum(min(max(n - lane * t_len, 0), r)
                                 for lane in range(k))
    if pallas:
        s8 = jnp.asarray(lit.reshape(k, t_len).T)
        pal = joint_histogram_pallas(s8, n, ctx_bits, srate, interpret=True)
        assert np.array_equal(got, np.asarray(pal))


def _text_lanes(k: int, t_len: int, seed: int) -> np.ndarray:
    """Text-like lanes: lowercase letters and spaces, a few other bytes."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"etaoin shrdlucmfwyp,.\n", np.uint8)
    p = 1.0 / np.arange(1, len(alphabet) + 1)
    return rng.choice(alphabet, k * t_len, p=p / p.sum()).astype(np.uint8)


# (T, srate) giving r = 1, 15, 16, 17, 64 and T; 75 and 85 are not
# multiples of 16, so every lane starts at another place of its group
_R_CASES = {"r1": (80, 80), "r15": (75, 5), "r16": (80, 5), "r17": (85, 5),
            "r64": (128, 2), "rT": (80, 1)}


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
@pytest.mark.parametrize("rcase", sorted(_R_CASES))
def test_k4_emulation_equals_reference_and_pallas(rcase, ctx_bits):
    """n cuts inside a lane's samples."""
    t_len, srate = _R_CASES[rcase]
    k = 96
    lit = _text_lanes(k, t_len, t_len + ctx_bits)
    r = max(t_len // srate, 1)
    n = 37 * t_len + (r + 1) // 2
    _k4_case(lit, n, ctx_bits, srate, k)


# lanes of T = 80 at srate 2 (three vectors a lane) that the C entry
# spreads over 1, 2, 3 and 7 CTAs
_GRID_LANES = {1: 150, 2: 200, 3: 400, 7: 1100}


@pytest.mark.parametrize("ctas", [1, 2, 3, 7])
@pytest.mark.parametrize("ctx_bits", [6, 8])
def test_k4_emulation_every_grid(ctx_bits, ctas):
    """Grids of one CTA and of several, the items spread over them by the
    grid-stride loop, each CTA's nonzero cells added into the zeroed
    output."""
    k, t_len = _GRID_LANES[ctas], 80
    assert _k4_grid(k, t_len, 2)[2] == ctas
    lit = np.random.default_rng(ctas).integers(0, 256, k * t_len,
                                               dtype=np.uint8)
    _k4_case(lit, k * t_len - 3, ctx_bits, 2, k, pallas=False)


@pytest.mark.parametrize("addr", [1, 7, 15])
def test_k4_emulation_at_an_unaligned_block(addr):
    """A block that starts ``addr`` bytes past a 16-byte boundary: every
    lane's head is read byte by byte."""
    k, t_len = 64, 128
    _k4_case(_text_lanes(k, t_len, addr), k * t_len - 5, 6, 2, k,
             addr=addr, pallas=False)


@pytest.mark.parametrize("ctx_bits", [6, 8])
def test_k4_emulation_one_symbol(ctx_bits):
    """Every sample on one cell (after t = 0): all atomics of a CTA on one
    16-bit counter."""
    k, t_len = 128, 64
    lit = np.full(k * t_len, 0x61, np.uint8)
    _k4_case(lit, k * t_len, ctx_bits, 1, k)
    got = _k4_emulated(lit, k * t_len, ctx_bits, 1, k)
    assert int(got[0x61 >> (8 - ctx_bits), 0x61]) == k * (t_len - 1)
    assert int(got[0, 0x61]) == (k if ctx_bits else k * t_len)


@pytest.mark.parametrize("ctx_bits", [0, 8])
def test_k4_emulation_full_alphabet(ctx_bits):
    """All 256 symbols behind every context row: every cell nonzero at
    ctx_bits 0, both halves of every word in use."""
    k, t_len = 256, 256
    lit = np.random.default_rng(5).permutation(
        np.tile(np.arange(256, dtype=np.uint8), k))
    _k4_case(lit, k * t_len, ctx_bits, 1, k)
    got = _k4_emulated(lit, k * t_len, ctx_bits, 1, k)
    assert (got.sum(0) > 0).all()


def test_k4_emulation_main_path_grid():
    """The main path's shape cut in lanes (K = 1024 of T = 1280, r = 64 at
    srate 20): the default grid, every item one aligned 16-byte load."""
    k, t_len, srate = 1024, 1280, 20
    assert _k4_grid(k, t_len, srate)[2] <= MAX_CTAS4
    assert _k4_grid(16384, t_len, srate)[2] == MAX_CTAS4
    lit = _text_lanes(k, t_len, 9)
    _k4_case(lit, k * t_len - 1000, 6, srate, k, pallas=False)


@pytest.mark.parametrize("k,t_len,srate", [(16384, 1280, 1),
                                           (16384, 32768, 16),
                                           (2048, 2048, 1)])
def test_k4_grid_keeps_every_table_below_2_to_the_16(k, t_len, srate):
    """The C entry grows the grid past kMaxCtas where a CTA would take
    2^16 samples: no 16-bit counter can overflow at any shape or
    alignment."""
    for addr in (0, 15):
        _, items, ctas = _k4_grid(k, t_len, srate, addr)
        assert ctas >= MAX_CTAS4
        assert -(-items // (ctas * THREADS4)) * THREADS4 * 16 <= MAX_SAMPLES
