"""The decomposition of the redesigned K9 (the dense matcher's two-mask run
compaction), pinned down on the CPU against the JAX package.

``_k9_emulated`` follows ``csrc/compact_masked.cu``'s one-pass kernel:
tiles of ``kTile`` elements cut at 16-byte boundaries of ``start``'s
address (``head`` bytes early), each lane's ``kLane`` consecutive
elements as ``kVecs`` aligned 16-byte vectors of ``start`` and the
``kVecs + 1`` aligned vectors of ``is_end`` that cover them at its own
offset, each vector's nonzero bytes turned into a 16-bit mask by the
kernel's bit trick, the two counts packed in one word through the warp
scan and the warps' offsets, the tile's pair of counts in one descriptor
(``lookback.cuh``'s ``pair``: status in the top 2 bits, two 31-bit
counts), the look-back run under seeded and adversarial schedules of the
blocks (tickets taken in shuffled orders, waits on unset descriptors,
look-backs over more than 32 predecessors), and each warp's scatter:
its j-th set flag of a mask to lane j % 32, found by ``warp_nth`` (a
search over the lanes' counts, then the bit of the lane's mask), and
stored at the warp's offset plus j.  Every output slot below a count must
be written exactly once.  It is held against
``compact_masked_reference``, the JAX package's ``compact_masked_pallas``
(interpret mode) and its ``matcher.compact_runs``.

The kernel is integer arithmetic and data movement, so every comparison
is exact (tolerance 0).  The constants are read from the CUDA sources, so
the emulation follows them.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu.ops import matcher as JM
from lrzip_next_tpu.ops.compact_pallas import compact_masked_pallas
from lrzip_next_tpu_torch.ops import compact as C
from lrzip_next_tpu_torch.ops import matcher as PM

_CSRC = Path(C.__file__).resolve().parent / "csrc"


def _constant(src: str, name: str) -> int:
    text = (_CSRC / src).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


THREADS = _constant("compact_masked.cu", "kThreads")
VECS = _constant("compact_masked.cu", "kVecs")
TILE = _constant("compact_masked.cu", "kTile")
PAIR_SHIFT = _constant("lookback.cuh", "kPairShift")
WARPS = THREADS // 32
LANE = 16 * VECS
SEG = 32 * LANE
PAIR_COUNT = (1 << PAIR_SHIFT) - 1
VALUE = (1 << 62) - 1
AGGREGATE, PREFIX = 1 << 62, 2 << 62


def test_constants_are_the_sources():
    assert (THREADS, VECS, TILE, PAIR_SHIFT) == (512, 4, 32768, 31)
    assert TILE == THREADS * LANE == WARPS * SEG
    assert LANE <= 64 and TILE < 1 << 16   # one 64-bit mask, 16-bit counts


def test_a_tile_of_set_ends_needs_an_unsigned_word():
    """The tile's two counts packed in one 32-bit word, start count low:
    a tile whose end flags are all set puts bit 31 on, so the word must be
    unsigned (as a signed int it would read negative and its high field
    would shift in ones)."""
    word = np.uint32(TILE) | np.uint32(TILE) << np.uint32(16)
    assert int(word) >= 1 << 31 and int(word >> np.uint32(16)) == TILE
    assert int(word.view(np.int32)) < 0


# --- the pieces -------------------------------------------------------------

def _byte_bits(words: np.ndarray) -> np.ndarray:
    """compact_masked.cu's byte_bits on (..., 4) uint32 words: bit j of the
    16-bit result set iff byte j of the 16 bytes is nonzero."""
    w = words.astype(np.uint64)
    t = (((w & 0x7F7F7F7F) + 0x7F7F7F7F) | w) & 0x80808080
    nib = ((((t >> 7) * 0x00204081) & 0xFFFFFFFF) >> 21) & 0xF
    return (nib << (4 * np.arange(4, dtype=np.uint64))).sum(-1)


def test_byte_bits_marks_exactly_the_nonzero_bytes():
    """Every word of bytes from {0, 1, 0x7F, 0x80, 0xFF}, in every lane of
    a vector."""
    vals = np.array([0, 1, 0x7F, 0x80, 0xFF], np.uint64)
    b = np.stack(np.meshgrid(vals, vals, vals, vals, indexing="ij"),
                 -1).reshape(-1, 4)
    words = (b << (8 * np.arange(4, dtype=np.uint64))).sum(-1)
    want_nib = ((b != 0) << np.arange(4)).sum(-1)
    for k in range(4):
        vec = np.zeros((len(words), 4), np.uint64)
        vec[:, k] = words
        assert np.array_equal(_byte_bits(vec), want_nib << (4 * k))


def _pair(first: int, second: int) -> int:
    return first | second << PAIR_SHIFT


def _add(a: int, b: int) -> int:
    return (a + b) & ((1 << 64) - 1)          # 64-bit registers


@pytest.mark.parametrize("tiles", [2, 33, 1000])
def test_pair_adds_without_a_carry_below_2_to_the_31(tiles):
    """Aggregates of 2^31 - 1 elements split over ``tiles`` tiles, each
    field summing to at most 2^31 - 1: the packed sums are the pairs of
    the sums, and a status set on top survives.  At 2^31 the first field
    would carry into the second, which is why the wrapper refuses
    2^31 elements."""
    rng = np.random.default_rng(tiles)
    m = (1 << 31) - 1
    for frac in (1.0, 0.5, 0.0):
        s = np.diff(np.concatenate([[0], np.sort(rng.integers(
            0, int(m * frac) + 1, tiles - 1)), [int(m * frac)]]))
        e = np.diff(np.concatenate([[0], np.sort(rng.integers(
            0, m + 1, tiles - 1)), [m]]))
        total = 0
        for a, b in zip(s, e):
            total = _add(total, _pair(int(a), int(b)))
            assert total <= VALUE
        assert total == _pair(int(s.sum()), int(e.sum()))
        assert total & PAIR_COUNT == s.sum() and total >> PAIR_SHIFT == m
        assert (PREFIX | total) >> 62 == 2 and (PREFIX | total) & VALUE \
            == total
    assert _add(_pair(PAIR_COUNT, 0), _pair(1, 0)) == _pair(0, 1)


# --- the look-back, block by block ------------------------------------------

def _block(tile: int, agg: int, desc: list, excl_out: dict, rounds: dict):
    """lookback.cuh's look_back_pair, one memory action between yields:
    publish the aggregate; rounds of 32 lanes reading the descriptors of
    tile - 1 - 32 * round - lane (before tile 0 a prefix of 0), spinning
    while any is unset, summing back to the nearest prefix; publish the
    inclusive prefix."""
    if tile == 0:
        desc[0] = PREFIX | agg
        excl_out[0], rounds[0] = 0, 0
        return
    desc[tile] = AGGREGATE | agg
    yield
    excl, pred, n = 0, tile - 1, 0
    while True:
        while True:
            d = [desc[j] if j >= 0 else PREFIX for j in range(pred,
                                                               pred - 32, -1)]
            if all(x >> 62 for x in d):
                break
            yield                               # spin
        n += 1
        status = [x >> 62 for x in d]
        if 2 in status:
            for x in d[:status.index(2) + 1]:
                excl = _add(excl, x & VALUE)
            break
        for x in d:
            excl = _add(excl, x & VALUE)
        pred -= 32
        yield
    desc[tile] = PREFIX | _add(excl, agg)
    excl_out[tile], rounds[tile] = excl, n


def _look_back(aggs: list, schedule: str, seed: int):
    """Every tile's exclusive pair and look-back rounds, the blocks run
    under ``schedule``: "random" (blocks take tickets in a seeded order of
    arrival and advance in seeded turns), "aggregates_first" (every block
    publishes its aggregate, then the highest ticket looks back first)
    or "in_order"."""
    tiles = len(aggs)
    desc = [0] * tiles
    excl, rounds = {}, {}
    blocks = [_block(t, a, desc, excl, rounds) for t, a in enumerate(aggs)]
    if schedule == "in_order":
        for b in blocks:
            for _ in b:
                pass
    elif schedule == "aggregates_first":
        live = [b for b in blocks if next(b, "done") != "done"]
        for b in reversed(live):
            for _ in b:
                pass
    else:
        rng = np.random.default_rng(seed)
        started, live = 0, []
        while started < tiles or live:
            # a block that arrives takes the next ticket: tickets go out
            # in arrival order, whatever order the blocks were launched in
            if started < tiles and (not live or rng.random() < 0.3):
                live.append(blocks[started])
                started += 1
            b = live[int(rng.integers(len(live)))]
            if next(b, "done") == "done":
                live.remove(b)
    return [excl[t] for t in range(tiles)], [rounds[t] for t in range(tiles)]


@pytest.mark.parametrize("tiles", [1, 2, 33, 70])
@pytest.mark.parametrize("schedule", ["random", "aggregates_first",
                                      "in_order"])
def test_look_back_pair_gives_every_tile_its_prefix(schedule, tiles):
    rng = np.random.default_rng(tiles)
    counts = rng.integers(0, TILE + 1, (tiles, 2))
    aggs = [_pair(int(a), int(b)) for a, b in counts]
    excl, rounds = _look_back(aggs, schedule, tiles)
    want = np.cumsum(counts, 0) - counts
    assert excl == [_pair(int(a), int(b)) for a, b in want]
    if schedule == "aggregates_first":
        # the last ticket reads back over every predecessor to tile 0
        assert rounds[-1] == -(-(tiles - 1) // 32)


# --- the kernel -------------------------------------------------------------

def _vectors(mask: np.ndarray, first: np.ndarray, addr: int) -> np.ndarray:
    """load16 of the mask at each element index in ``first`` (any shape):
    (..., 4) uint32 words, bytes outside [0, m) read as 0.  ``addr`` is
    the mask's address mod 16: every vector must be aligned."""
    assert ((first + addr) % 16 == 0).all()
    idx = first[..., None] + np.arange(16)
    inside = (idx >= 0) & (idx < len(mask))
    b = np.where(inside, mask[np.clip(idx, 0, len(mask) - 1)], 0)
    b = b.astype(np.uint64).reshape(*first.shape, 4, 4)
    return (b << (8 * np.arange(4, dtype=np.uint64))).sum(-1)


def _nth_set(w: np.ndarray, r: np.ndarray) -> np.ndarray:
    """compact_masked.cu's nth_set on uint64 arrays: the index of the r-th
    set bit (from 0) of w, by halving steps of popcounts."""
    w, r = w.astype(np.uint64).copy(), r.astype(np.int64).copy()
    at = np.zeros(len(w), np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        c = np.bitwise_count(w & np.uint64((1 << s) - 1)).astype(np.int64)
        go = r >= c
        r = np.where(go, r - c, r)
        w = np.where(go, w >> np.uint64(s), w)
        at += s * go
    return at


def _warp_nth(j: np.ndarray, incl: np.ndarray, flags: np.ndarray):
    """compact_masked.cu's warp_nth for task j of a warp whose lanes hold
    the inclusive counts ``incl`` and bit masks ``flags`` (rows of 32):
    the lane found by five halving steps over the shuffled counts, then
    the bit of its mask; returns lane * kLane + bit."""
    rows = np.arange(len(j))
    at = np.zeros(len(j), np.int64)
    for step in (16, 8, 4, 2, 1):
        at += step * (incl[rows, at + step - 1] <= j)
    w = flags[rows, at]
    before = incl[rows, at] - np.bitwise_count(w).astype(np.int64)
    return at * LANE + _nth_set(w, j - before)


def test_nth_set_and_warp_nth():
    """Every rank of masks of 0, 1, some and all 64 bits; every task of a
    warp of seeded lane masks."""
    rng = np.random.default_rng(3)
    words = np.concatenate([
        np.array([1, 1 << 63, (1 << 64) - 1], np.uint64),
        rng.integers(0, 1 << 62, 50).astype(np.uint64) * np.uint64(2) +
        np.uint64(1)])
    for w in words:
        bits = np.flatnonzero([(int(w) >> b) & 1 for b in range(64)])
        got = _nth_set(np.full(len(bits), w), np.arange(len(bits)))
        assert np.array_equal(got, bits)
    flags = (rng.integers(0, 1 << 63, 32) & rng.integers(0, 1 << 63, 32) &
             rng.integers(0, 1 << 63, 32)).astype(np.uint64)
    flags[[0, 7, 31]] = 0
    flags &= np.uint64((1 << LANE) - 1)
    incl = np.cumsum(np.bitwise_count(flags).astype(np.int64))
    j = np.arange(incl[-1])
    got = _warp_nth(j, np.tile(incl, (len(j), 1)), np.tile(flags,
                                                            (len(j), 1)))
    want = [lane * LANE + b for lane in range(32) for b in range(LANE)
            if (int(flags[lane]) >> b) & 1]
    assert np.array_equal(got, want)


def _k9_emulated(start, is_end, pos, cand, head_s=0, head_e=0,
                 schedule="random", seed=0):
    """The kernel's outputs, with slots it does not write left at
    torch.empty's garbage, and its count."""
    m = len(start)
    tiles = -(-(head_s + m) // TILE)
    shift = (head_e - head_s) % 16
    # e0[tile, warp, lane]: the lane's first element
    e0 = (np.arange(tiles)[:, None, None] * TILE - head_s +
          (np.arange(WARPS)[None, :, None] * 32 +
           np.arange(32)[None, None, :]) * LANE)
    h = 16 * np.arange(VECS + 1)
    sb = _byte_bits(_vectors(start.view(np.uint8), e0[..., None] +
                             h[:VECS], head_s))
    eb = _byte_bits(_vectors(is_end.view(np.uint8), e0[..., None] - shift +
                             h, head_e))
    if shift == 0:
        eb[..., VECS] = 0                 # the extra vector is not loaded
    fs = (sb << (16 * np.arange(VECS, dtype=np.uint64))).sum(-1)
    fe = (((((eb[..., :VECS] | eb[..., 1:] << 16) >> shift) & 0xFFFF))
          << (16 * np.arange(VECS, dtype=np.uint64))).sum(-1)
    bits_s = (fs[..., None] >> np.arange(LANE, dtype=np.uint64)) & 1
    bits_e = (fe[..., None] >> np.arange(LANE, dtype=np.uint64)) & 1
    elems = e0[..., None] + np.arange(LANE)
    # the flags the lanes hold are exactly the masks' flags
    for bits, mask in ((bits_s, start), (bits_e, is_end)):
        inside = (elems >= 0) & (elems < m)
        assert not bits[~inside].any()
        assert np.array_equal(bits[inside].astype(bool),
                              mask[elems[inside]])
    # the packed counts in 32-bit unsigned words, as the kernel holds them:
    # the warp scan, the warps' offsets, the aggregate
    cnt = (bits_s.sum(-1) | bits_e.sum(-1) << 16).astype(np.uint32)
    incl = np.cumsum(cnt, -1, dtype=np.uint32)
    wtot = incl[..., -1]
    woff = np.cumsum(wtot, -1, dtype=np.uint32) - wtot
    agg = wtot.sum(-1, dtype=np.uint32)
    assert (agg & 0xFFFF <= TILE).all() and (agg >> 16 <= TILE).all()
    assert np.array_equal(agg & 0xFFFF, bits_s.sum((1, 2, 3)))
    assert np.array_equal(agg >> 16, bits_e.sum((1, 2, 3)))
    incl, woff = incl.astype(np.int64), woff.astype(np.int64)
    excl, _ = _look_back([_pair(int(a & 0xFFFF), int(a >> 16)) for a in agg],
                         schedule, seed)
    # the tile that holds element m - 1 writes the count
    n = (excl[-1] & PAIR_COUNT) + int(agg[-1] & 0xFFFF)
    excl_s = np.array([x & PAIR_COUNT for x in excl])[:, None]
    excl_e = np.array([x >> PAIR_SHIFT for x in excl])[:, None]
    # each warp's scatter: its j-th set flag of a mask to lane j % 32 in
    # round j / 32, found by warp_nth, stored at the slot out0 + j
    garbage = np.int32(-0x21524111)
    outs = [np.full(m, garbage, np.int32) for _ in range(3)]
    writes = [np.zeros(m, np.int64) for _ in range(3)]
    seg = e0[..., 0]                               # (tile, warp)
    for flags, incl_x, out0, streams in (
            (fs, incl & 0xFFFF, excl_s + (woff & 0xFFFF),
             ((0, pos), (2, cand))),
            (fe, incl >> 16, excl_e + (woff >> 16), ((1, pos),))):
        total = incl_x[..., -1]
        tw = np.repeat(np.arange(total.size), total.ravel())
        j = np.arange(len(tw)) - np.repeat(np.cumsum(total.ravel()) -
                                           total.ravel(), total.ravel())
        elem = seg.ravel()[tw] + _warp_nth(j, incl_x.reshape(-1, 32)[tw],
                                           flags.reshape(-1, 32)[tw])
        # it is the warp's j-th set flag
        warp_elems = elems.reshape(-1, 32 * LANE)
        warp_bits = (flags.reshape(-1, 32)[..., None] >> np.arange(
            LANE, dtype=np.uint64) & 1).reshape(-1, 32 * LANE).astype(bool)
        want = np.concatenate([warp_elems[w][warp_bits[w]]
                               for w in range(total.size)] + [[]])
        assert np.array_equal(elem, want.astype(np.int64))
        slot = out0.ravel()[tw] + j
        for q, payload in streams:
            outs[q][slot] = payload[elem]
            np.add.at(writes[q], slot, 1)
    n_end = int(is_end.sum())
    for q, k in ((0, n), (1, n_end), (2, n)):
        assert (writes[q][:k] == 1).all() and not writes[q][k:].any()
    return outs, n


def _masks(kind: str, m: int, rng):
    """(start, is_end) bool masks of length m."""
    idx = np.arange(m)
    if kind == "none":
        return np.zeros(m, bool), np.zeros(m, bool)
    if kind == "all":
        return np.ones(m, bool), np.ones(m, bool)
    if kind == "only_starts":
        return rng.random(m) < 0.3, np.zeros(m, bool)
    if kind == "only_ends":
        return np.zeros(m, bool), rng.random(m) < 0.3
    if kind == "ends_without_starts_in_a_tile":
        # one start in the first tile, one end in every tile: the tiles
        # after the first hold ends and no start
        return idx == 0, idx % TILE == min(TILE, m) - 1
    if kind == "runs_cut_at_the_edge":
        # the dense matcher's run masks at about 2% of each mask, the last
        # run cut by the edge (its end flag is the last element)
        cand = np.full(m, -1, np.int32)
        at = 0
        while at < m:
            at += int(rng.integers(1, 60))
            length = int(rng.integers(1, 40))
            cand[at:at + length] = 7 + np.arange(len(cand[at:at + length]))
            at += length
        cand[-5:] = 100 + np.arange(len(cand[-5:]))
        start, is_end, _ = PM.run_masks(torch.from_numpy(cand),
                                        torch.from_numpy(cand >= 0), m)
        return start.numpy(), is_end.numpy()
    return rng.random(m) < 0.5, rng.random(m) < 0.5


_KINDS = ["none", "all", "only_starts", "only_ends",
          "ends_without_starts_in_a_tile", "runs_cut_at_the_edge", "half"]


def _payloads(m: int, rng):
    return (rng.integers(-2**31, 2**31, m, dtype=np.int64).astype(np.int32),
            rng.integers(-2**31, 2**31, m, dtype=np.int64).astype(np.int32))


def _assert_equal_up_to_counts(outs, n: int, n_end: int, ref):
    """``ref``: (starts, ends, srcs, n) of another implementation; the
    first n, n_end and n slots of the streams are compared."""
    assert int(ref[3]) == n
    for out, want, k in zip(outs, ref[:3], (n, n_end, n)):
        assert np.array_equal(out[:k], np.asarray(want)[:k])


def _k9_case(kind: str, m: int, seed: int, head_s: int = 0, head_e: int = 0,
             schedule: str = "random"):
    rng = np.random.default_rng(seed)
    start, is_end = _masks(kind, m, rng)
    pos, cand = _payloads(m, rng)
    outs, n = _k9_emulated(start, is_end, pos, cand, head_s, head_e,
                           schedule, seed)
    assert n == int(start.sum())
    ref = C.compact_masked_reference(*(torch.from_numpy(x) for x in
                                       (start, is_end, pos, cand)))
    _assert_equal_up_to_counts(outs, n, int(is_end.sum()),
                               [x.numpy() for x in ref])
    return start, is_end, pos, cand, outs, n


@pytest.mark.parametrize("m", [1, TILE - 17, 3 * TILE + 1_001])
@pytest.mark.parametrize("kind", _KINDS)
def test_k9_emulation_equals_reference(kind, m):
    """One element, a part of one tile, three tiles and a ragged tail."""
    _k9_case(kind, m, m + len(kind))


@pytest.mark.parametrize("head", range(16))
@pytest.mark.parametrize("which", ["start", "is_end"])
def test_k9_emulation_at_every_head(which, head):
    """Each mask at every byte mod 16, the other at another: tiles cut at
    start's boundaries, is_end's vectors shifted by the difference."""
    other = (head * 7 + 3) % 16
    heads = (head, other) if which == "start" else (other, head)
    _k9_case("runs_cut_at_the_edge", 2 * TILE + 333, head, *heads)


@pytest.mark.parametrize("schedule", ["random", "aggregates_first"])
@pytest.mark.parametrize("kind", ["runs_cut_at_the_edge", "half"])
def test_k9_emulation_over_more_than_32_tiles(kind, schedule):
    """40 tiles: under "aggregates_first" the last tile's look-back reads
    two rounds of 32 predecessors."""
    _k9_case(kind, 40 * TILE - 5, 40, 9, 2, schedule)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_k9_emulation_does_not_depend_on_the_block_order(seed):
    """The same input under three seeded schedules of the blocks: the same
    outputs."""
    rng = np.random.default_rng(5)
    start, is_end = _masks("half", 6 * TILE + 9, rng)
    pos, cand = _payloads(len(start), rng)
    want = _k9_emulated(start, is_end, pos, cand, 4, 11, "in_order")
    got = _k9_emulated(start, is_end, pos, cand, 4, 11, "random", seed)
    assert got[1] == want[1]
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))


_PALLAS_M = 2 * TILE + 4_321    # one shape: interpret mode compiles once


@pytest.mark.parametrize("kind", _KINDS)
def test_k9_emulation_equals_pallas(kind):
    start, is_end, pos, cand, outs, n = _k9_case(kind, _PALLAS_M, 17, 5, 12)
    pal = compact_masked_pallas(*(jnp.asarray(x) for x in
                                  (start, is_end, pos, cand)), _PALLAS_M,
                                interpret=True)
    _assert_equal_up_to_counts(outs, n, int(is_end.sum()), pal)


@pytest.mark.parametrize("limit_cut", [0, 1, 777])
@pytest.mark.parametrize("p", [0.1, 0.9])
def test_k9_emulation_equals_compact_runs(p, limit_cut):
    """The dense matcher's masks: the JAX matcher's compact_runs (its XLA
    twin) on candidate chains, the emulation on the port's run masks of
    the same chains, pos the element index as run_masks hands it."""
    m = 3 * TILE + 55
    rng = np.random.default_rng(int(p * 10) + limit_cut)
    cand = rng.integers(-1, m, m).astype(np.int32)
    cont = rng.random(m) < p
    for i in np.flatnonzero(cont[1:]) + 1:
        if cand[i - 1] >= 0:
            cand[i] = cand[i - 1] + 1
    ok = cand >= 0
    limit = m - limit_cut
    ref = JM.compact_runs(jnp.asarray(cand), jnp.asarray(ok),
                          jnp.int32(limit), m)
    start, is_end, idx = PM.run_masks(torch.from_numpy(cand),
                                      torch.from_numpy(ok), limit)
    start, is_end = start.numpy(), is_end.numpy()
    outs, n = _k9_emulated(start, is_end, idx.numpy(), cand, 0, 0,
                           "random", limit_cut)
    assert n == int(ref[3]) == int(is_end.sum())
    _assert_equal_up_to_counts(outs, n, n, ref)
