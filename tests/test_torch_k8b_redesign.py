"""The redesigned K8b (``layered_pass``), pass k >= 1 of a layered replay,
pinned down on the CPU against the JAX package.

- The layered plans: ``replay_pieces_layered`` against the JAX package's
  function run with ``interpret=True`` and against the host replay, on
  seeded token streams whose plans have one, two and several layers.
- ``layered_pass``'s plain version on a layer's piece table, on edge
  cases: pieces of 1 to 8193 bytes, a source and a destination in one
  16-byte word, two destinations in one word, pieces at the buffer's
  first and last byte, an empty layer, corrupt and unordered tables.
- ``_k8b_emulated`` follows ``csrc/replay_ragged.cu``
  ``layered_span_kernel``: the layer's range from its first and last
  record, the grid's spans, K8a's probe rounds for a span's first piece,
  the windows of records clipped to the span (reloaded from the first
  piece, then window after window), the block's prefix over the slots'
  words, each thread's binary search from its last slot, ``kLayerGroup``
  words in flight, the aligned loads realigned by funnel shifts and the
  widest aligned stores.  It is held to the plain version: every byte is
  written exactly once, by the piece that owns it, every store lies
  inside the buffer at its own alignment, and every source byte that a
  word takes lies inside its piece's source.
- The layered path hands K8b each layer's table and reads nothing back.

The kernels move bytes, so every comparison is exact (tolerance 0).  The
kernel's constants are read from the CUDA source.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu import runtime as jruntime
from lrzip_next_tpu.ops import replay_ragged as jrr
from lrzip_next_tpu_torch import runtime as pruntime
from lrzip_next_tpu_torch.format.tokens import split_long_runs
from lrzip_next_tpu_torch.ops import replay_ragged as RR

from test_torch_k8_redesign import (THREADS, WINDOW, _WRONG, _clamp_huge,
                                    _constant, _end_key, _first_piece,
                                    _load_source, _piece_owner,
                                    _store_parts, _wrong)

SPAN = _constant("kSpan")
GROUP = _constant("kLayerGroup")
PER_SM = _constant("kLayerBlocksPerSm")
SMS = 132                               # an H100's multiprocessors


def test_constants_are_the_sources():
    assert SPAN % 16 == 0 and SPAN >= 16 * THREADS
    assert GROUP >= 1 and PER_SM >= 1
    assert 0 < WINDOW <= THREADS - 32


# ---------------------------------------------------------------------------
# the kernel, in numpy


def _grid(buf_len: int) -> int:
    """The C entry's grid: enough blocks to fill the card, no more than
    the buffer has spans."""
    return min(SMS * PER_SM, (buf_len + 15) // SPAN + 1)


def _span(out, buf0, pieces, key, o, mo, written, owner, stats):
    """One block's turn on the span at aligned offset ``o``."""
    dst, src, ln = pieces
    n, buf_len = len(dst), len(buf0)
    origin = o - mo
    first = _first_piece(key, origin)[0]
    again = True
    lanes = np.arange(THREADS)
    while True:
        q = first + lanes
        inn = q < n
        qq = np.minimum(q, n - 1)
        d = np.where(inn, dst[qq], 0)
        s = np.where(inn, src[qq], 0)
        ll = np.where(inn, ln[qq], 0)
        below = inn & (_end_key(d, ll) <= origin)
        reaches = inn & (_clamp_huge(d) < origin + SPAN)
        ok = inn & (d >= 0) & (s >= 0) & (ll > 0) & (ll <= buf_len - d) & \
            (ll <= buf_len - s)
        a = np.where(ok, np.clip(d - origin, 0, SPAN), 0)
        b = np.where(ok, np.clip(d + ll - origin, 0, SPAN), 0)
        delta = np.where(ok, s - d, 0)
        cnt = int(below.sum())
        more = bool(reaches[-1] and q[-1] + 1 < n)
        if more and cnt > 0 and again:
            again = False
            first += cnt
            stats["reloads"] += 1
            continue
        stats["windows"] += 1
        nw = np.where(a < b, ((b - 1) >> 4) - (a >> 4) + 1, 0)
        excl = np.cumsum(nw) - nw
        total = int(nw.sum())
        slot = np.zeros(THREADS, np.int64)
        for x0 in range(0, total, GROUP * THREADS):
            pending = []
            for u in range(GROUP):          # every load before a store
                x = x0 + u * THREADS + lanes
                live_x = x < total
                j = np.full(THREADS, THREADS)
                while True:
                    act = live_x & (j - slot > 1)
                    if not act.any():
                        break
                    mid = (slot + j) >> 1
                    go = excl[np.minimum(mid, THREADS - 1)] <= x
                    slot = np.where(act & go, mid, slot)
                    j = np.where(act & ~go, mid, j)
                want = np.searchsorted(excl, x, side="right") - 1
                assert (slot[live_x] == want[live_x]).all()
                word = (a[slot] >> 4) + (x - excl[slot])
                lo = np.clip(a[slot] - 16 * word, 0, 16)
                hi = np.where(live_x, np.clip(b[slot] - 16 * word, 0, 16), lo)
                live = lo < hi
                if not live.any():
                    continue
                at = o + 16 * word
                sp0 = at - mo + delta[slot]
                piece = first + slot
                # the bytes a word takes lie inside its piece's source
                pc = np.minimum(piece, n - 1)
                assert ((sp0 + lo >= src[pc]) &
                        (sp0 + hi <= src[pc] + ln[pc]))[live].all()
                val = _load_source(buf0, mo, sp0[live], lo[live], hi[live])
                pending.append((at[live], lo[live], hi[live], val,
                                piece[live]))
            for ats, los, his, vals, owners in pending:
                for at, lo_b, hi_b, val, who in zip(ats, los, his, vals,
                                                    owners):
                    raw = val.view(np.uint8)
                    for off, width in _store_parts(int(lo_b), int(hi_b)):
                        addr = int(at) + off          # from the boundary
                        assert addr % width == 0
                        idx = addr - mo
                        assert 0 <= idx and idx + width <= buf_len
                        out[idx:idx + width] = raw[off:off + width]
                        written[idx:idx + width] += 1
                        owner[idx:idx + width] = who
        if not more:
            return
        first += THREADS
        again = False


def _k8b_emulated(buf0: np.ndarray, pieces: np.ndarray, mo: int,
                  grid: int = 0):
    """K8b block by block on a copy of ``buf0`` (whose byte 0 sits at
    address ``mo`` mod 16): (out, written, owner, stats), the number of
    stores that wrote each byte and the piece that did.  The sources are
    read from ``buf0``: no piece of a layer writes a byte that a piece of
    it reads, and every byte a word takes is checked to lie in its
    source."""
    pieces = tuple(np.asarray(r, np.int64) for r in pieces)
    dst, ln = pieces[0], pieces[2]
    n, buf_len = len(dst), len(buf0)
    assert n >= 1                       # the wrapper launches nothing else
    grid = grid or _grid(buf_len)
    out = buf0.copy()
    written = np.zeros(buf_len, np.int64)
    owner = np.full(buf_len, -1, np.int64)
    stats = {"spans": 0, "windows": 0, "reloads": 0}
    key = _end_key(dst, ln)
    size = buf_len + mo
    lo = int(np.clip(_clamp_huge(dst[0]) + mo, 0, size)) & ~15
    hi = int(np.clip(key[-1] + mo, 0, size))
    for blk in range(grid):
        for o in range(lo + blk * SPAN, hi, grid * SPAN):
            stats["spans"] += 1
            _span(out, buf0, pieces, key, o, mo, written, owner, stats)
    return out, written, owner, stats


def _valid(pieces, buf_len):
    d, s, ln = pieces
    return (d >= 0) & (s >= 0) & (ln > 0) & (ln <= buf_len - d) & \
        (ln <= buf_len - s)


def _check_k8b(buf0, pieces, mo, grid=0):
    """The emulated kernel against the plain version and the pieces'
    ownership of every byte; returns (out, stats)."""
    out, written, owner, stats = _k8b_emulated(buf0, pieces, mo, grid)
    ref = RR.layered_pass(torch.from_numpy(buf0.copy()),
                          torch.from_numpy(np.ascontiguousarray(pieces)))
    assert np.array_equal(out, ref.numpy())
    want = _piece_owner(pieces, len(buf0), _valid(pieces, len(buf0)))
    assert np.array_equal(owner, want)
    assert np.array_equal(written, (want >= 0).astype(np.int64))
    return out, stats


def _sliced(buf0, pieces):
    """The pass by numpy slicing, the gather before the scatter."""
    out = buf0.copy()
    valid = _valid(pieces, len(buf0))
    got = [buf0[s:s + n].copy() for d, s, n in pieces[:, valid].T]
    for (d, _, n), g in zip(pieces[:, valid].T, got):
        out[d:d + n] = g
    return out


# ---------------------------------------------------------------------------
# layer tables


def _layer(rng, lens, buf_len, gap_hi=1, src_region=None):
    """A layer's table: destinations ascending from the buffer's second
    half with gaps of 0 to gap_hi - 1 bytes, sources in the first half
    (or in ``src_region``), so no source byte is a destination byte."""
    lens = np.asarray(lens, np.int64)
    gaps = rng.integers(0, gap_hi, len(lens))
    dst = buf_len // 2 + np.cumsum(lens + gaps) - lens
    assert int(dst[-1] + lens[-1]) <= buf_len
    lo, hi = src_region or (0, buf_len // 2)
    src = np.asarray([rng.integers(lo, hi - n + 1) for n in lens], np.int64)
    return np.stack([dst, src, lens]).astype(np.int64)


def _buffer(rng, buf_len):
    return rng.integers(0, 256, buf_len, dtype=np.uint8)


_LENGTHS = [1, 15, 16, 17, 511, 512, 513, 4096, 8191, 8192, 8193]


@pytest.mark.parametrize("length", _LENGTHS)
def test_pieces_of_every_length(length):
    """A layer of pieces all of one length, at every alignment of source
    and destination that the seed gives, with and without gaps."""
    rng = np.random.default_rng(length)
    n = 9
    buf_len = 4 * n * (length + 40) + 64
    pieces = _layer(rng, [length] * n, buf_len, gap_hi=1 + 37 * (length % 2))
    buf0 = _buffer(rng, buf_len)
    assert np.array_equal(RR.layered_pass_reference(
        torch.from_numpy(buf0.copy()), torch.from_numpy(pieces)).numpy(),
        _sliced(buf0, pieces))
    _check_k8b(buf0, pieces, mo=length % 16)


def _edge_table(name: str):
    """(buffer length, table) of a named edge case."""
    if name == "source_and_destination_in_one_word":
        # one piece's source [40, 70) ends in the word [64, 80) where
        # another's destination [70, 90) starts; that one's source
        # [300, 320) ends where a third's destination [320, 331) starts
        # (one word where the buffer is misaligned)
        return 512, [[70, 200, 320], [300, 40, 96], [20, 30, 11]]
    if name == "two_destinations_in_one_word":
        return 512, [[100, 105, 108, 130, 131], [300, 10, 400, 17, 50],
                     [5, 3, 20, 1, 13]]
    if name == "first_and_last_byte":
        # destinations at byte 0 and ending at the last byte; sources at
        # bytes next to both ends
        return 10_000, [[0, 6000, 7000, 9991], [3000, 9, 9980, 5000],
                        [9, 10, 11, 9]]
    if name == "one_byte_pieces_in_a_row":
        return 4096, [list(range(2000, 2300)), list(range(5, 305)),
                      [1] * 300]
    if name == "piece_over_many_spans":
        return 10 * SPAN + 100, [[5 * SPAN - 3], [17], [4 * SPAN + 40]]
    raise KeyError(name)


_EDGES = ["source_and_destination_in_one_word", "two_destinations_in_one_word",
          "first_and_last_byte", "one_byte_pieces_in_a_row",
          "piece_over_many_spans"]


@pytest.mark.parametrize("mo", [0, 7, 15])
@pytest.mark.parametrize("name", _EDGES)
def test_edge_cases(name, mo):
    buf_len, rows = _edge_table(name)
    pieces = np.asarray(rows, np.int64)
    RR.check_order(torch.from_numpy(pieces))
    buf0 = _buffer(np.random.default_rng(len(name) + mo), buf_len)
    ref = RR.layered_pass(torch.from_numpy(buf0.copy()),
                          torch.from_numpy(pieces)).numpy()
    assert np.array_equal(ref, _sliced(buf0, pieces))
    untouched = _piece_owner(pieces, buf_len, _valid(pieces, buf_len)) < 0
    assert np.array_equal(ref[untouched], buf0[untouched])
    _check_k8b(buf0, pieces, mo)


def test_empty_layer_is_no_pass():
    buf = torch.arange(64, dtype=torch.uint8)
    before = RR.layered_launches
    out = RR.layered_pass(buf, torch.zeros((3, 0), dtype=torch.int64))
    assert out is buf and torch.equal(buf, torch.arange(64,
                                                        dtype=torch.uint8))
    assert RR.layered_launches == before


@pytest.mark.parametrize("k", range(16))
def test_every_misalignment(k):
    """Source k bytes past its destination mod 16, the buffer 3k mod 16
    bytes past a 16-byte boundary, pieces of 1 to 3000 bytes."""
    rng = np.random.default_rng(200 + k)
    lens = rng.integers(1, 3000, 40)
    buf_len = 2 * int(lens.sum()) + 2 * 16 * len(lens) + 64
    pieces = _layer(rng, lens, buf_len, gap_hi=20,
                    src_region=(0, buf_len // 2 - 16))
    pieces[1] += (pieces[0] + k - pieces[1]) % 16
    assert ((pieces[1] - pieces[0]) % 16 == k).all()
    assert (pieces[1] + pieces[2] <= buf_len // 2).all()
    _check_k8b(_buffer(rng, buf_len), pieces, mo=(3 * k) % 16)


def test_many_short_pieces_a_span_take_several_windows():
    """Pieces of 1 to 40 bytes: hundreds meet a span, so a block loads
    its window again from the span's first piece, then window after
    window."""
    rng = np.random.default_rng(5)
    lens = rng.integers(1, 40, 2500)
    buf_len = 2 * int(lens.sum()) + 30 * len(lens)
    pieces = _layer(rng, lens, buf_len, gap_hi=10)
    assert len(lens) > 3 * THREADS
    _, stats = _check_k8b(_buffer(rng, buf_len), pieces, mo=9)
    assert stats["windows"] > stats["spans"] and stats["reloads"] > 0


@pytest.mark.parametrize("grid", [1, 3, 0])
def test_grid_walks_every_span(grid):
    """Long pieces over many spans: one block, three, and the C entry's
    grid take every span once."""
    rng = np.random.default_rng(grid + 1)
    lens = [3 * SPAN + 5, 700, SPAN, 2 * SPAN - 1, 90]
    buf_len = 2 * sum(lens) + 4096
    pieces = _layer(rng, lens, buf_len, gap_hi=300)
    _, stats = _check_k8b(_buffer(rng, buf_len), pieces, mo=4, grid=grid)
    lo = (int(pieces[0, 0]) + 4) & ~15
    hi = int(pieces[0, -1] + pieces[2, -1]) + 4
    assert stats["spans"] == -(-(hi - lo) // SPAN) > 5


def test_sparse_layer_leaves_empty_spans():
    """Pieces far apart: most spans of the layer's range hold none."""
    rng = np.random.default_rng(8)
    n = 12
    lens = rng.integers(100, 900, n)
    buf_len = 70 * SPAN
    pieces = _layer(rng, lens, buf_len, src_region=(0, SPAN))
    pieces[0] = buf_len // 2 + np.arange(n) * (3 * SPAN + 333)
    _, stats = _check_k8b(_buffer(rng, buf_len), pieces, mo=1)
    assert stats["spans"] > 2 * n


_CORRUPT = {
    "neg_dst": (0, -5), "past_dst": (0, 1 << 40), "long_len": (2, 1 << 40),
    "zero_len": (2, 0), "neg_src": (1, -7), "past_src": (1, 1 << 40),
}


@pytest.mark.parametrize("field", sorted(_CORRUPT))
def test_corrupt_piece_is_skipped_whole(field):
    """Three good pieces and a corrupt one, in the order ``check_order``
    takes (the corrupt one last, or first for a negative dst): the plain
    version and the emulated kernel skip it and copy the others."""
    row, val = _CORRUPT[field]
    t = np.array([[6000, 6700, 8000, 9000], [10, 300, 40, 50],
                  [600, 1200, 900, 600]], np.int64)
    t[row, 3] = val
    if field == "neg_dst":
        t = np.ascontiguousarray(t[:, [3, 0, 1, 2]])
    RR.check_order(torch.from_numpy(t))
    buf0 = _buffer(np.random.default_rng(3), 12_000)
    good = _valid(t, len(buf0))
    assert good.sum() == 3
    out = RR.layered_pass(torch.from_numpy(buf0.copy()),
                          torch.from_numpy(t)).numpy()
    assert np.array_equal(out, _sliced(buf0, t[:, good]))
    _check_k8b(buf0, t, mo=6)


def test_unordered_table_is_refused_on_the_cpu_and_stays_inside():
    """A table out of dst order: the plain version raises; the emulated
    kernel writes only inside the buffer and only bytes of valid pieces,
    though which of them land is not defined."""
    t = np.array([[6000, 9000, 7000], [10, 300, 40], [500, 600, 900]],
                 np.int64)
    buf0 = _buffer(np.random.default_rng(4), 12_000)
    with pytest.raises(ValueError, match="ascending and disjoint"):
        RR.layered_pass(torch.from_numpy(buf0.copy()), torch.from_numpy(t))
    out, written, owner, _ = _k8b_emulated(buf0, t, mo=2)
    want = _piece_owner(t, len(buf0), _valid(t, len(buf0)))
    assert (written <= 1).all() and ((owner == want) | (owner < 0)).all()
    assert np.array_equal(out[want < 0], buf0[want < 0])


@pytest.mark.parametrize("what", _WRONG)
def test_k8b_wrapper_rejects(what):
    buf, table, err = _wrong(what)
    with pytest.raises(err):
        RR.layered_pass(buf, table)


# ---------------------------------------------------------------------------
# layered plans


def _stream(depth: int, seed: int, split: bool):
    """Literals with short matches into the literal just placed, then
    ``depth`` copies, each of the one before: a plan of ``depth`` layers.
    With ``split``, tokens are cut at the format's 64 KiB limit, so a
    layer holds many pieces."""
    rng = np.random.default_rng(seed)
    tokens, pos = [], 0
    for _ in range(120 + 40 * seed):
        n = int(rng.integers(40, 900))
        tokens.append((0, n, 0))
        pos += n
        ml = int(rng.integers(32, 300))
        if ml < n:
            tokens.append((1, ml, n))
            pos += ml
    region, start = pos, 0
    for k in range(depth):
        tokens.append((0, 50 + k, 0))
        pos += 50 + k
        tokens.append((1, region, pos - start))
        start = pos
        pos += region
    kinds, lens, dists = (np.asarray(c, np.int64) for c in zip(*tokens))
    kinds = kinds.astype(np.uint8)
    if split:
        kinds, lens, dists = split_long_runs(kinds, lens, dists)
    lit = rng.integers(0, 256, int(lens[kinds == 0].sum()), dtype=np.uint8)
    return kinds, lens.astype(np.int64), dists.astype(np.int64), lit


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_layered_replay_equals_jax(depth, seed, split):
    kinds, lens, dists, lit = _stream(depth, seed, split)
    lay = pruntime.flatten_replay_layered(kinds, lens, dists)
    want_lay = jruntime.flatten_replay_layered(kinds, lens, dists)
    for a, b in zip(lay[:3], want_lay[:3]):
        assert np.array_equal(a, b)
    pl_, ps_, py_, nl = lay
    assert nl == depth
    if split:
        assert np.bincount(py_)[1:].min() >= 2
    out_len = int(lens.sum())
    got = RR.replay_pieces_layered(pl_, ps_, py_, nl, torch.from_numpy(lit),
                                   out_len).numpy()
    want = np.asarray(jrr.replay_pieces_layered(
        pl_, ps_, py_, nl, jnp.asarray(lit), out_len, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, pruntime.replay_tokens(kinds, lens, dists,
                                                      lit, out_len))


def _layer_tables(monkeypatch, plan, lit, out_len):
    """``replay_pieces_layered`` with K8b recorded: the chunk and the
    (buffer before, table) of every pass."""
    real = RR.layered_pass
    passes = []

    def spy(buf, pieces):
        passes.append((buf.numpy().copy(), pieces.numpy().copy()))
        return real(buf, pieces)

    monkeypatch.setattr(RR, "layered_pass", spy)
    out = RR.replay_pieces_layered(*plan, torch.from_numpy(lit), out_len)
    monkeypatch.undo()
    return out.numpy(), passes


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_emulated_passes_rebuild_the_chunk(depth, monkeypatch):
    """Every pass of a layered plan through the emulated kernel: each
    equals the plain pass, and the last rebuilds the chunk."""
    kinds, lens, dists, lit = _stream(depth, 3, split=True)
    plan = pruntime.flatten_replay_layered(kinds, lens, dists)
    out_len = int(lens.sum())
    got, passes = _layer_tables(monkeypatch, plan, lit, out_len)
    assert len(passes) == depth
    buf = passes[0][0]
    for i, (before, table) in enumerate(passes):
        assert np.array_equal(buf, before)
        buf, _ = _check_k8b(before, table, mo=(5 * i) % 16)
    assert np.array_equal(buf[:out_len], got)
    assert np.array_equal(got, pruntime.replay_tokens(kinds, lens, dists,
                                                      lit, out_len))


def test_layered_path_has_no_fragment_planner_and_no_read_back(monkeypatch):
    """From the plan to the kernels: no fragment planner exists, nothing
    cuts pieces at cells (``repeat_interleave``, ``searchsorted``), and no
    tensor's value is read on the host; K8a and K8c take layer 0, and K8b
    each later layer's contiguous table in dst order, once a layer."""
    assert not hasattr(RR, "plan_frags") and not hasattr(RR,
                                                         "touched_ranges")
    kinds, lens, dists, lit = _stream(4, 1, split=True)
    pl_, ps_, py_, nl = pruntime.flatten_replay_layered(kinds, lens, dists)
    out_len = int(lens.sum())

    def banned(*args, **kwargs):
        raise AssertionError("called on the layered path")

    calls = []
    monkeypatch.setattr(RR, "ragged_concat", lambda lit, t, nc: calls.append(
        ("k8a", t)) or torch.zeros(nc * RR.CELL, dtype=torch.uint8))
    monkeypatch.setattr(RR, "small_merge", lambda out, lit, t: calls.append(
        ("k8c", t)) or out)
    monkeypatch.setattr(RR, "layered_pass", lambda buf, t: calls.append(
        ("k8b", t)) or buf)
    for name in ("repeat_interleave", "searchsorted", "nonzero", "unique"):
        monkeypatch.setattr(torch, name, banned)
    for name in ("__bool__", "__int__", "__index__", "item", "tolist",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, banned)
    RR.replay_pieces_layered(pl_, ps_, py_, nl, torch.from_numpy(lit),
                             out_len)
    monkeypatch.undo()
    assert [c[0] for c in calls] == ["k8a", "k8c"] + ["k8b"] * nl
    dst = np.cumsum(pl_) - pl_
    for k, (_, t) in enumerate(calls[2:], start=1):
        sel = (py_ == k) & (pl_ > 0)
        assert t.is_contiguous() and t.dtype == torch.int64
        assert np.array_equal(t.numpy(), np.stack([dst[sel], ps_[sel],
                                                   pl_[sel]]))
        RR.check_order(t)
