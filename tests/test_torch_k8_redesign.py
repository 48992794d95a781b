"""The redesigned K8a (``ragged_concat``) and K8c (``small_merge``), the
replay's literal copies, pinned down on the CPU against the JAX package.

- The piece plans: ``replay_pieces_ragged`` and ``replay_pieces_layered``
  against the JAX package's functions run with ``interpret=True`` and
  against ``replay_pieces_reference``, on seeded plans (a piece of
  several MiB, ends on 8 KiB and 1 KiB boundaries, tiny and odd output
  lengths, long or short pieces only, every source-against-destination
  misalignment mod 16, short pieces that share a 16-byte word).
- ``_k8a_emulated`` follows ``csrc/replay_ragged.cu`` ``ragged_kernel``:
  a block a cell, the probe rounds counted as ``__syncthreads_count``
  counts them, the window of records clipped to the cell, a thread's
  binary search for the pieces that meet each of its words, the aligned
  16-byte loads of ``lit`` (byte loads where a word is not wholly inside
  it), the funnel-shift realignment and the byte-mask merge.
  ``_k8c_emulated`` follows ``small_kernel``: 32 pieces a warp, the warp
  prefix over their destination words, the lanes' binary search over the
  prefixes, ``kSmallUnroll`` words in flight a lane and the widest
  aligned stores that stay inside a piece.  Both are held to the plain versions, every output
  byte must be written exactly once by the piece that owns it (K8a: every
  word stored once by its thread), and no access leaves its tensor.
- Corrupt tables: the plain versions skip or zero exactly as before.
- The wrappers reject a wrong dtype, shape or device.

The kernels move bytes, so every comparison is exact (tolerance 0).  The
kernels' constants are read from the CUDA source.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu import runtime as jruntime
from lrzip_next_tpu.ops import replay_ragged as jrr
from lrzip_next_tpu_torch import runtime as pruntime
from lrzip_next_tpu_torch.ops import replay_ragged as RR

_SRC = (Path(RR.__file__).resolve().parent / "csrc" /
        "replay_ragged.cu").read_text()


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int(?:64_t)? {name} = ([^;]+);", _SRC)
    expr = m.group(1)
    for k, v in _CONSTANTS.items():
        expr = re.sub(rf"\b{k}\b", str(v), expr)
    return int(eval(expr, {}))      # noqa: S307 - integer constants only


_CONSTANTS = {}
for _name in ("kCellThreads", "kCellBits", "kCell", "kWords", "kWindow",
              "kCellsPerBlock", "kSmallUnroll"):
    _CONSTANTS[_name] = _constant(_name)
THREADS = _CONSTANTS["kCellThreads"]      # a K8a block
CELL = _CONSTANTS["kCell"]
WORDS = _CONSTANTS["kWords"]
WINDOW = _CONSTANTS["kWindow"]
CELLS_PER_BLOCK = _CONSTANTS["kCellsPerBlock"]
UNROLL = _CONSTANTS["kSmallUnroll"]
HUGE = 1 << 61
MIB = 1 << 20


def test_constants_are_the_sources():
    assert CELL == RR.CELL == 1 << RR.CELL_BITS
    assert WORDS * 16 * THREADS == CELL
    assert THREADS % 32 == 0 and 0 < WINDOW <= THREADS - 32
    assert UNROLL >= 1


# ---------------------------------------------------------------------------
# the kernels' arithmetic, in numpy


def _clamp_huge(v):
    return np.clip(v, -HUGE, HUGE)


def _aligned_words(buf: np.ndarray, m: int, g: np.ndarray) -> np.ndarray:
    """``aligned_word``: (N, 16) bytes buf[16g - m ...], 0 outside buf."""
    idx = 16 * g[:, None] - m + np.arange(16)
    inside = (idx >= 0) & (idx < len(buf))
    return np.where(inside, buf[np.clip(idx, 0, max(len(buf) - 1, 0))]
                    if len(buf) else 0, 0).astype(np.uint8)


def _load_source(buf, m, sp0, lo, hi):
    """``load_source`` + ``realign``: (N, 4) uint32 words, and the byte
    indices of ``buf`` each aligned word covers (for the bounds check)."""
    x = sp0 + m
    g = x >> 4
    r = x & 15
    need_a = r + lo < 16
    need_b = (r != 0) & (r + hi > 16)
    a = np.where(need_a[:, None], _aligned_words(buf, m, g), 0)
    b = np.where(need_b[:, None], _aligned_words(buf, m, g + 1), 0)
    w = np.concatenate([a, b], 1).astype(np.uint8).view("<u4").astype(
        np.uint64)                                          # (N, 8)
    q = (r >> 2).astype(np.int64)
    s = (8 * (r & 3)).astype(np.uint64)
    rows = np.arange(len(x))[:, None]
    o = w[rows, q[:, None] + np.arange(5)]                  # (N, 5)
    out = (((o[:, 1:] << np.uint64(32)) | o[:, :4]) >> s[:, None]) & \
        np.uint64(0xFFFFFFFF)
    return out.astype(np.uint32)


def _byte_mask(lo, hi):
    k = 4 * np.arange(4)
    a = np.clip(lo[:, None] - k, 0, 4)
    b = np.clip(hi[:, None] - k, 0, 4)
    return (((1 << (8 * np.maximum(a, b))) - (1 << (8 * a)))
            & 0xFFFFFFFF).astype(np.uint32)


def _end_key(d, ln):
    return _clamp_huge(d) + np.where(ln < 0, 0, _clamp_huge(ln))


def _first_piece(key: np.ndarray, cell: int):
    """The block's probe rounds: (lo, hi, rounds)."""
    lo, hi, rounds = 0, len(key), 0
    while hi - lo > WINDOW:
        step = -(-(hi - lo) // THREADS)
        q = lo + np.arange(THREADS) * step
        cnt = int(((q < hi) & (key[np.minimum(q, hi - 1)] <= cell)).sum())
        rounds += 1
        if cnt == 0:
            hi = lo
        else:
            hi = min(hi, lo + cnt * step)
            lo = lo + (cnt - 1) * step + 1
    return lo, hi, rounds


def _window(pieces, base: int, origin: int, span: int, out_size: int):
    """``load_window``: the records base .. base + THREADS clipped to
    [origin, origin + span): (lo, hi, delta, count below, more)."""
    dst, src, ln = pieces
    n = len(dst)
    q = base + np.arange(THREADS)
    inn = q < n
    qq = np.minimum(q, max(n - 1, 0))
    d = np.where(inn, dst[qq] if n else 0, 0)
    s = np.where(inn, src[qq] if n else 0, 0)
    ll = np.where(inn, ln[qq] if n else 0, 0)
    below = inn & (_end_key(d, ll) <= origin)
    reaches = inn & (_clamp_huge(d) < origin + span)
    ok = inn & (ll > 0) & (d >= 0) & (ll <= out_size - d)
    a = np.where(inn, np.clip(_clamp_huge(d) - origin, 0, span), span)
    b = np.where(ok, np.clip(d + ll - origin, 0, span), a)
    more = bool(reaches[-1] and q[-1] + 1 < n)
    return a, np.maximum(a, b), _clamp_huge(s) - d, int(below.sum()), more


def _window_words(lit, m, win, first, origin, w0, v, merges, owner, base):
    """``WordJob.start`` and ``finish`` for the words at region offsets
    ``w0`` against one window: each word's first slot by the binary
    search, then the slots that start inside the word."""
    s_lo, s_hi, s_delta = win[:3]
    i = np.full(len(w0), first)
    j = np.full(len(w0), THREADS)
    while (i < j).any():
        act = i < j
        mid = (i + j) >> 1
        go = s_hi[np.minimum(mid, THREADS - 1)] <= w0
        i = np.where(act & go, mid + 1, i)
        j = np.where(act & ~go, mid, j)
    step = 0
    while True:
        ic = np.minimum(i, THREADS - 1)
        act = i < THREADS
        if step:
            act &= s_lo[ic] < w0 + 16
        if not act.any():
            break
        bl = np.maximum(s_lo[ic], w0) - w0
        bh = np.minimum(s_hi[ic], w0 + 16) - w0
        use = act & (bl < bh)
        if use.any():
            wsel = np.nonzero(use)[0]
            x = _load_source(lit, m, origin + w0[wsel] + s_delta[ic[wsel]],
                             bl[wsel], bh[wsel])
            k = _byte_mask(bl[wsel], bh[wsel])
            v[wsel] = (v[wsel] & ~k) | (x & k)
            for word, lo_b, hi_b, slot in zip(wsel, bl[wsel], bh[wsel],
                                              ic[wsel]):
                at = origin + w0[word]
                merges[at + lo_b:at + hi_b] += 1
                owner[at + lo_b:at + hi_b] = base + slot
        i = np.where(act, i + 1, i)
        step += 1


def _k8a_emulated(lit: np.ndarray, pieces: np.ndarray, ncells: int, m: int):
    """K8a block by block: (out, merges, owner, stores, paths): the
    output, the number of merges that wrote each byte and the piece that
    did, the number of stores of each word, and the blocks that took the
    one-window path and the cell-by-cell one."""
    pieces = tuple(np.asarray(r, np.int64) for r in pieces)
    out_size = ncells * CELL
    key = _end_key(pieces[0], pieces[2])
    out = np.zeros(out_size, np.uint8)
    merges = np.zeros(out_size, np.int64)
    owner = np.full(out_size, -1, np.int64)
    stores = np.zeros(out_size // 16, np.int64)
    paths = {"one window": 0, "cell by cell": 0}
    for blk in range(-(-ncells // CELLS_PER_BLOCK)):
        cell0 = blk * CELLS_PER_BLOCK
        cells = min(CELLS_PER_BLOCK, ncells - cell0)
        origin, span = cell0 * CELL, cells * CELL
        lo = _first_piece(key, origin)[0]
        win = _window(pieces, lo, origin, span, out_size)
        if win[4] and win[3] > 0:       # again from the first piece
            lo += win[3]
            win = _window(pieces, lo, origin, span, out_size)
        if not win[4]:
            paths["one window"] += 1
            regions = [(origin, span, lo, [win])]
        else:
            paths["cell by cell"] += 1
            regions = []
            for c in range(cells):
                cell = origin + c * CELL
                base0 = base = _first_piece(key, cell)[0]
                wins = [_window(pieces, base, cell, CELL, out_size)]
                while wins[-1][4]:
                    base += THREADS
                    wins.append(_window(pieces, base, cell, CELL, out_size))
                regions.append((cell, CELL, base0, wins))
        for start, size, base, wins in regions:
            w0 = 16 * np.arange(size // 16)
            v = np.zeros((size // 16, 4), np.uint32)
            for k, win in enumerate(wins):
                _window_words(lit, m, win, win[3] if k == 0 else 0, start,
                              w0, v, merges, owner, base + k * THREADS)
            out[start:start + size] = v.view(np.uint8).reshape(-1)
            stores[start // 16:(start + size) // 16] += 1
    return out, merges, owner, stores, paths


def _store_parts(lo: int, hi: int):
    """``store_bytes``: the (offset, width) stores of bytes [lo, hi)."""
    if lo == 0 and hi == 16:
        return [(0, 16)]
    parts, b = [], lo
    while b < hi:
        for w in (8, 4, 2, 1):
            if b % w == 0 and b + w <= hi:
                parts.append((b, w))
                b += w
                break
    return parts


def _k8c_emulated(out: np.ndarray, lit: np.ndarray, pieces: np.ndarray,
                  m: int, mo: int):
    """K8c warp by warp, in place on ``out`` (whose first byte sits at
    address ``mo`` mod 16): returns the number of stores that wrote each
    byte and the piece that did."""
    dst, src, ln = (np.asarray(r, np.int64) for r in pieces)
    n, out_len, lit_len = len(dst), len(out), len(lit)
    written = np.zeros(out_len, np.int64)
    owner = np.full(out_len, -1, np.int64)
    lanes = np.arange(32)
    for warp in range(-(-n // 32)):
        p = warp * 32 + lanes
        inn = p < n
        pc = np.minimum(p, n - 1)
        d = np.where(inn, dst[pc], 0)
        s = np.where(inn, src[pc], 0)
        ll = np.where(inn, ln[pc], 0)
        ok = inn & (d >= 0) & (s >= 0) & (ll > 0) & (ll <= out_len - d) & \
            (ll <= lit_len - s)
        dw = np.where(ok, (d + mo) >> 4, 0)
        nw = np.where(ok, ((d + mo + ll - 1) >> 4) - dw + 1, 0)
        incl = np.cumsum(nw)
        excl = incl - nw
        total = int(incl[-1])
        head, tail, delta = d + mo, d + mo + ll, s - d
        for x0 in range(0, total, 32 * UNROLL):
            pending = []
            for u in range(UNROLL):            # every load before a store
                x = x0 + 32 * u + lanes
                i = np.zeros(32, np.int64)
                for k in (16, 8, 4, 2, 1):
                    i = np.where(excl[i + k] <= x, i + k, i)
                word = dw[i] + (x - excl[i])
                w0 = 16 * word
                lo = np.clip(head[i] - w0, 0, 16)
                hi = np.where(x >= total, lo, np.clip(tail[i] - w0, 0, 16))
                live = lo < hi
                if live.any():
                    val = _load_source(lit, m, (w0 - mo + delta[i])[live],
                                       lo[live], hi[live])
                    pending.append((word[live], lo[live], hi[live], val,
                                    p[i][live]))
            for words, los, his, vals, owners in pending:
                for word, lo_b, hi_b, val, who in zip(words, los, his, vals,
                                                      owners):
                    raw = val.view(np.uint8)
                    for off, width in _store_parts(int(lo_b), int(hi_b)):
                        addr = 16 * int(word) + off    # from out's boundary
                        assert addr % width == 0
                        at = addr - mo
                        assert 0 <= at and at + width <= out_len
                        out[at:at + width] = raw[off:off + width]
                        written[at:at + width] += 1
                        owner[at:at + width] = who
    return written, owner


def _piece_owner(pieces: np.ndarray, size: int, valid) -> np.ndarray:
    owner = np.full(size, -1, np.int64)
    for k in np.nonzero(valid)[0]:
        owner[pieces[0, k]:pieces[0, k] + pieces[2, k]] = k
    return owner


def _check_k8a(lit, pieces, ncells, m):
    out, merges, owner, stores, paths = _k8a_emulated(lit, pieces, ncells, m)
    ref = RR.ragged_concat_reference(torch.from_numpy(lit),
                                     torch.from_numpy(pieces), ncells)
    assert np.array_equal(out, ref.numpy())
    d, ln = pieces[0], pieces[2]
    valid = (ln > 0) & (d >= 0) & (ln <= ncells * CELL - d)
    want = _piece_owner(pieces, ncells * CELL, valid)
    assert np.array_equal(owner, want)
    assert np.array_equal(merges, (want >= 0).astype(np.int64))
    assert (stores == 1).all()
    return out, paths


def _check_k8c(lit, pieces, out0, m, mo):
    out = out0.copy()
    written, owner = _k8c_emulated(out, lit, pieces, m, mo)
    ref = RR.small_merge_reference(torch.from_numpy(out0.copy()),
                                   torch.from_numpy(lit),
                                   torch.from_numpy(pieces))
    assert np.array_equal(out, ref.numpy())
    d, s, ln = pieces
    valid = (d >= 0) & (s >= 0) & (ln > 0) & (ln <= len(out0) - d) & \
        (ln <= len(lit) - s)
    want = _piece_owner(pieces, len(out0), valid)
    assert np.array_equal(owner, want)
    assert np.array_equal(written, (want >= 0).astype(np.int64))
    return out


# ---------------------------------------------------------------------------
# plans


def _plan_from_lens(rng, lens, lit_len):
    lens = np.asarray(lens, np.int64)
    srcs = np.asarray([rng.integers(0, lit_len - n + 1) for n in lens],
                      np.int64)
    return lens, srcs


def _mixed_lens(rng, total, lo=1, hi=3000):
    lens, left = [], total
    while left > 0:
        n = min(int(rng.integers(lo, hi)), left)
        lens.append(n)
        left -= n
    return lens


def _plan(name: str, rng):
    """(lens, srcs, lit, out_len) of a named plan."""
    lit_len = 400_000
    if name == "several_mib_piece":
        lens = [5000, 3 * MIB + 123, 700, 100, 20_000]
        lit_len = 4 * MIB
    elif name == "ends_on_8k":
        lens = [CELL, 2 * CELL, 600, CELL - 600, 300, 212, CELL - 512,
                3 * CELL, 1, CELL - 1, 513, 2 * CELL - 513]
    elif name == "ends_on_1k":
        lens = [1024, 512, 512, 1000, 24, 2048, 100, 924, 3000, 72,
                1024 * 9, 511, 513]
    elif name.startswith("out_len_"):
        lens = _mixed_lens(rng, int(name[8:]), 1, 1500)
        lit_len = 20_000
    elif name == "only_long":
        lens = _mixed_lens(rng, 200_000, RR.SHORT_LEN + 1, 20_000)
    elif name == "only_short":
        lens = _mixed_lens(rng, 60_000, 1, RR.SHORT_LEN + 1)
    elif name == "short_pieces_share_words":
        lens = _mixed_lens(rng, 20_000, 1, 16)
    else:
        raise KeyError(name)
    lit = rng.integers(0, 256, lit_len, dtype=np.uint8)
    lens, srcs = _plan_from_lens(rng, lens, lit_len)
    return lens, srcs, lit, int(lens.sum())


PLANS = ["several_mib_piece", "ends_on_8k", "ends_on_1k", "out_len_1",
         "out_len_8191", "out_len_8192", "out_len_8193", "only_long",
         "only_short", "short_pieces_share_words"]


def _np_split(dst, srcs, lens):
    """The long and short piece tables, (3, n) int64 in dst order, as
    ``replay_ragged.split_pieces`` makes them on the device."""
    t = np.stack([dst, srcs, lens]).astype(np.int64)
    short = t[2] <= RR.SHORT_LEN
    return (np.ascontiguousarray(t[:, ~short]),
            np.ascontiguousarray(t[:, short]))


def _tables(lens, srcs):
    """The long and short piece tables ``replay_pieces_ragged`` builds."""
    pl_, ps_ = RR.merge_contiguous(lens, srcs)
    return _np_split(np.cumsum(pl_) - pl_, ps_, pl_)


@pytest.mark.parametrize("name", ["only_long", "only_short", "ends_on_1k"])
def test_split_pieces_keeps_the_order(name):
    """The long and short tables that ``flat_tables`` uploads: contiguous,
    each ascending by dst, and the numpy split of the merged plan."""
    lens, srcs, lit, _ = _plan(name, np.random.default_rng(3))
    long_t, short_t = RR.flat_tables(lens, srcs, torch.from_numpy(lit))
    want = _tables(lens, srcs)
    for got, ref in zip((long_t, short_t), want):
        assert got.is_contiguous() and got.dtype == torch.int64
        assert np.array_equal(got.numpy(), ref)
        assert (np.diff(ref[0]) > 0).all()


@pytest.mark.parametrize("name", PLANS)
def test_replay_pieces_ragged_equals_jax(name):
    rng = np.random.default_rng(len(name) * 7 + 1)
    lens, srcs, lit, out_len = _plan(name, rng)
    got = RR.replay_pieces_ragged(lens, srcs, torch.from_numpy(lit),
                                  out_len).numpy()
    want = np.asarray(jrr.replay_pieces_ragged(lens, srcs, jnp.asarray(lit),
                                               out_len, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, jrr.replay_pieces_reference(lens, srcs, lit,
                                                           out_len))
    long_t, short_t = _tables(lens, srcs)
    if name == "only_long":
        assert short_t.shape[1] == 0 and long_t.shape[1] > 0
    if name in ("only_short", "short_pieces_share_words"):
        assert long_t.shape[1] == 0 and short_t.shape[1] > 0


def _misaligned(k: int, short: bool):
    """Pieces whose source sits k bytes past their destination mod 16."""
    rng = np.random.default_rng(100 + k + 16 * short)
    lens = np.asarray(_mixed_lens(rng, 30_000, 1, RR.SHORT_LEN + 1) if short
                      else _mixed_lens(rng, 60_000, RR.SHORT_LEN + 1, 9000),
                      np.int64)
    dst = np.cumsum(lens) - lens
    lit_len = 100_000
    srcs = np.asarray([(int(rng.integers(0, lit_len - n - 32)) & ~15)
                       + ((int(dd) + k) & 15) for n, dd in zip(lens, dst)],
                      np.int64)
    lit = rng.integers(0, 256, lit_len, dtype=np.uint8)
    assert ((srcs - dst) % 16 == k).all()
    return lens, srcs, lit


@pytest.mark.parametrize("k", range(16))
def test_every_misalignment_equals_jax(k):
    lens, srcs, lit = _misaligned(k, short=k % 2 == 1)
    out_len = int(lens.sum())
    got = RR.replay_pieces_ragged(lens, srcs, torch.from_numpy(lit),
                                  out_len).numpy()
    want = np.asarray(jrr.replay_pieces_ragged(lens, srcs, jnp.asarray(lit),
                                               out_len, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, jrr.replay_pieces_reference(lens, srcs, lit,
                                                           out_len))


def _tokens(seed: int):
    """A token stream whose matches copy earlier matches: a layered plan."""
    rng = np.random.default_rng(seed)
    tokens, pos = [], 0
    for _ in range(200):
        n = int(rng.integers(20, 900))
        tokens.append((0, n, 0))
        pos += n
        if pos > 2000:
            ml = int(rng.integers(32, 1200))
            tokens.append((1, ml, int(rng.integers(ml, pos))))
            pos += ml
    tokens.append((1, pos, pos))
    tokens.append((1, 3 * MIB // 2, pos + 100))
    kinds, lens, dists = (np.asarray(c) for c in zip(*tokens))
    lit = rng.integers(0, 256, int(lens[kinds == 0].sum()), dtype=np.uint8)
    return kinds.astype(np.uint8), lens.astype(np.int64), \
        dists.astype(np.int64), lit


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_replay_pieces_layered_equals_jax(seed):
    kinds, lens, dists, lit = _tokens(seed)
    lay = pruntime.flatten_replay_layered(kinds, lens, dists)
    assert lay is not None and lay[3] >= 1
    for a, b in zip(lay[:3], jruntime.flatten_replay_layered(kinds, lens,
                                                            dists)[:3]):
        assert np.array_equal(a, b)
    pl_, ps_, py_, nl = lay
    out_len = int(lens.sum())
    got = RR.replay_pieces_layered(pl_, ps_, py_, nl, torch.from_numpy(lit),
                                   out_len).numpy()
    want = np.asarray(jrr.replay_pieces_layered(
        pl_, ps_, py_, nl, jnp.asarray(lit), out_len, interpret=True))
    assert np.array_equal(got, want)
    data = pruntime.replay_tokens(kinds, lens, dists, lit, out_len)
    assert np.array_equal(got, data)


# ---------------------------------------------------------------------------
# the emulations


@pytest.mark.parametrize("k", range(16))
def test_k8a_emulation_every_misalignment(k):
    """Source against destination k mod 16, and ``lit`` itself k bytes
    past a 16-byte boundary."""
    lens, srcs, lit = _misaligned(k, short=False)
    long_t, short_t = _np_split(np.cumsum(lens) - lens, srcs, lens)
    assert short_t.shape[1] == 0
    _, paths = _check_k8a(lit, long_t, -(-int(lens.sum()) // CELL), m=k)
    assert paths["cell by cell"] == 0      # long pieces: one window


@pytest.mark.parametrize("k", range(16))
def test_k8c_emulation_every_misalignment(k):
    """Source against destination k mod 16, ``lit`` k and ``out`` 15 - k
    bytes past a 16-byte boundary, short pieces placed over K8a's bytes."""
    lens, srcs, lit = _misaligned(k, short=True)
    long_t, short_t = _np_split(np.cumsum(lens) - lens, srcs, lens)
    assert long_t.shape[1] == 0
    rng = np.random.default_rng(k)
    out0 = rng.integers(0, 256, int(lens.sum()) + 5, dtype=np.uint8)
    _check_k8c(lit, short_t, out0, m=k, mo=15 - k)


@pytest.mark.parametrize("name", PLANS)
def test_emulations_equal_the_plain_versions_on_the_plans(name):
    rng = np.random.default_rng(len(name) * 7 + 1)
    lens, srcs, lit, out_len = _plan(name, rng)
    long_t, short_t = _tables(lens, srcs)
    ncells = -(-out_len // CELL)
    out, paths = _check_k8a(lit, long_t, ncells, m=3)
    assert paths["cell by cell"] == 0
    out = _check_k8c(lit, short_t, out, m=3, mo=0)
    assert np.array_equal(out[:out_len], jrr.replay_pieces_reference(
        lens, srcs, lit, out_len))


def test_k8a_emulation_many_pieces_a_cell():
    """Pieces of 1..40 bytes in a K8a table: hundreds meet a cell, so the
    block takes its cells one by one, each over several windows."""
    rng = np.random.default_rng(5)
    lens = np.asarray(_mixed_lens(rng, 3 * CELL + 77, 1, 40), np.int64)
    dst = np.cumsum(lens) - lens
    lit = rng.integers(0, 256, 10_000, dtype=np.uint8)
    srcs = rng.integers(-30, 10_000, len(lens))
    pieces = np.stack([dst, srcs, lens]).astype(np.int64)
    assert len(lens) > 3 * THREADS
    _, paths = _check_k8a(lit, pieces, 4, m=9)
    assert paths == {"one window": 0, "cell by cell": 1}


@pytest.mark.parametrize("gap", [0, 100])
def test_k8a_one_window_holds_every_long_piece_of_a_block(gap):
    """Tens of thousands of 1-byte pieces in the first block (which takes
    its cells one by one), then the densest long pieces (513 bytes, with
    or without gaps between them): the probe rounds leave the next blocks'
    first pieces up to 195 records into their windows, so those windows
    are loaded again from the first piece, and every later block takes the
    one-window path."""
    rng = np.random.default_rng(gap + 1)
    tiny = 49_979
    n = 128
    dst = np.concatenate([np.arange(tiny), CELLS_PER_BLOCK * CELL +
                          np.arange(n) * (RR.SHORT_LEN + 1 + gap)])
    lens = np.concatenate([np.ones(tiny, np.int64),
                           np.full(n, RR.SHORT_LEN + 1, np.int64)])
    lit = rng.integers(0, 256, 50_000, dtype=np.uint8)
    srcs = rng.integers(0, 50_000 - 600, len(dst))
    pieces = np.stack([dst, srcs, lens]).astype(np.int64)
    ncells = -(-int(dst[-1] + lens[-1]) // CELL)
    lo = _first_piece(_end_key(dst, lens), CELLS_PER_BLOCK * CELL)[0]
    assert lo + THREADS < tiny + n          # the first window falls short
    _, paths = _check_k8a(lit, pieces, ncells, m=1)
    blocks = -(-ncells // CELLS_PER_BLOCK)
    assert paths == {"one window": blocks - 1, "cell by cell": 1}


@pytest.mark.parametrize("n", [0, 1, WINDOW, WINDOW + 1, 50_000, 1_000_000])
def test_k8a_search_finds_the_first_piece(n):
    """The probe rounds leave the first piece whose end passes the cell's
    start inside the last window, in few rounds (one piece of 600 bytes
    every 700)."""
    dst = 700 * np.arange(n, dtype=np.int64)
    key = _end_key(dst, np.full(n, 600, np.int64))
    ncells = -(-max(700 * n, 1) // CELL)
    worst = 0
    for blk in sorted({0, 1, ncells // 3, ncells // 2, ncells - 1}):
        cell = blk * CELL
        lo, hi, rounds = _first_piece(key, cell)
        f = int(np.searchsorted(key, cell, side="right"))
        assert lo <= f <= hi and hi - lo <= WINDOW
        f_window = lo + int((key[lo:lo + THREADS] <= cell).sum())
        assert f_window == f
        worst = max(worst, rounds)
    assert worst <= max(0, int(np.ceil(np.log(max(n, 1) / WINDOW) /
                                       np.log(THREADS))) + 1)


# ---------------------------------------------------------------------------
# corrupt tables


_CORRUPT = {
    "neg_dst": (0, -5), "past_dst": (0, 1 << 40), "long_len": (2, 1 << 40),
    "zero_len": (2, 0), "neg_src": (1, -7), "past_src": (1, 1 << 40),
}


def _corrupt_table(field: str):
    """Three good pieces and one corrupt one, placed so that the table
    stays in the order that K8a searches (``check_order``): last, or first
    for a negative dst, whose span [-5, 595) then ends before the first
    good piece.  Returns the table and the corrupt piece's column."""
    row, val = _CORRUPT[field]
    t = np.array([[600, 1300, 2600, 5000], [10, 300, 40, 50],
                  [600, 1200, 2400, 600]], np.int64)
    t[row, 3] = val
    if field == "neg_dst":
        return np.ascontiguousarray(t[:, [3, 0, 1, 2]]), 0
    return t, 3


@pytest.mark.parametrize("field", sorted(_CORRUPT))
def test_k8a_plain_on_a_corrupt_table(field):
    lit = np.arange(6000).astype(np.uint8)
    t, bad = _corrupt_table(field)
    RR.check_order(torch.from_numpy(t))
    out = RR.ragged_concat(torch.from_numpy(lit), torch.from_numpy(t),
                           1).numpy()
    want = np.zeros(CELL, np.uint8)
    for d, s, n in np.delete(t, bad, axis=1).T:
        want[d:d + n] = lit[s:s + n]
    d, s, n = t[:, bad]
    if n > 0 and d >= 0 and n <= CELL - d:
        idx = s + np.arange(n)
        want[d:d + n] = np.where((idx >= 0) & (idx < len(lit)),
                                 lit[np.clip(idx, 0, len(lit) - 1)], 0)
    assert np.array_equal(out, want)
    if field == "neg_src":
        assert (out[5000:5007] == 0).all() and out[5007] == lit[0]
    _check_k8a(lit, t, 1, m=5)


@pytest.mark.parametrize("field", sorted(_CORRUPT))
def test_k8c_plain_on_a_corrupt_table(field):
    lit = np.arange(6000).astype(np.uint8)
    t, bad = _corrupt_table(field)
    base = np.full(CELL, 0xAB, np.uint8)
    out = RR.small_merge(torch.from_numpy(base.copy()), torch.from_numpy(lit),
                         torch.from_numpy(t)).numpy()
    want = base.copy()
    for d, s, n in np.delete(t, bad, axis=1).T:
        want[d:d + n] = lit[s:s + n]
    assert np.array_equal(out, want)            # the corrupt piece skipped
    _check_k8c(lit, t, base, m=0, mo=8)


_ORDER = {
    "ascending": ([[0, 700, 2000], [600, 1200, 2500]], True),
    "touching": ([[0, 600, 1800], [600, 1200, 2500]], True),
    "one": ([[5], [9]], True),
    "empty": ([[], []], True),
    "corrupt_in_order": ([[-5, 0, 100, 16000, 16500],
                          [5, -20, 10, 500, 8]], True),
    "swapped": ([[700, 0, 2000], [1200, 600, 2500]], False),
    "overlap_by_one": ([[0, 599, 2000], [600, 1200, 2500]], False),
    "negative_dst_reaches_on": ([[0, -5, 2000], [600, 700, 2500]], False),
}


@pytest.mark.parametrize("name", sorted(_ORDER))
def test_k8a_takes_only_tables_in_its_search_order(name):
    """``check_order`` accepts a table whose spans [dst, dst + max(len,
    0)) follow one another, corrupt entries included, and refuses any
    other; the CPU's K8a refuses it too, K8c takes any order."""
    (dst, lens), ok = _ORDER[name]
    t = torch.tensor([dst, [0] * len(dst), lens],
                     dtype=torch.int64).reshape(3, -1)
    lit = torch.arange(64, dtype=torch.uint8)
    out = torch.zeros(3 * CELL, dtype=torch.uint8)
    RR.small_merge(out, lit, t)
    if ok:
        RR.check_order(t)
        assert RR.ragged_concat(lit, t, 3).shape[0] == 3 * CELL
    else:
        with pytest.raises(ValueError, match="ascending and disjoint"):
            RR.check_order(t)
        with pytest.raises(ValueError, match="ascending and disjoint"):
            RR.ragged_concat(lit, t, 3)


@pytest.mark.parametrize("seed", range(6))
def test_k8a_emulation_on_ordered_tables_with_corrupt_entries(seed):
    """Random tables in ``check_order``'s order with corrupt entries among
    the good ones (lengths of 0 or below, sources outside ``lit``, a
    negative dst first, a span past the output last): the emulated kernel
    writes what the plain version writes, each byte once by its owner."""
    rng = np.random.default_rng(100 + seed)
    hi = (40, 600, 3000, 9000, 20_000, 700)[seed]
    n = 400
    lens = rng.integers(1, hi, n)
    gaps = np.where(rng.random(n) < 0.5, 0, rng.integers(0, 300, n))
    dst = np.cumsum(lens + gaps) - lens
    lit_len = 30_000
    srcs = rng.integers(0, lit_len - hi, n)
    bad = rng.random(n) < 0.2
    what = rng.integers(0, 4, n)
    lens = np.where(bad & (what == 0), 0, lens)
    lens = np.where(bad & (what == 1), -rng.integers(1, 50, n), lens)
    srcs = np.where(bad & (what == 2), -rng.integers(1, 50, n), srcs)
    srcs = np.where(bad & (what == 3), lit_len - rng.integers(0, 9, n), srcs)
    dst[0] -= 37                        # starts before the output
    ncells = max(1, int(dst[-1]) // CELL)
    lens[-1] = 1 << 40                  # past the output
    pieces = np.stack([dst, srcs, lens]).astype(np.int64)
    RR.check_order(torch.from_numpy(pieces))
    lit = rng.integers(0, 256, lit_len, dtype=np.uint8)
    out, _ = _check_k8a(lit, pieces, ncells, m=seed)
    assert out.any()


# ---------------------------------------------------------------------------
# the wrappers


_WRONG = ["bytes_dtype", "table_dtype", "table_rows", "table_1d",
          "table_device", "table_strided"]


def _wrong(what: str):
    lit = torch.zeros(64, dtype=torch.uint8)
    table = torch.tensor([[0], [0], [4]], dtype=torch.int64)
    if what == "bytes_dtype":
        lit = lit.to(torch.int16)
    elif what == "table_dtype":
        table = table.to(torch.int32)
    elif what == "table_rows":
        table = torch.zeros(2, 1, dtype=torch.int64)
    elif what == "table_1d":
        table = table.reshape(-1)
    elif what == "table_device":
        table = table.to("meta")
    else:
        table = torch.zeros(2, 3, dtype=torch.int64).t()
    err = ValueError if what in ("table_device", "table_strided") \
        else TypeError
    return lit, table, err


@pytest.mark.parametrize("what", _WRONG)
def test_k8a_wrapper_rejects(what):
    lit, table, err = _wrong(what)
    with pytest.raises(err):
        RR.ragged_concat(lit, table, 1)


@pytest.mark.parametrize("what", _WRONG)
def test_k8c_wrapper_rejects(what):
    lit, table, err = _wrong(what)
    out = torch.zeros(64, dtype=torch.uint8)
    if what == "bytes_dtype":
        out = out.to(torch.int16)
    with pytest.raises(err):
        RR.small_merge(out, lit, table)


def test_literal_pass_has_no_device_sync_or_repeat_interleave(monkeypatch):
    """The path from the piece tables to K8a and K8c: no
    ``repeat_interleave`` (whose output size reads the device) and no read
    of a tensor's value on the host; each wrapper is called once with its
    table."""
    def banned(*args, **kwargs):
        raise AssertionError("called on the literal pass")

    lens, srcs, lit, out_len = _plan("ends_on_1k", np.random.default_rng(1))
    lit_t = torch.from_numpy(lit)
    long_t, short_t = RR.flat_tables(lens, srcs, lit_t)
    assert long_t.is_contiguous() and short_t.is_contiguous()
    assert long_t.shape[0] == short_t.shape[0] == 3
    assert long_t.shape[1] > 0 and short_t.shape[1] > 0
    calls = []
    monkeypatch.setattr(RR, "ragged_concat", lambda lit, t, nc: calls.append(
        ("k8a", t, nc)) or torch.zeros(nc * CELL, dtype=torch.uint8))
    monkeypatch.setattr(RR, "small_merge", lambda out, lit, t: calls.append(
        ("k8c", t)) or out)
    monkeypatch.setattr(torch, "repeat_interleave", banned)
    for name in ("__bool__", "__int__", "__index__", "item", "tolist",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, banned)
    out = RR._literal_pass(long_t, short_t, lit_t, out_len)
    monkeypatch.undo()
    assert out.shape[0] == -(-out_len // CELL) * CELL
    assert [c[0] for c in calls] == ["k8a", "k8c"]
    assert calls[0][1] is long_t and calls[1][1] is short_t


@pytest.mark.parametrize("name", ["lrzt_replay_ragged", "lrzt_replay_small",
                                  "lrzt_replay_layered"])
def test_ctypes_signatures_match_the_entry_points(name):
    """The argument count that ``_build`` declares for each replay entry
    point is the one the CUDA source defines (ctypes would refuse the call
    only on the card)."""
    from lrzip_next_tpu_torch.ops import _build
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', _SRC)
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(_build._SIGNATURES[name])
