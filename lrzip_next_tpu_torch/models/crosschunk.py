"""Cross-chunk long-range matching.

The reference's match reach ends at the current rzip chunk (its hash
table resets per chunk, src/rzip.c:601-614), so multi-chunk archives
never deduplicate across chunk boundaries.  The *format* allows it: the
decoder replays matches against the whole decompressed output
(src/runzip.c:184-241 seeks fd_hist from byte 0), and distances are only
bounded by the chunk byte width.  This module exploits that:

1. content-defined anchors - positions where a rolling 8-byte gear hash
   meets a mask (shift-robust sampling, ~1 anchor / 2^bits bytes);
2. a persistent index of (window fingerprint -> absolute position) over
   all previous chunks;
3. lookups for the current chunk's anchors; hits are verified and
   extended bidirectionally against the memmapped input, then spliced
   into literal spans of the in-chunk tokenisation.

Result: -U-scale dedup with memory bounded by the sampled index.

**Compatibility**: these archives are an extension.  A decoder honoring
the fd_hist replay rules handles them (ours does, including file-backed
history), but the reference *binary* cannot: it always decodes through
a RAM tmpoutbuf flushed after every chunk (src/runzip.c:401-403,
src/lrzip.c:1701-1703), so earlier chunks are unreachable there.
Proven both ways in tests/test_reference_binary_interop.py; leave
cross_chunk off (the default) for reference-portable archives.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..format.constants import MINIMUM_MATCH
from ..ops import gearscan

_GEAR = np.random.default_rng(0x6EA12).integers(
    0, 1 << 63, 256, dtype=np.int64).astype(np.uint64)

WINDOW = 32  # fingerprint window at anchors (tree hash, same as matcher)

# the counters ``find_cross_matches`` gives a chunk (a -U window)
COUNTERS = ("cross_anchors", "cross_hits", "cross_matches", "cross_bytes",
            "cross_left_bytes")


def gear_anchor_positions(data: np.ndarray, mask_bits: int = 10
                          ) -> np.ndarray:
    """Positions whose preceding 8 bytes satisfy the gear condition."""
    n = len(data)
    if n < 16:
        return np.zeros(0, dtype=np.int64)
    with np.errstate(over="ignore"):
        g = np.zeros(n, dtype=np.uint64)
        for k in range(8):
            # gear hash: sum of shifted table lookups over 8 bytes
            g[8:] += _GEAR[data[8 - k - 1 + np.arange(0, n - 8)]] \
                << np.uint64(k)
        mask = np.uint64((1 << mask_bits) - 1)
        sel = (g & mask) == mask
        sel[: 8] = False
        # a window shorter than WINDOW has no position with a whole
        # window after it (n - WINDOW < 0 would clear only the tail)
        sel[max(n - WINDOW, 0):] = False
        return np.flatnonzero(sel).astype(np.int64)


def window_hashes_at(data: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """32-byte tree-reduction fingerprints at the given positions only
    (gathered columns; same multipliers as the full matcher hash)."""
    if len(pos) == 0:
        return np.zeros(0, dtype=np.uint64)
    m1 = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
    m2 = (0xD1B54A33, 0xABC98389, 0x8CB92BA7, 0x2545F491, 0x9E377F4B)
    with np.errstate(over="ignore"):
        cols = data[pos[:, None] + np.arange(WINDOW)[None, :]] \
            .astype(np.uint32)
        a = cols.copy()
        b = cols.copy()
        for k in range(5):
            half = 1 << k
            a = a[:, :-half] * np.uint32(m1[k]) + a[:, half:]
            b = b[:, :-half] * np.uint32(m2[k]) + b[:, half:]
        return (a[:, 0].astype(np.uint64) << np.uint64(32)) \
            | b[:, 0].astype(np.uint64)


def anchor_set(data: np.ndarray, mask_bits: int = 10,
               dev: Optional[torch.Tensor] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The window's anchor set: its gear anchor positions, ascending, and
    the fingerprint at each.  Where ``dev`` holds the window on a CUDA
    card (its first ``len(data)`` bytes; the rest, padding, is not read),
    K11 (``ops/gearscan.py``) scans it there in one launch, on that
    card's current stream; else the host pair ``gear_anchor_positions`` and
    ``window_hashes_at``.  Both give the same arrays."""
    if dev is not None and dev.is_cuda:
        # the C entry launches on the current device: the window's
        with torch.cuda.device(dev.device):
            return gearscan.read_anchors(
                *gearscan.gear_anchors(dev, len(data), _GEAR, mask_bits))
    pos = gear_anchor_positions(data, mask_bits)
    return pos, window_hashes_at(data, pos)


class CrossChunkIndex:
    """Persistent anchor index over previously compressed chunks."""

    def __init__(self, mask_bits: int = 10):
        self.mask_bits = mask_bits
        self._hashes: List[np.ndarray] = []
        self._positions: List[np.ndarray] = []
        self._sorted_h: Optional[np.ndarray] = None
        self._sorted_p: Optional[np.ndarray] = None

    def add_chunk(self, data: np.ndarray, abs_base: int,
                  anchors: Optional[Tuple[np.ndarray, np.ndarray]] = None
                  ) -> None:
        """Index the chunk's anchors (``anchors``: its ``anchor_set``,
        computed from ``data`` where not given)."""
        pos, h = anchors if anchors is not None \
            else anchor_set(data, self.mask_bits)
        if len(pos) == 0:
            return
        self._hashes.append(h)
        self._positions.append(pos + abs_base)
        self._sorted_h = None  # invalidate

    def _ensure_sorted(self) -> bool:
        if self._sorted_h is None and self._hashes:
            h = np.concatenate(self._hashes)
            p = np.concatenate(self._positions)
            order = np.argsort(h, kind="stable")
            self._sorted_h = h[order]
            self._sorted_p = p[order]
        return self._sorted_h is not None

    def lookup(self, data: np.ndarray, abs_base: int,
               counts: Optional[dict] = None,
               anchors: Optional[Tuple[np.ndarray, np.ndarray]] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(cur_abs, src_abs) candidate pairs for the chunk's anchors
        (``anchors`` as for ``add_chunk``); ``counts["cross_anchors"]``
        takes the number of anchors looked up (0 while the index is
        empty)."""
        if counts is not None:
            counts["cross_anchors"] = 0
        if not self._ensure_sorted():
            return (np.zeros(0, np.int64),) * 2
        pos, h = anchors if anchors is not None \
            else anchor_set(data, self.mask_bits)
        if counts is not None:
            counts["cross_anchors"] = len(pos)
        if len(pos) == 0:
            return (np.zeros(0, np.int64),) * 2
        idx = np.searchsorted(self._sorted_h, h)
        idx = np.clip(idx, 0, len(self._sorted_h) - 1)
        hit = self._sorted_h[idx] == h
        return (pos[hit] + abs_base), self._sorted_p[idx[hit]]


def find_cross_matches(full_data: np.ndarray, index: CrossChunkIndex,
                       chunk_base: int, chunk_len: int, max_dist: int,
                       counts: Optional[dict] = None,
                       anchors: Optional[Tuple[np.ndarray, np.ndarray]]
                       = None) -> List[Tuple[int, int, int]]:
    """Verified, extended cross-chunk matches for one chunk.

    Returns (start_abs, length, dist) triples sorted by start, pruned of
    overlaps (greedy left-to-right).  Where ``counts`` is a dict it takes
    the chunk's counters (``COUNTERS``): the anchors looked up, the
    candidate hits, the matches kept, the bytes they cover, and the bytes
    the left extension stepped over, every candidate that reached it.
    ``anchors`` is the chunk's ``anchor_set``, computed here where not
    given.
    """
    chunk = full_data[chunk_base:chunk_base + chunk_len]
    cur, src = index.lookup(chunk, chunk_base, counts, anchors)
    out: List[Tuple[int, int, int]] = []
    frontier = chunk_base
    left = 0
    from .rzip_host import extend_one
    for c, s in zip(cur.tolist(), src.tolist()):
        if c < frontier or s >= c:
            continue
        dist = c - s
        if dist > max_dist:
            continue
        # extend left into unclaimed territory (source index must stay
        # >= 0: a negative numpy index would silently wrap to the end)
        start = c
        while start > frontier and start > chunk_base and \
                start - 1 - dist >= 0 and \
                full_data[start - 1] == full_data[start - 1 - dist]:
            start -= 1
        left += c - start
        ml = extend_one(full_data, start - dist, start)
        end = min(start + ml, chunk_base + chunk_len)
        if end - start < MINIMUM_MATCH:
            continue
        out.append((start, end - start, dist))
        frontier = end
    if counts is not None:
        counts.update(cross_hits=len(cur), cross_matches=len(out),
                      cross_bytes=sum(m[1] for m in out),
                      cross_left_bytes=left)
    return out


def splice_cross_matches(kinds: np.ndarray, lengths: np.ndarray,
                         dists: np.ndarray, cross, chunk_base: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replace every region a cross match covers with ONE match token.

    The cross intervals are verified maximal equalities, so any tokens
    they cover - literals AND in-window matches (a duplicated region's
    internal structure re-tokenises into many short matches) - collapse
    into a single long-distance match, matching the single long match
    the reference's whole-window hash search would emit.  Tokens cut at
    an interval edge are clipped: any sub-range of a match token is
    itself a valid match (the decoder's replay is positionwise), and
    literals clip trivially.
    """
    if not cross:
        return kinds, lengths, dists
    ends = np.cumsum(lengths)
    starts = ends - lengths  # chunk-relative token starts
    chunk_len = int(ends[-1]) if len(ends) else 0
    ok_kinds: List[int] = []
    ok_lens: List[int] = []
    ok_dists: List[int] = []

    def emit(k: int, ln: int, d: int):
        if ln <= 0:
            return
        if ok_kinds and ok_kinds[-1] == k and (k == 0 or
                                               ok_dists[-1] == d):
            ok_lens[-1] += ln  # merge adjacent same-kind pieces
            return
        ok_kinds.append(k)
        ok_lens.append(ln)
        ok_dists.append(d)

    t = 0  # original token cursor

    def emit_originals(upto: int, p: int) -> int:
        """Emit original tokens (clipped) covering [p, upto)."""
        nonlocal t
        while p < upto and t < len(kinds):
            t0, t1 = int(starts[t]), int(ends[t])
            if t1 <= p:
                t += 1
                continue
            seg = min(t1, upto) - p
            emit(int(kinds[t]), seg, int(dists[t]) if kinds[t] else 0)
            p += seg
            if t1 <= p:
                t += 1
        return p

    p = 0
    for cs_abs, cl, cd in sorted(cross):
        cs = max(cs_abs - chunk_base, p)
        ce = min(cs_abs - chunk_base + cl, chunk_len)
        if ce - cs < MINIMUM_MATCH:
            continue
        p = emit_originals(cs, p)
        emit(1, ce - p, cd)
        p = ce
    emit_originals(chunk_len, p)
    return (np.array(ok_kinds, dtype=np.uint8),
            np.array(ok_lens, dtype=np.int64),
            np.array(ok_dists, dtype=np.int64))
