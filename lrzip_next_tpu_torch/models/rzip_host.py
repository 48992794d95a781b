"""Host (numpy) rzip long-range matcher - the correctness reference.

Re-expresses the reference's single-threaded greedy hash search
(src/rzip.c:586-762 ``hash_search``) as batch array operations:

1. 31-byte-window polynomial fingerprints for every position via prefix
   sums (replaces the incremental Zobrist tag roll, src/rzip.c:385-429);
2. nearest-previous-occurrence candidates via one stable sort by
   (fingerprint, position) (replaces the open-addressed hash table with
   tag-mask sparsification, src/rzip.c:304-383) - batch search is exact,
   so sparsification is a memory knob here, not a recall compromise;
3. greedy left-to-right token selection with *lazy* match extension: the
   walk only extends matches it actually emits, so total work is
   O(n + selected match bytes) even on highly repetitive data (the
   reference gets the same property by jumping ``p`` past each emitted
   match, src/rzip.c:683-687);
4. fingerprint equality stands in for the 31-byte compare; the lazy
   extension starts at offset 0, so a (vanishingly rare) hash collision
   yields a < MINIMUM_MATCH extension and the candidate is skipped -
   never a corrupt token.

The GPU matcher in ops/matcher.py finds its tokens another way (anchor
seeds, sorts and a selection); this module holds the host-side helpers
it shares (``literals_of``, ``extend_one``) and the host encoder.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..format.constants import MINIMUM_MATCH

def window_fingerprints(data: np.ndarray, w: int = 32) -> np.ndarray:
    """64-bit fingerprint of data[i:i+w] for every i in [0, n-w].

    Same tree-reduction construction as the device path
    (ops/anchor.py): two independent 32-bit hashes from
    log2(w) shifted multiply-add levels, packed into one uint64.  Pure
    vectorised uint32 ops - ~100x faster than the earlier modular
    prefix-product scheme (uint64 cumprod has no SIMD path).
    ``w`` must be a power of two; 32 covers MINIMUM_MATCH=31.
    """
    n = len(data)
    if n < w:
        return np.zeros(0, dtype=np.uint64)
    assert w & (w - 1) == 0, "w must be a power of two"
    m1 = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
    m2 = (0xD1B54A33, 0xABC98389, 0x8CB92BA7, 0x2545F491, 0x9E377F4B)
    levels = w.bit_length() - 1
    with np.errstate(over="ignore"):
        d = data.astype(np.uint32)
        a, b = d, d
        for k in range(levels):
            half = 1 << k
            a = a[:-half] * np.uint32(m1[k % 5]) + a[half:]
            b = b[:-half] * np.uint32(m2[k % 5]) + b[half:]
        m = n - w + 1
        return (a[:m].astype(np.uint64) << np.uint64(32)) \
            | b[:m].astype(np.uint64)


def nearest_previous_candidates(fps: np.ndarray) -> np.ndarray:
    """cand[i] = largest j < i with fps[j] == fps[i], else -1."""
    n = len(fps)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(fps, kind="stable")
    sf = fps[order]
    cand = np.full(n, -1, dtype=np.int64)
    same = sf[1:] == sf[:-1]
    cand[order[1:][same]] = order[:-1][same]
    return cand


def extend_one(data: np.ndarray, src: int, pos: int,
               start: int = 0) -> int:
    """Common prefix length of data[pos:] vs data[src:] from offset start.

    Chunked vector compares with doubling block size; overlap-safe because
    for LZ factorisation the source window inside ``data`` equals the
    would-be output.
    """
    n = len(data)
    if src < 0 or src >= pos:
        return 0
    ml = start
    block = 4096
    while pos + ml < n:
        c = min(block, n - (pos + ml))
        a = data[pos + ml:pos + ml + c]
        b = data[src + ml:src + ml + c]
        neq = a != b
        if neq.any():
            return ml + int(neq.argmax())
        ml += c
        block = min(block * 2, 1 << 22)
    return ml


def greedy_select(data: np.ndarray, cand: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy left-to-right cover with lazy extension.

    Returns columnar tokens (kinds, lengths, dists); lengths unbounded
    (the stream encoder splits at MAX_TOKEN_LEN).
    """
    n = len(data)
    m = len(cand)
    # nxt[i]: next position >= i with a candidate, n if none
    has = cand >= 0
    nxt_vals = np.full(m, n, dtype=np.int64)
    idx = np.flatnonzero(has)
    nxt_vals[idx] = idx
    if m:
        nxt_vals = np.minimum.accumulate(nxt_vals[::-1])[::-1]
    kinds, lengths, dists = [], [], []
    p = 0        # emission frontier
    s = 0        # scan position
    while s < m:
        j = int(nxt_vals[s])
        if j >= m:
            break
        ml = extend_one(data, int(cand[j]), j)
        if ml < MINIMUM_MATCH:
            s = j + 1  # hash collision or short true match: skip
            continue
        if j > p:
            kinds.append(0)
            lengths.append(j - p)
            dists.append(0)
        kinds.append(1)
        lengths.append(ml)
        dists.append(j - int(cand[j]))
        p = j + ml
        s = p
    if p < n:
        kinds.append(0)
        lengths.append(n - p)
        dists.append(0)
    return (np.array(kinds, dtype=np.uint8),
            np.array(lengths, dtype=np.int64),
            np.array(dists, dtype=np.int64))


def rzip_encode_chunk(data: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full host-path rzip encode of one chunk -> columnar tokens.

    Uses the native hash-table matcher (runtime/csrc hostops
    rzip_encode_host, ~100x the numpy path) when the runtime is built;
    the numpy pipeline below remains the correctness oracle.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    if n <= MINIMUM_MATCH:
        if n == 0:
            return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        return (np.array([0], np.uint8), np.array([n], np.int64),
                np.array([0], np.int64))
    from .. import runtime
    if runtime.available():
        res = runtime.rzip_encode_host(data, MINIMUM_MATCH)
        if res is not None:
            return res
    return rzip_encode_chunk_numpy(data)


def rzip_encode_chunk_numpy(data: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray]:
    """The vectorised-numpy matcher (correctness oracle for tests)."""
    fps = window_fingerprints(data)
    cand = nearest_previous_candidates(fps)
    return greedy_select(data, cand)


def literals_of(data: np.ndarray, kinds: np.ndarray, lengths: np.ndarray
                ) -> np.ndarray:
    """Extract the literal byte stream implied by a token sequence.

    Contiguous span copies: one numpy slice per literal token (tokens
    number in the thousands; the repeat/arange fancy-index formulation
    built n-sized index arrays and cost seconds per chunk)."""
    data = np.asarray(data, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    lit = np.asarray(kinds) == 0
    if not lit.any():
        return np.zeros(0, dtype=np.uint8)
    ll = lengths[lit]
    ls = starts[lit]
    out = np.empty(int(ll.sum()), dtype=np.uint8)
    w = 0
    for s, l in zip(ls.tolist(), ll.tolist()):
        out[w:w + l] = data[s:s + l]
        w += l
    return out
