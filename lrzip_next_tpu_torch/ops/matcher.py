"""GPU rzip matcher: the anchor-seed pipeline and the dense stride-1
pipeline on PyTorch and CUDA.

Port of ``lrzip_next_tpu/ops/matcher.py`` (``TpuMatchJob``: device
selection with the walk fallback for stride > 1, dense candidates and run
compaction for stride 1).  At stride > 1 one chunk, zero-padded to its
bucket, goes through:

1. K1 (``anchor.anchor_fps``): fingerprints and the local-min anchor mask;
2. one anchor per stride-row (the leftmost row minimum), then one sort by
   (fpa, pos): each anchor's candidate is the nearest previous anchor with
   the same fingerprint;
3. one sort by (dist, pos) chains same-distance seeds into the chain
   start and chain end masks;
4. K10 (``compact.compact_starts``) compacts (pos, dist) at the chain
   starts and, in a second launch, pos at the chain ends: in (dist, pos)
   order the i-th end closes the i-th start; the record count ``n_raw``
   is read back once, and every later stage runs on exactly ``n_raw``
   records (no cap, no redo);
5. coarse chains (merged across gaps of up to ``_CHAIN_GAP`` bytes, their
   ends carried by a reverse segmented copy over the records), the
   position order of the fine chains, and the prefix-max greedy selection
   (``torch.cummax``);
6. one readback of the selected pieces and both coverage sums; the host
   runtime byte-verifies and finalizes them (``runtime.finalize_tokens``),
   or, where the coarse chains would cover much more (dense text), walks
   the coarse records instead (``runtime.greedy_cover``).

At stride 1 every 32-byte window is a seed (``match_candidates``): both
fingerprints of every window (plain tensor code, as the JAX package
computes them outside any kernel), one sort by (fpa, pos), the nearest
previous window with the same pair as candidate; ``compact_runs`` marks
the runs of lockstep candidates and K9 (``compact.compact_masked``)
compacts their (start, end, src) triples; the run count is read back
once, then the triples, and the host runtime's byte-verified greedy cover
(``runtime.greedy_cover``) makes the tokens.

Every sort key is an int64 built from the int32 values, so the order
equals ``jax.lax.sort``'s multi-key order, and no stage uses a float:
coverage sums are exact integers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import runtime
from ..format.constants import MINIMUM_MATCH
from .anchor import HASH_W, INT32_MAX, anchor_fps, window_fps_pair
from .compact import compact_masked, compact_starts

# pad value of positions and distances (matcher._I32_BIG)
_I32_BIG = 0x7FFFFFF0
# Same-distance seeds within this many bytes merge into one coarse chain
# (matcher._CHAIN_GAP): the host walk resyncs across the gaps.
_CHAIN_GAP = 1024

# select-mode jobs that fell back to the coarse-chain walk
walk_fallbacks = 0


def default_anchor_stride(rzip_level: int) -> int:
    """Anchor sampling stride for the 1-9 rzip level (as
    ``lrzip_next_tpu/ops/matcher.py`` ``default_anchor_stride``)."""
    if rzip_level >= 9:
        return 2
    if rzip_level == 8:
        return 4
    if rzip_level >= 5:
        return 8
    if rzip_level >= 3:
        return 16
    return 32


def verify_gap(stride: int) -> int:
    """Chain gap of the selection path: seeds at most this far apart have
    overlapping certified windows (matcher._verify_gap)."""
    return max(2 * HASH_W, 2 * stride)


def bucket_size(n: int) -> int:
    """Padded chunk length (matcher._bucket_size).  The anchor rows and the
    edge of the last window depend on it, so archives match only if the
    port pads exactly as the JAX package does."""
    if n <= 1 << 16:
        return 1 << 16
    if n > 1 << 23:
        step = 1 << 23
        return -(-n // step) * step
    b = 1 << 16
    while b < n:
        b <<= 1
    return b


def _prev(x: torch.Tensor, fill) -> torch.Tensor:
    """y[i] = x[i-1], y[0] = fill."""
    if x.shape[0] == 0:
        return x
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def _next(x: torch.Tensor, fill) -> torch.Tensor:
    """y[i] = x[i+1], y[-1] = fill."""
    if x.shape[0] == 0:
        return x
    return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype,
                                        device=x.device)])


def _key2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordering lexicographically by (signed hi, lo >= 0)."""
    return hi.to(torch.int64) * (1 << 32) + lo.to(torch.int64)


def anchor_candidates_fporder(dev: torch.Tensor, stride: int):
    """(spos, cand) int32 of length ``(len(dev) - 31) // stride`` in
    fingerprint order: one anchor per stride-row and its nearest previous
    equal-fingerprint anchor (-1 where none); empty rows carry
    ``_I32_BIG`` positions (matcher._anchor_candidates_fporder)."""
    m = dev.shape[0] - HASH_W + 1
    k = m // stride
    fpa_m, fpb = anchor_fps(dev, stride, k * stride)
    rows = fpa_m.view(k, stride)
    row_min = rows.amin(dim=1)
    cols = torch.arange(stride, dtype=torch.int64, device=dev.device)
    # leftmost column holding the row minimum (the JAX suffix-min keeps
    # the left one on ties; torch.min's tie index is not specified)
    col = torch.where(rows == row_min[:, None], cols, stride).amin(dim=1)
    flat = torch.arange(k, dtype=torch.int64, device=dev.device) * stride \
        + col
    fpb8 = fpb[flat] & 255                    # 8-bit collision check
    a_pos = torch.where(row_min != INT32_MAX, flat.to(torch.int32),
                        _I32_BIG)
    order = torch.argsort(_key2(row_min, a_pos), stable=True)
    sfpa, spos, sfpb = row_min[order], a_pos[order], fpb8[order]
    same = (sfpa == _prev(sfpa, INT32_MAX)) & (sfpb == _prev(sfpb, -1)) \
        & (sfpa != INT32_MAX)
    cand = torch.where(same, _prev(spos, 0), -1)
    return spos, cand


def match_candidates(data: torch.Tensor):
    """(cand, ok) for every 32-byte window of a uint8 tensor: the nearest
    previous window with the same two fingerprints as int32 (-1 where
    none) and ``cand >= 0``; length ``len(data) - 31``
    (matcher.match_candidates).

    One sort by (fpa as uint32, pos); the second fingerprint rides along
    and is compared on all 32 bits.  The sorted positions are a
    permutation of 0..m-1, so the way back to position order is a scatter
    (the JAX package sorts a second time)."""
    return candidates_from_fps(*window_fps_pair(data))


def candidates_from_fps(fpa: torch.Tensor, fpb: torch.Tensor):
    """``match_candidates`` from the two fingerprints of every window
    (uint32 values in int64, as ``anchor.window_fps_pair`` returns
    them)."""
    m = fpa.shape[0]
    dev = fpa.device
    # uint32 order of fpa as the signed order of an int64 key
    key = ((fpa - (1 << 31)) << 32) | torch.arange(
        m, dtype=torch.int64, device=dev)
    key = torch.sort(key).values
    spos = key & 0xFFFFFFFF
    sfpa = key >> 32
    del key
    sfpb = fpb[spos]
    same = (sfpa == _prev(sfpa, 0)) & (sfpb == _prev(sfpb, 0))
    same[0] = False
    del sfpa, sfpb
    cand_sorted = torch.where(same, _prev(spos, 0), -1).to(torch.int32)
    cand = torch.empty(m, dtype=torch.int32, device=dev)
    cand[spos] = cand_sorted
    return cand, cand >= 0


def chain_runs(cand: torch.Tensor, ok: torch.Tensor):
    """(run_start_mask, run_id): a position starts a run when it is ok and
    its predecessor's candidate does not continue into it; ``run_id`` is
    the int32 inclusive count of run starts (matcher.chain_runs)."""
    cont = ok & _prev(ok, False) & (cand == _prev(cand, 0) + 1)
    cont[:1] = False
    start = ok & ~cont
    return start, torch.cumsum(start, 0, dtype=torch.int32)


def run_masks(cand: torch.Tensor, ok: torch.Tensor, limit: int):
    """(start, is_end) masks of the lockstep candidate runs among the
    positions below ``limit`` (the masks of matcher.compact_runs)."""
    idx = torch.arange(cand.shape[0], dtype=torch.int32, device=cand.device)
    valid = ok & (idx < limit)
    cont = valid & _prev(valid, False) & (cand == _prev(cand, 0) + 1)
    cont[:1] = False
    return valid & ~cont, valid & ~_next(cont, False), idx


def compact_runs(cand: torch.Tensor, ok: torch.Tensor, limit: int):
    """Run compaction on the tensors' device: ``(starts, ends, srcs, n)``,
    the first and last position and the first candidate of every run in
    position order, in the first ``n`` slots of m-sized int32 tensors
    (later slots unspecified), ``n`` a 0-dim int32 tensor.  The k-th start
    pairs with the k-th end because runs cannot nest.  The masks are plain
    tensor code; K9 compacts them (matcher.compact_runs,
    compact_pallas.compact_runs_pallas, without their ``cap``)."""
    start, is_end, idx = run_masks(cand, ok, limit)
    return compact_masked(start, is_end, idx, cand)


def runs_to_host(cand: torch.Tensor, ok: torch.Tensor, limit=None):
    """Run detection and compaction on the device, then one read-back of
    the count and one of the triples: int64 numpy ``(starts, run_len,
    srcs)`` (matcher.runs_to_host)."""
    if limit is None:
        limit = cand.shape[0]
    return fetch_runs(*compact_runs(cand, ok, limit))


def fetch_runs(starts, ends, srcs, n):
    """One read-back of the run count and one of the ``n`` triples of
    ``compact_runs`` -> int64 numpy (starts, run_len, srcs)."""
    k = int(n)
    rs, re, src = _host(torch.stack([starts[:k], ends[:k], srcs[:k]]))
    return rs, re - rs + 1, src


def dist_sorted_seed_starts(pos, cand, limit: int, gap: int):
    """Chain start/end masks over the seeds sorted by (dist, pos): runs of
    equal distance whose positions step by at most ``gap``.  Seeds come in
    any order (the fingerprint order of ``anchor_candidates_fporder``;
    this sort makes it irrelevant).  Returns (start, is_end, spos, sdist)
    in (dist, pos) order (matcher._dist_sorted_seed_starts)."""
    valid = (pos < limit) & (cand >= 0) & (cand < limit)
    dist = torch.where(valid, pos - cand, _I32_BIG)
    order = torch.argsort(_key2(dist, pos), stable=True)
    sd, sp = dist[order], pos[order]
    sv = sd < _I32_BIG
    cont = sv & _prev(sv, False) & (sd == _prev(sd, -1)) \
        & (sp - _prev(sp, 0) <= gap)
    cont[0] = False
    start = sv & ~cont
    is_end = sv & ~_next(cont, False)
    return start, is_end, sp, sd


def seg_end_copy(vals: torch.Tensor, is_end: torch.Tensor) -> torch.Tensor:
    """result[i] = vals at the first ``is_end`` position >= i; zeros past
    the last one (matcher._seg_end_copy).  Callers read only positions
    inside segments."""
    n = vals.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=vals.device)
    nxt = torch.where(is_end, idx, n)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,))
    got = vals[nxt.clamp(max=max(n - 1, 0))]
    return torch.where(nxt < n, got, torch.zeros_like(got))


def order_chains(ps, ds, pe):
    """Chain records in position order -> (starts, ends, dists)."""
    order = torch.argsort(ps, stable=True)
    return ps[order], pe[order], ds[order]


def derive_coarse(ps, ds, pe, gap_w: int):
    """Coarse chains from the fine records in (dist, pos) order: maximal
    runs of equal dist whose start-to-previous-end gaps are at most
    ``gap_w``.  Returns position-ordered (starts, ends, dists)
    (matcher._derive_coarse)."""
    if ps.shape[0] == 0:
        return ps, pe, ds
    cont = (ds == _prev(ds, -1)) \
        & (ps.to(torch.int64) - _prev(pe, 0).to(torch.int64) <= gap_w)
    cont[0] = False
    seg_s = ~cont
    cend = seg_end_copy(pe, ~_next(cont, False))
    return order_chains(ps[seg_s], ds[seg_s], cend[seg_s])


def chain_records(pos, cand, limit: int, gap: int):
    """Chain records ``(starts, dists, ends)`` in (dist, pos) order, where
    the i-th end closes the i-th start: one (dist, pos) sort, K10 once for
    (pos, dist) at the chain starts and once for pos at the chain ends,
    one read-back of the count (matcher.compact_seeds_pallas, without its
    ``cap``)."""
    start, is_end, sp, sd = dist_sorted_seed_starts(pos, cand, limit, gap)
    ps_c, ds_c, n = compact_starts(start, sp, sd)
    # K10 takes two payloads: the ends' dists are compacted and dropped, an
    # extra int32 read and write a chain (about 2 MB on a 64 MiB chunk)
    pe_c, _, _ = compact_starts(is_end, sp, sd)
    n_raw = int(n)
    return ps_c[:n_raw], ds_c[:n_raw], pe_c[:n_raw]


def compact_seeds(pos, cand, limit: int, gap: int):
    """Chain records ``(starts, ends, dists)`` in position order at one
    chain gap (matcher.compact_seeds / compact_seeds_pallas)."""
    return order_chains(*chain_records(pos, cand, limit, gap))


def compact_seeds_dual(pos, cand, limit: int, gap_v: int, gap_w: int):
    """Fine (gap_v) and coarse (gap_w) chain records, both in position
    order (matcher.compact_seeds_dual_pallas): the fine records of
    ``chain_records``, and the coarse ones derived from them.  K10 runs
    twice; no segmented copy runs over the seed array."""
    ps_c, ds_c, pe_c = chain_records(pos, cand, limit, gap_v)
    return (order_chains(ps_c, ds_c, pe_c),
            derive_coarse(ps_c, ds_c, pe_c, gap_w))


def _prefix_max_cover(ps, pe):
    """Greedy left-to-right cover over position-ordered records as one
    prefix max: the frontier before record i is the running max of the
    earlier certified ends.  Returns (clip_start, length, selected)."""
    e_full = pe.to(torch.int64) + HASH_W
    frontier = _prev(torch.cummax(e_full, 0).values, 0)
    clip_s = torch.maximum(ps.to(torch.int64), frontier)
    plen = e_full - clip_s
    sel = (e_full > frontier) & (plen >= MINIMUM_MATCH)
    return clip_s, plen, sel


def select_records(ps, pe, ds):
    """Prefix-max greedy selection -> disjoint pieces (starts, lengths,
    dists) in ascending start order, int64 (matcher.select_records)."""
    clip_s, plen, sel = _prefix_max_cover(ps, pe)
    return clip_s[sel], plen[sel], ds[sel].to(torch.int64)


def selected_coverage(ps, pe) -> torch.Tensor:
    """Bytes the prefix-max selection would cover (exact int64 sum)."""
    _, plen, sel = _prefix_max_cover(ps, pe)
    return torch.where(sel, plen, 0).sum()


class StageClock:
    """CUDA events between the device stages of one job; inert on CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks = []

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append((name, ev))

    def ms(self) -> dict:
        """Per-stage milliseconds; call after the last mark completed."""
        return {name: a.elapsed_time(b) for (_, a), (name, b)
                in zip(self.marks, self.marks[1:])}


def require_runtime() -> None:
    """Raise unless the native host runtime is loaded."""
    if not runtime.available():
        raise RuntimeError(
            "the native host runtime (lrzip_next_tpu_torch.runtime, built "
            "with g++) is required for token finalization and replay"
            + (": " + runtime.build_error if runtime.build_error else ""))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


class MatchJob:
    """The matcher for one chunk on ``device`` (port of ``TpuMatchJob``).

    Construction uploads the chunk and queues the anchor stage (K1, the
    row minimum, the candidate sort); ``collect()`` queues the chain stage
    (the (dist, pos) sort, K10 twice), reads the record count, finishes
    selection on the device, reads the selected pieces back and finalizes
    tokens on the host.  ``dev`` keeps the padded chunk on the device after
    ``collect()`` for the device literal encode (None for a trivial
    chunk).  ``select=False`` walks the coarse chains directly (the JAX
    package's walk mode).  Stride 1 is the dense matcher: construction
    queues the fingerprints, the candidate sort and the run compaction
    (K9); ``collect()`` reads the run count and the run triples back and
    the host's byte-verified greedy cover makes the tokens (``select`` has
    no meaning there).  ``stats`` holds the JAX package's per-chunk
    counters and, on CUDA, ``device_ms``: CUDA-event milliseconds of each
    device stage.
    """

    def __init__(self, data, stride: int, device: torch.device,
                 select: bool = True):
        data = np.asarray(data, dtype=np.uint8)
        if stride not in (1, 2, 4, 8, 16, 32):
            raise ValueError(f"anchor stride {stride} not in 1..32 "
                             "(powers of 2)")
        self.data = data
        self.stride = stride
        self.n = len(data)
        self.device = torch.device(device)
        self.select = select and stride > 1
        self.walked = False
        self.stats: dict = {}
        self.trivial = self.n <= HASH_W + 4 or self.n < 4 * stride
        self.dev = None
        if self.trivial:
            return
        require_runtime()
        nb = bucket_size(self.n)
        padded = np.zeros(nb, dtype=np.uint8)
        padded[:self.n] = data
        self.clock = StageClock(self.device)
        self.clock.mark("start")
        self.dev = torch.from_numpy(padded).to(self.device)
        self.clock.mark("upload")
        self.limit = self.n - HASH_W + 1
        if stride == 1:
            fps = window_fps_pair(self.dev)
            self.clock.mark("fingerprints")
            cand, ok = candidates_from_fps(*fps)
            del fps
            self.clock.mark("candidates")
            self.runs = compact_runs(cand, ok, self.limit)
            self.clock.mark("runs")
            return
        self.seeds = anchor_candidates_fporder(self.dev, stride)
        self.clock.mark("anchors")

    def _chains(self):
        fine, coarse = compact_seeds_dual(*self.seeds, self.limit,
                                          verify_gap(self.stride),
                                          _CHAIN_GAP)
        self.seeds = None
        self.clock.mark("chains")
        return fine, coarse

    def _walk(self, coarse):
        """Host frontier walk over the coarse chain records."""
        self.walked = True
        pw, ew, dw = (_host(t) for t in coarse)
        self.clock.mark("walk_readback")
        res = runtime.greedy_cover(pw, ew - pw + 1, pw - dw, self.n, HASH_W,
                                   data=self.data)
        if res is None:
            raise RuntimeError("runtime.greedy_cover failed")
        return res, len(pw)

    def _dense(self):
        """Stride 1: the runs' read-back and the host greedy cover in
        verified mode (exact runs, not gap-merged records)."""
        rs, rl, src = fetch_runs(*self.runs)
        self.runs = None
        self.clock.mark("readback")
        t_host = time.perf_counter()
        res = runtime.greedy_cover(rs, rl, src, self.n, HASH_W,
                                   data=self.data)
        if res is None:
            raise RuntimeError("runtime.greedy_cover failed")
        return res, len(rs), t_host

    def collect(self):
        """Final (kinds, lengths, dists) tokens of the chunk."""
        global walk_fallbacks
        if self.trivial:
            self.stats = {"chunk_bytes": self.n, "chains": 0,
                          "matches": 0, "match_bytes": 0,
                          "literals": 1 if self.n else 0,
                          "literal_bytes": self.n}
            if self.n == 0:
                return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                        np.zeros(0, np.int64))
            return (np.array([0], np.uint8), np.array([self.n], np.int64),
                    np.array([0], np.int64))
        if self.stride == 1:
            (kinds, lengths, dists), chains, t_host = self._dense()
            return self._finish(kinds, lengths, dists, chains, t_host)
        fine, coarse = self._chains()
        n_raw = int(fine[0].shape[0])
        t_host = time.perf_counter()
        if not self.select:
            (kinds, lengths, dists), chains = self._walk(coarse)
        else:
            ss, sl, sd = select_records(*fine)
            covs = torch.stack([sl.sum(), selected_coverage(*coarse[:2])])
            self.clock.mark("select")
            # one counted readback: both coverage sums, then the pieces
            flat = _host(torch.cat([covs, ss, sl, sd]))
            self.clock.mark("readback")
            t_host = time.perf_counter()
            cov_v, cov_w = int(flat[0]), int(flat[1])
            k = (len(flat) - 2) // 3
            chains = n_raw
            if cov_w - cov_v > max(cov_w // 4, self.n // 256):
                # the coarse chains would cover much more than the exact
                # spans: densely interleaved redundancy, where the walk's
                # multi-chain resync wins (matcher.py, TpuMatchJob.collect)
                walk_fallbacks += 1
                (kinds, lengths, dists), chains = self._walk(coarse)
            else:
                res = runtime.finalize_tokens(
                    flat[2:2 + k], flat[2 + k:2 + 2 * k],
                    flat[2 + 2 * k:2 + 3 * k], self.n, self.data,
                    MINIMUM_MATCH)
                if res is None:
                    raise RuntimeError("runtime.finalize_tokens failed")
                kinds, lengths, dists = res
        return self._finish(kinds, lengths, dists, chains, t_host)

    def _finish(self, kinds, lengths, dists, chains: int, t_host: float):
        """Fill ``stats`` and hand the tokens on."""
        host_ms = (time.perf_counter() - t_host) * 1e3
        m = kinds == 1
        self.stats = {
            "chunk_bytes": self.n,
            "chains": chains,
            "matches": int(m.sum()),
            "match_bytes": int(lengths[m].sum()),
            "literals": int((~m).sum()),
            "literal_bytes": int(lengths[~m].sum()),
        }
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.stats["device_ms"] = self.clock.ms()
            self.stats["host_ms"] = host_ms
        return kinds, lengths, dists


def rzip_encode_chunk(data, stride: int, device, select: bool = True):
    """Matcher tokens of one chunk (``matcher.rzip_encode_chunk_tpu``)."""
    return MatchJob(data, stride, device, select=select).collect()
