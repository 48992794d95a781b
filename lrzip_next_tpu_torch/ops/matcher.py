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

``MatchJob`` queues all of it at construction (``TpuMatchJob``): one of
its device's three worker threads uploads the chunk from pinned host
memory and runs every stage, both read-backs and the host finalize, on
the job's own CUDA stream, so the compress loops keep the next two
chunks' jobs running
while the caller packages the current one.  Where the native runtime is
missing, ``finalize_selected`` and ``greedy_cover_from_runs`` take their
numpy counterparts, as the JAX package's do.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

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
_walk_lock = threading.Lock()


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
    """CUDA events between the device stages of one job, recorded on
    ``stream`` (the caller's current stream where None); inert on CPU."""

    def __init__(self, device: torch.device, stream=None):
        self.device = device
        self.marks = []
        self.stream = stream
        if device.type == "cuda" and stream is None:
            self.stream = torch.cuda.current_stream(device)

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            self.marks.append((name, ev))

    def sync(self) -> None:
        """Wait for the clock's stream (and nothing else on the card)."""
        if self.device.type == "cuda":
            self.stream.synchronize()

    def ms(self) -> dict:
        """Per-stage milliseconds; call after the last mark completed."""
        return {name: a.elapsed_time(b) for (_, a), (name, b)
                in zip(self.marks, self.marks[1:])}


def require_runtime(device="cuda") -> None:
    """Raise unless the native host runtime is loaded, where ``device``
    is CUDA.  The numpy finalize and the pointer-doubling replay stand in
    for the runtime only on the CPU and for the host matcher
    (``device=None``): a card run never takes them."""
    if device is None or torch.device(device).type != "cuda":
        return
    if not runtime.available():
        raise RuntimeError(
            "the native host runtime (lrzip_next_tpu_torch.runtime, built "
            "with g++) is required for token finalization and replay"
            + (": " + runtime.build_error if runtime.build_error else ""))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


def finalize_selected(starts: np.ndarray, lens: np.ndarray,
                      dists: np.ndarray, n: int, data: np.ndarray,
                      w: int = HASH_W, hole_out: list | None = None):
    """Byte-verify and extend the selected pieces into final tokens
    (matcher.finalize_selected): the native ``runtime.finalize_tokens``,
    or where the runtime is missing this numpy loop of the same
    semantics.  Per piece: extend the start left across the literal gap,
    scan the span emitting maximal byte-verified matches (resyncing over
    interior holes), extend the last match right.  ``hole_out`` receives
    the count of scanned but unverified bytes inside the pieces."""
    if runtime.available():
        res = runtime.finalize_tokens(starts, lens, dists, n, data,
                                      MINIMUM_MATCH, hole_out=hole_out)
        if res is not None:
            return res
    kinds, out_l, out_d = [], [], []
    f = 0
    holes = 0

    def emit(kind, length, dist):
        kinds.append(kind)
        out_l.append(length)
        out_d.append(dist)

    for s0, l0, d in zip(starts, lens, dists):
        s0, l0, d = int(s0), int(l0), int(d)
        e0 = min(s0 + l0, n)
        if d < 1 or e0 <= f:
            continue
        s = max(s0, f)
        if s - d < 0:
            continue
        # left extension across the literal gap
        while s > f and s > d and data[s - 1] == data[s - 1 - d]:
            s -= 1
        p = s
        while p < e0:
            q = p
            maxl = n - p
            ln = 0
            while ln < maxl and data[p + ln] == data[p - d + ln]:
                ln += 1
            if ln >= MINIMUM_MATCH:
                if q > f:
                    emit(0, q - f, 0)
                emit(1, ln, d)
                f = q + ln
                p = f
            else:
                step = min(ln + 1, e0 - p)
                holes += step
                p += step
        if f >= n:
            break
    if f < n:
        emit(0, n - f, 0)
    if hole_out is not None:
        hole_out.append(holes)
    return (np.array(kinds, dtype=np.uint8),
            np.array(out_l, dtype=np.int64),
            np.array(out_d, dtype=np.int64))


def greedy_cover_from_runs(run_start: np.ndarray, run_len: np.ndarray,
                           run_src: np.ndarray, n: int, w: int = HASH_W,
                           data: np.ndarray | None = None,
                           hole_out: list | None = None,
                           gap_merged: bool = False):
    """Greedy left-to-right token cover from chain runs
    (matcher.greedy_cover_from_runs): the native ``runtime.greedy_cover``,
    or where the runtime is missing this numpy walk of the same semantics.

    Each run (s, r, src) certifies same-distance seed windows across
    data[s : s+r+w-1].  The frontier walk emits byte-verified matches
    within each run's span, resyncing across gaps, and extends them past
    the span with exact byte compares.  ``data=None`` emits each span
    wholesale and is valid only for stride-1 contiguous runs; gap-merged
    chain records (``gap_merged``) must be verified against ``data``."""
    if gap_merged and data is None:
        raise ValueError(
            "gap-merged chain records require data for byte "
            "verification (unverified mode is stride-1-only)")
    if runtime.available():
        res = runtime.greedy_cover(run_start, run_len, run_src, n, w,
                                   data=data, hole_out=hole_out)
        if res is not None:
            return res
    kinds, lengths, dists = [], [], []
    f = 0  # emission frontier
    holes = 0  # unmatched bytes inside certified spans (approximate here)
    dist_arr = run_start - run_src

    def emit(kind, length, dist):
        kinds.append(kind)
        lengths.append(length)
        dists.append(dist)

    for i in range(len(run_start)):
        s = int(run_start[i])
        cert_end = min(int(run_start[i] + run_len[i] + w - 1), n)
        if cert_end <= f or f >= n:
            continue
        d = int(dist_arr[i])
        start_at = s if s >= f else f
        if d < 1 or start_at - d < 0:
            continue
        if data is None:
            if cert_end - start_at < w:
                continue
            if start_at > f:
                emit(0, start_at - f, 0)
            emit(1, cert_end - start_at, d)
            f = cert_end
            continue
        scan_lim = cert_end - w
        eq = np.asarray(data[start_at:cert_end]
                        == data[start_at - d:cert_end - d])
        holes += int((~eq).sum())
        edges = np.flatnonzero(np.diff(np.concatenate(
            [[0], eq.astype(np.int8), [0]])))
        for rs_, re_ in zip(edges[::2], edges[1::2]):
            abs_s = start_at + int(rs_)
            abs_e = start_at + int(re_)
            if abs_s > scan_lim:
                break
            if abs_s < f:
                abs_s = f
            if abs_e == cert_end:  # run touches the edge: extend right
                while abs_e < n and data[abs_e] == data[abs_e - d]:
                    abs_e += 1
            # extend left over the literal gap
            while abs_s > f and abs_s - d > 0 and \
                    data[abs_s - 1] == data[abs_s - 1 - d]:
                abs_s -= 1
            if abs_e - abs_s < w:
                continue
            if abs_s > f:
                emit(0, abs_s - f, 0)
            emit(1, abs_e - abs_s, d)
            f = abs_e
            if f >= n:
                break
    if f < n:
        emit(0, n - f, 0)
    if hole_out is not None:
        hole_out.append(holes)
    return (np.array(kinds, dtype=np.uint8),
            np.array(lengths, dtype=np.int64),
            np.array(dists, dtype=np.int64))


# Side streams of the match jobs: three a device, taken in turn.  The
# single-device lookahead keeps at most three jobs live, and a mesh with
# one dp row a card three a card, so there live jobs never share a
# stream, and the allocator's blocks cached on a stream serve a later
# job.  A test mesh that names one card for several rows keeps three jobs
# a row on it: those take the three streams in turn, so two live jobs may
# share one, which orders their work and changes no byte.
_JOB_STREAMS = 3
_streams: dict = {}
_streams_lock = threading.Lock()
# The jobs' worker threads, a pool of three a device, each started with
# the device's first job: as many as jobs live at once on a card, so a
# mesh over several cards keeps each card's jobs running side by side,
# and kept so that each thread's runtime scratch (the finalize's token
# buffers, tens of MB a chunk) serves the jobs after.
_workers: dict = {}
_workers_lock = threading.Lock()


def _worker_pool(device: torch.device) -> ThreadPoolExecutor:
    key = (device.type, device.index if device.index is not None or
           device.type != "cuda" else torch.cuda.current_device())
    with _workers_lock:
        pool = _workers.get(key)
        if pool is None:
            pool = _workers[key] = ThreadPoolExecutor(
                max_workers=_JOB_STREAMS, thread_name_prefix="lrzt-match-job")
    return pool


def _job_stream(device: torch.device):
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _streams_lock:
        ring = _streams.get(index)
        if ring is None:
            ring = _streams[index] = [
                [torch.cuda.Stream(index) for _ in range(_JOB_STREAMS)], 0]
        stream = ring[0][ring[1] % _JOB_STREAMS]
        ring[1] += 1
    return stream


class MatchJob:
    """The matcher for one chunk on ``device`` (port of ``TpuMatchJob``).

    Construction queues the chunk's whole device graph and returns at
    once: one of its device's three worker threads uploads the chunk from
    pinned host memory (``non_blocking``), runs the anchor stage (K1, the
    row minimum, the candidate sort), the chain stage (the (dist, pos)
    sort, K10 twice, the one read-back of the record count), the
    selection and the one read-back of the selected pieces, and finalizes
    the tokens on the host; on CUDA all of it goes to the job's own
    stream, so jobs queued ahead run beside the caller's work.
    ``collect()`` waits for the
    worker and returns the tokens; on CUDA the caller's current stream
    then waits on the job's stream and takes over ``dev``.

    ``dev`` keeps the padded chunk on the device for the device literal
    encode (None for a trivial chunk).  A chunk already on the device,
    zero-padded to ``bucket_size(len(data))``, is passed as ``dev=`` and
    used as is.  ``select=False`` walks the coarse chains directly (the
    JAX package's walk mode).  Stride 1 is the dense matcher: the worker
    runs the fingerprints, the candidate sort and the run compaction
    (K9), reads the run count and the run triples back, and the host's
    byte-verified greedy cover makes the tokens (``select`` has no
    meaning there).  The host steps take the native runtime where it is
    loaded and its numpy counterparts where it is not.  ``stats`` holds
    the JAX package's per-chunk counters and, on CUDA, ``device_ms``:
    CUDA-event milliseconds of each device stage on the job's stream.
    ``coarse_chains`` (stride > 1) is the count of coarse chain records,
    the ``chains`` of the JAX package's mesh path.
    """

    def __init__(self, data, stride: int, device, select: bool = True,
                 dev: Optional[torch.Tensor] = None):
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
        require_runtime(self.device)
        nb = bucket_size(self.n)
        self.limit = self.n - HASH_W + 1
        self.stream = _job_stream(self.device) \
            if self.device.type == "cuda" else None
        self._upload = dev is None
        if dev is None:
            with self._on_stream():
                dev = torch.empty(nb, dtype=torch.uint8, device=self.device)
        else:
            # the caller holds the chunk on the device already, padded to
            # its bucket (TpuMatchJob's dev=)
            if dev.dtype != torch.uint8 or tuple(dev.shape) != (nb,) or \
                    dev.device.type != self.device.type:
                raise ValueError(
                    f"dev= must be a uint8 tensor of shape ({nb},) on "
                    f"{self.device}, got {dev.dtype} {tuple(dev.shape)} on "
                    f"{dev.device}")
            if self.stream is not None:
                self.stream.wait_stream(
                    torch.cuda.current_stream(self.device))
                dev.record_stream(self.stream)
        self.dev = dev
        self.clock = StageClock(self.device, self.stream)
        self._future = _worker_pool(self.device).submit(self._run)

    def _on_stream(self):
        """The job's device and stream as the current ones (CUDA)."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def _run(self):
        with self._on_stream():
            return self._work()

    def _work(self):
        host = None
        if self._upload:
            # the padded chunk: in place on the CPU, through a pinned
            # buffer on CUDA (``fill_ms``, host time)
            t0 = time.perf_counter()
            host = torch.empty(self.dev.shape[0], dtype=torch.uint8,
                               pin_memory=True) \
                if self.device.type == "cuda" else self.dev
            h = host.numpy()
            h[:self.n] = self.data
            h[self.n:] = 0
            self.fill_ms = (time.perf_counter() - t0) * 1e3
        self.clock.mark("start")
        if host is not None and host is not self.dev:
            # the host allocator keeps the pinned block until the copy
            # has run
            self.dev.copy_(host, non_blocking=True)
        del host
        self.clock.mark("upload")
        if self.stride == 1:
            return self._dense()
        return self._anchored()

    def _dense(self):
        """Stride 1: fingerprints, candidates, the runs' compaction and
        read-back, then the host greedy cover in verified mode (exact
        runs, not gap-merged records)."""
        fps = window_fps_pair(self.dev)
        self.clock.mark("fingerprints")
        cand, ok = candidates_from_fps(*fps)
        del fps
        self.clock.mark("candidates")
        self.runs = compact_runs(cand, ok, self.limit)
        del cand, ok
        self.clock.mark("runs")
        rs, rl, src = fetch_runs(*self.runs)
        self.runs = None
        self.clock.mark("readback")
        t_host = time.perf_counter()
        kinds, lengths, dists = greedy_cover_from_runs(
            rs, rl, src, self.n, data=self.data)
        return self._finish(kinds, lengths, dists, len(rs), t_host)

    def _walk(self, coarse):
        """Host frontier walk over the coarse chain records."""
        self.walked = True
        pw, ew, dw = (_host(t) for t in coarse)
        self.clock.mark("walk_readback")
        res = greedy_cover_from_runs(pw, ew - pw + 1, pw - dw, self.n,
                                     data=self.data, gap_merged=True)
        return res, len(pw)

    def _anchored(self):
        global walk_fallbacks
        self.seeds = anchor_candidates_fporder(self.dev, self.stride)
        self.clock.mark("anchors")
        fine, coarse = compact_seeds_dual(*self.seeds, self.limit,
                                          verify_gap(self.stride),
                                          _CHAIN_GAP)
        self.seeds = None
        self.clock.mark("chains")
        n_raw = int(fine[0].shape[0])
        self.coarse_chains = int(coarse[0].shape[0])
        t_host = time.perf_counter()
        if not self.select:
            (kinds, lengths, dists), chains = self._walk(coarse)
            return self._finish(kinds, lengths, dists, chains, t_host)
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
            with _walk_lock:
                walk_fallbacks += 1
            (kinds, lengths, dists), chains = self._walk(coarse)
        else:
            kinds, lengths, dists = finalize_selected(
                flat[2:2 + k], flat[2 + k:2 + 2 * k],
                flat[2 + 2 * k:2 + 3 * k], self.n, self.data)
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
            self.clock.sync()
            self.stats["device_ms"] = self.clock.ms()
            self.stats["host_ms"] = host_ms
            if self._upload:
                self.stats["fill_ms"] = self.fill_ms
        return kinds, lengths, dists

    def collect(self):
        """Final (kinds, lengths, dists) tokens of the chunk."""
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
        tokens = self._future.result()
        if self.stream is not None and self.dev is not None:
            # the caller's stream takes the chunk over (the device
            # literal encode reads it there)
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self.stream)
            self.dev.record_stream(cur)
        return tokens


def rzip_encode_chunk(data, stride: int, device, select: bool = True):
    """Matcher tokens of one chunk (``matcher.rzip_encode_chunk_tpu``)."""
    return MatchJob(data, stride, device, select=select).collect()
