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

A mesh's sp axis splits one job over the devices of its dp row
(``MatchJob(sp_devices=)``; ``split_stage``, the one split that the job
and ``match_candidates`` / ``anchor_candidates_fporder`` share): each
device runs K1 and the row minima on its slab of anchor rows, or at
stride 1 the fingerprints of its slab of windows, and everything global
over the chunk runs on the row's first device.  The tokens do not depend
on the split.
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
from .anchor import HASH_W, INT32_MAX, _to_i32, anchor_fps, window_fps_pair
from .compact import compact_masked, compact_starts

# pad value of positions and distances (matcher._I32_BIG)
_I32_BIG = 0x7FFFFFF0
INT32_MIN = -(1 << 31)
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


def sp_slabs(k: int, s: int, unit: int, halo: int) -> list:
    """The cut of a chunk's ``k`` units over an sp row of ``s`` devices:
    anchor rows of ``unit`` = stride window positions (``halo`` 1), or
    single windows at stride 1 (``unit`` 1, ``halo`` 0).  Returns at most
    ``s`` slabs of whole units, sizes differing by at most one, in chunk
    order; slab i goes to the row's i-th device.  Each is ``(u0, u1, lo,
    hi)``: units [u0, u1), and a view over the window positions [lo, hi),
    the slab's positions widened by ``halo`` units a side and clipped at
    the chunk's ends, whose bytes are [lo, hi + HASH_W - 1).  Fewer than
    ``s`` slabs when ``k < s``, never an empty one."""
    cut = [k * j // s for j in range(s + 1)]
    return [(u0, u1, max(u0 - halo, 0) * unit, min(u1 + halo, k) * unit)
            for u0, u1 in zip(cut, cut[1:]) if u1 > u0]


def anchor_rows(view: torch.Tensor, stride: int, slab: tuple):
    """The anchor rows [r0, r1) of ``slab = (r0, r1, lo, hi)``
    (``sp_slabs``) from one K1 launch on ``view``, the chunk's bytes
    [lo, hi + 31): each row's fingerprint minimum (INT32_MAX where it has
    no anchor), its anchor's chunk position, the leftmost column holding
    the minimum (``_I32_BIG`` where none), as int32, and the 8 low bits of
    that window's second fingerprint as uint8.

    K1 treats the view's ends as the chunk's (``anchor.py``): a halo of
    one row, at least the window's h = stride / 2 positions, keeps an
    interior slab edge from changing an anchor, and only the first and
    last slab meet the chunk's edges."""
    r0, r1, lo, hi = slab
    kk = r1 - r0
    c0 = r0 * stride - lo
    fpa_m, fpb = anchor_fps(view, stride, hi - lo)
    rows = fpa_m[c0:c0 + kk * stride].view(kk, stride)
    row_min = rows.amin(dim=1)
    cols = torch.arange(stride, dtype=torch.int64, device=view.device)
    # leftmost column holding the row minimum (the JAX suffix-min keeps
    # the left one on ties; torch.min's tie index is not specified)
    col = torch.where(rows == row_min[:, None], cols, stride).amin(dim=1)
    at = torch.arange(kk, dtype=torch.int64, device=view.device) * stride \
        + c0 + col
    fpb8 = (fpb[at] & 255).to(torch.uint8)    # 8-bit collision check
    a_pos = torch.where(row_min != INT32_MAX, (at + lo).to(torch.int32),
                        _I32_BIG)
    return row_min, a_pos, fpb8


def candidates_from_rows(row_min, a_pos, fpb8):
    """(spos, cand) int32 in fingerprint order from the anchor rows of a
    whole chunk (``anchor_rows``): one sort by (fpa, pos); each anchor's
    candidate is the nearest previous anchor with the same fingerprint
    and the same 8-bit check (-1 where none)."""
    order = torch.argsort(_key2(row_min, a_pos), stable=True)
    sfpa, spos = row_min[order], a_pos[order]
    sfpb = fpb8[order].to(torch.int32)
    same = (sfpa == _prev(sfpa, INT32_MAX)) & (sfpb == _prev(sfpb, -1)) \
        & (sfpa != INT32_MAX)
    cand = torch.where(same, _prev(spos, 0), -1)
    return spos, cand


def _slab_fps(view: torch.Tensor, slab: tuple):
    """Both fingerprints of the windows of a stride-1 slab's view, as
    int32 bit patterns (8 bytes a window to the row's first device, not
    16)."""
    return tuple(_to_i32(f) for f in window_fps_pair(view))


def _row_devices(sp_devices, home) -> list:
    """The devices of a dp row as a list (``[home]`` for None)."""
    if sp_devices is None or len(sp_devices) == 0:
        return [torch.device(home)]
    return [torch.device(d) for d in sp_devices]


def split_stage(dev: torch.Tensor, stride: int, devices, streams=None,
                clock: Optional["StageClock"] = None):
    """The chunk's per-slab stage over the devices of a dp row (the mesh's
    sp axis; one device is one slab over the whole chunk): at stride > 1
    the anchor rows (``anchor_rows``), at stride 1 both fingerprints of
    every window as int32 bit patterns (``_slab_fps``).  ``dev`` is the
    padded chunk on ``devices[0]``; slab i (``sp_slabs``) runs on
    ``devices[i]``.  Returns the outputs on ``dev``'s device, in chunk
    order, and the ``StageClock``s of slabs 1.. (upload, the stage,
    gather).

    Slab i > 0 copies its view's bytes from ``dev`` to its device and
    runs on ``streams[i - 1]`` (its device's current stream where
    ``streams`` is None); slab 0 runs on the current stream of ``dev``'s
    device, and only then are the other slabs' outputs copied there, so
    the slabs run side by side.  A copy between two cards waits on, and
    is waited on by, the current streams of both (PyTorch's barrier); the
    explicit waits and ``record_stream`` order a row that repeats a
    device, where ``.to`` makes no copy, the same way.  ``clock`` (the
    job's) marks the stage after slab 0 and the gather."""
    home = dev.device
    m = dev.shape[0] - HASH_W + 1
    if stride == 1:
        slabs, work, stage = sp_slabs(m, len(devices), 1, 0), _slab_fps, \
            "fingerprints"
    else:
        slabs, stage = sp_slabs(m // stride, len(devices), stride, 1), \
            "anchors"

        def work(view, slab):
            return anchor_rows(view, stride, slab)
    streams = streams or [None] * len(devices)
    here = torch.cuda.current_stream(home) if home.type == "cuda" else None
    queued = []
    for slab, device, stream in zip(slabs[1:], devices[1:], streams):
        _, _, lo, hi = slab
        with _on(device, stream):
            if stream is not None:
                stream.wait_stream(here)
            slab_clock = StageClock(device, stream)
            slab_clock.mark("start")
            view = dev[lo:hi + HASH_W - 1].to(device, non_blocking=True)
            slab_clock.mark("upload")
            out = work(view, slab)
            slab_clock.mark(stage)
            del view
        queued.append((device, stream, slab_clock, out))
    _, _, lo, hi = slabs[0]
    parts = [work(dev[lo:hi + HASH_W - 1], slabs[0])]
    if clock is not None:
        clock.mark(stage)
    for device, stream, slab_clock, out in queued:
        with _on(device, stream):
            out = tuple(t.to(home, non_blocking=True) for t in out)
            slab_clock.mark("gather")
        if stream is not None:
            here.wait_stream(stream)
            for t in out:
                t.record_stream(here)
        parts.append(out)
    out = [torch.cat(p) if len(p) > 1 else p[0] for p in zip(*parts)]
    if clock is not None:
        clock.mark("gather")
    return out, [c for _, _, c, _ in queued]


def anchor_candidates_fporder(dev: torch.Tensor, stride: int,
                              sp_devices=None):
    """(spos, cand) int32 of length ``(len(dev) - 31) // stride`` in
    fingerprint order: one anchor per stride-row and its nearest previous
    equal-fingerprint anchor (-1 where none); empty rows carry
    ``_I32_BIG`` positions (matcher._anchor_candidates_fporder).

    ``sp_devices`` (the devices of a dp row, ``dev``'s first) splits the
    rows over them (``split_stage``); the sort runs on the first, where
    the result lies.  The result does not depend on the split."""
    rows, _ = split_stage(dev, stride, _row_devices(sp_devices, dev.device))
    return candidates_from_rows(*rows)


def match_candidates(data: torch.Tensor, sp_devices=None):
    """(cand, ok) for every 32-byte window of a uint8 tensor: the nearest
    previous window with the same two fingerprints as int32 (-1 where
    none) and ``cand >= 0``; length ``len(data) - 31``
    (matcher.match_candidates).  ``sp_devices`` (the devices of a dp row,
    ``data``'s first) splits the fingerprints' windows over them
    (``split_stage``); the sort runs on the first, where the result
    lies."""
    fps, _ = split_stage(data, 1, _row_devices(sp_devices, data.device))
    return candidates_from_fps(*fps)


def candidates_from_fps(fpa: torch.Tensor, fpb: torch.Tensor):
    """``match_candidates`` from the two fingerprints of every window, as
    int32 bit patterns (``_slab_fps``).

    One sort by (fpa as uint32, pos); the second fingerprint rides along
    and is compared on all 32 bits.  The sorted positions are a
    permutation of 0..m-1, so the way back to position order is a scatter
    (the JAX package sorts a second time)."""
    m = fpa.shape[0]
    dev = fpa.device
    # uint32 order of fpa as the signed order of an int64 key: flipping
    # the sign bit maps the uint32 value u to the int32 u - 2**31
    key = ((fpa ^ INT32_MIN).to(torch.int64) << 32) | torch.arange(
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
# The slab streams of the sp split (``MatchJob(sp_devices=)``): three a
# device, a ring of their own, so a job's slab work never takes a stream
# that a live job holds, even on a row that repeats the job's device.
# Two live jobs' slabs may share one: that orders them, no more.
_slab_streams: dict = {}
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


def _next_stream(rings: dict, device: torch.device):
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _streams_lock:
        ring = rings.get(index)
        if ring is None:
            ring = rings[index] = [
                [torch.cuda.Stream(index) for _ in range(_JOB_STREAMS)], 0]
        stream = ring[0][ring[1] % _JOB_STREAMS]
        ring[1] += 1
    return stream


def _job_stream(device: torch.device):
    return _next_stream(_streams, device)


def _slab_stream(device: torch.device):
    return _next_stream(_slab_streams, device)


def _on(device: torch.device, stream=None):
    """``device``, and ``stream`` where given, as the current ones (CUDA;
    a null context on another device)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    if stream is not None:
        stack.enter_context(torch.cuda.stream(stream))
    return stack


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

    ``sp_devices`` names the devices of the chunk's dp row, ``device``
    first (the mesh's sp axis).  The job's first device stage is
    ``split_stage`` over them: with s > 1 it splits what the JAX
    package's ``P("dp", "sp")`` sharding splits, at stride > 1 each
    slab's K1 and row minima on its device over its rows and a halo of
    one row a side, at stride 1 the windows' fingerprints, narrowed to
    int32 for the trip.  Slab i > 0 copies its bytes from ``dev`` and
    runs on a slab stream of its device (a ring of its own, never a live
    job's stream), and its outputs come back to ``device`` after slab 0
    has been queued on the job stream; nothing is read back on another
    device.  Everything global over the chunk (the candidate sort, the
    chains, K9, the selection, the read-backs, the host finalize) runs
    on ``device`` as in a one-device job, so the tokens do not depend on
    the split.  ``stats["sp_device_ms"]`` holds each slab i > 0's stages
    (upload: the copy from ``dev``, anchors or fingerprints, gather: the
    copy back) on its stream, and ``sp_peer`` whether ``device`` can
    reach its device directly (``torch.cuda.can_device_access_peer``;
    None for the same device): without peer access the copies stage
    through the host.
    """

    def __init__(self, data, stride: int, device, select: bool = True,
                 dev: Optional[torch.Tensor] = None, sp_devices=None):
        data = np.asarray(data, dtype=np.uint8)
        if stride not in (1, 2, 4, 8, 16, 32):
            raise ValueError(f"anchor stride {stride} not in 1..32 "
                             "(powers of 2)")
        self.data = data
        self.stride = stride
        self.n = len(data)
        self.device = torch.device(device)
        self.sp_devices = _row_devices(sp_devices, self.device)
        if self.sp_devices[0] != self.device or any(
                d.type != self.device.type for d in self.sp_devices):
            raise ValueError(f"sp_devices {self.sp_devices} must start with "
                             f"{self.device} and share its type")
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
        return _on(self.device, self.stream)

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
        streams = [_slab_stream(d) for d in self.sp_devices[1:]] \
            if self.stream is not None else None
        out, self._sp_clocks = split_stage(self.dev, self.stride,
                                           self.sp_devices, streams,
                                           self.clock)
        if self.stride == 1:
            return self._dense(out)
        return self._anchored(out)

    def _dense(self, fps):
        """Stride 1: candidates from the fingerprints, the runs'
        compaction and read-back, then the host greedy cover in verified
        mode (exact runs, not gap-merged records)."""
        cand, ok = candidates_from_fps(*fps)
        fps.clear()             # the caller's list: frees the fingerprints
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

    def _anchored(self, rows):
        global walk_fallbacks
        self.seeds = candidates_from_rows(*rows)
        rows.clear()
        self.clock.mark("candidates")
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
            # the job stream waited on every slab's last event
            self.clock.sync()
            self.stats["device_ms"] = self.clock.ms()
            if len(self.sp_devices) > 1:
                self.stats["sp_device_ms"] = [c.ms() for c in
                                              self._sp_clocks]
                self.stats["sp_peer"] = [
                    None if d == self.device else
                    torch.cuda.can_device_access_peer(self.device, d)
                    for d in self.sp_devices[1:len(self._sp_clocks) + 1]]
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
