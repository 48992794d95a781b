#!/usr/bin/env python3
"""Smoke run of lrzip_next_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the last line:

1. environment: the card's name and power limit, torch and CUDA versions,
   whether ``zstandard`` imports, and the port's native host runtime
   (required; built with g++ at first use);
2. build: nvcc compiles the port's CUDA kernels from ``ops/csrc``, one
   process per source, all started together;
3. kernels: every kernel against its plain PyTorch version on the card,
   bit for bit, with both times (median of 5, CUDA events): K1
   (anchor_fps) and K2 (compact_starts3, the one-pass compaction; its
   own check is the only run that launches it) at the matcher's shapes
   for a 64 MiB and a 256 MiB chunk (stride 8; K1 also bit for bit at
   strides 2, 4, 16 and 32 on the 64 MiB chunk); K3 (pack_stream), K4
   (joint_histogram), K5 (encode_scan), K6 (pack_plane) and K7
   (decode_scan) at the shapes of the 64 MiB chunk's literal stream, made
   from its real matcher tokens (level 7, ctx_bits 6; K4, K5 and K7 also
   at ctx_bits 8; K4, K5 and K7 also with their own device time under
   ``torch.profiler``, and K7 with its cluster size), K7 at 64 lanes and
   at every cluster size it launches (K = 1024 .. 16384 lanes of 1280
   steps); the replay kernels K8a
   (ragged_concat) and K8c (small_merge) on the piece tables, and K8b
   (layered_pass) on every layer's piece table, that the device replay of
   the 64 MiB long-range chunk and of the 64 MiB pasted-pieces chunk hands
   them (each also with its own device time), and the pasted-pieces
   chunk's whole layered replay (``replay_pieces_layered``, median of 5);
   K9 (compact_masked) on the run masks of the chunk's dense candidates;
   K11 (gear_anchors, the cross-window index's scan) on an 8 MiB and a
   64 MiB window of the long-range corpus in their padded buckets, against
   the host pair ``gear_anchor_positions`` + ``window_hashes_at`` (its
   numpy counterpart, timed) and its plain version, with its device time
   and the time of the scan with its read-back (``read_anchors``).
   Beside each kernel's time stand its bound (see ``bound``) and, where
   one PyTorch call computes the same function, that call's time and the
   ratio.  K2, K9, K10, K3 and K6 also run under ``torch.profiler``: at
   most one kernel and one memset a call, and the kernel's own device time
   (K2, K9 and K10 also on an all-clear mask and on one tile,
   ``one_pass_floors``); K1's device time too.  Every row whose device
   time the profiler measured carries it as ``dev_ms``;
4. the slice: ``lrzip_next_tpu_torch.compress`` of the 64 MiB long-range
   corpus with ``method="rans"`` (the matcher's K1 and K10, twice a
   chunk for the chain starts and ends, and the device literal encode:
   K3-K6) and
   ``decompress`` on the card of that archive and of the 64 MiB
   pasted-pieces one, whose plan is layered (the device literal decode
   and the device replay: K7, K8a, K8b, K8c), cold and twice warm; the
   same with lzma (host literal coder: K1, K10; host decode, no kernel),
   and a 16 MiB word-soup text with holes (gzip, which takes the walk
   fallback).  Then the dense matcher: the same 64 MiB corpus with
   ``anchor_stride=1`` and rans (K9 and K3-K6, neither K1 nor K10),
   round trip, beside the stride-8 numbers; the matcher's stages one by
   one (K1, the anchor candidates, the chain masks with ``compact_seeds``
   and with ``compact_seeds_dual``: K10 twice each, K2 never; the full
   step); and
   ``decompress_to_device`` of the long-range and pasted-pieces rans
   archives and of the lzma archive (K7 and K8a-c
   as for ``decompress``; CUDA tensors equal to the input), timed up to a
   synchronised device tensor.  The launch counters are zeroed just before
   each run and read just after: every kernel of the path must have
   launched.  A profile of one warm decompress shows where its time goes,
   with the replay on the card split into its parts;
5. multichunk: the command line (``lrzip_next_tpu_torch.cli.main``) on
   a 256 MiB long-range file with ``--rans -m 1``: three chunks of 100,
   100 and 56 MiB, each queued two ahead (K1 three times, K10 six, K3-K6
   three each; the peak device memory with three jobs live), the same
   archive twice, each chunk's tokens equal to those of a ``MatchJob``
   run on the calling thread and the default stream, and ``-d`` back to
   the file (K7, K8a, K8c three times each, no pointer-doubling
   replay); the seconds per 64 MiB of a warm compress in one 64 MiB chunk
   and in four (median of 3; the lookahead's overlap, reported and not
   gated); ``-U`` (gzip) over four 32 MiB windows of its first 128 MiB
   (K1 four times, K10 eight, K11 four, ``cross_scan_card`` 1 on every
   window, no K3-K6), round trip; and ``--no-tpu -g``
   on a 16 MiB word soup (the host matcher: no launch), round trip;
6. mesh: the multi-device path (``parallel/``) on this card, on the same
   256 MiB corpus: ``use_mesh=True`` with one card writes the
   ``use_mesh=False`` archive and makes no mesh batch; four 64 MiB rans
   chunks through a mesh of two dp rows on cuda:0 (two batches, K1 four
   times, K10 eight, K3-K6 four each) write the single-device archive,
   which decodes on the card, with the seconds per 64 MiB beside the
   lookahead's (median of 3, in turns) and the peak device memory; the
   same dense on two 64 MiB chunks (K9 twice); ``dryrun_multichip`` on 2
   and 4 mesh entries; two processes joined by ``init_distributed`` over
   127.0.0.1 (gloo), a 64 MiB chunk each, whose archive equals one
   process's and decodes; then the sp axis (``phase_mesh_sp``): K1 on
   the slabs of the 64 MiB chunk's rows at s = 2 and 4 equal to one
   whole-chunk K1 and its plain version, four 64 MiB rans chunks on
   meshes of 1 x 2 and 2 x 2 entries of cuda:0 (K1 once a slab, the
   single-device archive, each chunk's tokens equal to a one-device
   job's, per-slab device ms), their seconds per 64 MiB beside the
   dp-only mesh, and two dense 64 MiB chunks on the 2 x 2 mesh (K9 2);
7. card equals CPU: an 8 MiB mixed input (gzip), a 4 MiB skewed input
   whose literals make one rANS block of 4096 lanes (rans), a 4 MiB
   pasted-pieces input (rans, layered replay), a 4 MiB dense
   (``anchor_stride=1``) rans archive, 4 MiB of the mixed corpus in 1
   MiB chunks (rans) and in 1 MiB ``-U`` windows (gzip), each compressed
   with device="cuda" and with device="cpu", give the same archive
   bytes, and each device decodes the other's archive;
8. corrupt payloads on the card: a flipped word and a word count cut
   short must raise ``ValueError`` from the literal decode, and a flipped
   byte in an archive's literal block from ``decompress``.

The line before the last is a JSON object of the kernels, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
nonzero and prints no result.  All data is generated from fixed seeds.
"""

from __future__ import annotations

import cProfile
import importlib.util
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MIB = 1 << 20
STRIDE = 8  # level 7
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, where a fused
# multiply-add counts two, so 33.5e12 plain 32-bit operations a second is
# the rate the kernels' integer arithmetic is held to.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 33.5e12


def log(msg: str) -> None:
    """Print; with ``CHIP_SMOKE_LOG`` set, also append to that file (for
    output longer than a terminal keeps)."""
    print(msg, flush=True)
    path = os.environ.get("CHIP_SMOKE_LOG")
    if path:
        with open(path, "a") as fd:
            fd.write(msg + "\n")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event milliseconds of ``fn`` over ``reps`` runs."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(moved_bytes: int, int_ops: int) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate, and its integer operations over the peak rate."""
    by_bytes = moved_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = int_ops / PEAK_INT_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(moved_bytes), "bound_ops": int(int_ops)}


def set_sectors(mask: torch.Tensor, x: torch.Tensor) -> int:
    """The 32-byte sectors of the int32 tensor ``x`` that hold an element
    at a set flag of ``mask`` (from this run's mask and x's address)."""
    idx = torch.nonzero(mask).squeeze(1)
    return int(torch.unique_consecutive((idx + x.data_ptr() // 4) // 8)
               .numel())


def compaction_bound(mask: torch.Tensor, payloads, n: int,
                     int_ops: int) -> dict:
    """``bound`` of a compaction (K2, K10) that reads the flags once, each
    int32 payload only in the 32-byte sectors that hold an element at a
    set flag (counted from this run's mask and the payloads' addresses),
    and writes the n kept records and the count.  ``bound_ms_all_payload``
    is the same bound charged with every payload byte, the figure these
    rows carried before the kernel read payloads at set flags only."""
    m = mask.shape[0]
    sectors = sum(set_sectors(mask, x) for x in payloads)
    width = 4 * len(payloads)
    res = bound(m + 32 * sectors + width * n + 4, int_ops)
    res["bound_ms_all_payload"] = bound((1 + width) * m + width * n + 4,
                                        int_ops)["bound_ms"]
    return res


def byte_compaction_bound(mask: torch.Tensor, vals: torch.Tensor, cap: int,
                          int_ops: int) -> dict:
    """``bound`` of K3, by the rule of ``compaction_bound``: the flags
    once, the uint8 values only in the 32-byte sectors that hold an
    element at a set flag (counted from this run's mask and the values'
    address), and the cap-sized block and the count written.
    ``bound_ms_all_payload`` charges every value byte."""
    m = mask.shape[0]
    idx = torch.nonzero(mask).squeeze(1)
    sectors = int(torch.unique_consecutive(
        (idx + vals.data_ptr()) // 32).numel())
    res = bound(m + 32 * sectors + cap + 4, int_ops)
    res["bound_ms_all_payload"] = bound(2 * m + cap + 4, int_ops)["bound_ms"]
    return res


def text_blob() -> np.ndarray:
    srcs = sorted(ROOT.glob("lrzip_next_tpu/**/*.py")) + \
        sorted(ROOT.glob("lrzip_next_tpu/runtime/csrc/*.cpp"))
    blob = b"".join(p.read_bytes() for p in srcs)
    require(len(blob) > 100_000, "in-repo text for the corpus not found")
    return np.frombuffer(blob, dtype=np.uint8)


def long_range_corpus(total: int, seg_mib: int = 8, unique: int = 3
                      ) -> np.ndarray:
    """Text-like 8 MiB segments (the in-repo sources under seeded byte
    permutations, so no exact repeat inside a segment), three unique ones
    recurring 24 MiB apart: only the long-range matcher finds them."""
    blob = text_blob()
    seg = seg_mib * MIB
    segs = []
    for k in range(unique):
        rng = np.random.default_rng(1000 + k)
        parts = [rng.permutation(256).astype(np.uint8)[blob]
                 for _ in range(seg // len(blob) + 1)]
        segs.append(np.concatenate(parts)[:seg])
    reps = -(-total // seg)
    return np.concatenate([segs[i % unique] for i in range(reps)])[:total]


def word_soup_with_holes(total: int) -> np.ndarray:
    """Dense small-distance text (a few words in random order), copied with
    8-byte random holes every 23,000 bytes, plus a tail repeat: the corpus
    on which the coarse-chain walk beats the prefix-max selection."""
    rng = np.random.default_rng(5)
    words = [np.frombuffer(w, np.uint8) for w in (
        b"the quick brown fox ", b"jumps over ", b"lazy dog ",
        b"compression ", b"long range redundancy ", b"tpu kernel ")]
    size = int(total / 2.25)
    idx = rng.integers(0, len(words), size // 8)
    base = np.concatenate([words[i] for i in idx])[:size]
    holed = base.copy()
    for off in range(5_000, size - 10_000, 23_000):
        holed[off:off + 8] = rng.integers(0, 256, 8, dtype=np.uint8)
    return np.concatenate([base, holed, base[:total - 2 * size]])


def pasted_corpus(total: int) -> np.ndarray:
    """A quarter of seeded i.i.d. bytes of a Zipf-like law (compressible,
    no long repeats), a region of short pieces of it (40 to 400 bytes)
    pasted in random order, and copies of that region and of its copies:
    long matches over a fragmented region, whose replay plan is layered."""
    rng = np.random.default_rng(13)
    part = total // 4
    law = 1.0 / np.arange(1, 257) ** 1.2
    base = rng.choice(256, part, p=law / law.sum()).astype(np.uint8)
    lens = rng.integers(40, 400, part // 200)
    lens = lens[np.cumsum(lens) <= part]
    starts = rng.integers(0, part - 400, len(lens))
    idx = np.repeat(starts - (np.cumsum(lens) - lens), lens) + \
        np.arange(int(lens.sum()))
    frag = base[idx]
    out = np.concatenate([base, frag, frag, frag[len(frag) // 3:], base,
                          frag])
    require(len(out) >= total, "pasted corpus too short")
    return out[:total]


def mixed_corpus(total: int) -> np.ndarray:
    """Random base with short segments of it pasted far apart."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, total // 3, dtype=np.uint8)
    starts = rng.integers(0, len(base) - 256, total // 100)
    lens = rng.integers(16, 256, total // 100)
    out = np.concatenate([base[s:s + n] for s, n in zip(starts, lens)])
    require(len(out) >= total, "mixed corpus too short")
    return out[:total]


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi gave no card"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return card


def phase_build():
    from lrzip_next_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    log(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
        f"{time.perf_counter() - t0:.3f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


def padded_on_card(data: np.ndarray) -> torch.Tensor:
    from lrzip_next_tpu_torch.ops.matcher import bucket_size
    padded = torch.zeros(bucket_size(len(data)), dtype=torch.uint8,
                         device="cuda")
    padded[:len(data)] = torch.from_numpy(data).cuda()
    return padded


def check_k1(data: np.ndarray, label: str, stride: int = STRIDE,
             timed: bool = True) -> dict:
    """K1 against its plain version at ``stride``; with ``timed``, also its
    times, its device time and its bound."""
    from lrzip_next_tpu_torch.ops.anchor import anchor_fps, \
        anchor_fps_reference
    padded = padded_on_card(data)
    nb = padded.shape[0]
    ma = ((nb - 31) // stride) * stride
    fpa, fpb = anchor_fps(padded, stride, ma)
    torch.cuda.synchronize()
    rfpa, rfpb = anchor_fps_reference(padded, stride, ma)
    torch.cuda.synchronize()
    err = max(int((fpa.long() - rfpa.long()).abs().max()),
              int((fpb.long() - rfpb.long()).abs().max()))
    require(err == 0 and torch.equal(fpa, rfpa) and torch.equal(fpb, rfpb),
            f"K1 differs from its plain version at {label}, stride {stride}")
    anchors = int((fpa != 0x7FFFFFFF).sum())
    del rfpa, rfpb
    if not timed:
        log(f"K1 anchor_fps {label}, stride {stride}: n={nb} ma={ma} "
            f"anchors={anchors} bit-equal")
        return {"max_abs_err": err}
    ms = cuda_ms(lambda: anchor_fps(padded, stride, ma))
    plain_ms = cuda_ms(lambda: anchor_fps_reference(padded, stride, ma))
    device_ms = kernel_device_ms(lambda: anchor_fps(padded, stride, ma),
                                 "anchor_fps_kernel", f"K1 {label}")
    # bytes: the chunk in, two int32 fingerprints a window out; operations
    # a window: 12 for the two tree hashes (6 multiply-adds), 2 * (stride
    # / 2) + 2 for the centred-window minimum, compare and select
    bnd = bound(nb + 8 * ma, ma * (12 + stride + 2))
    log(f"K1 anchor_fps {label}, stride {stride}: n={nb} ma={ma} "
        f"anchors={anchors} bit-equal; kernel {ms:.4f} ms, device "
        f"{device_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
        f"({bnd['bound_bytes']} bytes); bound / device "
        f"{bnd['bound_ms'] / device_ms:.4f}; no single library call")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None, "device_ms": device_ms}


def profiled_cuda_events(fn, label: str, reps: int = 5) -> list:
    """The CUDA events that ``torch.profiler`` records over ``reps`` calls
    of ``fn`` (after one call outside it).  The profiler drops events now
    and then, at times a whole window's; a window that saw no CUDA event
    at all is taken again, at most twice, and said so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ops:
            return ops
        log(f"  {label}: the profiler saw no CUDA event in window "
            f"{attempt + 1}")
    return []


def one_pass_device(fn, label: str, reps: int = 5,
                    kernel: str = "compact_kernel") -> float:
    """``fn`` calls a one-pass compaction's wrapper once (K2 or K10:
    ``compact_kernel``; K3: ``pack_bytes_kernel``; K6:
    ``pack_plane_kernel``; K9: ``compact_masked_kernel``).  Under
    ``torch.profiler``, the calls must run at most one ``kernel`` and at
    most one memset each on the device and nothing else (the profiler may
    miss a call of a few microseconds, so fewer count too); returns the
    kernel's device milliseconds, averaged over the kernels it saw (the
    wrapper's CUDA-event time also holds the host's work between the
    events)."""
    ops = profiled_cuda_events(fn, label, reps)
    kernels = [e for e in ops if kernel in e.name]
    memsets = [e for e in ops if "memset" in e.name.lower()]
    require(1 <= len(kernels) <= reps and len(memsets) <= reps
            and len(kernels) + len(memsets) == len(ops),
            f"{label}: {reps} calls ran {[e.name for e in ops]}")
    ms = sum(e.device_time_total for e in kernels) / 1e3 / len(kernels)
    log(f"  {label}: {reps} calls ran {len(kernels)} kernels and "
        f"{len(memsets)} memsets that the profiler saw; the kernel alone "
        f"{ms:.4f} ms a call on the device (torch.profiler)")
    return ms


def one_pass_floors(call, m: int, label: str, kernel: str = "compact_kernel",
                    tile: int = 8192) -> dict:
    """Device ms of a K2, K9 or K10 wrapper without its payload traffic:
    ``call(mask)`` on an all-clear mask of the same m flags (the flag loads
    and the look-back, nothing to scatter) and on one tile's ``tile``
    flags (the launch and one block); ``kernel`` as for
    ``one_pass_device``."""
    res = {}
    for key, n in (("device_ms_all_clear", m), ("device_ms_one_tile", tile)):
        mask = torch.zeros(n, dtype=torch.bool, device="cuda")
        res[key] = one_pass_device(lambda: call(mask), f"{label}, {key}",
                                   kernel=kernel)
    return res


def kernel_device_ms(fn, kernel: str, label: str, reps: int = 5) -> float:
    """Device milliseconds of the CUDA kernel whose name holds ``kernel``,
    averaged over the launches ``torch.profiler`` saw in ``reps`` calls of
    ``fn`` (the wrapper's CUDA-event time also holds the host's work
    between the events and, for K5, the launch that packs its table)."""
    seen = [e for e in profiled_cuda_events(fn, label, reps)
            if kernel in e.name]
    require(1 <= len(seen) <= reps,
            f"{label}: {reps} calls ran {len(seen)} {kernel} kernels")
    ms = sum(e.device_time_total for e in seen) / 1e3 / len(seen)
    log(f"  {label}: {kernel} alone {ms:.4f} ms a call on the device "
        f"(torch.profiler, {len(seen)} launches seen)")
    return ms


def check_k2(data: np.ndarray, label: str) -> dict:
    from lrzip_next_tpu_torch.ops import matcher as M
    from lrzip_next_tpu_torch.ops.compact import compact_starts3, \
        compact_starts3_reference
    pos, cand = M.anchor_candidates_fporder(padded_on_card(data), STRIDE)
    start, is_end, sp, sd = M.dist_sorted_seed_starts(
        pos, cand, len(data) - 31, M.verify_gap(STRIDE))
    end_at = M.seg_end_copy(sp, is_end)
    zero_launches()
    a, b, c, n = compact_starts3(start, sp, sd, end_at)
    torch.cuda.synchronize()
    launches = read_launches()   # the check's own, not a path's
    require(launches["k2"] == 1 and sum(launches.values()) == 1,
            f"compact_starts3 launched {launches}, not K2 once")
    ra, rb, rc, rn = compact_starts3_reference(start, sp, sd, end_at)
    torch.cuda.synchronize()
    k = int(rn)
    require(int(n) == k, f"K2 count {int(n)} != plain {k} at {label}")
    err = max(int((x[:k].long() - y[:k].long()).abs().max()) if k else 0
              for x, y in ((a, ra), (b, rb), (c, rc)))
    require(err == 0, f"K2 differs from its plain version at {label}")
    ms = cuda_ms(lambda: compact_starts3(start, sp, sd, end_at))
    plain_ms = cuda_ms(
        lambda: compact_starts3_reference(start, sp, sd, end_at))

    def library():
        idx = torch.nonzero(start).squeeze(1)
        return sp[idx], sd[idx], end_at[idx]

    library_ms = cuda_ms(library)
    m = start.shape[0]
    # operations: flag test, ballot rank and slot per element, three moves
    # per record
    bnd = compaction_bound(start, (sp, sd, end_at), k, 4 * m + 3 * k)
    device_ms = one_pass_device(
        lambda: compact_starts3(start, sp, sd, end_at), f"K2 {label}")
    floors = one_pass_floors(
        lambda f: compact_starts3(f, *(x[:f.shape[0]] for x in
                                       (sp, sd, end_at))), m, f"K2 {label}")
    log(f"K2 compact_starts3 {label}: k={m} n={k} bit-equal; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
        f"({bnd['bound_bytes']} bytes; every payload byte: "
        f"{bnd['bound_ms_all_payload']:.4f} ms), torch.nonzero + 3 gathers "
        f"{library_ms:.4f} ms; kernel / library "
        f"{ms / library_ms:.4f}, bound / kernel {bnd['bound_ms'] / ms:.4f}, "
        f"bound / device {bnd['bound_ms'] / device_ms:.4f}")
    # K2 is on no path: its ``launches`` in the kernels line is the main
    # path's 0, and this check's one launch goes under ``check_launches``
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": library_ms, "device_ms": device_ms, **floors,
            "check_launches": launches["k2"]}


def check_k9(data: np.ndarray, label: str) -> dict:
    """K9 on the run masks of the chunk's dense stride-1 candidates."""
    from lrzip_next_tpu_torch.ops import matcher as M
    from lrzip_next_tpu_torch.ops.compact import compact_masked, \
        compact_masked_reference
    cand, ok = M.match_candidates(padded_on_card(data))
    start, is_end, idx = M.run_masks(cand, ok, len(data) - 31)
    del ok
    m = start.shape[0]
    k = int(start.sum())
    require(int(is_end.sum()) == k, f"K9 input: {k} starts but "
            f"{int(is_end.sum())} ends at {label}")

    def same(a, b):
        require(int(a[3]) == int(b[3]) == k,
                f"K9 count {int(a[3])} != plain {int(b[3])} at {label}")
        return max(max_err(x[:k], y[:k]) for x, y in zip(a[:3], b[:3]))

    def library():
        s_idx = torch.nonzero(start).squeeze(1)
        e_idx = torch.nonzero(is_end).squeeze(1)
        return idx[s_idx], idx[e_idx], cand[s_idx]

    # bytes, by the rule of ``compaction_bound``: both flags once, the
    # int32 positions only in the 32-byte sectors that hold a run's start
    # or end, the candidates only in those that hold a start, k triples
    # and the count out ("all": every payload byte); operations: two flag
    # tests, two ballot ranks and two slots per element, three moves per
    # run
    ops = 6 * m + 3 * k
    sectors = set_sectors(start | is_end, idx) + set_sectors(start, cand)
    bnd = bound(2 * m + 32 * sectors + 12 * k + 4, ops)
    bnd["bound_ms_all_payload"] = bound(10 * m + 12 * k + 4, ops)["bound_ms"]
    res = timed_pair(
        "K9 compact_masked", f"{label}: m={m} runs={k}",
        lambda: compact_masked(start, is_end, idx, cand),
        lambda: compact_masked_reference(start, is_end, idx, cand), same,
        bnd, library, "torch.nonzero twice + 3 gathers")
    res.pop("out")
    # device time: one kernel and at most one memset a call, nothing else
    k9 = "compact_masked_kernel"
    res["device_ms"] = one_pass_device(
        lambda: compact_masked(start, is_end, idx, cand), f"K9 {label}",
        kernel=k9)
    clear_end = torch.zeros(m, dtype=torch.bool, device="cuda")
    res.update(one_pass_floors(
        lambda f: compact_masked(f, clear_end[:f.shape[0]], idx[:f.shape[0]],
                                 cand[:f.shape[0]]),
        m, f"K9 {label}", kernel=k9, tile=32768))   # compact_masked.cu kTile
    log(f"  K9 {label}: bound {bnd['bound_ms']:.4f} ms ({sectors} payload "
        f"sectors at set flags), every payload byte "
        f"{bnd['bound_ms_all_payload']:.4f} ms; bound / device "
        f"{bnd['bound_ms'] / res['device_ms']:.4f}")
    return res


def check_k10(data: np.ndarray, label: str) -> dict:
    """K10 on the chain masks of the chunk's stride-8 seeds: the launch
    for (pos, dist) at the chain starts (the row of the table) and the one
    for pos at the chain ends."""
    from lrzip_next_tpu_torch.ops import matcher as M
    from lrzip_next_tpu_torch.ops.compact import compact_starts, \
        compact_starts_reference
    pos, cand = M.anchor_candidates_fporder(padded_on_card(data), STRIDE)
    start, is_end, sp, sd = M.dist_sorted_seed_starts(
        pos, cand, len(data) - 31, M.verify_gap(STRIDE))
    kk = start.shape[0]
    res = None
    for what, mask in (("starts", start), ("ends", is_end)):
        k = int(mask.sum())

        def same(a, b):
            require(int(a[2]) == int(b[2]) == k,
                    f"K10 count {int(a[2])} != plain {int(b[2])} at {label}")
            return max(max_err(x[:k], y[:k]) for x, y in zip(a[:2], b[:2]))

        def library():
            i = torch.nonzero(mask).squeeze(1)
            return sp[i], sd[i]

        # operations: flag test, ballot rank and slot per element, two
        # moves per record
        bnd = compaction_bound(mask, (sp, sd), k, 4 * kk + 2 * k)
        r = timed_pair(
            "K10 compact_starts", f"{label}, chain {what}: k={kk} n={k}",
            lambda: compact_starts(mask, sp, sd),
            lambda: compact_starts_reference(mask, sp, sd), same,
            bnd, library, "torch.nonzero + 2 gathers")
        r.pop("out")
        r["device_ms"] = one_pass_device(
            lambda: compact_starts(mask, sp, sd), f"K10 {label}, {what}")
        log(f"  K10 {label}, {what}: every payload byte "
            f"{bnd['bound_ms_all_payload']:.4f} ms; bound / device "
            f"{bnd['bound_ms'] / r['device_ms']:.4f}")
        if what == "starts":
            r.update(one_pass_floors(
                lambda f: compact_starts(f, sp[:f.shape[0]],
                                         sd[:f.shape[0]]),
                kk, f"K10 {label}"))
        res = res or r
        if what == "ends":
            res.update(ends_ms=r["ms"], ends_library_ms=r["library_ms"],
                       ends_device_ms=r["device_ms"],
                       ends_bound_ms=r["bound_ms"])
    return res


def check_k11(data: np.ndarray, label: str) -> dict:
    """K11 on one window in its padded bucket: the same anchors,
    fingerprints and order as the host pair (``gear_anchor_positions`` +
    ``window_hashes_at``, the JAX package's numpy scan, timed once on the
    host clock) and as its plain version; its times, device time and
    bound; and the scan with its read-back, as the pipeline runs it."""
    from lrzip_next_tpu_torch.models import crosschunk as X
    from lrzip_next_tpu_torch.ops import gearscan as G
    padded = padded_on_card(data)
    n = len(data)
    t0 = time.perf_counter()
    want = X.gear_anchor_positions(data)
    want = (want, X.window_hashes_at(data, want))
    host_pair_ms = (time.perf_counter() - t0) * 1e3
    k = len(want[0])

    def same(a, b):
        require(int(a[2]) == int(b[2]) == k,
                f"K11 count {int(a[2])} != plain {int(b[2])} != host {k} "
                f"at {label}")
        return max(max_err(x[:k], y[:k]) for x, y in zip(a[:2], b[:2]))

    def kernel():
        return G.gear_anchors(padded, n, X._GEAR, 10)

    def scan_and_read():
        return G.read_anchors(*kernel())

    # bytes: the window once, an int32 position and a 64-bit fingerprint
    # an anchor, the count; operations a position: two table look-ups,
    # shift, add, subtract, mask and compare; 206 multiply-adds an anchor
    bnd = bound(n + 12 * k + 4, 7 * n + 206 * k)
    r = timed_pair("K11 gear_anchors", f"{label}: n={n} anchors={k}",
                   kernel, lambda: G.gear_anchors_reference(
                       padded, n, X._GEAR, 10), same, bnd)
    r.pop("out")
    got = scan_and_read()
    require(all(np.array_equal(x, y) for x, y in zip(got, want)),
            f"K11 read back differs from the host pair at {label}")
    r["device_ms"] = one_pass_device(kernel, f"K11 {label}",
                                     kernel="gear_anchors_kernel")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan_and_read()
        times.append((time.perf_counter() - t0) * 1e3)
    r["read_ms"] = statistics.median(times)
    r["host_pair_ms"] = host_pair_ms
    log(f"  K11 {label}: bound / device {bnd['bound_ms'] / r['device_ms']:.4f}"
        f"; scan and read-back {r['read_ms']:.4f} ms (host clock, median of "
        f"5) against the host pair {host_pair_ms:.1f} ms")
    return r


def skewed_symbols(total: int) -> np.ndarray:
    """Seeded i.i.d. bytes of a Zipf-like law: no long repeats, so every
    byte is a literal, and rANS-compressible."""
    rng = np.random.default_rng(11)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, total, p=p / p.sum()).astype(np.uint8)


def timed_pair(name: str, label: str, kernel, plain, same, bnd: dict,
               library=None, library_name: str = "") -> dict:
    """Run the kernel and its plain version once each, require ``same`` of
    their results (0 = equal), then time both, and the one library call
    ``library`` where there is one (median of 5 each).  ``bnd`` is the
    kernel's ``bound`` at these inputs."""
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    err = same(got, ref)
    require(err == 0, f"{name} differs from its plain version at {label}")
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain)
    library_ms = cuda_ms(library) if library is not None else None
    log(f"{name} {label}: bit-equal; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by "
        f"{bnd['bound_by']} ({bnd['bound_bytes']} bytes, "
        f"{bnd['bound_ops']} operations), " +
        (f"{library_name} {library_ms:.4f} ms; kernel / library "
         f"{ms / library_ms:.4f}" if library is not None
         else "no single library call") +
        f"; bound / kernel {bnd['bound_ms'] / ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": library_ms, "out": got}


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return 1 << 62
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_k7(words, states, freqs, n: int, ctx_bits: int, t_len: int,
             want: torch.Tensor, label: str) -> dict:
    """K7 against its plain version on the same CUDA tensors; the decoded
    block must also equal ``want`` and every final state 2^16."""
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    k = states.shape[0]
    nw = words.shape[0]
    # bytes: the words, the states in and out, the cumulative table, and
    # the K*T symbol block out; operations a symbol, as the function needs
    # them (a slot-to-symbol table, not this kernel's search): the slot
    # mask, one table load, 6 for the state update and renormalisation, 2
    # for its share of the step's prefix.  Neither binds: the T steps are
    # a dependent chain (see ``check_k7_small``)
    bnd = bound(2 * nw + 8 * k + 2 * 257 * freqs.shape[0] + k * t_len,
                10 * n)
    res = timed_pair(
        f"K7 decode_scan ctx_bits {ctx_bits}", label,
        lambda: RK.decode_scan(words, states, freqs, n, ctx_bits, t_len),
        lambda: RK.decode_scan_reference(words, states, freqs, n, ctx_bits,
                                         t_len),
        lambda a, b: max(max_err(a[0], b[0]), max_err(a[1], b[1])), bnd)
    plane, xf = res["out"]
    require(torch.equal(plane[:n], want[:n]),
            f"K7 does not return the encoded block at {label}")
    require(bool((xf == RK.L_INIT).all()),
            f"K7 final states are not all 2^16 at {label}")
    res["cluster"] = RK.decode_cluster(k, ctx_bits)
    require(k <= 1024 or res["cluster"] >= 2,
            f"K7 at {k} lanes runs on {res['cluster']} CTA")
    res["device_ms"] = kernel_device_ms(
        lambda: RK.decode_scan(words, states, freqs, n, ctx_bits, t_len),
        "decode_kernel", f"K7 ctx_bits {ctx_bits} {label}")
    log(f"  K7: {n} symbols from {nw} words in {t_len} dependent steps of "
        f"{k} lanes on a cluster of {res['cluster']} CTAs: "
        f"{n / res['ms'] / 1e6:.4f} GB/s of output; "
        f"{res['device_ms'] * 1e3 / t_len:.4f} us a step on the device")
    res["t_len"], res["lanes"] = t_len, k
    return res


def check_k7_small() -> float:
    """K7 at the fewest lanes (K = 64, one lane a thread, two warps).
    Returns its microseconds a step: with two warps nothing but the
    step's own dependent chain (search, update, prefix, word fetch,
    barrier) takes time, so T times this is the least a decode of T steps
    takes on this design, whatever its lane count."""
    from lrzip_next_tpu_torch.ops import rans
    n = 64 * 1024 - 5
    lit = torch.from_numpy(skewed_symbols(n)).cuda()
    k, t_len, _ = rans.plan(n)
    require(k == 64, f"small K7 case planned {k} lanes, not 64")
    freqs, states, packed, n_words, t_len = rans.encode_arrays(lit, n, 6)
    res = check_k7(packed[:int(n_words)].contiguous(), states, freqs, n, 6,
                   t_len, lit, f"K={k} T={t_len}")
    return res["ms"] * 1e3 / t_len


def check_k7_clusters(t_len: int = 1280) -> None:
    """K7 at every cluster size it launches: K = 1024 (one CTA), 2048,
    4096, 8192 and 16384 lanes of ``t_len`` steps, ctx_bits 6, each on the
    card's own encode of seeded skewed bytes.  The lines show how the step
    grows with the cluster size C."""
    from lrzip_next_tpu_torch.ops import rans
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    from lrzip_next_tpu_torch.ops import streampack as SP
    block = torch.from_numpy(skewed_symbols(16384 * t_len)).cuda()
    for k in (1024, 2048, 4096, 8192, 16384):
        n = k * t_len
        lit = block[:n].contiguous()
        freqs = rans.quantize_freqs(RK.joint_histogram(lit, n, 6, 1, k))
        states, plane = RK.encode_scan(lit, n, freqs, 6, k)
        packed, n_words = SP.pack_plane(plane, n)
        res = check_k7(packed[:int(n_words)].contiguous(), states, freqs, n,
                       6, t_len, lit, f"K={k} T={t_len}")
        log(f"  K7 cluster sweep: K={k} C={res['cluster']}: kernel "
            f"{res['ms']:.4f} ms, device {res['device_ms']:.4f} ms, "
            f"{res['device_ms'] * 1e3 / t_len:.4f} us a step")
    torch.cuda.empty_cache()


def replay_tables(corpus: np.ndarray):
    """One device replay of the chunk from its matcher tokens and its
    literal block, with every call of a replay kernel's wrapper recorded:
    {wrapper name: [argument tuples]}, tensors cloned as they were handed
    over.  The replayed chunk must equal the input."""
    from lrzip_next_tpu_torch.format.tokens import split_long_runs
    from lrzip_next_tpu_torch.models import device_path as DP
    from lrzip_next_tpu_torch.ops import matcher, rans
    from lrzip_next_tpu_torch.ops import replay_ragged as RR
    from lrzip_next_tpu_torch.ops import streampack as SP
    job = matcher.MatchJob(corpus, STRIDE, torch.device("cuda"))
    kinds, lengths, dists = split_long_runs(*job.collect())
    ls, le, n_lit = DP.literal_spans(kinds, lengths)
    mask = DP.literal_mask(job.dev.shape[0], ls, le, job.dev.device)
    k, t_len, _ = rans.plan(n_lit)
    lit = SP.pack_stream(job.dev, mask, k * t_len)[0]   # as K7 leaves it
    del job, mask
    # the kernels' wrappers where replay_ragged calls them, the layered
    # replay where device_path calls it
    spied = [(RR, "ragged_concat"), (RR, "small_merge"),
             (RR, "layered_pass"), (DP, "replay_pieces_layered")]
    real = {name: getattr(mod, name) for mod, name in spied}
    calls = {name: [] for _, name in spied}

    def spy(name):
        def wrapper(*args):
            calls[name].append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args))
            return real[name](*args)
        return wrapper

    for mod, name in spied:
        setattr(mod, name, spy(name))
    try:
        out = DP.replay_tokens_device_array(kinds, lengths, dists, lit)
    finally:
        for mod, name in spied:
            setattr(mod, name, real[name])
    require(out is not None and
            torch.equal(out, torch.from_numpy(corpus).cuda()),
            "the device replay does not rebuild the chunk")
    log(f"  replay plan: {len(kinds)} tokens, {n_lit} literals; wrapper "
        f"calls " + ", ".join(f"{k} {len(v)}" for k, v in calls.items()))
    return calls


def check_replay_kernels(corpus: np.ndarray, label: str) -> dict:
    """K8a, K8c and, where the plan is layered, K8b against their plain
    versions on the tables of this chunk's device replay: K8a and K8c take
    the long and short piece tables, K8b each layer's piece table (every
    pass is held and timed; the row is pass 1's), each also with its own
    device time (``torch.profiler``).  Where the plan is layered, the
    whole ``replay_pieces_layered`` too, host clock, median of 5."""
    from lrzip_next_tpu_torch.ops import replay_ragged as RR
    calls = replay_tables(corpus)
    res = {}
    none = "no single library call: no PyTorch function takes ragged slices"

    def table_bytes(table):
        return int(table[2].sum())

    lit, pieces, ncells = calls["ragged_concat"][0]
    # K8a bytes: the long pieces' bytes and their 24-byte records in, every
    # cell out; operations: one address and one move per byte
    nb = table_bytes(pieces)

    def k8a():
        return RR.ragged_concat(lit, pieces, ncells)

    res["k8a"] = timed_pair(
        "K8a ragged_concat", f"{label}: {pieces.shape[1]} long pieces, {nb} "
        f"bytes, {ncells} cells", k8a,
        lambda: RR.ragged_concat_reference(lit, pieces, ncells), max_err,
        bound(nb + 24 * pieces.shape[1] + ncells * RR.CELL,
              2 * nb + ncells * RR.CELL))
    res["k8a"]["device_ms"] = kernel_device_ms(k8a, "ragged_kernel",
                                               f"K8a {label}")
    if calls["small_merge"]:
        out0, lit, pieces = calls["small_merge"][0]
        nb = table_bytes(pieces)
        mine, plain = out0.clone(), out0.clone()

        # K8c and K8b copy in place from bytes they do not write, so a
        # second run on the same buffer writes the same bytes again
        def k8c():
            return RR.small_merge(mine, lit, pieces)

        res["k8c"] = timed_pair(
            "K8c small_merge", f"{label}: {pieces.shape[1]} short pieces, "
            f"{nb} bytes", k8c,
            lambda: RR.small_merge_reference(plain, lit, pieces), max_err,
            bound(2 * nb + 24 * pieces.shape[1], 2 * nb))
        res["k8c"]["device_ms"] = kernel_device_ms(k8c, "small_kernel",
                                                   f"K8c {label}")
    for i, (buf0, pieces) in enumerate(calls["layered_pass"]):
        nb = table_bytes(pieces)
        mine, plain = buf0.clone(), buf0.clone()

        def k8b():
            return RR.layered_pass(mine, pieces)

        # bytes: the layer's piece bytes in and out and their 24-byte
        # records; operations: one address and one move per byte
        r = timed_pair(
            "K8b layered_pass", f"{label}, pass {i + 1}: {pieces.shape[1]} "
            f"pieces, {nb} bytes", k8b,
            lambda: RR.layered_pass_reference(plain, pieces), max_err,
            bound(2 * nb + 24 * pieces.shape[1], 2 * nb))
        r["device_ms"] = kernel_device_ms(k8b, "layered_span_kernel",
                                          f"K8b {label}, pass {i + 1}")
        log(f"  K8b {label}, pass {i + 1}: bound / device "
            f"{r['bound_ms'] / r['device_ms']:.4f}")
        if "k8b" not in res:
            res["k8b"] = r
        else:
            res["k8b"][f"pass{i + 1}_ms"] = r["ms"]
            res["k8b"][f"pass{i + 1}_device_ms"] = r["device_ms"]
            res["k8b"][f"pass{i + 1}_bound_ms"] = r["bound_ms"]
        del mine, plain
    for args in calls["replay_pieces_layered"]:
        want = torch.from_numpy(corpus).cuda()
        times = []
        for _ in range(6):              # one warm run, then 5 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = RR.replay_pieces_layered(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        require(torch.equal(out, want), f"replay_pieces_layered of {label} "
                "does not rebuild the chunk")
        whole = statistics.median(times[1:])
        log(f"  replay_pieces_layered {label}: {args[3]} layers, "
            f"{len(args[0])} pieces, {whole:.3f} ms (host clock, "
            f"synchronised, median of 5)")
        res["k8b"]["replay_layered_ms"] = whole
        del want, out
    for r in res.values():
        r.pop("out")
    log(f"  K8a-c {label}: {none}")
    torch.cuda.empty_cache()
    return res


def check_literal_kernels(corpus64: np.ndarray) -> dict:
    """K3-K7 at the shapes of the 64 MiB chunk's literal stream."""
    from lrzip_next_tpu_torch.models import device_path as DP
    from lrzip_next_tpu_torch.ops import matcher, rans
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    from lrzip_next_tpu_torch.ops import streampack as SP
    job = matcher.MatchJob(corpus64, STRIDE, torch.device("cuda"))
    kinds, lengths, _ = job.collect()
    ls, le, n_lit = DP.literal_spans(kinds, lengths)
    npos = job.dev.shape[0]
    mask = DP.literal_mask(npos, ls, le, job.dev.device)
    k, t_len, srate = rans.plan(n_lit)
    cap = k * t_len
    label = (f"n_lit={n_lit} in {len(ls)} spans, K={k} T={t_len} "
             f"srate={srate}")
    log(f"literal stream of the 64 MiB chunk: {label}")

    def same_pack(a, b):
        return max(max_err(a[1], b[1]), max_err(a[0], b[0]))

    # K3 bytes: the mask once, the chunk's bytes in the 32-byte sectors
    # that hold a literal, the zero-padded block and the count out;
    # operations: flag test, rank and slot per position, one move per
    # literal
    zero_launches()
    SP.pack_stream(job.dev, mask, cap)
    torch.cuda.synchronize()
    once = read_launches()
    require(once["k3"] == 1 and sum(once.values()) == 1,
            f"pack_stream launched {once}, not K3 once")
    k3_bound = byte_compaction_bound(mask, job.dev, cap, 3 * npos + n_lit)
    res = {"k3": timed_pair(
        "K3 pack_stream", "64 MiB chunk",
        lambda: SP.pack_stream(job.dev, mask, cap),
        lambda: SP.pack_stream_reference(job.dev, mask, cap),
        same_pack, k3_bound,
        lambda: torch.masked_select(job.dev, mask), "torch.masked_select")}
    res["k3"]["device_ms"] = one_pass_device(
        lambda: SP.pack_stream(job.dev, mask, cap), "K3 64 MiB chunk",
        kernel="pack_bytes_kernel")
    log(f"  K3: every value byte {k3_bound['bound_ms_all_payload']:.4f} ms; "
        f"bound / device {k3_bound['bound_ms'] / res['k3']['device_ms']:.4f}")
    lit = res["k3"]["out"][0]
    require(int(res["k3"]["out"][1]) == n_lit, "K3 count != n_lit")
    rows = max(t_len // srate, 1)
    spans = lit.view(k, t_len)[:, :rows].to(torch.int64)
    for ctx_bits in (6, 8):
        cells = 256 << ctx_bits
        prev = torch.cat([torch.zeros_like(spans[:, :1]), spans[:, :-1]], 1)
        idx = ((prev >> (8 - ctx_bits)) * 256 + spans).reshape(-1)
        # K4 bytes: the sampled positions in, the table out; operations a
        # sample: context shift, index, validity test, add
        hist = timed_pair(
            f"K4 joint_histogram ctx_bits {ctx_bits}", label,
            lambda: RK.joint_histogram(lit, n_lit, ctx_bits, srate, k),
            lambda: RK.joint_histogram_reference(lit, n_lit, ctx_bits,
                                                 srate, k), max_err,
            bound(rows * k + 4 * cells, 4 * rows * k),
            lambda: torch.bincount(idx, minlength=cells), "torch.bincount")
        hist["device_ms"] = kernel_device_ms(
            lambda: RK.joint_histogram(lit, n_lit, ctx_bits, srate, k),
            "hist_kernel", f"K4 ctx_bits {ctx_bits} {label}")
        freqs = rans.quantize_freqs(hist["out"])
        # K5 bytes: the block and the packed table in, the (T, K) int32
        # plane and the states out; operations a symbol: context, table
        # load, compare, shift, divide, remainder, multiply, two adds, the
        # emission word
        enc = timed_pair(
            f"K5 encode_scan ctx_bits {ctx_bits}", label,
            lambda: RK.encode_scan(lit, n_lit, freqs, ctx_bits, k),
            lambda: RK.encode_scan_reference(lit, n_lit, freqs, ctx_bits,
                                             k),
            lambda a, b: max(max_err(a[0], b[0]), max_err(a[1], b[1])),
            bound(cap + 4 * cells + 4 * cap + 4 * k, 12 * n_lit))
        enc["device_ms"] = kernel_device_ms(
            lambda: RK.encode_scan(lit, n_lit, freqs, ctx_bits, k),
            "encode_kernel", f"K5 ctx_bits {ctx_bits} {label}")
        states, plane = enc["out"]
        packed, n_words = SP.pack_plane(plane, cap)
        dec = check_k7(packed[:int(n_words)].contiguous(), states, freqs,
                       n_lit, ctx_bits, t_len, lit, label)
        if ctx_bits == 6:   # level 7, the main path's
            res["k4"], res["k5"], res["k7"] = hist, enc, dec
        else:
            res["k4"]["ms_ctx_bits_8"] = hist["ms"]
            res["k4"]["device_ms_ctx_bits_8"] = hist["device_ms"]
    plane = res["k5"]["out"][1]
    n_words = int(SP.pack_plane(plane, cap)[1])
    # K6 bytes: the int32 plane in, the cap-sized u16 stream (the flagged
    # words, then the zero tail, which reaches the rANS planes) and the
    # count out; operations: flag test, rank and slot per cell, one move
    # per word
    res["k6"] = timed_pair(
        "K6 pack_plane", label,
        lambda: SP.pack_plane(plane, cap),
        lambda: SP.pack_plane_reference(plane, cap), same_pack,
        bound(4 * cap + 2 * cap + 4, 3 * cap + n_words),
        lambda: torch.masked_select(plane, plane >= 1 << 16),
        "torch.masked_select")
    require(int(res["k6"]["out"][1]) == n_words, "K6 count differs")
    res["k6"]["device_ms"] = one_pass_device(
        lambda: SP.pack_plane(plane, cap), "K6 64 MiB chunk",
        kernel="pack_plane_kernel")
    words_only = bound(4 * cap + 2 * n_words + 4, 3 * cap + n_words)
    log(f"  K6 words: {n_words} of {cap} slots; bound / device "
        f"{res['k6']['bound_ms'] / res['k6']['device_ms']:.4f}; the bound "
        f"counted without the zero tail (the figure of the rows before) "
        f"{words_only['bound_ms']:.4f} ms ({words_only['bound_bytes']} "
        f"bytes)")
    for r in res.values():
        r.pop("out")
    return res


def phase_kernels(corpus64: np.ndarray, pasted64: np.ndarray) -> dict:
    # K1 at every stride: its halo and window logic depend on h
    for stride in (2, 4, 16, 32):
        check_k1(corpus64, "64 MiB", stride, timed=False)
    torch.cuda.empty_cache()
    res = {"k1": check_k1(corpus64, "64 MiB"),
           "k2": check_k2(corpus64, "64 MiB"),
           **check_literal_kernels(corpus64)}
    step_us = check_k7_small()
    log(f"  K7 dependent chain: {step_us:.4f} us a step at 64 lanes; the "
        f"64 MiB chunk's {res['k7']['t_len']} steps need at least "
        f"{step_us * res['k7']['t_len'] / 1e3:.4f} ms, and take "
        f"{res['k7']['ms']:.4f} ms at {res['k7']['lanes']} lanes on a "
        f"cluster of {res['k7']['cluster']} CTAs")
    check_k7_clusters()
    torch.cuda.empty_cache()
    # the layered passes exist only where the plan is layered: K8b's row
    # comes from the long-range chunk if its plan has them, else from the
    # pasted-pieces chunk
    pasted = check_replay_kernels(pasted64, "64 MiB pasted pieces")
    res.update(pasted)
    res.update(check_replay_kernels(corpus64, "64 MiB long-range"))
    require(all(k in res for k in ("k8a", "k8b", "k8c")),
            f"a replay kernel was not reached: {sorted(res)}")
    torch.cuda.empty_cache()
    res["k9"] = check_k9(corpus64, "64 MiB dense")
    torch.cuda.empty_cache()
    res["k10"] = check_k10(corpus64, "64 MiB stride 8")
    torch.cuda.empty_cache()
    check_k11(corpus64, "64 MiB window")
    res["k11"] = check_k11(corpus64[:8 * MIB], "8 MiB window")
    torch.cuda.empty_cache()
    big = long_range_corpus(256 * MIB)
    check_k1(big, "256 MiB")
    check_k2(big, "256 MiB")
    del big
    torch.cuda.empty_cache()
    return res


def zero_launches() -> None:
    from lrzip_next_tpu_torch.ops import anchor, compact, gearscan
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    from lrzip_next_tpu_torch.ops import streampack as SP
    from lrzip_next_tpu_torch.ops import replay_ragged as RR
    anchor.launches = compact.launches = gearscan.launches = 0
    compact.masked_launches = compact.starts_launches = 0
    RK.hist_launches = RK.encode_launches = RK.decode_launches = 0
    SP.stream_launches = SP.plane_launches = 0
    RR.ragged_launches = RR.layered_launches = RR.small_launches = 0


def read_launches() -> dict:
    from lrzip_next_tpu_torch.ops import anchor, compact, gearscan
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    from lrzip_next_tpu_torch.ops import streampack as SP
    from lrzip_next_tpu_torch.ops import replay_ragged as RR
    return {"k1": anchor.launches, "k2": compact.launches,
            "k3": SP.stream_launches, "k4": RK.hist_launches,
            "k5": RK.encode_launches, "k6": SP.plane_launches,
            "k7": RK.decode_launches, "k8a": RR.ragged_launches,
            "k8b": RR.layered_launches, "k8c": RR.small_launches,
            "k9": compact.masked_launches, "k10": compact.starts_launches,
            "k11": gearscan.launches}


# K2 is on no path: the chain stage compacts with K10
ENCODE_KERNELS = ("k1", "k10", "k3", "k4", "k5", "k6")
LITERAL_KERNELS = ("k3", "k4", "k5", "k6")
DECODE_KERNELS = ("k7", "k8a", "k8b", "k8c")
DENSE_KERNELS = ("k9",)


def compress_timed(raw: bytes, method: str, label: str, **settings_kw):
    """One ``compress`` on the card: (archive, per-chunk stats); the
    host-clock seconds stand in the first chunk's ``compress_s``."""
    import lrzip_next_tpu_torch as lrzt
    stats = []
    settings = lrzt.Settings(method=method, stats_sink=stats.append,
                             **settings_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    archive = lrzt.compress(raw, settings, device="cuda")
    secs = time.perf_counter() - t0
    stats[0]["compress_s"] = secs
    dev_ms = sum(sum(s.get("device_ms", {}).values()) for s in stats)
    log(f"slice {label} ({method}): {len(raw)} -> {len(archive)} bytes, "
        f"ratio {len(raw) / len(archive):.4f}, compress {secs:.3f} s, "
        f"matcher device stages {dev_ms:.3f} ms")
    for s in stats:
        stages = ", ".join(f"{k} {v:.3f}" for k, v in
                           s.get("device_ms", {}).items())
        log(f"  chunk {s['chunk']}: chains {s['chains']} matches "
            f"{s['matches']} match_bytes {s['match_bytes']} literal_bytes "
            f"{s['literal_bytes']} | device ms: {stages} | host "
            f"finalize/walk ms {s.get('host_ms', 0):.3f}, pinned fill ms "
            f"{s.get('fill_ms', 0):.3f}")
        lit_ms = s.get("literal_ms")
        if lit_ms:
            log("  literal encode device ms: " + ", ".join(
                f"{k} {v:.3f}" for k, v in lit_ms.items()) +
                f" (sum {sum(lit_ms.values()):.3f})")
    return archive, stats


def decompress_timed(archive: bytes, raw: bytes, label: str) -> float:
    """One ``decompress`` on the card, compared with the input; host-clock
    seconds."""
    import lrzip_next_tpu_torch as lrzt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lrzt.decompress(archive, device="cuda")
    secs = time.perf_counter() - t0
    require(out == raw, f"{label}: decompress differs from the input")
    log(f"slice {label}: decompress on the card {secs:.3f} s, equals the "
        f"input")
    return secs


def profile_decompress(archive: bytes) -> None:
    """Where one warm ``decompress`` spends its host time (cProfile, top
    entries by cumulative time) and its CUDA time."""
    import lrzip_next_tpu_torch as lrzt
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    lrzt.decompress(archive, device="cuda")
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(22)
    log("profile of one warm decompress (cProfile, by cumulative time):")
    for line in text.getvalue().splitlines():
        if line.strip() and ("{" in line or ".py" in line
                             or "function calls" in line):
            log("  " + line.rstrip()[:150])
    from lrzip_next_tpu_torch import runtime
    from lrzip_next_tpu_torch.backends import BackendConfig, decompress_block
    from lrzip_next_tpu_torch.format.container import ChunkReader, \
        read_chunk_header
    from lrzip_next_tpu_torch.format.magic import MagicHeader
    from lrzip_next_tpu_torch.models import device_path as DP
    # the one chunk's decode stages alone, each ended by a synchronise
    fd = io.BytesIO(archive)
    fd.seek(MagicHeader.decode(archive[:100]).header_len)
    hdr = read_chunk_header(fd)
    reader = ChunkReader(fd, hdr)
    stream0 = b"".join(
        decompress_block(reader.read_payload(r), r.c_type, r.u_len,
                         BackendConfig()) for r in reader.blocks(0))
    ref = list(reader.blocks(1))[0]
    payload = reader.read_payload(ref)
    dev = torch.device("cuda")

    def stage(fn, reps=5):
        """fn's last result and its median host-clock ms over reps runs,
        each synchronised before and after."""
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    tokens, parse_ms = stage(lambda: runtime.parse_token_stream(
        np.frombuffer(stream0, np.uint8), hdr.chunk_bytes)[:3])
    plane, k7_ms = stage(lambda: DP.DeviceLitPlane(payload, ref.u_len, dev))
    parts = replay_parts(tokens, plane.plane)
    chunk = DP.replay_tokens_device_array(*tokens, plane.plane)
    host, back_ms = stage(lambda: chunk.cpu().numpy().tobytes())
    _, check_ms = stage(plane.check)
    log(f"  the chunk's decode stages alone, host-clock ms, median of 5, "
        f"each synchronised: token parse {parse_ms:.3f}; literal block "
        f"({len(payload)} payload bytes -> {plane.n} literals) parse + "
        f"upload + K7 {k7_ms:.3f}; replay on the card {parts['whole']:.3f}; "
        f"read-back of {len(host)} bytes {back_ms:.3f}; final-state check "
        f"{check_ms:.3f}")
    log("  replay on the card, its parts (replay_parts), host-clock ms, "
        "median of 5: " + "; ".join(f"{k} {v:.3f}" for k, v in parts.items()))


# The functions that the replay on the card calls, each timed on its own by
# ``replay_parts``; a checkout that lacks one leaves it out.
REPLAY_PARTS = (
    ("runtime", "flatten_replay_layered", "layered flatten"),
    ("runtime", "flatten_replay", "flat flatten"),
    ("RR", "flat_tables", "piece tables (check, merge, upload, split)"),
    ("RR", "_pieces", "piece upload"),
    ("RR", "ragged_concat", "K8a"),
    ("RR", "small_merge", "K8c"),
    ("RR", "layered_pass", "K8b"),
)


def replay_parts(tokens, lit: torch.Tensor, reps: int = 5) -> dict:
    """The replay on the card split into its parts, host-clock ms, median
    of ``reps`` runs.  It runs the function that the decode runs,
    ``device_path.replay_tokens_device_array``, with each function of
    ``REPLAY_PARTS`` that it calls wrapped by a timer that synchronises
    before and after (a call made inside another timed call counts for
    the outer one).  "rest" is that run less its timed parts (the token
    columns and the steps between the calls), "whole" the same call
    without the timers, and "read-back" the chunk's copy to the host."""
    from lrzip_next_tpu_torch import runtime
    from lrzip_next_tpu_torch.models import device_path as DP
    from lrzip_next_tpu_torch.ops import replay_ragged as RR
    mods = {"runtime": runtime, "RR": RR}
    timed: dict = {}
    depth = [0]

    def timer(fn, label):
        def wrapper(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                timed[label] = timed.get(label, 0.0) + \
                    (time.perf_counter() - t0) * 1e3
                depth[0] -= 1
        return wrapper

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def replay():
        return DP.replay_tokens_device_array(*tokens, lit)

    present = [(mods[m], name, label) for m, name, label in REPLAY_PARTS
               if hasattr(mods[m], name)]
    runs = []
    replay()                               # warm
    for _ in range(reps):
        _, whole = synced_ms(replay)
        timed.clear()
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in present]
        for mod, name, label in present:
            setattr(mod, name, timer(getattr(mod, name), label))
        try:
            chunk, spied = synced_ms(replay)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        _, back = synced_ms(lambda: chunk.cpu().numpy())
        run = dict(timed)
        run["rest"] = spied - sum(timed.values())
        run["whole"] = whole
        run["read-back"] = back
        runs.append(run)
    keys = [label for _, _, label in present if label in runs[0]]
    return {k: statistics.median(r.get(k, 0.0) for r in runs)
            for k in keys + ["rest", "whole", "read-back"]}


def to_device_timed(archive: bytes, corpus: np.ndarray, label: str,
                    want: dict) -> float:
    """One ``decompress_to_device`` on the card: CUDA tensors equal to the
    input, the kernels of ``want`` launched (a count of 0: not launched);
    host-clock seconds up to a synchronised device tensor."""
    import lrzip_next_tpu_torch as lrzt
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = lrzt.decompress_to_device(archive, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = read_launches()
    require(all(c.is_cuda and c.dtype == torch.uint8 for c in chunks),
            f"{label}: decompress_to_device did not return CUDA uint8 "
            f"tensors")
    require(torch.equal(torch.cat(chunks), torch.from_numpy(corpus).cuda()),
            f"{label}: decompress_to_device differs from the input")
    require(all((got[k] > 0) == (n > 0) for k, n in want.items())
            and not any(got[k] for k in ENCODE_KERNELS + DENSE_KERNELS
                        + ("k2",)),
            f"{label}: decompress_to_device launched {got}, wanted {want}")
    log(f"slice {label}: decompress_to_device {secs:.3f} s up to a "
        f"synchronised device tensor, equals the input; launches "
        + ", ".join(f"{k} {got[k]}" for k in DECODE_KERNELS))
    return secs


def phase_dense(corpus64: np.ndarray, raw: bytes, stride8: dict) -> dict:
    """The dense matcher: the 64 MiB long-range corpus with
    ``anchor_stride=1`` and rans.  Returns the launch counts of the first
    compress."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    archive, stats = compress_timed(raw, "rans", "64 MiB long-range dense",
                                    anchor_stride=1)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    require(launches["k9"] == 1
            and all(launches[k] > 0 for k in LITERAL_KERNELS)
            and not any(launches[k] for k in ("k1", "k2", "k10")
                        + DECODE_KERNELS),
            f"the dense rans compress did not launch K9 and K3-K6 alone: "
            f"{launches}")
    secs = decompress_timed(archive, raw, "64 MiB long-range dense rans")
    again, warm = compress_timed(raw, "rans", "64 MiB long-range dense, "
                                 "warm", anchor_stride=1)
    require(again == archive, "the dense rans archive changed between runs")
    s1, s8 = warm[0], stride8
    log(f"dense against stride 8 on the 64 MiB long-range corpus (rans, "
        f"warm): ratio {len(raw) / len(archive):.4f} against "
        f"{s8['ratio']:.4f}; compress {s1['compress_s']:.3f} s against "
        f"{s8['compress_s']:.3f} s; matcher device stages "
        f"{sum(s1['device_ms'].values()):.3f} ms against "
        f"{sum(s8['device_ms'].values()):.3f} ms; host greedy cover "
        f"{s1['host_ms']:.3f} ms against host finalize "
        f"{s8['host_ms']:.3f} ms; runs {s1['chains']} (read back as "
        f"{12 * s1['chains']} bytes in {s1['device_ms']['readback']:.3f} "
        f"ms) against {s8['chains']} chains; match bytes "
        f"{s1['match_bytes']} against {s8['match_bytes']}; decompress "
        f"{secs:.3f} s; peak device memory of the dense compress "
        f"{peak} bytes")
    return launches


def phase_matcher_profile(corpus64: np.ndarray) -> None:
    """The stride-8 matcher's stages one by one on the 64 MiB chunk (host
    clock, each ended by a synchronise, median of 3 after a warm-up).
    ``compact_seeds`` and ``compact_seeds_dual`` must each launch K10
    twice and nothing else (that ``compact_seeds_dual`` runs no
    ``torch.cummin`` over the seed array is
    ``tests/test_torch_chains.py``'s)."""
    from lrzip_next_tpu_torch.ops import matcher as M
    from lrzip_next_tpu_torch.ops.anchor import anchor_fps
    dev = padded_on_card(corpus64)
    limit = len(corpus64) - 31
    ma = ((dev.shape[0] - 31) // STRIDE) * STRIDE
    gap = M.verify_gap(STRIDE)

    def timeit(name, fn):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"  {name:46s} {statistics.median(times):9.3f} ms")
        return statistics.median(times)

    log("matcher stage profile, 64 MiB long-range chunk, stride 8:")
    timeit("A K1 fingerprints + anchor mask",
           lambda: anchor_fps(dev, STRIDE, ma))
    timeit("A+B anchor candidates (row minimum, sort)",
           lambda: M.anchor_candidates_fporder(dev, STRIDE))
    pos, cand = M.anchor_candidates_fporder(dev, STRIDE)
    zero_launches()
    records = M.compact_seeds(pos, cand, limit, gap)
    torch.cuda.synchronize()
    got = read_launches()
    require(got["k10"] == 2 and sum(got.values()) == 2,
            f"compact_seeds did not launch K10 twice and nothing else: {got}")
    zero_launches()
    fine, coarse = M.compact_seeds_dual(pos, cand, limit, gap, M._CHAIN_GAP)
    torch.cuda.synchronize()
    dual = read_launches()
    require(dual["k10"] == 2 and sum(dual.values()) == 2,
            f"compact_seeds_dual did not launch K10 twice and nothing else "
            f"(K2 never): {dual}")
    require(all(torch.equal(a, b) for a, b in zip(records, fine)),
            "compact_seeds differs from the fine records of "
            "compact_seeds_dual")
    log(f"  compact_seeds: {records[0].shape[0]} chain records, equal to "
        f"the fine records of compact_seeds_dual; K10 launches "
        f"{got['k10']} and {dual['k10']}, K2 {dual['k2']}; "
        f"{coarse[0].shape[0]} coarse records against {pos.shape[0]} seeds")
    timeit("  chain masks only ((dist, pos) sort)",
           lambda: M.dist_sorted_seed_starts(pos, cand, limit, gap))
    fine_ms = timeit("C chain masks + compact_seeds (K10 twice)",
                     lambda: M.compact_seeds(pos, cand, limit, gap))
    dual_ms = timeit("C' chain masks + compact_seeds_dual (K10 twice)",
                     lambda: M.compact_seeds_dual(pos, cand, limit, gap,
                                                  M._CHAIN_GAP))
    log(f"  compact_seeds_dual {dual_ms:.3f} ms against compact_seeds "
        f"{fine_ms:.3f} ms: the coarse chains cost "
        f"{dual_ms - fine_ms:.3f} ms")

    def full():
        p, c = M.anchor_candidates_fporder(dev, STRIDE)
        return M.compact_seeds(p, c, limit, gap)

    ms = timeit("FULL step (A+B+C)", full)
    log(f"  => {len(corpus64) / 1e6 / (ms / 1e3):.1f} MB/s")


def phase_slice(corpus64: np.ndarray, pasted64: np.ndarray) -> dict:
    from lrzip_next_tpu_torch.ops import matcher
    raw = corpus64.tobytes()
    zero_launches()
    archive, stats = compress_timed(raw, "rans", "64 MiB long-range")
    launches = read_launches()
    require(all(launches[k] > 0 for k in ENCODE_KERNELS)
            and launches["k10"] == 2 * len(stats) and launches["k2"] == 0
            and not any(launches[k] for k in DECODE_KERNELS + DENSE_KERNELS),
            f"the rans compress did not launch K1, K10 (twice a chunk) and "
            f"K3-K6 alone: {launches}")
    require(all(s.get("literal_ms") for s in stats),
            "the rans path did not take the device literal encode")
    pasted_raw = pasted64.tobytes()
    pasted_archive, _ = compress_timed(pasted_raw, "rans",
                                       "64 MiB pasted pieces")
    # the decode path, driven once: both archives through decompress
    zero_launches()
    cold = decompress_timed(archive, raw, "64 MiB long-range rans, cold")
    decode = read_launches()
    log(f"launches of the long-range decompress: {decode}")
    decompress_timed(pasted_archive, pasted_raw, "64 MiB pasted pieces rans")
    decode = read_launches()
    log(f"launches of both decompresses: {decode}")
    require(decode["k7"] == 2 and decode["k8a"] >= 2
            and decode["k8b"] >= 1 and decode["k8c"] >= 1
            and not any(decode[k] for k in ENCODE_KERNELS + DENSE_KERNELS),
            f"the rans decompresses did not launch K7 and K8a-c alone: "
            f"{decode}")
    for k in DECODE_KERNELS:
        launches[k] = decode[k]
    to_dev = [to_device_timed(pasted_archive, pasted64,
                              "64 MiB pasted pieces rans",
                              {"k7": 1, "k8a": 1, "k8b": 1, "k8c": 1})]
    del pasted_archive, pasted_raw
    warm = []
    for _ in range(2):
        again, stats = compress_timed(raw, "rans", "64 MiB long-range, warm")
        require(again == archive, "the rans archive changed between runs")
        warm.append(decompress_timed(archive, raw,
                                     "64 MiB long-range rans, warm"))
    stride8 = dict(stats[0], ratio=len(raw) / len(archive))
    log(f"decompress of the 64 MiB rans archive on the card: cold "
        f"{cold:.3f} s, warm {warm[0]:.3f} and {warm[1]:.3f} s")
    for _ in range(2):
        to_dev.append(to_device_timed(archive, corpus64,
                                      "64 MiB long-range rans",
                                      {"k7": 1, "k8a": 1, "k8c": 1}))
    log(f"64 MiB long-range rans archive, up to a synchronised device "
        f"tensor: decompress_to_device {to_dev[1]:.3f} and {to_dev[2]:.3f} "
        f"s against decompress (host bytes) {warm[0]:.3f} and "
        f"{warm[1]:.3f} s; pasted pieces {to_dev[0]:.3f} s")
    profile_decompress(archive)
    del archive

    zero_launches()
    lzma_archive, lzma_stats = compress_timed(raw, "lzma",
                                              "64 MiB long-range")
    lzma = read_launches()
    require(lzma["k1"] > 0 and lzma["k10"] == 2 * len(lzma_stats)
            and lzma["k2"] == 0,
            f"the lzma path did not launch K1 and K10 alone: {lzma}")
    zero_launches()
    decompress_timed(lzma_archive, raw, "64 MiB long-range lzma")
    require(sum(read_launches().values()) == 0,
            f"the lzma decompress launched a kernel: {read_launches()}")
    to_device_timed(lzma_archive, corpus64, "64 MiB long-range lzma",
                    {"k7": 0, "k8a": 1, "k8c": 1})
    del lzma_archive
    launches["k9"] = phase_dense(corpus64, raw, stride8)["k9"]
    phase_matcher_profile(corpus64)
    # the same chunk's matcher again, warm (allocator and modules loaded)
    runs = []
    for _ in range(3):
        job = matcher.MatchJob(corpus64, STRIDE, torch.device("cuda"))
        job.collect()
        runs.append(job.stats)
    med = {k: statistics.median(r["device_ms"][k] for r in runs)
           for k in runs[0]["device_ms"]}
    log("matcher 64 MiB warm, median of 3: device ms " + ", ".join(
        f"{k} {v:.3f}" for k, v in med.items()) +
        f" (sum {sum(med.values()):.3f}) | host finalize ms "
        f"{statistics.median(r['host_ms'] for r in runs):.3f}, pinned fill "
        f"ms {statistics.median(r['fill_ms'] for r in runs):.3f}")
    walks = matcher.walk_fallbacks
    soup = word_soup_with_holes(16 * MIB).tobytes()
    soup_archive, _ = compress_timed(soup, "gzip", "16 MiB word soup")
    require(matcher.walk_fallbacks > walks,
            "the word-soup text did not take the walk fallback")
    decompress_timed(soup_archive, soup, "16 MiB word soup gzip")
    return launches


def cli_run(argv: list) -> float:
    """One run of the port's command line (its default route: the card);
    host-clock seconds.  Fails unless it exits 0."""
    from lrzip_next_tpu_torch import cli
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    secs = time.perf_counter() - t0
    require(rc == 0, f"lrzip-next-torch {' '.join(argv)} exited {rc}")
    return secs


def per_64mib(raw: bytes, label: str, reps: int = 3, **settings_kw) -> float:
    """Median warm seconds of ``compress`` per 64 MiB of input."""
    import lrzip_next_tpu_torch as lrzt
    settings = lrzt.Settings(method="rans", **settings_kw)
    lrzt.compress(raw, settings, device="cuda")         # warm
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lrzt.compress(raw, settings, device="cuda")
        runs.append((time.perf_counter() - t0) * (64 * MIB) / len(raw))
    log(f"multichunk {label}: seconds per 64 MiB "
        f"{', '.join(f'{r:.4f}' for r in runs)} (median "
        f"{statistics.median(runs):.4f})")
    return statistics.median(runs)


def standalone_tokens(chunk: np.ndarray):
    """The matcher's tokens of one chunk outside the jobs' machinery: the
    chunk uploaded by a plain copy and passed as ``dev=``, its device
    graph run on the calling thread and the default stream (no worker
    thread, no side stream, no pinned upload)."""
    from concurrent.futures import Future
    from lrzip_next_tpu_torch.ops import matcher

    class Inline:
        @staticmethod
        def submit(fn):
            done = Future()
            done.set_result(fn())
            return done

    pool, stream = matcher._worker_pool, matcher._job_stream
    matcher._worker_pool = lambda _dev: Inline
    matcher._job_stream = torch.cuda.default_stream
    try:
        return matcher.MatchJob(chunk, STRIDE, torch.device("cuda"),
                                dev=padded_on_card(chunk)).collect()
    finally:
        matcher._worker_pool, matcher._job_stream = pool, stream


def phase_multichunk(big: np.ndarray, soup: bytes) -> int:
    """The multi-chunk compress path the command line runs: a 256 MiB
    file in three chunks through ``cli.main`` (rans, ``-m 1``: 100, 100
    and 56 MiB), its decompress, the lookahead's tokens against
    standalone jobs, the overlap (reported, not gated), ``-U`` over four
    32 MiB windows, and the host matcher (``--no-tpu``).  Returns K11's
    launches in the ``-U`` step."""
    import lrzip_next_tpu_torch as lrzt
    from lrzip_next_tpu_torch.models import pipeline as P
    from lrzip_next_tpu_torch.ops import matcher
    os.environ["LRZIP"] = "NOCONFIG"        # no lrzip.conf of the machine
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    src, arc, back = (work / "big.bin", work / "big.bin.lrz",
                      work / "big.back")
    src.write_bytes(big.tobytes())

    # the lookahead's tokens, chunk by chunk, through a spy on collect
    seen = []

    class Spy(matcher.MatchJob):
        def collect(self):
            tokens = super().collect()
            seen.append((self.n, [t.copy() for t in tokens]))
            return tokens

    cli_argv = ["--rans", "-m", "1", "-f", "-o", str(arc), str(src)]
    P.MatchJob = Spy
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    try:
        secs = cli_run(cli_argv)
    finally:
        P.MatchJob = matcher.MatchJob
    enc = read_launches()
    peak = torch.cuda.max_memory_allocated()
    archive = arc.read_bytes()
    log(f"multichunk CLI --rans -m 1, 256 MiB: {len(archive)} bytes, ratio "
        f"{len(big) / len(archive):.4f}, {secs:.3f} s cold, chunks "
        f"{[n for n, _ in seen]}, launches {enc}, peak device memory "
        f"{peak} bytes (three jobs queued)")
    require([n for n, _ in seen] == [100 * MIB, 100 * MIB, 56 * MIB],
            f"the CLI did not compress 100, 100 and 56 MiB chunks: "
            f"{[n for n, _ in seen]}")
    require(enc["k1"] == 3 and enc["k10"] == 6
            and all(enc[k] == 3 for k in LITERAL_KERNELS)
            and enc["k2"] == 0
            and not any(enc[k] for k in DECODE_KERNELS + DENSE_KERNELS),
            f"the three-chunk rans compress launched {enc}, not K1 three "
            f"times, K10 six and K3-K6 three each")
    p0 = 0
    for ci, (n, tokens) in enumerate(seen):
        alone = standalone_tokens(big[p0:p0 + n])
        require(all(np.array_equal(a, b) for a, b in zip(tokens, alone)),
                f"chunk {ci}: the lookahead's tokens differ from a "
                f"standalone MatchJob's")
        p0 += n
    log("multichunk: each chunk's tokens equal those of a MatchJob run "
        "on the calling thread and the default stream")
    del seen

    from lrzip_next_tpu_torch.models import device_path as DP
    doubling = DP.doubling_replays
    zero_launches()
    secs = cli_run(["-d", "-f", "-o", str(back), str(arc)])
    dec = read_launches()
    doubling = DP.doubling_replays - doubling
    require(back.read_bytes() == big.tobytes(),
            "the CLI's decompress differs from the file")
    require(dec["k7"] == 3 and dec["k8a"] == 3 and dec["k8c"] == 3
            and not any(dec[k] for k in ENCODE_KERNELS + DENSE_KERNELS),
            f"the three-chunk decompress launched {dec}, not K7, K8a and "
            f"K8c three times each")
    require(doubling == 0,
            f"{doubling} chunks of the decompress replayed by pointer "
            f"doubling, not by a piece plan")
    log(f"multichunk CLI -d: {secs:.3f} s, equals the file, launches {dec}, "
        f"no pointer-doubling replay")
    secs = cli_run(cli_argv)
    require(arc.read_bytes() == archive,
            "the same three-chunk compress gave another archive")
    log(f"multichunk CLI --rans -m 1 again: the same archive, {secs:.3f} s")
    del archive
    for p in (src, arc, back):
        p.unlink()

    raw = big.tobytes()
    one = per_64mib(raw[:64 * MIB], "one 64 MiB chunk, compress")
    four = per_64mib(raw, "256 MiB in four 64 MiB chunks, compress",
                     max_chunk=64 * MIB)
    log(f"multichunk overlap: {four:.4f} s per 64 MiB in four chunks "
        f"against {one:.4f} s for one chunk ({100 * (1 - four / one):.1f}% "
        f"less; reported, not gated)")

    # -U over 256 MiB took 64.7 s on an H100 (the host cross-window
    # index): 128 MiB in four 32 MiB windows keeps the step near 30 s
    del raw
    raw = big[:128 * MIB].tobytes()
    zero_launches()
    u_stats = []
    settings = lrzt.Settings(method="gzip", unlimited=True,
                             max_chunk=32 * MIB, stats_sink=u_stats.append)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_arc = lrzt.compress(raw, settings, device="cuda")
    u_secs = time.perf_counter() - t0
    u = read_launches()
    require(u["k1"] == 4 and u["k10"] == 8 and u["k11"] == 4
            and not any(u[k] for k in LITERAL_KERNELS + DECODE_KERNELS
                        + DENSE_KERNELS),
            f"-U over four windows launched {u}, not K1 four times, K10 "
            f"eight and K11 four")
    require([s.get("cross_scan_card") for s in u_stats] == [1] * 4,
            f"-U did not scan every window on the card: "
            f"{[s.get('cross_scan_card') for s in u_stats]}")
    t0 = time.perf_counter()
    require(lrzt.decompress(u_arc, device="cuda") == raw,
            "the -U archive does not decode to the input")
    log(f"multichunk -U gzip, 128 MiB in four 32 MiB windows: "
        f"{len(u_arc)} bytes, ratio {len(raw) / len(u_arc):.4f}, compress "
        f"{u_secs:.3f} s, decompress {time.perf_counter() - t0:.3f} s, "
        f"launches {u}; cross_find + cross_index ms a window " +
        ", ".join(f"{s['main_ms'].get('compress.cross_find', 0.0):.1f} + "
                  f"{s['main_ms'].get('compress.cross_index', 0.0):.1f}"
                  for s in u_stats))
    del u_arc, raw

    s_src, s_arc, s_back = (work / "soup.bin", work / "soup.bin.lrz",
                            work / "soup.back")
    s_src.write_bytes(soup)
    zero_launches()
    c_secs = cli_run(["--no-tpu", "-g", "-f", "-o", str(s_arc), str(s_src)])
    d_secs = cli_run(["--no-tpu", "-d", "-f", "-o", str(s_back),
                      str(s_arc)])
    host = read_launches()
    require(sum(host.values()) == 0,
            f"the host matcher (--no-tpu) launched a kernel: {host}")
    require(s_back.read_bytes() == soup,
            "the --no-tpu round trip differs from the input")
    log(f"multichunk CLI --no-tpu -g, 16 MiB word soup: "
        f"{s_arc.stat().st_size} bytes, compress {c_secs:.3f} s, "
        f"decompress {d_secs:.3f} s, no kernel launched")
    for p in (s_src, s_arc, s_back):
        p.unlink()
    return u["k11"]


_DIST_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[2])
import numpy as np
import torch.distributed as dist
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu_torch.parallel import distributed
rank = int(sys.argv[1])
assert distributed.init_distributed(sys.argv[3], 2, rank) == 2
data = np.fromfile(sys.argv[4], dtype=np.uint8)
s = lrzt.Settings(method="gzip", max_chunk=64 << 20)
if rank == 0:
    with open(sys.argv[5], "wb") as fh:
        assert distributed.compress_distributed(
            data, fh, s, n_hosts=2, host=0, device="cuda:0") > 0
else:
    assert distributed.compress_distributed(
        data, None, s, n_hosts=2, host=1, device="cuda:0") is None
dist.destroy_process_group()
print("rank", rank, "done")
"""


def mesh_compress(raw: bytes, mesh, **settings_kw) -> tuple:
    """``compress`` on the card with ``use_mesh=True`` and ``mesh`` pinned
    as the compress path's mesh (None: the card's own choice); returns
    (archive, host-clock seconds, mesh batches made)."""
    import lrzip_next_tpu_torch as lrzt
    from lrzip_next_tpu_torch.parallel import mesh as M
    settings = lrzt.Settings(use_mesh=True, **settings_kw)
    orig, before = M.pipeline_mesh, M.batches
    if mesh is not None:
        M.pipeline_mesh = lambda *_: mesh
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        archive = lrzt.compress(raw, settings, device="cuda")
        secs = time.perf_counter() - t0
    finally:
        M.pipeline_mesh = orig
    return archive, secs, M.batches - before


def phase_mesh(big: np.ndarray) -> None:
    """The multi-device path on this card: (a) ``use_mesh=True`` with one
    card writes the ``use_mesh=False`` archive and makes no mesh batch;
    (b) the 256 MiB long-range corpus in four 64 MiB rans chunks through
    a mesh of two dp rows on cuda:0 (two batches; K1 4, K10 8, K3-K6 4
    each), the single-device archive byte for byte, decoded on the card,
    its seconds per 64 MiB beside the lookahead's (median of 3, in turns)
    and its peak device memory; (c) the same, dense, on two 64 MiB chunks
    (K9 2); (d) ``dryrun_multichip`` on 2 and 4 mesh entries of cuda:0;
    (e) two processes joined by ``init_distributed`` over 127.0.0.1, a
    64 MiB chunk each, whose archive equals one process's."""
    import lrzip_next_tpu_torch as lrzt
    from lrzip_next_tpu_torch.parallel import distributed, dryrun
    from lrzip_next_tpu_torch.parallel import mesh as M
    raw = big.tobytes()
    kw = {"method": "rans", "max_chunk": 64 * MIB}

    # (a) the repaired fault: use_mesh=True and the card's own choice
    single = lrzt.compress(raw, lrzt.Settings(use_mesh=False, **kw),
                           device="cuda")
    auto, _, n_auto = mesh_compress(raw, None, **kw)
    require(auto == single, "use_mesh=True differs from use_mesh=False")
    cards = torch.cuda.device_count()
    require(n_auto == 0 if cards < 2 else n_auto > 0,
            f"use_mesh=True on {cards} card(s) made {n_auto} mesh batches")
    log(f"mesh (a): use_mesh=True on {cards} card(s) writes the "
        f"use_mesh=False archive ({len(single)} bytes), {n_auto} mesh "
        f"batches")

    # (b) two dp rows on one card, four 64 MiB chunks
    mesh = M.make_mesh(devices=["cuda:0"] * 2)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    archive, cold, n_b = mesh_compress(raw, mesh, **kw)
    enc = read_launches()
    peak = torch.cuda.max_memory_allocated()
    require(archive == single,
            "the mesh archive differs from the single-device one")
    require(n_b == 2, f"four chunks on two dp rows made {n_b} batches")
    require(enc["k1"] == 4 and enc["k10"] == 8
            and all(enc[k] == 4 for k in LITERAL_KERNELS) and enc["k2"] == 0
            and not any(enc[k] for k in DECODE_KERNELS + DENSE_KERNELS),
            f"the mesh compress launched {enc}, not K1 4, K10 8, K3-K6 4")
    t0 = time.perf_counter()
    require(lrzt.decompress(archive, device="cuda") == raw,
            "the mesh archive does not decode to the input")
    d_secs = time.perf_counter() - t0
    log(f"mesh (b): 256 MiB rans in four 64 MiB chunks on {mesh} of "
        f"cuda:0: {len(archive)} bytes, equal to the single-device "
        f"archive, {cold:.3f} s cold, batches {n_b}, launches {enc}, peak "
        f"device memory {peak} bytes, decoded on the card in "
        f"{d_secs:.3f} s")
    runs = {"mesh": [], "single": []}
    for order in (("mesh", "single"), ("single", "mesh"),
                  ("mesh", "single")):
        for which in order:
            if which == "mesh":
                secs = mesh_compress(raw, mesh, **kw)[1]
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lrzt.compress(raw, lrzt.Settings(use_mesh=False, **kw),
                              device="cuda")
                secs = time.perf_counter() - t0
            runs[which].append(secs * 64 * MIB / len(raw))
    med = {k: statistics.median(v) for k, v in runs.items()}
    log(f"mesh (b): seconds per 64 MiB, mesh of two rows "
        f"{', '.join(f'{r:.4f}' for r in runs['mesh'])} (median "
        f"{med['mesh']:.4f}); single-device lookahead "
        f"{', '.join(f'{r:.4f}' for r in runs['single'])} (median "
        f"{med['single']:.4f}); reported, not gated")
    del archive, auto, single

    # (c) dense, two 64 MiB chunks
    half = raw[:128 * MIB]
    dense = {"method": "rans", "max_chunk": 64 * MIB, "anchor_stride": 1}
    single = lrzt.compress(half, lrzt.Settings(use_mesh=False, **dense),
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    archive, secs, n_b = mesh_compress(half, mesh, **dense)
    enc = read_launches()
    peak = torch.cuda.max_memory_allocated()
    require(archive == single,
            "the dense mesh archive differs from the single-device one")
    require(n_b == 1, f"two dense chunks on two dp rows made {n_b} batches")
    require(enc["k9"] == 2 and all(enc[k] == 2 for k in LITERAL_KERNELS)
            and not any(enc[k] for k in ("k1", "k2", "k10")
                        + DECODE_KERNELS),
            f"the dense mesh compress launched {enc}, not K9 2, K3-K6 2")
    require(lrzt.decompress(archive, device="cuda") == half,
            "the dense mesh archive does not decode to the input")
    log(f"mesh (c): 128 MiB dense rans in two 64 MiB chunks on {mesh}: "
        f"{len(archive)} bytes, equal to the single-device archive, "
        f"{secs:.3f} s, batches {n_b}, launches {enc}, peak device memory "
        f"{peak} bytes, decodes")
    del archive, single

    # (d) the dry run
    for n in (2, 4):
        t0 = time.perf_counter()
        dryrun.dryrun_multichip(n, device="cuda")
        log(f"mesh (d): dryrun_multichip({n}, device='cuda') passed in "
            f"{time.perf_counter() - t0:.3f} s")

    # (e) two processes, a 64 MiB chunk each
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    src, out = work / "dist.bin", work / "dist.lrz"
    big[:128 * MIB].tofile(src)
    s = lrzt.Settings(method="gzip", max_chunk=64 * MIB)
    one = io.BytesIO()
    t0 = time.perf_counter()
    distributed.compress_distributed(np.frombuffer(half, np.uint8), one, s,
                                     device="cuda")
    one_secs = time.perf_counter() - t0
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_WORKER, str(rank), str(ROOT), coord,
         str(src), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    except subprocess.TimeoutExpired:
        raise SystemExit("chip_smoke: FAILED: a distributed worker timed "
                         "out after 240 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        require(p.returncode == 0,
                f"distributed rank {rank} exited {p.returncode}: "
                f"{text[-2000:]}")
    two_secs = time.perf_counter() - t0
    archive = out.read_bytes()
    require(archive == one.getvalue(),
            "the two-process archive differs from the one-process one")
    require(lrzt.decompress(archive, device="cuda") == half,
            "the two-process archive does not decode to the input")
    log(f"mesh (e): two processes over init_distributed ({coord}, gloo), "
        f"128 MiB gzip in two 64 MiB chunks: {len(archive)} bytes, equal "
        f"to one process's ({one_secs:.3f} s) and decoded; "
        f"{two_secs:.3f} s with both processes' start-up")
    for p in (src, out):
        p.unlink()


def sp_slab_k1(chunk: np.ndarray) -> None:
    """K1 on the slabs of a 64 MiB chunk's anchor rows, as an sp row of 2
    and of 4 cuts them (``matcher.sp_slabs``: whole rows, a halo of one
    row a side, each slab's view a copy of its own): the slabs' outputs,
    cropped to their rows and concatenated, equal one whole-chunk K1 and
    the plain version, bit for bit; each slab's K1 time beside the
    whole's."""
    from lrzip_next_tpu_torch.ops.anchor import anchor_fps, \
        anchor_fps_reference
    from lrzip_next_tpu_torch.ops.matcher import HASH_W, sp_slabs
    padded = padded_on_card(chunk)
    k = (padded.shape[0] - HASH_W + 1) // STRIDE
    whole = anchor_fps(padded, STRIDE, k * STRIDE)
    plain = anchor_fps_reference(padded, STRIDE, k * STRIDE)
    require(all(torch.equal(a, b) for a, b in zip(whole, plain)),
            "whole-chunk K1 differs from its plain version")
    whole_ms = cuda_ms(lambda: anchor_fps(padded, STRIDE, k * STRIDE))
    for s in (2, 4):
        slabs = sp_slabs(k, s, STRIDE, 1)
        views = [padded[lo:hi + HASH_W - 1].clone() for _, _, lo, hi in slabs]
        outs = [anchor_fps(v, STRIDE, hi - lo)
                for v, (_, _, lo, hi) in zip(views, slabs)]
        for i in (0, 1):
            cat = torch.cat([o[i][u0 * STRIDE - lo:u1 * STRIDE - lo]
                             for o, (u0, u1, lo, _) in zip(outs, slabs)])
            require(torch.equal(cat, whole[i]) and torch.equal(cat, plain[i]),
                    f"the {s} slabs' K1 output differs from one whole-chunk "
                    f"K1 or its plain version")
        ms = [cuda_ms(lambda v=v, w=hi - lo: anchor_fps(v, STRIDE, w))
              for v, (_, _, lo, hi) in zip(views, slabs)]
        log(f"mesh (f): K1 on {s} slabs of the 64 MiB chunk's {k} rows "
            f"(rows {[u1 - u0 for u0, u1, _, _ in slabs]}, a halo row a "
            f"side): bit-equal to one whole-chunk K1 and the plain version; "
            f"slab ms {', '.join(f'{t:.4f}' for t in ms)} against "
            f"{whole_ms:.4f} whole")
        del views, outs
    del padded, whole, plain
    torch.cuda.empty_cache()


def phase_mesh_sp(big: np.ndarray) -> None:
    """The sp axis on this card: (f) K1 on slabs (``sp_slab_k1``); the 256
    MiB corpus in four 64 MiB rans chunks through a mesh of one dp row of
    two sp entries (1 x 2) and of two rows of two (2 x 2), all cuda:0:
    the single-device archive byte for byte, K1 once a slab (8), K10
    twice a chunk (8), K3-K6 once a chunk (4), each chunk's tokens equal
    to a one-device ``MatchJob``'s, the per-slab device ms, the gather's
    ms, the peak device memory; the seconds per 64 MiB of the 2 x 2 mesh
    beside the dp-only mesh of two rows (median of 3, in turns); two
    dense 64 MiB chunks on the 2 x 2 mesh (K9 once a chunk, the
    single-device archive)."""
    import lrzip_next_tpu_torch as lrzt
    from lrzip_next_tpu_torch.parallel import mesh as M
    sp_slab_k1(big[:64 * MIB])
    raw = big.tobytes()
    kw = {"method": "rans", "max_chunk": 64 * MIB}
    single = lrzt.compress(raw, lrzt.Settings(use_mesh=False, **kw),
                           device="cuda")
    alone = [standalone_tokens(big[i * 64 * MIB:(i + 1) * 64 * MIB])
             for i in range(4)]
    seen = []

    class Spy(M.MeshMatchBatch):
        def collect(self, i):
            tokens = super().collect(i)
            seen.append(([t.copy() for t in tokens], self.jobs[i].stats))
            return tokens

    meshes = {"1 x 2": M.make_mesh(devices=["cuda:0"] * 2, dp=1),
              "2 x 2": M.make_mesh(devices=["cuda:0"] * 4)}
    orig, M.MeshMatchBatch = M.MeshMatchBatch, Spy
    try:
        for shape, mesh in meshes.items():
            dp, sp = mesh.devices.shape
            seen.clear()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            archive, cold, n_b = mesh_compress(raw, mesh, **kw)
            enc = read_launches()
            peak = torch.cuda.max_memory_allocated()
            require(archive == single, f"the {shape} sp mesh archive differs "
                    f"from the single-device one")
            require(n_b == 4 // dp, f"four chunks on {shape} made {n_b} "
                    f"batches")
            require(enc["k1"] == 4 * sp and enc["k10"] == 8
                    and all(enc[k] == 4 for k in LITERAL_KERNELS)
                    and enc["k2"] == 0
                    and not any(enc[k] for k in DECODE_KERNELS
                                + DENSE_KERNELS),
                    f"the {shape} sp mesh compress launched {enc}, not K1 "
                    f"{4 * sp} (once a slab), K10 8, K3-K6 4")
            require(len(seen) == 4 and all(
                all(np.array_equal(a, b) for a, b in zip(tok, ref))
                for (tok, _), ref in zip(seen, alone)),
                f"a chunk's tokens on the {shape} sp mesh differ from a "
                f"one-device MatchJob's")
            log(f"mesh (f): 256 MiB rans in four 64 MiB chunks on {mesh} of "
                f"cuda:0: equal to the single-device archive, {cold:.3f} s "
                f"cold, batches {n_b}, launches {enc}, peak device memory "
                f"{peak} bytes; each chunk's tokens equal a one-device "
                f"MatchJob's")
            for ci, (_, st) in enumerate(seen):
                dms = st["device_ms"]
                log(f"  chunk {ci}: first device ms: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in dms.items())
                    + " | slabs 1..: " + "; ".join(
                        ", ".join(f"{k} {v:.3f}" for k, v in d.items())
                        for d in st["sp_device_ms"])
                    + f" | peer access {st['sp_peer']}, fill ms "
                    f"{st['fill_ms']:.3f}")
        del archive, single, alone
        seen.clear()
        half = raw[:128 * MIB]
        dense = {"method": "rans", "max_chunk": 64 * MIB, "anchor_stride": 1}
        single = lrzt.compress(half, lrzt.Settings(use_mesh=False, **dense),
                               device="cuda")
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        archive, secs, n_b = mesh_compress(half, meshes["2 x 2"], **dense)
        enc = read_launches()
        peak = torch.cuda.max_memory_allocated()
        require(archive == single,
                "the dense sp mesh archive differs from the single-device one")
        require(enc["k9"] == 2 and all(enc[k] == 2 for k in LITERAL_KERNELS)
                and not any(enc[k] for k in ("k1", "k2", "k10")
                            + DECODE_KERNELS),
                f"the dense sp mesh compress launched {enc}, not K9 2, K3-K6 2")
        log(f"mesh (f): 128 MiB dense rans in two 64 MiB chunks on "
            f"{meshes['2 x 2']}: equal to the single-device archive, "
            f"{secs:.3f} s, batches {n_b}, launches {enc}, peak device "
            f"memory {peak} bytes")
        for ci, (_, st) in enumerate(seen):
            log(f"  chunk {ci}: first device ms: " + ", ".join(
                f"{k} {v:.3f}" for k, v in st["device_ms"].items())
                + " | slab 1: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in st["sp_device_ms"][0].items()))
    finally:
        M.MeshMatchBatch = orig

    dp_only = M.make_mesh(devices=["cuda:0"] * 2)
    runs = {"sp": [], "dp": []}
    for order in (("sp", "dp"), ("dp", "sp"), ("sp", "dp")):
        for which in order:
            mesh = meshes["2 x 2"] if which == "sp" else dp_only
            secs = mesh_compress(raw, mesh, **kw)[1]
            runs[which].append(secs * 64 * MIB / len(raw))
    med = {k: statistics.median(v) for k, v in runs.items()}
    log(f"mesh (f): seconds per 64 MiB, 2 x 2 sp mesh "
        f"{', '.join(f'{r:.4f}' for r in runs['sp'])} (median "
        f"{med['sp']:.4f}); dp-only mesh of two rows "
        f"{', '.join(f'{r:.4f}' for r in runs['dp'])} (median "
        f"{med['dp']:.4f}); reported, not gated")


def phase_card_equals_cpu() -> bytes:
    """Returns the 4 MiB skewed rans archive for the corruption phase."""
    import lrzip_next_tpu_torch as lrzt
    raw = mixed_corpus(8 * MIB).tobytes()
    s = lrzt.Settings(method="gzip")
    on_card = lrzt.compress(raw, s, device="cuda")
    on_cpu = lrzt.compress(raw, s, device="cpu")
    require(on_card == on_cpu, "8 MiB archive differs between cuda and cpu")
    require(lrzt.decompress(on_card, device="cuda") == raw,
            "8 MiB round trip differs")
    log(f"card equals cpu: 8 MiB mixed -> {len(on_card)} bytes, identical")

    raw = skewed_symbols(4 * MIB).tobytes()
    stats = []
    on_card = lrzt.compress(raw, lrzt.Settings(method="rans",
                                               stats_sink=stats.append),
                            device="cuda")
    lit = [(s.get("literal_coder"), s.get("literal_lanes", 0),
            s["literal_bytes"]) for s in stats]
    require(len(lit) == 1 and lit[0][0] == "rans" and lit[0][1] >= 2048,
            f"4 MiB skewed input: literal blocks (coder, lanes, bytes) "
            f"{lit}, not one rANS block of >= 2048 lanes")
    on_cpu = lrzt.compress(raw, lrzt.Settings(method="rans"), device="cpu")
    require(on_card == on_cpu, "4 MiB rans archive differs between cuda "
            "and cpu")
    zero_launches()
    require(lrzt.decompress(on_cpu, device="cuda") == raw,
            "the card does not decode the CPU's 4 MiB rans archive")
    require(read_launches()["k7"] == 1, "the card's decode launched no K7")
    zero_launches()
    require(lrzt.decompress(on_card, device="cpu") == raw,
            "the CPU does not decode the card's 4 MiB rans archive")
    require(read_launches()["k7"] == 0, "the CPU decode launched K7")
    log(f"card equals cpu: 4 MiB skewed (rans, {lit[0][2]} literals in "
        f"{lit[0][1]} lanes) -> {len(on_card)} bytes, identical; each "
        f"device decodes the other's archive")

    pasted = pasted_corpus(4 * MIB).tobytes()
    p_card = lrzt.compress(pasted, lrzt.Settings(method="rans"),
                           device="cuda")
    p_cpu = lrzt.compress(pasted, lrzt.Settings(method="rans"), device="cpu")
    require(p_card == p_cpu, "4 MiB pasted-pieces rans archive differs "
            "between cuda and cpu")
    zero_launches()
    require(lrzt.decompress(p_cpu, device="cuda") == pasted,
            "the card does not decode the CPU's pasted-pieces archive")
    on = read_launches()
    require(all(on[k] >= 1 for k in DECODE_KERNELS),
            f"the card's layered decode did not launch K7 and K8a-c: {on}")
    zero_launches()
    require(lrzt.decompress(p_card, device="cpu") == pasted,
            "the CPU does not decode the card's pasted-pieces archive")
    require(sum(read_launches().values()) == 0,
            "the CPU decode launched a kernel")
    log(f"card equals cpu: 4 MiB pasted pieces (rans, layered replay) -> "
        f"{len(p_card)} bytes, identical; each device decodes the other's "
        f"archive; launches on the card {on}")

    dense = lrzt.Settings(method="rans", anchor_stride=1)
    zero_launches()
    d_card = lrzt.compress(pasted, dense, device="cuda")
    on = read_launches()
    require(on["k9"] == 1 and on["k1"] == 0 and on["k2"] == 0
            and on["k10"] == 0,
            f"the 4 MiB dense compress on the card launched {on}")
    zero_launches()
    d_cpu = lrzt.compress(pasted, dense, device="cpu")
    require(sum(read_launches().values()) == 0,
            "the CPU dense compress launched a kernel")
    require(d_card == d_cpu, "4 MiB dense rans archive differs between "
            "cuda and cpu")
    require(lrzt.decompress(d_cpu, device="cuda") == pasted,
            "the card does not decode the CPU's dense archive")
    require(lrzt.decompress(d_card, device="cpu") == pasted,
            "the CPU does not decode the card's dense archive")
    log(f"card equals cpu: 4 MiB pasted pieces, dense (anchor_stride=1, "
        f"rans) -> {len(d_card)} bytes against {len(p_card)} at stride 8, "
        f"identical; each device decodes the other's archive")

    mixed = mixed_corpus(4 * MIB).tobytes()
    for label, kw in (
            ("4 MiB mixed in 1 MiB chunks (rans, the lookahead at depth 2)",
             {"method": "rans", "max_chunk": MIB}),
            ("4 MiB mixed in 1 MiB windows (-U, gzip)",
             {"method": "gzip", "unlimited": True, "max_chunk": MIB})):
        multi = lrzt.Settings(**kw)
        m_card = lrzt.compress(mixed, multi, device="cuda")
        m_cpu = lrzt.compress(mixed, multi, device="cpu")
        require(m_card == m_cpu, f"{label}: the archive differs between "
                "cuda and cpu")
        require(lrzt.decompress(m_cpu, device="cuda") == mixed,
                f"{label}: the card does not decode the CPU's archive")
        require(lrzt.decompress(m_card, device="cpu") == mixed,
                f"{label}: the CPU does not decode the card's archive")
        log(f"card equals cpu: {label} -> {len(m_card)} bytes, identical; "
            f"each device decodes the other's archive")
    return on_card


def must_raise(what: str, fn) -> None:
    """``fn`` must raise ``ValueError``; returning anything fails."""
    try:
        fn()
    except ValueError as exc:
        torch.cuda.synchronize()
        log(f"corrupt payload, {what}: ValueError({exc})")
        return
    raise SystemExit(f"chip_smoke: FAILED: {what}: no ValueError")


def phase_corrupt(archive: bytes) -> None:
    """Damaged rANS payloads on the card raise, and never return bytes."""
    import lrzip_next_tpu_torch as lrzt
    from lrzip_next_tpu_torch.models.device_path import DeviceLitPlane
    from lrzip_next_tpu_torch.ops import rans
    data = skewed_symbols(3 * MIB)
    payload = rans.encode_block(data, 6, device="cuda")
    require(rans.decode_block(payload, device="cuda") == data.tobytes(),
            "the intact payload does not decode on the card")
    hdr = list(rans._HDR.unpack_from(payload, 0))
    nw = hdr[5]

    flipped = bytearray(payload)
    flipped[len(payload) - nw] ^= 0x20      # a word in the stream's middle
    cut = hdr[:]
    cut[5] = nw // 2                        # half the words, header agreeing
    short = rans._HDR.pack(*cut) + payload[rans._HDR.size:len(payload) - 2 *
                                           (nw - nw // 2)]
    dev = torch.device("cuda")
    for what, bad in (("one flipped word", bytes(flipped)),
                      ("word count cut short", short)):
        must_raise(f"{what}, decode_block",
                   lambda: rans.decode_block(bad, device="cuda"))
        must_raise(f"{what}, DeviceLitPlane.check",
                   lambda: DeviceLitPlane(bad, len(data), dev).check())
    # through the entry point: the literal block's words end the chunk,
    # just before the 16-byte MD5
    damaged = bytearray(archive)
    damaged[len(archive) - 16 - 4_000] ^= 0x08
    must_raise("one flipped byte in the archive's literal block, decompress",
               lambda: lrzt.decompress(bytes(damaged), device="cuda"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = phase_environment()
    log("zstandard: " + ("imports" if importlib.util.find_spec("zstandard")
                         else "missing (method zstd raises ValueError)"))
    from lrzip_next_tpu_torch.ops import matcher
    matcher.require_runtime()
    log(f"host runtime: available ({time.perf_counter() - t0:.3f} s "
        f"including its g++ build)")

    phase_build()
    corpus64 = long_range_corpus(64 * MIB)
    pasted64 = pasted_corpus(64 * MIB)
    kern = phase_kernels(corpus64, pasted64)
    # K2 is on no path (the chain stage compacts with K10): its launches
    # are the stride-8 compress's 0, which phase_slice requires
    launches = phase_slice(corpus64, pasted64)
    del corpus64, pasted64
    torch.cuda.empty_cache()
    big = long_range_corpus(256 * MIB)
    launches["k11"] = phase_multichunk(
        big, word_soup_with_holes(16 * MIB).tobytes())
    phase_mesh(big)
    phase_mesh_sp(big)
    del big
    phase_corrupt(phase_card_equals_cpu())
    log(f"all phases passed in {time.perf_counter() - t0:.3f} s")

    rows = [
        ("anchor_fps", "lrzip_next_tpu_torch/ops/csrc/anchor_fps.cu",
         "lrzip_next_tpu/ops/anchor_pallas.py:127", "k1"),
        ("compact_starts3", "lrzip_next_tpu_torch/ops/csrc/compact3.cu",
         "lrzip_next_tpu/ops/compact_pallas.py:248", "k2"),
        ("pack_stream", "lrzip_next_tpu_torch/ops/csrc/streampack.cu",
         "lrzip_next_tpu/ops/streampack.py:118", "k3"),
        ("joint_histogram", "lrzip_next_tpu_torch/ops/csrc/rans_hist.cu",
         "lrzip_next_tpu/ops/rans_pallas.py:143", "k4"),
        ("encode_scan", "lrzip_next_tpu_torch/ops/csrc/rans_encode.cu",
         "lrzip_next_tpu/ops/rans_pallas.py:281", "k5"),
        ("pack_plane", "lrzip_next_tpu_torch/ops/csrc/streampack.cu",
         "lrzip_next_tpu/ops/streampack.py:73", "k6"),
        ("decode_scan", "lrzip_next_tpu_torch/ops/csrc/rans_decode.cu",
         "lrzip_next_tpu/ops/rans_decode_pallas.py:308", "k7"),
        ("ragged_concat", "lrzip_next_tpu_torch/ops/csrc/replay_ragged.cu",
         "lrzip_next_tpu/ops/replay_ragged.py:274", "k8a"),
        ("layered_pass", "lrzip_next_tpu_torch/ops/csrc/replay_ragged.cu",
         "lrzip_next_tpu/ops/replay_ragged.py:481", "k8b"),
        ("small_merge", "lrzip_next_tpu_torch/ops/csrc/replay_ragged.cu",
         "lrzip_next_tpu/ops/replay_ragged.py:607", "k8c"),
        ("compact_masked",
         "lrzip_next_tpu_torch/ops/csrc/compact_masked.cu",
         "lrzip_next_tpu/ops/compact_pallas.py:177", "k9"),
        ("compact_starts", "lrzip_next_tpu_torch/ops/csrc/compact3.cu",
         "lrzip_next_tpu/ops/compact_pallas.py:291", "k10"),
        ("gear_anchors", "lrzip_next_tpu_torch/ops/csrc/gear_anchors.cu",
         "lrzip_next_tpu/models/crosschunk.py gear_anchor_positions + "
         "window_hashes_at (numpy, no pallas_call)", "k11"),
    ]
    for r in kern.values():   # the profiler's device time, where measured
        if "device_ms" in r:
            r["dev_ms"] = r["device_ms"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[key], **kern[key]}
        for name, src, rep, key in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
