#!/usr/bin/env python3
"""Smoke run of lrzip_next_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the last line:

1. environment: the card's name and power limit, torch and CUDA versions,
   whether ``zstandard`` imports, and the native host runtime (required);
2. build: nvcc compiles the port's CUDA kernels from ``ops/csrc``, one
   process per source, all started together;
3. kernels: every kernel against its plain PyTorch version on the card,
   bit for bit, with both times (median of 5, CUDA events): K1
   (anchor_fps) and K2 (compact_starts3) at the matcher's shapes for a
   64 MiB and a 256 MiB chunk (stride 8); K3 (pack_stream), K4
   (joint_histogram), K5 (encode_scan) and K6 (pack_plane) at the shapes
   of the 64 MiB chunk's literal stream, made from its real matcher
   tokens (level 7, ctx_bits 6; K4 and K5 also at ctx_bits 8, untimed);
4. the slice: ``lrzip_next_tpu_torch.compress`` of the 64 MiB long-range
   corpus with ``method="rans"`` (the device literal encode: K1-K6), with
   lzma (host literal coder: K1, K2), and of a 16 MiB word-soup text with
   holes (gzip, which takes the walk fallback), each decoded by the
   shared ``decompress`` and compared; the launch counters are zeroed
   just before each 64 MiB run and must rise for every kernel it uses;
5. card equals CPU: an 8 MiB mixed input (gzip) and a 4 MiB skewed input
   whose literals make one rANS block of 4096 lanes (rans), each
   compressed with device="cuda" and with device="cpu", give the same
   archive bytes.

The line before the last is a JSON object of the kernels, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
nonzero and prints no result.  All data is generated from fixed seeds.
"""

from __future__ import annotations

import json
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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def check_k1(data: np.ndarray, label: str) -> dict:
    from lrzip_next_tpu_torch.ops.anchor import anchor_fps, \
        anchor_fps_reference
    from lrzip_next_tpu_torch.ops.matcher import bucket_size
    nb = bucket_size(len(data))
    padded = torch.zeros(nb, dtype=torch.uint8, device="cuda")
    padded[:len(data)] = torch.from_numpy(data).cuda()
    ma = ((nb - 31) // STRIDE) * STRIDE
    fpa, fpb = anchor_fps(padded, STRIDE, ma)
    torch.cuda.synchronize()
    rfpa, rfpb = anchor_fps_reference(padded, STRIDE, ma)
    torch.cuda.synchronize()
    err = max(int((fpa.long() - rfpa.long()).abs().max()),
              int((fpb.long() - rfpb.long()).abs().max()))
    require(err == 0 and torch.equal(fpa, rfpa) and torch.equal(fpb, rfpb),
            f"K1 differs from its plain version at {label}")
    ms = cuda_ms(lambda: anchor_fps(padded, STRIDE, ma))
    plain_ms = cuda_ms(lambda: anchor_fps_reference(padded, STRIDE, ma))
    anchors = int((fpa != 0x7FFFFFFF).sum())
    log(f"K1 anchor_fps {label}: n={nb} ma={ma} anchors={anchors} "
        f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_k2(data: np.ndarray, label: str) -> dict:
    from lrzip_next_tpu_torch.ops import matcher as M
    from lrzip_next_tpu_torch.ops.compact import compact_starts3, \
        compact_starts3_reference
    nb = M.bucket_size(len(data))
    padded = torch.zeros(nb, dtype=torch.uint8, device="cuda")
    padded[:len(data)] = torch.from_numpy(data).cuda()
    pos, cand = M.anchor_candidates_fporder(padded, STRIDE)
    start, is_end, sp, sd = M.dist_sorted_seed_starts(
        pos, cand, len(data) - 31, M.verify_gap(STRIDE))
    end_at = M.seg_end_copy(sp, is_end)
    a, b, c, n = compact_starts3(start, sp, sd, end_at)
    torch.cuda.synchronize()
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
    log(f"K2 compact_starts3 {label}: k={start.shape[0]} n={k} bit-equal; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def skewed_symbols(total: int) -> np.ndarray:
    """Seeded i.i.d. bytes of a Zipf-like law: no long repeats, so every
    byte is a literal, and rANS-compressible."""
    rng = np.random.default_rng(11)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, total, p=p / p.sum()).astype(np.uint8)


def timed_pair(name: str, label: str, kernel, plain, same) -> dict:
    """Run the kernel and its plain version once each, require ``same`` of
    their results (0 = equal), then time both (median of 5)."""
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    err = same(got, ref)
    require(err == 0, f"{name} differs from its plain version at {label}")
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain)
    log(f"{name} {label}: bit-equal; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "out": got}


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return 1 << 62
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_literal_kernels(corpus64: np.ndarray) -> dict:
    """K3-K6 at the shapes of the 64 MiB chunk's literal stream."""
    from lrzip_next_tpu_torch.models import device_path as DP
    from lrzip_next_tpu_torch.ops import matcher, rans
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    from lrzip_next_tpu_torch.ops import streampack as SP
    job = matcher.MatchJob(corpus64, STRIDE, torch.device("cuda"))
    kinds, lengths, _ = job.collect()
    ls, le, n_lit = DP.literal_spans(kinds, lengths)
    mask = DP.literal_mask(job.dev.shape[0], ls, le, job.dev.device)
    k, t_len, srate = rans.plan(n_lit)
    label = (f"n_lit={n_lit} in {len(ls)} spans, K={k} T={t_len} "
             f"srate={srate}")
    log(f"literal stream of the 64 MiB chunk: {label}")

    def same_pack(a, b):
        return max(max_err(a[1], b[1]), max_err(a[0], b[0]))

    res = {"k3": timed_pair(
        "K3 pack_stream", "64 MiB chunk",
        lambda: SP.pack_stream(job.dev, mask, k * t_len),
        lambda: SP.pack_stream_reference(job.dev, mask, k * t_len),
        same_pack)}
    lit = res["k3"]["out"][0]
    require(int(res["k3"]["out"][1]) == n_lit, "K3 count != n_lit")
    for ctx_bits in (6, 8):
        hist = timed_pair(
            f"K4 joint_histogram ctx_bits {ctx_bits}", label,
            lambda: RK.joint_histogram(lit, n_lit, ctx_bits, srate, k),
            lambda: RK.joint_histogram_reference(lit, n_lit, ctx_bits,
                                                 srate, k), max_err)
        freqs = rans.quantize_freqs(hist["out"])
        enc = timed_pair(
            f"K5 encode_scan ctx_bits {ctx_bits}", label,
            lambda: RK.encode_scan(lit, n_lit, freqs, ctx_bits, k),
            lambda: RK.encode_scan_reference(lit, n_lit, freqs, ctx_bits,
                                             k),
            lambda a, b: max(max_err(a[0], b[0]), max_err(a[1], b[1])))
        if ctx_bits == 6:   # level 7, the main path's
            res["k4"], res["k5"] = hist, enc
    plane = res["k5"]["out"][1]
    res["k6"] = timed_pair(
        "K6 pack_plane", label,
        lambda: SP.pack_plane(plane, k * t_len),
        lambda: SP.pack_plane_reference(plane, k * t_len), same_pack)
    log(f"  K6 words: {int(res['k6']['out'][1])} of {k * t_len} slots")
    for r in res.values():
        r.pop("out")
    return res


def phase_kernels(corpus64: np.ndarray) -> dict:
    res = {"k1": check_k1(corpus64, "64 MiB"),
           "k2": check_k2(corpus64, "64 MiB"),
           **check_literal_kernels(corpus64)}
    torch.cuda.empty_cache()
    big = long_range_corpus(256 * MIB)
    check_k1(big, "256 MiB")
    check_k2(big, "256 MiB")
    del big
    torch.cuda.empty_cache()
    return res


def zero_launches() -> None:
    from lrzip_next_tpu_torch.ops import anchor, compact
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    from lrzip_next_tpu_torch.ops import streampack as SP
    anchor.launches = compact.launches = 0
    RK.hist_launches = RK.encode_launches = 0
    SP.stream_launches = SP.plane_launches = 0


def read_launches() -> dict:
    from lrzip_next_tpu_torch.ops import anchor, compact
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    from lrzip_next_tpu_torch.ops import streampack as SP
    return {"k1": anchor.launches, "k2": compact.launches,
            "k3": SP.stream_launches, "k4": RK.hist_launches,
            "k5": RK.encode_launches, "k6": SP.plane_launches}


def compress_checked(data: np.ndarray, method: str, label: str) -> list:
    import lrzip_next_tpu_torch as lrzt
    stats = []
    settings = lrzt.Settings(method=method, stats_sink=stats.append)
    raw = data.tobytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    archive = lrzt.compress(raw, settings)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = lrzt.decompress(archive)
    dsecs = time.perf_counter() - t0
    require(out == raw, f"{label}: round trip differs")
    dev_ms = sum(sum(s.get("device_ms", {}).values()) for s in stats)
    log(f"slice {label} ({method}): {len(raw)} -> {len(archive)} bytes, "
        f"ratio {len(raw) / len(archive):.4f}, compress {secs:.3f} s, "
        f"decompress (host) {dsecs:.3f} s, matcher device stages "
        f"{dev_ms:.3f} ms")
    for s in stats:
        stages = ", ".join(f"{k} {v:.3f}" for k, v in
                           s.get("device_ms", {}).items())
        log(f"  chunk {s['chunk']}: chains {s['chains']} matches "
            f"{s['matches']} match_bytes {s['match_bytes']} literal_bytes "
            f"{s['literal_bytes']} | device ms: {stages} | host "
            f"finalize/walk ms {s.get('host_ms', 0):.3f}")
        lit_ms = s.get("literal_ms")
        if lit_ms:
            log("  literal encode device ms: " + ", ".join(
                f"{k} {v:.3f}" for k, v in lit_ms.items()) +
                f" (sum {sum(lit_ms.values()):.3f})")
    return stats


def phase_slice(corpus64: np.ndarray) -> dict:
    from lrzip_next_tpu_torch.ops import matcher
    zero_launches()
    stats = compress_checked(corpus64, "rans", "64 MiB long-range")
    launches = read_launches()
    require(all(v > 0 for v in launches.values()),
            f"the rans path did not launch every kernel: {launches}")
    require(all(s.get("literal_ms") for s in stats),
            "the rans path did not take the device literal encode")
    for _ in range(2):
        compress_checked(corpus64, "rans", "64 MiB long-range, warm")
    zero_launches()
    compress_checked(corpus64, "lzma", "64 MiB long-range")
    lzma = read_launches()
    require(lzma["k1"] > 0 and lzma["k2"] > 0,
            f"the lzma path did not launch K1 and K2: {lzma}")
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
        f"{statistics.median(r['host_ms'] for r in runs):.3f}")
    walks = matcher.walk_fallbacks
    compress_checked(word_soup_with_holes(16 * MIB), "gzip",
                     "16 MiB word soup")
    require(matcher.walk_fallbacks > walks,
            "the word-soup text did not take the walk fallback")
    return launches


def phase_card_equals_cpu() -> None:
    import lrzip_next_tpu_torch as lrzt
    raw = mixed_corpus(8 * MIB).tobytes()
    s = lrzt.Settings(method="gzip")
    on_card = lrzt.compress(raw, s, device="cuda")
    on_cpu = lrzt.compress(raw, s, device="cpu")
    require(on_card == on_cpu, "8 MiB archive differs between cuda and cpu")
    require(lrzt.decompress(on_card) == raw, "8 MiB round trip differs")
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
    require(lrzt.decompress(on_card) == raw, "4 MiB rans round trip differs")
    log(f"card equals cpu: 4 MiB skewed (rans, {lit[0][2]} literals in "
        f"{lit[0][1]} lanes) -> {len(on_card)} bytes, identical")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    import lrzip_next_tpu_torch  # noqa: F401  (installs the zstd guard)
    card = phase_environment()
    zstd = sys.modules.get("zstandard")
    log("zstandard: " + ("missing (stub installed; zstd raises)"
                         if getattr(zstd, "IS_STUB", False) else "imports"))
    from lrzip_next_tpu_torch.ops import matcher
    matcher.require_runtime()
    log(f"host runtime: available ({time.perf_counter() - t0:.3f} s "
        f"including its g++ build)")

    phase_build()
    corpus64 = long_range_corpus(64 * MIB)
    kern = phase_kernels(corpus64)
    launches = phase_slice(corpus64)
    phase_card_equals_cpu()

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
    ]
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
