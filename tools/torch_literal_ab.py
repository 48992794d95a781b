#!/usr/bin/env python3
"""Time the port's K4 (joint_histogram) and K6 (pack_plane) of one
checkout of the repository on a CUDA card, so that two checkouts can be
compared within one run on one card:

    python3 tools/torch_literal_ab.py ROOT TAG

ROOT is the root of the checkout to import ``lrzip_next_tpu_torch`` from
(its kernels are built there), TAG a label for the printed lines.  Run it
for two checkouts in turns (a, b, b, a).  The inputs are the main path's:
the 64 MiB long-range chunk of ``chip_smoke.py`` (made from its seeds;
this script's own checkout provides the corpus), its matcher tokens at
stride 8, its literal block (K3) of K = 16384 lanes, and K5's emission
plane of that block at ctx_bits 6.  K4 at ctx_bits 6 and 8 and K6 are
each first checked bit for bit against their plain versions, then timed:
the wrapper with CUDA events (median of 7), and on the device with
``torch.profiler`` (mean over 5 calls): the named kernels alone, and
every device operation of a call (memsets, fills, scans and conversions
too).  ptxas's registers, spills and shared memory of the kernels are
printed from the build.
"""

import importlib.util
import re
import statistics
import subprocess
import sys
from pathlib import Path

KERNELS = ("pack_plane_kernel", "count_kernel", "scatter_kernel",
           "hist_kernel")


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lrzip_next_tpu_torch.models import device_path as DP
    from lrzip_next_tpu_torch.ops import _build, matcher, rans
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    from lrzip_next_tpu_torch.ops import streampack as SP
    if not torch.cuda.is_available():
        print("torch_literal_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if not SP.__file__.startswith(root):
        print(f"torch_literal_ab: imported {SP.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    _build.build(force=True)
    kernel = None
    for line in _build.build_log.splitlines():
        if "entry function" in line:
            m = re.search("|".join(KERNELS), line)
            kernel = m and m.group(0) + ("<true>" if "ILb1E" in line else
                                         "<false>" if "ILb0E" in line
                                         else "")
        elif kernel and ("Used" in line or "spill" in line):
            print(f"AB {tag} ptxas {kernel}: "
                  f"{line.split(':', 1)[-1].strip()}", flush=True)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def event_ms(fn, reps=7):
        fn()
        torch.cuda.synchronize()
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

    def device_ms(fn, kernels, reps=5):
        """(ms of the named kernels a call, ms of every device operation a
        call, the names seen).  The profiler now and then misses a call's
        events, so a call is counted by the launches of the named kernel
        seen most often."""
        for _ in range(3):      # the profiler drops a whole window at times
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            ops = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            named = [e for e in ops if any(k in e.name for k in kernels)]
            if named:
                calls = max(sum(k in e.name for e in named) for k in kernels)
                return (sum(e.device_time_total for e in named) / 1e3 / calls,
                        sum(e.device_time_total for e in ops) / 1e3 / calls,
                        sorted({e.name.split("(")[0] for e in ops}))
        return float("nan"), float("nan"), []

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    corpus = smoke.long_range_corpus(64 << 20)
    job = matcher.MatchJob(corpus, smoke.STRIDE, torch.device("cuda"))
    kinds, lengths, _ = job.collect()
    ls, le, n_lit = DP.literal_spans(kinds, lengths)
    mask = DP.literal_mask(job.dev.shape[0], ls, le, job.dev.device)
    k, t_len, srate = rans.plan(n_lit)
    cap = k * t_len
    lit = SP.pack_stream(job.dev, mask, cap)[0]
    del job, mask
    torch.cuda.empty_cache()
    print(f"AB {tag} {smi}: 64 MiB long-range chunk: {n_lit} literals, "
          f"K = {k}, T = {t_len}, srate {srate}", flush=True)

    for ctx_bits in (6, 8):
        def k4():
            return RK.joint_histogram(lit, n_lit, ctx_bits, srate, k)

        got = k4()
        ref = RK.joint_histogram_reference(lit, n_lit, ctx_bits, srate, k)
        assert torch.equal(got, ref), f"K4 ctx_bits {ctx_bits} differs"
        dev, dev_all, names = device_ms(k4, ("hist_kernel",))
        print(f"AB {tag} {smi}: K4 ctx_bits {ctx_bits}: wrapper "
              f"{event_ms(k4):.4f} ms, kernel on the device {dev:.4f} ms, "
              f"every device operation {dev_all:.4f} ms "
              f"({', '.join(names)})", flush=True)
        if ctx_bits == 6:
            freqs = rans.quantize_freqs(got)

    plane = RK.encode_scan(lit, n_lit, freqs, 6, k)[1]

    def k6():
        return SP.pack_plane(plane, cap)

    got, n = k6()
    ref, ref_n = SP.pack_plane_reference(plane, cap)
    assert int(n) == int(ref_n) and torch.equal(got, ref), "K6 differs"
    dev, dev_all, names = device_ms(k6, KERNELS[:3])
    print(f"AB {tag} {smi}: K6 {int(n)} words of {cap}: wrapper "
          f"{event_ms(k6):.4f} ms, its kernels on the device {dev:.4f} ms, "
          f"every device operation {dev_all:.4f} ms ({', '.join(names)})",
          flush=True)
    # the same without a zero tail (cap = the count), and an all-clear
    # plane of the same shape (nothing kept, the whole stream zeroed)
    clear = torch.zeros_like(plane)
    for label, p, c in (("cap = count", plane, int(n)),
                        ("all-clear plane", clear, cap)):
        dev, _, _ = device_ms(lambda: SP.pack_plane(p, c), KERNELS[:3])
        print(f"AB {tag} {smi}: K6 {label}: its kernels on the device "
              f"{dev:.4f} ms", flush=True)
    dev, _, _ = device_ms(lambda: plane.clone(), ("Memcpy", "copy"))
    print(f"AB {tag} {smi}: plane.clone() ({2 * 4 * cap} bytes moved) on "
          f"the device {dev:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
