#!/usr/bin/env python3
"""Time the port's K1 (anchor_fps) and K3 (pack_stream) of one checkout of
the repository on a CUDA card, so that two checkouts can be compared
within one run on one card:

    python3 tools/torch_anchor_pack_ab.py ROOT TAG

ROOT is the root of the checkout to import ``lrzip_next_tpu_torch`` from
(its kernels are built there), TAG a label for the printed lines.  Run it
for two checkouts in turns (a, b, b, a).  The inputs are the main path's
shapes, made from seeds: K1 on a 64 MiB chunk at stride 8; K3 on a
64 MiB chunk under a mask of runs (mean 40 set, 100 clear: about 29% set,
like the literal mask of the 64 MiB long-range chunk) into a block of
16384 x 1280 bytes.  Each kernel is first checked bit for bit against its
plain version, then timed: the wrapper with CUDA events (median of 7),
and on the device with ``torch.profiler`` (mean over 5 calls): the named
kernels alone, and every device operation of a call (K3's memsets, scans
and conversions too).  K3's kernels are also timed on the device with
the cap at the count (no zero tail) and on an all-clear mask (no byte
kept: the floor of flags, offsets and launch).
"""

import statistics
import subprocess
import sys


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lrzip_next_tpu_torch.ops import _build
    from lrzip_next_tpu_torch.ops import anchor as A
    from lrzip_next_tpu_torch.ops import streampack as SP
    if not torch.cuda.is_available():
        print("torch_anchor_pack_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if not A.__file__.startswith(root):
        print(f"torch_anchor_pack_ab: imported {A.__file__}, not from "
              f"{root}", file=sys.stderr)
        return 2
    _build.build(force=True)

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
    rng = np.random.default_rng(8)
    n = 64 << 20
    base = rng.integers(0, 256, n // 4, dtype=np.uint8)
    data = torch.from_numpy(np.concatenate([base] * 4)).cuda()
    stride = 8
    ma = ((n - 31) // stride) * stride
    fpa, fpb = A.anchor_fps(data, stride, ma)
    ra, rb = A.anchor_fps_reference(data, stride, ma)
    assert torch.equal(fpa, ra) and torch.equal(fpb, rb), "K1 differs"
    del fpa, fpb, ra, rb
    torch.cuda.empty_cache()

    def k1():
        return A.anchor_fps(data, stride, ma)

    dev, dev_all, names = device_ms(k1, ("anchor_fps_kernel",))
    print(f"AB {tag} {smi}: K1 64 MiB stride 8: wrapper {event_ms(k1):.4f} "
          f"ms, kernel on the device {dev:.4f} ms, every device operation "
          f"{dev_all:.4f} ms ({', '.join(names)})", flush=True)

    lens = rng.geometric([1 / 40, 1 / 100] * (n // 70 + 2))
    mask = torch.from_numpy(
        np.repeat(np.arange(len(lens)) % 2 == 0, lens)[:n]).cuda()
    cap = 16384 * 1280
    got, cnt = SP.pack_stream(data, mask, cap)
    ref, ref_n = SP.pack_stream_reference(data, mask, cap)
    assert int(cnt) == int(ref_n) and torch.equal(got, ref), "K3 differs"
    del got, ref

    def k3():
        return SP.pack_stream(data, mask, cap)

    k3_kernels = ("pack_bytes_kernel", "count_kernel", "scatter_kernel")
    dev, dev_all, names = device_ms(k3, k3_kernels)
    print(f"AB {tag} {smi}: K3 64 MiB, {int(cnt)} kept of {n}, cap {cap}: "
          f"wrapper {event_ms(k3):.4f} ms, its kernels on the device "
          f"{dev:.4f} ms, every device operation {dev_all:.4f} ms "
          f"({', '.join(names)})", flush=True)
    # the same without a zero tail (cap = the count), and the floor: an
    # all-clear mask of the same length, nothing kept, a cap of 16
    clear = torch.zeros_like(mask)
    for label, f, c in (("cap = count", mask, int(cnt)),
                        ("all-clear mask, cap 16", clear, 16)):
        dev, _, _ = device_ms(lambda: SP.pack_stream(data, f, c), k3_kernels)
        print(f"AB {tag} {smi}: K3 64 MiB, {label}: its kernels on the "
              f"device {dev:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
