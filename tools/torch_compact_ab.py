#!/usr/bin/env python3
"""Time the port's K9 (compact_masked, the dense matcher's two-mask run
compaction) of one checkout of the repository on a CUDA card, so that two
checkouts can be compared within one run on one card:

    python3 tools/torch_compact_ab.py ROOT TAG

ROOT is the root of the checkout to import ``lrzip_next_tpu_torch`` from
(its kernels are built there), TAG a label for the printed lines.  Run it
for two checkouts in turns (a, b, b, a).  The input is the main path's
shape: the run masks of the dense (stride-1) candidates of
``chip_smoke.py``'s 64 MiB long-range corpus (this script's own checkout
makes the corpus, ROOT's matcher the candidates and masks; about 2% of
each mask set).  K9 is first checked bit for bit against its plain
version (the count and the first count slots of each stream), then timed:
the wrapper with CUDA events (median of 7), and on the device with
``torch.profiler`` (mean over 5 calls): K9's kernels alone, and every
device operation of a call (memsets, scans and conversions too, by
name).  Its kernels are also timed on the device on all-clear masks of
the same length (nothing to scatter: the floor of flags, offsets and
launch) and on 32768 elements (one tile of ``compact_masked.cu``: the
launch and one block).
"""

import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

K9_KERNELS = ("compact_masked_kernel", "masked_count_kernel",
              "masked_scatter_kernel")


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lrzip_next_tpu_torch.ops import _build
    from lrzip_next_tpu_torch.ops import compact as C
    from lrzip_next_tpu_torch.ops import matcher as M
    if not torch.cuda.is_available():
        print("torch_compact_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if not C.__file__.startswith(root):
        print(f"torch_compact_ab: imported {C.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    _build.build(force=True)
    # the corpus from this script's own checkout, whatever ROOT is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_corpus", Path(__file__).resolve().parents[1] /
        "chip_smoke.py")
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

    def device_ms(fn, reps=5):
        """(ms of K9's kernels a call, ms of every device operation a
        call, the names seen).  The profiler now and then misses a call's
        events, so a call is counted by the launches of the K9 kernel seen
        most often."""
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
            named = [e for e in ops if any(k in e.name for k in K9_KERNELS)]
            if named:
                calls = max(sum(k in e.name for e in named)
                            for k in K9_KERNELS)
                return (sum(e.device_time_total for e in named) / 1e3 / calls,
                        sum(e.device_time_total for e in ops) / 1e3 / calls,
                        sorted({e.name.replace("(anonymous namespace)::",
                                               "").split("(")[0]
                                for e in ops}))
        return float("nan"), float("nan"), []

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    data = smoke.long_range_corpus(64 << 20)
    cand, ok = M.match_candidates(smoke.padded_on_card(data))
    start, is_end, idx = M.run_masks(cand, ok, len(data) - 31)
    del ok
    torch.cuda.empty_cache()
    m = start.shape[0]
    n_runs = int(start.sum())

    def k9():
        return C.compact_masked(start, is_end, idx, cand)

    got = k9()
    ref = C.compact_masked_reference(start, is_end, idx, cand)
    n, n_end = int(ref[3]), int(is_end.sum())
    assert int(got[3]) == n == n_runs, "K9 count differs"
    for x, y, k in zip(got[:3], ref[:3], (n, n_end, n)):
        assert torch.equal(x[:k], y[:k]), "K9 differs"
    del got, ref
    dev, dev_all, names = device_ms(k9)
    print(f"AB {tag} {smi}: K9 64 MiB dense, m={m}, {n} starts, {n_end} "
          f"ends: wrapper {event_ms(k9):.4f} ms, its kernels on the device "
          f"{dev:.4f} ms, every device operation {dev_all:.4f} ms "
          f"({', '.join(names)})", flush=True)
    for label, k in (("all-clear masks", m), ("one tile", 32768)):
        clear = [torch.zeros(k, dtype=torch.bool, device="cuda")
                 for _ in range(2)]
        dev, _, _ = device_ms(
            lambda: C.compact_masked(*clear, idx[:k], cand[:k]))
        print(f"AB {tag} {smi}: K9 {label}, m={k}: its kernels on the "
              f"device {dev:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
