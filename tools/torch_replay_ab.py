#!/usr/bin/env python3
"""Time the port's K8a (ragged_concat), K8c (small_merge) and K8b
(layered_pass) of one checkout of the repository on a CUDA card, so that
two checkouts can be compared within one run on one card:

    python3 tools/torch_replay_ab.py ROOT TAG

ROOT is the root of the checkout to import ``lrzip_next_tpu_torch`` from
(its kernels are built there), TAG a label for the printed lines.  Run it
for two checkouts in turns (a, b, b, a).  The input is the main path's:
the 64 MiB long-range chunk of ``chip_smoke.py`` (made from its seeds;
this script's own checkout provides the corpus), its matcher tokens at
stride 8 and its flat piece plan.  ``replay_pieces_ragged`` replays the
plan once with the two wrappers' calls recorded, whatever their
signatures in that checkout; each kernel is then checked bit for bit
against its plain version on the recorded arguments and timed: the
wrapper with CUDA events (median of 7) and the kernel on the device with
``torch.profiler`` (mean over 5 calls); ptxas's registers, spills and
shared memory of the two kernels are printed from the build.  Also
timed, host clock with a synchronise (median of 7):
``replay_pieces_ragged`` from the plan to the chunk (planning, upload and
kernels), and ``replay_tokens_device_array`` from the tokens (the
flattens too) with its parts, each timed inside the same repeated run
(``chip_smoke.replay_parts``).

Then the same for the layered plan of the 64 MiB pasted-pieces chunk
(``chip_smoke.pasted_corpus``): ``replay_pieces_layered`` replays it once
with K8b's calls recorded (a pass each, whatever their signature); each
pass is checked bit for bit against its plain version and timed (wrapper
and device, the kernel found by the name ``layered``); the whole
``replay_pieces_layered`` is timed on the host clock (median of 7) and
its device operations under ``torch.profiler`` (one call, every kernel,
copy and memset it runs); ``replay_parts`` splits the decode's replay.
"""

import importlib.util
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lrzip_next_tpu_torch import runtime
    from lrzip_next_tpu_torch.format.tokens import split_long_runs
    from lrzip_next_tpu_torch.models import device_path as DP
    from lrzip_next_tpu_torch.ops import _build, matcher
    from lrzip_next_tpu_torch.ops import replay_ragged as RR
    if not torch.cuda.is_available():
        print("torch_replay_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if not RR.__file__.startswith(root):
        print(f"torch_replay_ab: imported {RR.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    _build.build(force=True)
    kernel = None       # ptxas's report of K8a, K8c and K8b
    for line in _build.build_log.splitlines():
        if "entry function" in line:
            m = re.search(r"(ragged_kernel|small_kernel|layered\w*kernel)",
                          line)
            kernel = m and m.group(1)
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

    def host_ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def device_ms(fn, kernel, reps=5):
        """ms of the named kernel a launch, as the profiler saw them."""
        for _ in range(3):      # the profiler drops a whole window at times
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            seen = [e for e in prof.events()
                    if e.device_type == DeviceType.CUDA and kernel in e.name]
            if seen:
                return sum(e.device_time_total for e in seen) / 1e3 / \
                    len(seen)
        return float("nan")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    corpus = smoke.long_range_corpus(64 << 20)
    job = matcher.MatchJob(corpus, smoke.STRIDE, torch.device("cuda"))
    kinds, lengths, dists = split_long_runs(*job.collect())
    del job
    ls, le, _ = DP.literal_spans(kinds, lengths)
    lit_host = np.concatenate([corpus[a:b] for a, b in zip(ls, le)])
    lit = torch.from_numpy(lit_host).cuda()
    lens, d = DP._token_columns(kinds, lengths, dists)[:2]
    flat = runtime.flatten_replay(kinds, lens, d)
    out_len = int(lens.sum())

    names = ("ragged_concat", "small_merge")
    real = {name: getattr(RR, name) for name in names}
    calls = {}

    def spy(name):
        def wrapper(*args):
            calls[name] = tuple(a.clone() if isinstance(a, torch.Tensor)
                                else a for a in args)
            return real[name](*args)
        return wrapper

    for name in names:
        setattr(RR, name, spy(name))
    try:
        chunk = RR.replay_pieces_ragged(flat[0], flat[1], lit, out_len)
    finally:
        for name in names:
            setattr(RR, name, real[name])
    assert np.array_equal(chunk.cpu().numpy(), corpus), "replay differs"
    k8a_args, k8c_args = calls["ragged_concat"], calls["small_merge"]
    got = RR.ragged_concat(*k8a_args)
    assert torch.equal(got, RR.ragged_concat_reference(*k8a_args)), \
        "K8a differs"
    mine, plain = k8c_args[0].clone(), k8c_args[0].clone()
    RR.small_merge(mine, *k8c_args[1:])
    RR.small_merge_reference(plain, *k8c_args[1:])
    assert torch.equal(mine, plain), "K8c differs"

    def k8a():
        return RR.ragged_concat(*k8a_args)

    def k8c():
        return RR.small_merge(mine, *k8c_args[1:])

    print(f"AB {tag} {smi}: 64 MiB long-range chunk, {len(kinds)} tokens, "
          f"{len(flat[0])} flat pieces", flush=True)
    print(f"AB {tag} {smi}: K8a wrapper {event_ms(k8a):.4f} ms, kernel on "
          f"the device {device_ms(k8a, 'ragged_kernel'):.4f} ms", flush=True)
    print(f"AB {tag} {smi}: K8c wrapper {event_ms(k8c):.4f} ms, kernel on "
          f"the device {device_ms(k8c, 'small_kernel'):.4f} ms", flush=True)
    pieces_ms = host_ms(lambda: RR.replay_pieces_ragged(flat[0], flat[1],
                                                        lit, out_len), reps=7)
    print(f"AB {tag} {smi}: replay_pieces_ragged {pieces_ms:.3f} ms (host "
          f"clock, synchronised, median of 7)", flush=True)
    parts = smoke.replay_parts((kinds, lengths, dists), lit, reps=7)
    print(f"AB {tag} {smi}: replay_tokens_device_array and its parts "
          f"(chip_smoke.replay_parts, host-clock ms, median of 7): "
          + "; ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    del lit, flat, k8a_args, k8c_args, mine, plain, got, chunk
    torch.cuda.empty_cache()

    # the layered plan of the pasted-pieces chunk: K8b
    corpus = smoke.pasted_corpus(64 << 20)
    job = matcher.MatchJob(corpus, smoke.STRIDE, torch.device("cuda"))
    kinds, lengths, dists = split_long_runs(*job.collect())
    del job
    ls, le, _ = DP.literal_spans(kinds, lengths)
    lit = torch.from_numpy(np.concatenate(
        [corpus[a:b] for a, b in zip(ls, le)])).cuda()
    lens, d = DP._token_columns(kinds, lengths, dists)[:2]
    plan = runtime.flatten_replay_layered(kinds, lens, d)
    assert plan is not None and plan[3] >= 1, "the plan is not layered"
    out_len = int(lens.sum())
    passes = []
    real = RR.layered_pass

    def spy(*args):
        passes.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args))
        return real(*args)

    RR.layered_pass = spy
    try:
        chunk = RR.replay_pieces_layered(*plan, lit, out_len)
    finally:
        RR.layered_pass = real
    want = torch.from_numpy(corpus).cuda()
    assert torch.equal(chunk, want), "layered replay differs"
    print(f"AB {tag} {smi}: 64 MiB pasted-pieces chunk, {len(kinds)} "
          f"tokens, {len(plan[0])} pieces in {plan[3] + 1} layers",
          flush=True)
    for i, args in enumerate(passes):
        mine = args[0].clone()
        plain = args[0].clone()
        RR.layered_pass(mine, *args[1:])
        RR.layered_pass_reference(plain, *args[1:])
        assert torch.equal(mine, plain), f"K8b differs on pass {i + 1}"

        def k8b():
            return RR.layered_pass(mine, *args[1:])

        table = args[1]
        print(f"AB {tag} {smi}: K8b pass {i + 1} ({table.shape[1]} records, "
              f"{int(table[2].sum())} bytes) wrapper {event_ms(k8b):.4f} ms, "
              f"kernel on the device {device_ms(k8b, 'layered'):.4f} ms",
              flush=True)
        del mine, plain

    def layered():
        return RR.replay_pieces_layered(*plan, lit, out_len)

    print(f"AB {tag} {smi}: replay_pieces_layered {host_ms(layered, 7):.3f} "
          f"ms (host clock, synchronised, median of 7)", flush=True)
    layered()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        layered()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(f"AB {tag} {smi}: replay_pieces_layered on the device: "
          f"{len(ops)} operations, "
          f"{sum(e.device_time_total for e in ops) / 1e3:.4f} ms in all "
          f"(torch.profiler, one call): " + ", ".join(
              f"{e.name[:40]} {e.device_time_total / 1e3:.4f}"
              for e in ops), flush=True)
    parts = smoke.replay_parts((kinds, lengths, dists), lit, reps=7)
    print(f"AB {tag} {smi}: pasted pieces, replay_tokens_device_array and "
          f"its parts (host-clock ms, median of 7): "
          + "; ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
