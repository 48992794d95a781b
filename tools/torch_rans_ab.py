#!/usr/bin/env python3
"""Time the port's rANS coder kernels, K5 (encode_scan) and K7
(decode_scan), of one checkout of the repository on a CUDA card, so that
two checkouts can be compared within one run on one card:

    python3 tools/torch_rans_ab.py ROOT TAG

ROOT is the root of the checkout to import ``lrzip_next_tpu_torch`` from
(its kernels are built there), TAG a label for the printed lines.  Run it
for two checkouts in turns (a, b, b, a).  The input is the 64 MiB
chunk's literal shape, K = 16384 lanes of T = 1280 bytes, seeded skewed
bytes, at ctx_bits 6 and 8.  Each kernel is first checked against its
plain version (K5) or against the encoded block (K7), then timed: the
wrapper with CUDA events (median of 7) and the kernel alone on the device
with ``torch.profiler`` (mean over 5 calls).  Where the checkout has a
cluster K7, it is also timed at C = 8 CTAs of two lanes a thread.
"""

import statistics
import sys


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lrzip_next_tpu_torch.ops import _build, rans
    from lrzip_next_tpu_torch.ops import rans_kernels as RK
    from lrzip_next_tpu_torch.ops import streampack as SP
    if not torch.cuda.is_available():
        print("torch_rans_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if not RK.__file__.startswith(root):
        print(f"torch_rans_ab: imported {RK.__file__}, not from {root}",
              file=sys.stderr)
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

    def device_ms(fn, kernel, reps=5):
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
                return sum(e.device_time_total for e in seen) / 1e3 / len(seen)
        return float("nan")

    t_len, k = 1280, 16384
    p = 1.0 / np.arange(1, 257) ** 1.2
    lit = torch.from_numpy(np.random.default_rng(1).choice(
        256, k * t_len, p=p / p.sum()).astype(np.uint8)).cuda()
    n = k * t_len - 777
    lit[n:] = 0
    card = torch.cuda.get_device_name(0)
    for cb in (6, 8):
        freqs = rans.quantize_freqs(RK.joint_histogram(lit, n, cb, 1, k))
        states, plane = RK.encode_scan(lit, n, freqs, cb, k)
        rs, rp = RK.encode_scan_reference(lit, n, freqs, cb, k)
        assert torch.equal(states, rs) and torch.equal(plane, rp)
        packed, n_words = SP.pack_plane(plane, k * t_len)
        words = packed[:int(n_words)].contiguous()
        out, xf = RK.decode_scan(words, states, freqs, n, cb, t_len)
        assert torch.equal(out[:n], lit[:n]) and bool((xf == 65536).all())

        def enc():
            return RK.encode_scan(lit, n, freqs, cb, k)

        def dec():
            return RK.decode_scan(words, states, freqs, n, cb, t_len)

        ctas = RK.decode_cluster(k, cb) if hasattr(RK, "decode_cluster") \
            else 1
        d7 = device_ms(dec, "decode_kernel")
        print(f"AB {tag} {card} ctx_bits={cb}: K5 wrapper "
              f"{event_ms(enc):.4f} ms device "
              f"{device_ms(enc, 'encode_kernel'):.4f} ms | K7 C={ctas} "
              f"wrapper {event_ms(dec):.4f} ms device {d7:.4f} ms "
              f"{d7 * 1e3 / t_len:.4f} us a step", flush=True)
        if hasattr(RK, "decode_cluster"):
            lib = _build.library()
            got = torch.empty(k * t_len, dtype=torch.uint8, device="cuda")
            xo = torch.empty(k, dtype=torch.int32, device="cuda")

            def dec8():
                _build.check(lib.lrzt_rans_decode(
                    words.data_ptr(), words.shape[0], states.data_ptr(),
                    freqs.data_ptr(), n, cb, t_len, k, 8, got.data_ptr(),
                    xo.data_ptr(), _build.stream_ptr(words.device)),
                    "rans_decode")
            dec8()
            torch.cuda.synchronize()
            assert torch.equal(got, out) and torch.equal(xo, xf)
            print(f"AB {tag} {card} ctx_bits={cb}: K7 at C=8 (two lanes a "
                  f"thread) wrapper {event_ms(dec8):.4f} ms device "
                  f"{device_ms(dec8, 'decode_kernel'):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
