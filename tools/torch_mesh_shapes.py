#!/usr/bin/env python3
"""Seconds per 64 MiB of the port's mesh compress on every card of one
host, in the automatic shape against every card on dp:

    python3 tools/torch_mesh_shapes.py [--chunks N] [--reps 5] [--entries N]

Needs two CUDA cards or more; ``--entries N`` runs both shapes over N
entries of cuda:0 instead (one card: a check of the script, whose
seconds say nothing of several cards).  The automatic mesh is what
``parallel/mesh.pipeline_mesh("cuda")`` takes (the JAX package's
``make_mesh()``: 4 cards 2 x 2, 8 cards 4 x 2, so each dp row's sp
devices split its chunk); the other is ``make_mesh(dp=n)`` (n x 1, a
whole chunk a card).  The input is ``chip_smoke.long_range_corpus`` in
``--chunks`` 64 MiB chunks (default two a card), rans at level 7
(stride 8), then the first half of it dense (stride 1).  Each mesh must
write the single-device archive byte for byte and launch K1 once a slab
(chunks x sp), K10 twice a chunk and K3-K6 once a chunk.  The shapes run
in turns (a, b, b, a, ...), ``--reps`` each; the one-card lookahead is
timed beside them.  Prints, per shape, each run's seconds per 64 MiB and
their median, the peak device memory of every card, and for the
automatic mesh (after a warm-up run) the median device ms of each stage
of a chunk on its row's first card and of each other slab on its own
(``MatchJob.stats`` ``device_ms``, ``sp_device_ms``) with the peer
access between them; the same as JSON in
``chiprun_out/mesh_shapes.json``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

MIB = 1 << 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--entries", type=int, default=0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < (1 if args.entries else 2):
        print("torch_mesh_shapes: needs two CUDA cards or more",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import lrzip_next_tpu_torch as lrzt
    from lrzip_next_tpu_torch.ops import _build
    from lrzip_next_tpu_torch.ops import matcher
    from lrzip_next_tpu_torch.parallel import mesh as M

    n = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(f"cards: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    peer = [[None if i == j else torch.cuda.can_device_access_peer(i, j)
             for j in range(n)] for i in range(n)]
    print(f"peer access: {peer}")
    matcher.require_runtime()
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s")

    entries = args.entries or n
    chunks = args.chunks or 2 * entries
    raw = smoke.long_range_corpus(chunks * 64 * MIB).tobytes()
    if args.entries:
        devices = ["cuda:0"] * entries
        auto = M.make_mesh(devices=devices)
        pinned = {"auto": auto, "dp": M.make_mesh(devices=devices,
                                                  dp=entries)}
    else:
        auto = M.pipeline_mesh("cuda", use_mesh=True)
        # None: the compress path's own choice, pipeline_mesh's
        pinned = {"auto": None, "dp": M.make_mesh(dp=n)}
    shapes = {f"auto {auto.devices.shape[0]} x {auto.devices.shape[1]}":
              pinned["auto"], f"dp only {entries} x 1": pinned["dp"]}
    out = {"cards": smi, "peer": peer, "chunks": chunks}

    seen = []

    class Spy(M.MeshMatchBatch):
        def collect(self, i):
            tokens = super().collect(i)
            seen.append(self.jobs[i].stats)
            return tokens

    for label, kw, n_chunks in (
            ("rans", {"method": "rans", "max_chunk": 64 * MIB}, chunks),
            ("dense", {"method": "rans", "max_chunk": 64 * MIB,
                       "anchor_stride": 1}, max(chunks // 2, 2))):
        data = raw[:n_chunks * 64 * MIB]
        single = lrzt.compress(data, lrzt.Settings(use_mesh=False, **kw),
                               device="cuda")
        res = {}
        orig, M.MeshMatchBatch = M.MeshMatchBatch, Spy
        try:
            for shape, mesh in shapes.items():
                m = mesh if mesh is not None else auto
                dp, sp = m.devices.shape
                # a warm-up first: a card's first use (its context, its
                # kernels' modules, peer access) would fill the stages
                smoke.mesh_compress(data, mesh, **kw)
                seen.clear()
                for d in range(n):
                    torch.cuda.reset_peak_memory_stats(d)
                smoke.zero_launches()
                archive, secs, n_b = smoke.mesh_compress(data, mesh, **kw)
                enc = smoke.read_launches()
                peak = [torch.cuda.max_memory_allocated(d) for d in range(n)]
                ok = archive == single and n_b == -(-n_chunks // dp)
                want = ({"k9": n_chunks} if label == "dense" else
                        {"k1": n_chunks * sp, "k10": 2 * n_chunks})
                want.update({k: n_chunks for k in smoke.LITERAL_KERNELS})
                ok = ok and all(enc[k] == v for k, v in want.items())
                print(f"{label} {shape}: {n_chunks} chunks, archive equal to "
                      f"the single-device one: {archive == single}, batches "
                      f"{n_b}, launches {enc}, {secs:.3f} s warm, peak "
                      f"device memory {peak}")
                if not ok:
                    print(f"torch_mesh_shapes: {label} {shape} wanted "
                          f"launches {want} and the single-device archive",
                          file=sys.stderr)
                    return 1
                res[shape] = {"peak": peak, "launches": enc, "runs": []}
                if m is auto and sp > 1:
                    first = {k: statistics.median(s["device_ms"][k]
                                                  for s in seen)
                             for k in seen[0]["device_ms"]}
                    slabs = [{k: statistics.median(s["sp_device_ms"][i][k]
                                                   for s in seen)
                              for k in seen[0]["sp_device_ms"][i]}
                             for i in range(sp - 1)]
                    res[shape].update(first_device_ms=first, slab_ms=slabs,
                                      sp_peer=seen[0]["sp_peer"])
                    print("  first card of a row, median ms: " + ", ".join(
                        f"{k} {v:.3f}" for k, v in first.items()))
                    print("  other slabs, median ms: " + "; ".join(
                        ", ".join(f"{k} {v:.3f}" for k, v in s.items())
                        for s in slabs) + f" | peer {seen[0]['sp_peer']}")
        finally:
            M.MeshMatchBatch = orig
        names = list(shapes)
        for rep in range(args.reps):
            for shape in names if rep % 2 == 0 else names[::-1]:
                secs = smoke.mesh_compress(data, shapes[shape], **kw)[1]
                res[shape]["runs"].append(secs * 64 * MIB / len(data))
        res["one card, lookahead"] = {"runs": []}
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lrzt.compress(data, lrzt.Settings(use_mesh=False, **kw),
                          device="cuda")
            res["one card, lookahead"]["runs"].append(
                (time.perf_counter() - t0) * 64 * MIB / len(data))
        for shape, r in res.items():
            r["median"] = statistics.median(r["runs"])
            print(f"{label} {shape}: s per 64 MiB "
                  f"{', '.join(f'{x:.4f}' for x in r['runs'])} (median "
                  f"{r['median']:.4f})")
        out[label] = res
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "mesh_shapes.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
