"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (``setup_s``, from the process's start): import the program,
build its kernels on first use, and run each operation of the traffic on
the generator's set-up inputs, which have the window's shapes. The
window: a closed loop with one client. Input ``i`` is generated from
``(seed, i)`` outside the timed spans; each operation of the traffic
(compress, then decompress of that archive) is timed on the host clock
around the call and a device synchronise, with the peak device memory
read per operation. The window holds a fixed number of files,
``files_for(traffic, seconds)``: the same work for a seed in every run,
about ``seconds`` long when the traffic was added. With ``trace`` the
profiler records the window and the metrics are the cell's per-layer
ones; the comparison (``check.py``) runs after the window and the
profiler, outside both.
"""

from __future__ import annotations

import dataclasses
import io
import os
import resource
import subprocess
import time
from typing import Optional

import numpy as np

from . import check, faults, guard
from .trace import SPAN_PREFIX, Tracer


@dataclasses.dataclass
class Record:
    """One file of the window: its input, archive and outcome."""

    index: int
    data: np.ndarray
    archive: Optional[bytes] = None
    roundtrip_ok: Optional[bool] = None
    failed: int = 0
    kept: bool = False      # data and archive kept for the reference


@dataclasses.dataclass
class Run:
    """What the metric readers read (``portbench/metrics/*.py``)."""

    setup_s: float
    ops: list                    # dicts: kind, bytes_in, bytes_out, seconds
    stats: list                  # stats_sink dicts of the compress chunks
    trace: Optional[dict]        # trace.Tracer.reduce, traced runs only
    peaks: dict
    chips: int


class Program:
    """The system under test: ``compress_stream`` and
    ``decompress_stream`` of ``lrzip_next_tpu_torch`` on in-memory
    buffers, each ending in a device synchronise."""

    def __init__(self, settings, device, sync):
        import lrzip_next_tpu_torch as lrzt
        self.lrzt, self.settings, self.device, self.sync = \
            lrzt, settings, device, sync

    def compress(self, data) -> bytes:
        out = io.BytesIO()
        self.lrzt.compress_stream(data, out, self.settings,
                                  device=self.device)
        self.sync()
        return out.getvalue()

    def decompress(self, archive: bytes) -> bytes:
        out = self.lrzt.decompress_stream(io.BytesIO(archive),
                                          self.settings, device=self.device)
        self.sync()
        return out

    def with_settings(self, **changes) -> "Program":
        return Program(dataclasses.replace(self.settings, stats_sink=None,
                                           **changes),
                       self.device, self.sync)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def files_for(traffic: dict, seconds: float) -> int:
    """The window's fixed number of files: ``seconds`` over the traffic's
    ``nominal_file_seconds`` (one file's operations and its generation
    on an H100 when the traffic was added), at least one."""
    return max(1, round(seconds / traffic["nominal_file_seconds"]))


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", fault: Optional[str] = None, log=print,
             report=print):
    """The result line's object, or None where the guard refuses.  ``log``
    takes the lines for standard error, ``report`` those for standard
    output (one a timed operation)."""
    import torch
    from lrzip_next_tpu_torch.models.pipeline import Settings

    cuda = device.startswith("cuda")
    n_dev = min(cell.chips, torch.cuda.device_count()) if cuda else 1
    gen_device = "cuda:0" if cuda else "cpu"

    def sync():
        if cuda:
            for d in range(n_dev):
                torch.cuda.synchronize(d)

    def reset_peaks():
        if cuda:
            for d in range(n_dev):
                torch.cuda.reset_peak_memory_stats(d)

    def read_peak() -> int:
        return max(torch.cuda.max_memory_allocated(d)
                   for d in range(n_dev)) if cuda else 0

    stats: list = []
    settings = Settings(**cell.config["settings"])
    if trace:
        settings.stats_sink = stats.append
    program = Program(settings, device, sync)
    ops_kinds = cell.traffic["ops"]
    gen, params = cell.generator, cell.traffic["params"]

    # set-up: the window's shapes, once each
    for idx in gen.warmup(params):
        archive = program.compress(gen.generate(params, seed, idx,
                                                gen_device))
        if "decompress" in ops_kinds:
            program.decompress(archive)
    del stats[:]
    sync()
    setup_s = time.perf_counter() - t_start

    log(f"host: os.cpu_count() {os.cpu_count()}, "
        f"{len(os.sched_getaffinity(0))} cores in the affinity mask, "
        f"{settings.resolved_threads()} program threads")
    if fault:
        faults.apply(fault, program)
    tracer = Tracer(cuda) if trace else None
    if tracer is not None:
        tracer.start()          # the profiler's own start-up is not timed
    n_files = files_for(cell.traffic, seconds)
    spec = cell.traffic.get("reference_sample", {})
    sampled = check.plan(seed, n_files, spec)
    records, ops, peak, largest = [], [], 0, None
    t_window = time.perf_counter()
    window_ns = [time.time_ns(), 0]
    for i in range(n_files):
        rec = Record(index=i, data=gen.generate(params, seed, i, gen_device))
        records.append(rec)
        result = rec.data
        for kind in ops_kinds:
            reset_peaks()
            fn = program.compress if kind == "compress" else \
                program.decompress
            r0 = resource.getrusage(resource.RUSAGE_SELF)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(SPAN_PREFIX + kind):
                    out = fn(result)
            except Exception as e:      # counted as failed, run goes on
                rec.failed += 1
                log(f"file {i} {kind}: {type(e).__name__}: {e}")
                break
            dt = time.perf_counter() - t0
            r1 = resource.getrusage(resource.RUSAGE_SELF)
            peak = max(peak, read_peak())
            # the host's part of an operation's time: CPU seconds of all
            # threads in user code and in the kernel (page faults)
            report(f"op {i} {kind} {len(result)} {len(out)} {dt:.6f} "
                   f"user {r1.ru_utime - r0.ru_utime:.3f} "
                   f"sys {r1.ru_stime - r0.ru_stime:.3f}")
            ops.append({"kind": kind, "index": i, "seconds": dt,
                        "bytes_in": len(result), "bytes_out": len(out)})
            if kind == "compress":
                rec.archive = out
            else:
                rec.roundtrip_ok = np.array_equal(
                    np.frombuffer(out, np.uint8), rec.data)
            result = out
        del result
        # only the sampled files and the largest one are kept, so the
        # host memory of the window stays flat
        rec.kept = i in sampled
        if spec.get("largest") and (largest is None or
                                    len(rec.data) > len(largest.data)):
            if largest is not None and largest.index not in sampled:
                largest.kept, largest.data, largest.archive = False, None, None
            rec.kept, largest = True, rec
        if not rec.kept:
            rec.data = rec.archive = None
    window_ns[1] = time.time_ns()
    if tracer is not None:
        tracer.stop()
    window_s = time.perf_counter() - t_window
    reduced = tracer.reduce(cell.chips if cuda else 0, window_ns) \
        if tracer is not None else None
    del tracer
    if cuda:
        torch.cuda.empty_cache()

    checks = check.compare(cell, records, seed, program, log)
    run = Run(setup_s=setup_s, ops=ops, stats=stats, trace=reduced,
              peaks=_peaks(), chips=cell.chips)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if cuda:
        dev["power"] = power_limit()
    out = {"correct": bool(records) and all(v <= lim
                                            for _, v, lim in checks),
           "attempted": len(records) * len(ops_kinds),
           "failed": sum(r.failed for r in records), "metrics": metrics,
           "device": dev}
    if reduced is not None:
        busy = reduced["busy_ns"]
        if busy:
            dev["busy_s"] = sum(busy) / len(busy) / 1e9
        dev["window_s"] = reduced["window_ns"] / 1e9
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
        log(f"trace: {reduced['device_events']} device events over "
            f"{window_s:.3f} s")
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n} {v} limit {lim}")
    found = guard.loaded()
    if found:
        log("refused: loaded " + ", ".join(found))
        return None
    return out


def _peaks() -> dict:
    import json
    from pathlib import Path
    return json.loads((Path(__file__).parent / "peaks.json").read_text())
