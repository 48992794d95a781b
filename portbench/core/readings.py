"""Arithmetic that the metric readers share (``portbench/metrics``).

A reader returns None where its run has nothing to read: no operation
of the kind, no stats of the stage, or no device event in the trace.
"""

from __future__ import annotations

GIB = float(1 << 30)


def ops(run, kind: str) -> list:
    return [o for o in run.ops if o["kind"] == kind]


def rate_mb_s(run, kind: str, field: str):
    """10^6 bytes of ``field`` over the summed seconds of ``kind`` ops."""
    sel = ops(run, kind)
    secs = sum(o["seconds"] for o in sel)
    return sum(o[field] for o in sel) / secs / 1e6 if secs > 0 else None


def stage_ms_per_gib(run, key: str):
    """Summed milliseconds of the stats entry ``key`` (a number, or a
    dict of stage milliseconds) over the compress chunks, per GiB of
    compress input."""
    total, seen = 0.0, False
    for s in run.stats:
        v = s.get(key)
        if not v:
            continue
        seen = True
        total += sum(v.values()) if isinstance(v, dict) else v
    gib = sum(o["bytes_in"] for o in ops(run, "compress")) / GIB
    return total / gib if seen and gib > 0 else None


def traced_ops(run, kind: str) -> list:
    """The trace's spans of ``kind`` (busy ns per device, span ns)."""
    if run.trace is None or run.trace["device_events"] == 0:
        return []
    return [o for o in run.trace["ops"] if o["kind"] == kind]


def busy_ns(run, kind: str):
    """Device busy ns inside the ``kind`` spans, summed over devices."""
    sel = traced_ops(run, kind)
    return sum(sum(o["busy_ns"]) for o in sel) if sel else None


def idle_pct(run, kind: str):
    """100 x (1 - busy / span), the mean over the cell's cards."""
    sel = traced_ops(run, kind)
    span = sum(o["span_ns"] for o in sel)
    if not sel or span <= 0:
        return None
    busy = sum(sum(o["busy_ns"]) for o in sel) / run.chips
    return 100.0 * (1.0 - busy / span)


def roofline_pct(run, kind: str):
    """The least time of the stage's own traffic (each input byte read
    once, each output byte written once) at the card's HBM bandwidth,
    over the device busy time of its spans summed over the cards."""
    busy = busy_ns(run, kind)
    if not busy:
        return None
    moved = sum(o["bytes_in"] + o["bytes_out"] for o in ops(run, kind))
    least_s = moved / run.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (busy / 1e9)
