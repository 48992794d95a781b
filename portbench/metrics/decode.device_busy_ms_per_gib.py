"""decode.device_busy_ms_per_gib: the union of the device's activity
(``torch.profiler``) inside the decompress spans, per GiB of output."""

from portbench.core.readings import GIB, busy_ns, ops


def read(run):
    busy = busy_ns(run, "decompress")
    gib = sum(o["bytes_out"] for o in ops(run, "decompress")) / GIB
    return busy / 1e6 / gib if busy and gib > 0 else None
