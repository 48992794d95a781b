"""crosswindow.find_ms_per_gib: each ``-U`` window's matches into the
earlier windows (the ``stats_sink`` ``main_ms`` stage
``compress.cross_find``: the index lookup with its gear anchors,
fingerprints and sort, the verify and extend loop, the splice into the
window's tokens) summed over the compress windows, per GiB of compress
input.  None where no dict has the stage (the parent timed it in one
``compress.cross`` stage)."""

from portbench.core.readings import GIB, ops

STAGE = "compress.cross_find"


def read(run):
    sel = [s["main_ms"][STAGE] for s in run.stats
           if s.get("op") == "compress" and STAGE in s.get("main_ms", {})]
    gib = sum(o["bytes_in"] for o in ops(run, "compress")) / GIB
    return sum(sel) / gib if sel and gib > 0 else None
