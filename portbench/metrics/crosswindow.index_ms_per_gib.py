"""crosswindow.index_ms_per_gib: the ``-U`` windows entering the host
cross-window index (the ``stats_sink`` ``main_ms`` stage
``compress.cross_index``: ``CrossChunkIndex.add_chunk``, the window's
gear anchors and fingerprints) summed over the compress windows, per GiB
of compress input.  None where no dict has the stage (the parent timed
the index in one ``compress.cross`` stage)."""

from portbench.core.readings import GIB, ops

STAGE = "compress.cross_index"


def read(run):
    sel = [s["main_ms"][STAGE] for s in run.stats
           if s.get("op") == "compress" and STAGE in s.get("main_ms", {})]
    gib = sum(o["bytes_in"] for o in ops(run, "compress")) / GIB
    return sum(sel) / gib if sel and gib > 0 else None
