"""crosswindow.covered_pct: 100 x the bytes that the ``-U`` windows'
matches into earlier windows cover (the ``stats_sink`` counter
``cross_bytes`` of each compress window) over the compress input bytes:
the share of the input that the cross-window index, not the in-window
matcher, takes out.  None where no dict has the counter (the parent's
program)."""

from portbench.core.readings import ops


def read(run):
    sel = [s["cross_bytes"] for s in run.stats
           if s.get("op") == "compress" and "cross_bytes" in s]
    total = sum(o["bytes_in"] for o in ops(run, "compress"))
    return 100.0 * sum(sel) / total if sel and total > 0 else None
