"""compress_p95_ms: the 95th percentile of the per-file compress wall
time over every file of the window (numpy's linear interpolation)."""

import numpy as np

from portbench.core.readings import ops


def read(run):
    ms = [o["seconds"] * 1e3 for o in ops(run, "compress")]
    return float(np.percentile(ms, 95)) if ms else None
