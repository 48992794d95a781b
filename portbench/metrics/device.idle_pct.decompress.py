"""device.idle_pct.decompress: 100 x (1 - union device busy / span time)
over the decompress spans, the mean over the cell's cards."""

from portbench.core.readings import idle_pct


def read(run):
    return idle_pct(run, "decompress")
