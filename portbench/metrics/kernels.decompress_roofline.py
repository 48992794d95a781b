"""kernels.decompress_roofline: the least time of the decode stage's
own traffic (archive read once, output written once) at 3.35 TB/s, over
the device busy time of the decompress spans."""

from portbench.core.readings import roofline_pct


def read(run):
    return roofline_pct(run, "decompress")
