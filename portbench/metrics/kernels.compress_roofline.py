"""kernels.compress_roofline: the least time of the compress stage's
own traffic (input read once, archive written once) at 3.35 TB/s, over
the device busy time of the compress spans."""

from portbench.core.readings import roofline_pct


def read(run):
    return roofline_pct(run, "compress")
