"""compress_MBps: input bytes of every compress in the window over
their summed wall seconds, in 10^6 bytes a second."""

from portbench.core.readings import rate_mb_s


def read(run):
    return rate_mb_s(run, "compress", "bytes_in")
