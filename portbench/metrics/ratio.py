"""ratio: input bytes over archive bytes, summed over the window's
compresses (bytes stored per byte of user data, inverted)."""

from portbench.core.readings import ops


def read(run):
    sel = ops(run, "compress")
    stored = sum(o["bytes_out"] for o in sel)
    return sum(o["bytes_in"] for o in sel) / stored if stored else None
