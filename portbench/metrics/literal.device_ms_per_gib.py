"""literal.device_ms_per_gib: the device literal encode
(``stats_sink`` ``literal_ms``: CUDA events of mask, pack, histogram,
quantize, encode, pack_words, readback) summed over the chunks, per GiB
of compress input."""

from portbench.core.readings import stage_ms_per_gib


def read(run):
    return stage_ms_per_gib(run, "literal_ms")
