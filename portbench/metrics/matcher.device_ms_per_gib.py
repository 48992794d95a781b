"""matcher.device_ms_per_gib: the matcher job's device milliseconds
(``stats_sink`` ``device_ms``: CUDA events on the job's stream, every
stage) summed over the chunks, per GiB of compress input."""

from portbench.core.readings import stage_ms_per_gib


def read(run):
    return stage_ms_per_gib(run, "device_ms")
