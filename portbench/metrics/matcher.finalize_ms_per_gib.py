"""matcher.finalize_ms_per_gib: the host finalize of the matcher job
(``stats_sink`` ``host_ms``, on the job's worker thread) summed over
the chunks, per GiB of compress input."""

from portbench.core.readings import stage_ms_per_gib


def read(run):
    return stage_ms_per_gib(run, "host_ms")
