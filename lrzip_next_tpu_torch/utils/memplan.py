"""Memory planning: RAM detection, per-codec overhead model, and the
thread/dictionary negotiation solver.

Mirrors the reference's setup_ram/setup_overhead (src/util.c:103-188) and
the open_stream_out negotiation loop (src/stream.c:1176-1331, P7 in
SURVEY.md): never overcommit; shed threads first, then shrink the codec's
dictionary/block size.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def get_ram() -> int:
    """Total physical RAM in bytes (reference src/lrzip.c:69-128)."""
    try:
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        pass
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("cannot determine RAM size")


def usable_ram(ramsize: Optional[int] = None, stdout_mode: bool = False
               ) -> int:
    """maxram = ramsize/3 (or /6 when buffering output in RAM),
    reference src/util.c:179-188."""
    r = ramsize or get_ram()
    return r // (6 if stdout_mode else 3)


def default_max_chunk(ramsize: Optional[int] = None) -> int:
    """Default rzip chunk cap: 2/3 of RAM (reference src/rzip.c:1007)."""
    r = ramsize or get_ram()
    return r // 3 * 2


def lzma_overhead(dict_size: int) -> int:
    """Per-thread LZMA compressor RAM (reference src/util.c:131)."""
    return int(dict_size * 11.5) + 6 * (1 << 20) + 16384


def zpaq_overhead(zpaq_bs: int, level: int) -> int:
    """reference src/util.c:160-165."""
    base = (1 << zpaq_bs) * (1 << 20)
    extra = {1: 128, 2: 196, 3: 256, 4: 512, 5: 850}.get(level, 512) << 20
    return base + extra


def bzip3_overhead(block_size: int) -> int:
    return 6 * block_size  # reference src/util.c:173


@dataclasses.dataclass
class Plan:
    threads: int
    dict_size: int
    block_bytes: int  # stream buffer (block) size


def negotiate(method: str, threads: int, dict_size: int, chunk_size: int,
              budget: Optional[int] = None,
              stream_bufsize: int = 10 << 20,
              zpaq_bs: int = 6, zpaq_level: int = 4,
              bzip3_block: int = 1 << 26) -> Plan:
    """Reproduce the P7 solver: fit `threads` codec instances in budget.

    Sheds threads down to half, then shrinks the LZMA dictionary, then
    sheds further - same order as src/stream.c:1176-1331.  For zpaq and
    bzip3 the *configured* block size / level feed the overhead model
    (the reference plugs control->zpaq_bs / bzip3_bs into
    setup_overhead, src/util.c:160-173).
    """
    budget = budget if budget is not None else usable_ram()
    if method != "lzma":
        per = {"zpaq": zpaq_overhead(zpaq_bs, zpaq_level),
               "bzip3": bzip3_overhead(bzip3_block)}.get(
            method, stream_bufsize * 2)
        t = threads
        while t > 1 and per * t > budget:
            t -= 1
        return Plan(threads=t, dict_size=dict_size,
                    block_bytes=stream_bufsize)
    d = dict_size
    floor = min(threads, max(1, threads // 2))
    while True:
        t = threads
        while t >= floor:
            if lzma_overhead(d) * t <= budget:
                return Plan(threads=t, dict_size=d,
                            block_bytes=stream_bufsize)
            t -= 1
        if d > (1 << 24):
            d //= 2
        elif floor > 1:
            floor -= 1
        else:
            return Plan(threads=1, dict_size=1 << 24,
                        block_bytes=stream_bufsize)
