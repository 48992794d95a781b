"""Stage spans of the port's host threads.

``stage(name, acc)`` wraps one stage of a thread's work.  It adds the
stage's host milliseconds (``time.perf_counter``) to ``acc[name]`` where
``acc`` is a dict, and opens the ``torch.profiler.record_function`` range
``"lrzt." + name`` while a profiler runs, so that the range lies on the
clock of the device events the profiler records.  With neither it
returns one shared no-op context and calls nothing else: a
``record_function`` costs about 13 us even with no profiler running.

On the calling thread of ``compress_stream`` and ``iter_decompress`` the
stages do not nest and together they cover the call, so each idle gap
of the device inside an operation lies within one stage's range.
``OpStats`` hands the stage milliseconds of one operation to
``Settings.stats_sink``, a dict a chunk; ``timed`` is the pool threads'
counter, which opens no range (the profiler records the calling
thread's).
"""

from __future__ import annotations

import contextlib
import time

import torch

PREFIX = "lrzt."

_NOOP = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


class _Stage:
    __slots__ = ("name", "acc", "range", "t0")

    def __init__(self, name: str, acc):
        self.name, self.acc = name, acc
        self.range = torch.profiler.record_function(PREFIX + name) \
            if _profiling() else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.acc is not None:
            self.acc[self.name] = self.acc.get(self.name, 0.0) + \
                (time.perf_counter() - self.t0) * 1e3
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def stage(name: str, acc):
    """The context of stage ``name``: its milliseconds go to ``acc`` (a
    dict, or None), its range to a running profiler."""
    if acc is None and not _profiling():
        return _NOOP
    return _Stage(name, acc)


def timed(fn, times):
    """``fn`` where ``times`` is None, else ``fn`` wrapped to append each
    call's host milliseconds to the list ``times``: the pool threads'
    counter (``list.append`` is atomic), which opens no range."""
    if times is None:
        return fn

    def run(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            times.append((time.perf_counter() - t0) * 1e3)
    return run


class OpStats:
    """The ``stats_sink`` dicts of one operation (``op``: "compress" or
    "decompress").

    ``main`` gathers the calling thread's stage milliseconds, and
    ``count`` the pool threads' ``backend_ms``, until ``chunk(stats)``
    hands the sink a chunk's dict: ``stats``, ``op``, ``backend_ms`` and
    the stages as ``main_ms``.  ``op_ms`` gathers the operation's own
    stages (set-up, the final digest, the join): the last chunk's dict
    (``last=True``) waits for them, and for the operation's own counters
    (``counters``, such as the hash thread's ``hash_ms``), until
    ``close()``, so the ``main_ms`` values of an operation sum to its
    calling thread's time in its stages.  Without a sink ``main``, ``op_ms`` and ``pool_times()`` are
    None and nothing is kept."""

    def __init__(self, sink, op: str):
        self.sink, self.op = sink, op
        self.main = {} if sink is not None else None
        self.op_ms = {} if sink is not None else None
        self._backend_ms = 0.0
        self._last = None
        self.counters = {}

    def pool_times(self):
        """A list for ``timed``, or None without a sink."""
        return [] if self.sink is not None else None

    def count(self, times) -> None:
        """Add the pool times that ``timed`` put in ``times``."""
        if times:
            self._backend_ms += sum(times)

    def chunk(self, stats: dict, last: bool = False) -> None:
        if self.sink is None:
            return
        stats = dict(stats, op=self.op, backend_ms=self._backend_ms,
                     main_ms=dict(self.main))
        self.main.clear()
        self._backend_ms = 0.0
        if last:
            self._last = stats
        else:
            self.sink(stats)

    def close(self) -> None:
        if self._last is None:
            return
        self._last.update(self.counters)
        self._last["backend_ms"] += self._backend_ms
        ms = self._last["main_ms"]
        for acc in (self.main, self.op_ms):
            for name, v in acc.items():
                ms[name] = ms.get(name, 0.0) + v
        self.sink(self._last)
        self._last = None
