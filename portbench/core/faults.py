"""Faults planted under the timed path, for the control and the tests.

None of these runs in a benchmark run: ``run.py --fault NAME`` and the
tests under ``portbench/tests`` select one, and it is planted after the
set-up, under the window's operations only.  Each breaks one guarantee
that the configurations state, so that ``correct`` has to come out
false:

- ``control``: a lossy program, the control of the comparison: one byte
  of every 64 MiB of the input is altered before it is compressed, and
  one byte of every decompressed file;
- ``answer``: an answer altered where it is produced: one byte of every
  decompressed file, and the last byte of every archive (its MD5);
- ``token``: a token altered where it is produced: the first match of
  every chunk points one byte further back;
- ``stale``: a step that returns its state unchanged: compress returns
  its input as the archive, decompress the archive as the output;
- ``half``: half of the batch left out: compress takes the first half of
  the input, decompress returns the first half of its output;
- ``exchange``: the exchange between cards left out: the anchor rows of
  every slab but a chunk's first come back as zeros (``split_stage``).
"""

from __future__ import annotations

import numpy as np

NAMES = ("control", "answer", "token", "stale", "half", "exchange")


def _flip(buf: bytes, positions) -> bytes:
    out = bytearray(buf)
    for p in positions:
        if 0 <= p < len(out):
            out[p] ^= 0x5A
    return bytes(out)


def apply(name: str, program) -> None:
    """Plant fault ``name`` in ``program`` (a ``runner.Program``)."""
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
    compress, decompress = program.compress, program.decompress
    if name == "control":
        def lossy(data):
            data = np.array(data, copy=True)
            data[(np.arange(0, len(data), 64 << 20) + 12345) % max(
                len(data), 1)] ^= 0x5A
            return compress(data)
        program.compress = lossy
        program.decompress = lambda a: _flip(decompress(a), [777])
    elif name == "answer":
        program.compress = lambda d: (lambda a: _flip(a, [len(a) - 1]))(
            compress(d))
        program.decompress = lambda a: _flip(decompress(a), [777])
    elif name == "stale":
        program.compress = lambda d: bytes(np.asarray(d, np.uint8))
        program.decompress = lambda a: bytes(a)
    elif name == "half":
        program.compress = lambda d: compress(d[:len(d) // 2])
        program.decompress = lambda a: (lambda o: o[:len(o) // 2])(
            decompress(a))
    elif name == "token":
        from lrzip_next_tpu_torch.models import pipeline
        split = pipeline.split_long_runs

        def shifted(kinds, lengths, dists):
            kinds, lengths, dists = split(kinds, lengths, dists)
            m = np.flatnonzero(np.asarray(kinds) == 1)
            if len(m):
                dists = np.array(dists, copy=True)
                dists[m[0]] += 1
            return kinds, lengths, dists
        pipeline.split_long_runs = shifted
    elif name == "exchange":
        from lrzip_next_tpu_torch.ops import matcher
        stage = matcher.split_stage

        def no_exchange(dev, stride, devices, streams=None, clock=None):
            out, clocks = stage(dev, stride, devices, streams, clock)
            if len(devices) > 1:
                for t in out:
                    t[t.shape[0] // len(devices):] = 0
            return out, clocks
        matcher.split_stage = no_exchange
