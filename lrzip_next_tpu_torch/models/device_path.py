"""Device literal encode: the chunk's literal stream never leaves the card.

Port of the encode half of ``lrzip_next_tpu/models/device_path.py``.
The chunk already on the device (``MatchJob.dev``, padded to its bucket)
goes through

1. the literal mask: +1 at every literal token's start, -1 past its
   end, running sum > 0 (plain PyTorch scatter and ``cumsum``, as the
   JAX package computes it outside any kernel);
2. K3 (``streampack.pack_stream``): the masked bytes, compacted into the
   zero-padded literal block;
3. the rANS encode of ``ops/rans.py`` (K4, quantizing, K5, K6).

``payload()`` reads back the word count, then the frequency table, the
lane states and the packed words, and assembles the ``CTYPE_RANS``
payload on the host.  On CUDA, ``stage_ms`` holds CUDA-event
milliseconds of each stage.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import rans
from ..ops.matcher import StageClock
from ..ops.streampack import pack_stream


def literal_spans(kinds: np.ndarray, lengths: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Chunk-coordinate (starts, ends) of literal tokens + total bytes."""
    lengths = np.asarray(lengths, dtype=np.int64)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    is_lit = np.asarray(kinds) == 0
    ls = starts[is_lit]
    le = ends[is_lit]
    return ls, le, int((le - ls).sum())


def literal_mask(npos: int, starts: np.ndarray, ends: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """(npos,) bool: True inside the literal spans.  Spans are disjoint
    and sorted, so the running sum is only ever 0 or 1; boundaries at or
    past ``npos`` are dropped (the JAX scatter's ``mode="drop"``)."""
    idx = np.concatenate([starts, ends]).astype(np.int64)
    val = np.concatenate([np.ones(len(starts), np.int32),
                          np.full(len(ends), -1, np.int32)])
    keep = idx < npos
    delta = torch.zeros(npos, dtype=torch.int32, device=device)
    delta.index_add_(0, torch.from_numpy(idx[keep]).to(device),
                     torch.from_numpy(val[keep]).to(device))
    return torch.cumsum(delta, 0) > 0


class DeviceLiteralEncode:
    """The device literal encode of one chunk.

    Construction queues mask -> K3 -> rANS encode on ``dev``, the chunk
    on its device; ``payload()`` reads back and assembles the payload.
    """

    def __init__(self, dev: torch.Tensor, kinds: np.ndarray,
                 lengths: np.ndarray, ctx_bits: int):
        ls, le, n_lit = literal_spans(kinds, lengths)
        self.n_lit = n_lit
        self.ctx_bits = ctx_bits
        self.stage_ms: dict = {}
        self.lanes = 0
        if n_lit == 0:
            return
        self.clock = StageClock(dev.device)
        self.clock.mark("start")
        mask = literal_mask(int(dev.shape[0]), ls, le, dev.device)
        self.clock.mark("mask")
        k, t_len, _ = rans.plan(n_lit)
        self.lanes = k
        lit, _ = pack_stream(dev, mask, k * t_len)
        self.clock.mark("pack_literals")
        (self.freqs, self.states, self.words, self.n_words,
         self.t_len) = rans.encode_arrays(lit, n_lit, ctx_bits, self.clock)

    def payload(self) -> Optional[bytes]:
        """Readback + wire assembly; None for an empty literal stream."""
        if self.n_lit == 0:
            return None
        host = rans.read_back(self.freqs, self.states, self.words,
                              self.n_words)
        self.clock.mark("readback")
        if self.clock.device.type == "cuda":
            torch.cuda.synchronize(self.clock.device)
            self.stage_ms = self.clock.ms()
        return rans.assemble_payload(*host, self.n_lit, self.ctx_bits,
                                     self.t_len)
