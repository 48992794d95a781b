"""Device literal encode and decode of one chunk.

Port of ``lrzip_next_tpu/models/device_path.py``.

Encode: the chunk already on the device (``MatchJob.dev``, padded to its bucket)
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

Decode: ``DeviceLitPlane`` parses one ``CTYPE_RANS`` payload on the host
(every malformed header, table or length raises ``ValueError``), uploads
the words, the states and the table, and queues K7
(``rans.decode_arrays``).  ``check()`` raises unless every final state is
2^16; ``literals()`` reads the first ``n`` bytes of the plane back (the
host path of a chunk whose tokens reach into earlier chunks).

``replay_device`` builds the chunk on the device from the plane: the
native runtime flattens the tokens into a piece plan on the host (a few
records a token), and the ragged replay kernels of ``ops/replay_ragged``
(K8a, K8c, and K8b for a layered plan) copy the pieces; the chunk is read
back once, in slices that a sink (the decode's CRC and archive hash)
takes as they land (``read_back``).  Tokens that the runtime cannot
flatten (byte-RLE chains) are resolved by pointer doubling in plain
PyTorch (``ops/replay``), and so is every chunk where the native runtime
is missing.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..ops import rans
from ..ops.matcher import StageClock, require_runtime
from ..ops.replay import expand_tokens, resolve_bytes
from ..ops.replay_ragged import replay_pieces_layered, replay_pieces_ragged
from ..ops.streampack import pack_stream
from ..utils.spans import stage

# replays that no piece plan could take and that pointer doubling did
doubling_replays = 0
_doubling_lock = threading.Lock()


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
            self.clock.sync()
            self.stage_ms = self.clock.ms()
        return rans.assemble_payload(*host, self.n_lit, self.ctx_bits,
                                     self.t_len)


class DeviceLitPlane:
    """The decoded literal plane of one rANS block, on ``device``."""

    def __init__(self, payload: bytes, u_len: int, device):
        n, ctx_bits, k, t_len, freqs, states, words = rans.parse_payload(
            payload, u_len)
        self.n = n
        self.plane = None
        if n == 0:
            return
        self.plane, self.xf = rans.decode_arrays(
            *rans.upload(freqs, states, words, device), n, ctx_bits, k,
            t_len)

    def check(self) -> None:
        if self.n and not rans.states_final(self.xf):
            raise ValueError("corrupt rans stream (final state check)")

    def literals(self) -> np.ndarray:
        """Host copy of the ``n`` literal bytes (one read-back)."""
        if self.plane is None:
            return np.zeros(0, dtype=np.uint8)
        return self.plane[:self.n].cpu().numpy()


def _token_columns(kinds: np.ndarray, lengths: np.ndarray,
                   dists: np.ndarray):
    """(lengths, dists, is_match, literal lengths, reaches back) of a
    chunk's tokens; the last is True when a match starts before the
    chunk."""
    lengths = np.asarray(lengths, dtype=np.int64)
    d = np.asarray(dists, dtype=np.int64)
    is_match = np.asarray(kinds) == 1
    starts = np.cumsum(lengths) - lengths
    reaches_back = bool((d[is_match] > starts[is_match]).any())
    return lengths, d, is_match, np.where(is_match, 0, lengths), reaches_back


def replay_device(kinds: np.ndarray, lengths: np.ndarray,
                  dists: np.ndarray, plane: DeviceLitPlane, device,
                  main: Optional[dict] = None,
                  sink: Optional[Callable] = None) -> Optional[bytes]:
    """Token replay on ``device`` from the literal plane that lies there.

    Returns the chunk bytes, or None when the tokens reach back before
    the chunk (cross-chunk history lives on the host side).  ``sink``,
    where given, takes the chunk's bytes in order, a slice at a time as
    the read-back lands (``read_back``).  ``main`` takes the stage
    milliseconds (``decompress.flatten``, ``decompress.replay_launch``,
    ``decompress.readback_wait``, and the sink's ``decompress.crc``).
    """
    with stage("decompress.flatten", main):
        lengths, d, is_match, lit_lens, reaches_back = _token_columns(
            kinds, lengths, dists)
        if int(lengths.sum()) == 0:
            return b""
        if reaches_back:
            return None  # cross-chunk reach: host path owns history
        if plane.n != int(lit_lens.sum()):
            raise ValueError("literal stream length mismatch")
        literals = plane.plane if plane.plane is not None \
            else torch.zeros(1, dtype=torch.uint8, device=device)
    res = _replay(kinds, lengths, d, is_match, lit_lens, literals, main)
    return read_back(res, plane, sink, main)


# The read-back's slice: each lands in pinned host memory and goes on to
# the sink as soon as its copy is done.
READBACK_SLICE = 32 << 20


def read_back(res: torch.Tensor, plane: DeviceLitPlane,
              sink: Optional[Callable] = None,
              main: Optional[dict] = None) -> bytes:
    """The bytes of the replayed chunk ``res`` after ``plane.check()``.

    On CUDA the chunk comes back into one pinned buffer (PyTorch's
    caching host allocator keeps it for the next chunk of its size) in
    ``READBACK_SLICE`` slices, copied on a stream of their own after the
    replay's last kernel; each slice goes to ``sink`` as soon as its copy
    is done, and one host copy makes the bytes.  On the CPU the slices
    are views of ``res``.  The slices' waits, the check and the copy are
    ``decompress.readback_wait``, the sink's calls ``decompress.crc``."""
    n = int(res.shape[0])
    events = []
    with stage("decompress.readback_wait", main):
        if res.device.type == "cuda":
            host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            copy = torch.cuda.Stream(res.device)
            copy.wait_stream(torch.cuda.current_stream(res.device))
            res.record_stream(copy)
            with torch.cuda.stream(copy):
                for a in range(0, n, READBACK_SLICE):
                    host[a:a + READBACK_SLICE].copy_(
                        res[a:a + READBACK_SLICE], non_blocking=True)
                    events.append(torch.cuda.Event())
                    events[-1].record(copy)
        else:
            host = res
        view = host.numpy()
    for i, a in enumerate(range(0, n, READBACK_SLICE)):
        if events:
            with stage("decompress.readback_wait", main):
                events[i].synchronize()
        if sink is not None:
            with stage("decompress.crc", main):
                sink(view[a:a + READBACK_SLICE])
    with stage("decompress.readback_wait", main):
        plane.check()
        return view.tobytes()


def replay_tokens_device_array(kinds: np.ndarray, lengths: np.ndarray,
                               dists: np.ndarray, lit_dev: torch.Tensor
                               ) -> Optional[torch.Tensor]:
    """Token replay -> the uint8 chunk on ``lit_dev``'s device (or None
    when a match reaches before the chunk)."""
    lengths, d, is_match, lit_lens, reaches_back = _token_columns(
        kinds, lengths, dists)
    if int(lengths.sum()) == 0:
        return torch.zeros(0, dtype=torch.uint8, device=lit_dev.device)
    if reaches_back:
        return None
    if int(lit_dev.shape[0]) < int(lit_lens.sum()):
        # a short literal plane would replay wrong bytes
        raise ValueError("literal stream length mismatch")
    return _replay(kinds, lengths, d, is_match, lit_lens, lit_dev)


def _replay(kinds: np.ndarray, lengths: np.ndarray, d: np.ndarray,
            is_match: np.ndarray, lit_lens: np.ndarray,
            lit_dev: torch.Tensor, main: Optional[dict] = None
            ) -> torch.Tensor:
    """A layered piece plan first (matches whose expansion would multiply
    the plan become copies of finished output, resolved in later passes),
    then the flat plan, then pointer doubling: for byte-RLE chains, which
    neither plan expresses, and on the CPU where the native runtime,
    which builds both plans, is missing.  Each pointer-doubling replay
    adds one to ``doubling_replays``.  ``main`` takes the stage
    milliseconds of the flatten and of the replay's launches."""
    global doubling_replays
    require_runtime(lit_dev.device)
    out_len = int(lengths.sum())
    if runtime.available():
        with stage("decompress.flatten", main):
            lay = runtime.flatten_replay_layered(kinds, lengths, d)
            flat = runtime.flatten_replay(kinds, lengths, d) \
                if lay is None else None
        with stage("decompress.replay_launch", main):
            if lay is not None:
                pl_, ps_, py_, nl = lay
                if nl == 0:
                    return replay_pieces_ragged(pl_, ps_, lit_dev, out_len)
                return replay_pieces_layered(pl_, ps_, py_, nl, lit_dev,
                                             out_len)
            if flat is not None:
                return replay_pieces_ragged(flat[0], flat[1], lit_dev,
                                            out_len)
    with stage("decompress.replay_launch", main):
        with _doubling_lock:
            doubling_replays += 1
        dev = lit_dev.device
        src, lit_idx = expand_tokens(
            torch.from_numpy(lengths).to(dev),
            torch.from_numpy(is_match).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(np.cumsum(lit_lens) - lit_lens).to(dev))
        return resolve_bytes(src, lit_idx, lit_dev)
