"""The chunk mesh of the port: chunks on a (dp, sp) grid of devices.

Port of ``lrzip_next_tpu/parallel/mesh.py``.  The archive format makes
rzip chunks independent (own window, own CRC), so a batch of consecutive
equal-size chunks runs across the devices of the mesh's dp axis at once,
and the archive equals the single-device one byte for byte.

In the port the dp axis is one ``MatchJob`` a chunk: chunk j of a batch
runs on dp row j, on its first device's stream and worker thread
(``ops/matcher.py``), and its padded chunk stays there for the device
literal encode.  The sp axis splits that job over the row's devices
(``MatchJob(sp_devices=mesh.devices[j, :])``), where the JAX package
shards the chunk's window ``P("dp", "sp")`` and lets XLA insert the
collectives: at stride > 1 each device runs K1 and the row minima on its
slab of anchor rows (whole rows and a halo of one row a side), at stride
1 the fingerprints of its slab of windows; the rows or fingerprints go to
the row's first device, where the global stages run as in a one-device
job (the candidate sort over the chunk, the chains, K9 and the
selection, the read-backs, the host finalize).  So the tokens, and the
archive, do not depend on the mesh's shape.

Left behind, on purpose: the cap, the zero-padded batch rows and the
overflow redo.  The port's ``MatchJob`` reads its record count back and
has no cap (ROADMAP "Cap hints and overflow redos are gone"), so a batch
holds only real chunks and nothing is ever redone.

Why a producer of its own (the mesh branch of ``models/pipeline.
_windows``) and not the lookahead with each job placed on the next card
in turn: the lookahead keeps three jobs live in all, the mesh producer
two batches ahead of the current one, so three jobs on every row of a
mesh; and its stats are the JAX mesh path's (``chains`` counts coarse
chain records), which the tests hold against that path batch by batch.
On one card (a test mesh) the two producers do the same work in another
order.

``shard_blocks`` and ``sharded_match_step`` are the JAX module's
exports, kept as its counterparts and held against them by the tests:
no compress path of either package runs them.

``batches`` counts the ``MeshMatchBatch``es made, under the launch
counters' lock: byte equality alone cannot tell which chunk loop ran.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build
from ..ops.matcher import MatchJob, chain_runs, match_candidates

batches = 0

STATS_KEYS = ("chunk_bytes", "chains", "matches", "match_bytes",
              "literals", "literal_bytes")


class Mesh:
    """A (dp, sp) grid of devices: ``devices`` is a numpy object array of
    ``torch.device``s, ``axis_names`` is ``("dp", "sp")``.  Row j holds
    chunk j of a batch; its sp devices split that chunk's matcher."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    def __repr__(self) -> str:
        return f"Mesh(dp={self.devices.shape[0]}, sp={self.devices.shape[1]})"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, sp) mesh over the first ``n_devices`` of ``devices``, by
    default the squarest factorisation with dp >= sp (8 -> 4 x 2, 4 -> 2 x
    2, 2 -> 2 x 1), as the JAX package's ``make_mesh``: dp rows take a
    batch's chunks, and each row's sp devices split its chunk's matcher
    (``MeshMatchBatch``).

    ``devices`` defaults to every card, ``cuda:0 .. device_count() - 1``
    (CUDA is required then).  An explicit list may name one device more
    than once: that is a test device, the counterpart of the virtual CPU
    devices the JAX package's tests run on (``["cpu"] * 8`` on the CPU,
    ``["cuda:0"] * 2`` on one card), not a way to speed anything up."""
    if devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    n = n_devices or len(devs)
    if not 0 < n <= len(devs):
        raise ValueError(f"a mesh of {n} devices over {len(devs)} given")
    if dp is None:
        dp = 1
        for f in range(int(np.sqrt(n)), 0, -1):
            if n % f == 0:
                dp = n // f
                break
    if n % dp:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(dp, n // dp))


def shard_blocks(n_blocks: int, n_shards: int) -> list:
    """Round-robin assignment of backend blocks to shards (the dp analog
    of the reference's round-robin compthread dispatch,
    src/stream.c:1836-1874).  A parity counterpart: no compress path runs
    it."""
    return [list(range(s, n_blocks, n_shards)) for s in range(n_shards)]


def sharded_match_step(mesh: Mesh):
    """The matcher's candidate stages over a (B, L) uint8 batch of chunks,
    B a multiple of dp (the JAX package's ``sharded_match_step``).

    Row b runs on its dp row (the rows split into dp contiguous blocks,
    as a "dp"-sharded batch does): ``match_candidates`` with the window's
    fingerprints split over the row's sp devices, as a ``MatchJob``
    splits them, and ``chain_runs`` on the row's first device.  Returns
    ``(cand, ok, coverage)``: int32 and bool (B, L) tensors on
    ``mesh.devices[0, 0]``, padded past the last window with -1 and
    False, and the total count of ok positions as an int.  A parity
    counterpart: no compress path runs it."""
    dp = mesh.devices.shape[0]

    def step(batch) -> tuple:
        batch = torch.as_tensor(batch)
        b_rows, length = batch.shape
        if b_rows % dp:
            raise ValueError(f"a batch of {b_rows} rows over dp={dp}")
        per = b_rows // dp
        home = mesh.devices[0, 0]
        cands, oks = [], []
        total = 0
        for b in range(b_rows):
            row = mesh.devices[b // per]
            cand, ok = match_candidates(batch[b].to(row[0]), sp_devices=row)
            chain_runs(cand, ok)
            total += int(ok.sum())
            pad = length - cand.shape[0]
            cands.append(torch.nn.functional.pad(cand, (0, pad),
                                                 value=-1).to(home))
            oks.append(torch.nn.functional.pad(ok, (0, pad),
                                               value=False).to(home))
        return torch.stack(cands), torch.stack(oks), total

    return step


def pipeline_mesh(device, use_mesh: Optional[bool] = None
                  ) -> Optional[Mesh]:
    """The mesh of the compress path on ``device``: None for the CPU and
    below two cards (the single-device lookahead then), else the JAX
    package's ``make_mesh()`` over every card, the squarest (dp, sp)
    shape with dp >= sp (2 -> 2 x 1, 4 -> 2 x 2, 8 -> 4 x 2): dp rows take
    chunks, and a row's sp devices split each of its chunks.  On four
    cards it compresses at the pace of every card on dp (n x 1), within
    the spread of their runs (``tools/torch_mesh_shapes.py``): the main
    thread's work a chunk sets that pace, not the rows.

    ``use_mesh`` is the setting of that name.  Left to choose (None), the
    mesh is taken only for a device named without an index (``"cuda"``):
    a caller who names one card (``"cuda:1"``) keeps its chunks there
    unless ``use_mesh=True`` asks for every card."""
    if device is None or torch.device(device).type != "cuda" \
            or torch.cuda.device_count() < 2 or use_mesh is False:
        return None
    if use_mesh is None and torch.device(device).index is not None:
        return None
    return make_mesh()


class MeshMatchBatch:
    """(dp, sp)-sharded matcher dispatch for a batch of at most dp
    equal-size chunks (the JAX package's ``MeshMatchBatch``).

    Construction queues one ``MatchJob`` a chunk, chunk j on dp row j:
    on ``mesh.devices[j, 0]``, split over the row's sp devices
    (``sp_devices=mesh.devices[j, :]``), and returns.  ``collect(i)`` returns chunk
    i's tokens and fills ``stats[i]`` with the JAX mesh path's counters
    (``chains`` counts the coarse chain records at stride > 1, the runs at
    stride 1); ``job_for(i)`` is chunk i's job, whose ``dev`` feeds the
    device literal encode as in the single-device loop.  A trivial chunk
    never reaches a device (``MatchJob`` makes its one literal token)."""

    def __init__(self, mesh: Mesh, chunks: list, stride: int):
        global batches
        dp = mesh.devices.shape[0]
        if not 0 < len(chunks) <= dp:
            raise ValueError(f"{len(chunks)} chunks for a batch of dp={dp}")
        if any(len(c) != len(chunks[0]) for c in chunks):
            raise ValueError("a mesh batch takes equal-size chunks")
        self.stride = stride
        self.jobs = [MatchJob(np.asarray(c, dtype=np.uint8), stride,
                              mesh.devices[j, 0],
                              sp_devices=list(mesh.devices[j]))
                     for j, c in enumerate(chunks)]
        self.stats: list = [{} for _ in chunks]
        with _build.count_lock:
            batches += 1

    def job_for(self, i: int) -> MatchJob:
        return self.jobs[i]

    def collect(self, i: int):
        """Tokens (kinds, lengths, dists) of chunk i."""
        job = self.jobs[i]
        tokens = job.collect()
        stats = {k: job.stats[k] for k in STATS_KEYS}
        if not job.trivial and self.stride > 1:
            stats["chains"] = job.coarse_chains
        self.stats[i] = stats
        return tokens
