"""Chunk-parallel compression across processes on ``torch.distributed``.

Port of ``lrzip_next_tpu/parallel/distributed.py``.  The .lrz format makes
scale-out exact: rzip chunks are independent (own window, own CRC, own
eof flag), so processes compress disjoint chunk ranges and the archive is
the ordered concatenation.

1. every process calls ``init_distributed(coordinator, n, rank)``: a
   ``torch.distributed.TCPStore`` at the coordinator (rank 0 serves it)
   and a gloo process group on it;
2. chunks are assigned in contiguous ranges; each process compresses its
   chunks to self-contained byte strings (``compress_chunk_blob``);
3. rank 0 gathers the blobs through the store (``kv_gather_blobs``) and
   writes the magic, the chunks in order and the hash.

The exchange is host bytes, so gloo and the store suffice; the JAX
package uses no device collective either.  Blobs cross the wire as
``(chunk index, length, bytes)`` records, never pickled, so a peer's
bytes are never run as code.  No archive byte depends on the wire.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..models import pipeline, rzip_host
from ..ops.matcher import require_runtime, rzip_encode_chunk
from ..utils.hashing import ArchiveHash

# the store of init_distributed (what jax.distributed's client is to the
# JAX package); None until a multi-process init
_store = None
# gathers made so far in this process, by tag: every rank makes the same
# gathers in the same order, so the counts agree across ranks
_generations: dict = {}

_RECORD = struct.Struct("<QQ")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Join a job of ``num_processes`` processes coordinated at
    ``coordinator`` (``host:port``; rank 0 serves the store there) and
    return the world size.  With one process or none it does nothing and
    returns 1."""
    global _store
    if not num_processes or num_processes <= 1:
        return 1
    import torch.distributed as dist
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=timedelta(seconds=300))
    dist.init_process_group("gloo", store=store, rank=process_id,
                            world_size=num_processes)
    _store = store
    _generations.clear()
    return dist.get_world_size()


def _frame(blobs) -> bytes:
    return b"".join(_RECORD.pack(ci, len(blob)) + bytes(blob)
                    for ci, blob in blobs)


def _unframe(buf: bytes) -> list:
    out, pos = [], 0
    while pos < len(buf):
        if pos + _RECORD.size > len(buf):
            raise ValueError("truncated chunk record in a gathered blob")
        ci, n = _RECORD.unpack_from(buf, pos)
        pos += _RECORD.size
        if pos + n > len(buf):
            raise ValueError("truncated chunk bytes in a gathered blob")
        out.append((ci, buf[pos:pos + n]))
        pos += n
    return out


def kv_gather_blobs(blobs, n_hosts: int, host: int,
                    timeout_ms: int = 600_000, tag: str = "gather"):
    """Ordered gather of each process's ``[(chunk index, bytes), ...]``
    over the store of ``init_distributed``: rank 0 blocks until every
    rank's key is present and returns the lists in rank order, the others
    return None (the control-plane analog of the reference's
    ordered-writer ticket, P2, src/stream.c:87-89).  Raises
    ``RuntimeError`` before ``init_distributed``.

    The keys are ``lrz/{tag}/{generation}/{host}``, the generation
    counting this process's earlier gathers under ``tag``: the store
    overwrites a key without complaint (the JAX package's key-value store
    refuses), so a second gather in one group must not find the first
    one's keys.  Rank 0 deletes each generation's keys once read."""
    if _store is None:
        raise RuntimeError(
            "torch.distributed is not initialised; call init_distributed "
            "or pass an explicit gather callback")
    gen = _generations.get(tag, 0)
    _generations[tag] = gen + 1
    keys = [f"lrz/{tag}/{gen}/{h}" for h in range(n_hosts)]
    _store.set(keys[host], _frame(blobs))
    if host != 0:
        return None
    _store.wait(keys, timedelta(milliseconds=timeout_ms))
    gathered = [_unframe(_store.get(k)) for k in keys]
    for k in keys:
        _store.delete_key(k)
    return gathered


def chunk_assignment(n_chunks: int, n_hosts: int, host: int) -> List[int]:
    """Contiguous block assignment keeps I/O sequential per host."""
    per = (n_chunks + n_hosts - 1) // n_hosts
    lo = host * per
    return list(range(lo, min(lo + per, n_chunks)))


def compress_chunk_blob(data: np.ndarray, eof: bool,
                        settings: pipeline.Settings,
                        device="cuda") -> bytes:
    """One chunk as its self-contained on-disk byte string: the tokens of
    a ``MatchJob`` on ``device`` (``None``: the host matcher, the JAX
    package's ``use_tpu=False``), the literals through the host codecs
    (no job is handed on, as the JAX blob passes none)."""
    require_runtime(device)
    dev = None if device is None else resolve_device(device)
    chunk = np.asarray(data, dtype=np.uint8)
    tokens = rzip_host.rzip_encode_chunk(chunk) if dev is None else \
        rzip_encode_chunk(chunk, settings.resolved_anchor_stride(), dev)
    buf = io.BytesIO()
    with ThreadPoolExecutor(max_workers=settings.resolved_threads()) as pool:
        pipeline.ChunkWriter(buf, settings, pool).add(chunk, tokens,
                                                      last=eof)
    return buf.getvalue()


def compress_distributed(data: np.ndarray, out,
                         settings: Optional[pipeline.Settings] = None,
                         n_hosts: int = 1, host: int = 0, gather=None,
                         device="cuda") -> Optional[int]:
    """Chunk-parallel compression across processes; rank ``host`` of
    ``n_hosts`` compresses its chunks on ``device`` (chunks are planned
    with the device cap unless ``device`` is None, as ``compress_stream``
    plans them).

    ``gather(my_blobs) -> [blobs of rank 0, blobs of rank 1, ...]`` is
    the exchange (tests inject a local one; with several hosts and none
    given, ``kv_gather_blobs``).  Rank 0 writes the archive and returns
    its byte count; the others return None.  ``RuntimeError`` when a
    chunk is missing from the gather; ``ValueError`` for a passphrase
    (the distributed archive is never encrypted)."""
    require_runtime(device)
    dev = None if device is None else resolve_device(device)
    settings = dataclasses.replace(settings or pipeline.Settings(),
                                   use_tpu=dev is not None)
    if settings.passphrase is not None:
        raise ValueError("compress_distributed writes no encrypted archive")
    data = np.asarray(data, dtype=np.uint8)
    total = len(data)
    bounds = pipeline.chunk_bounds(total, settings)
    blobs = []
    for ci in chunk_assignment(len(bounds), n_hosts, host):
        p0, cs = bounds[ci]
        blobs.append((ci, compress_chunk_blob(
            data[p0:p0 + cs], ci == len(bounds) - 1, settings, dev)))
    if gather is None and n_hosts > 1:
        gather = lambda my: kv_gather_blobs(my, n_hosts, host)  # noqa: E731
    all_blobs = [blobs] if gather is None else gather(blobs)
    if host != 0:
        return None
    # ordered commit: chunk index order, exactly once
    by_index = {}
    for host_blobs in all_blobs:
        for ci, blob in host_blobs:
            by_index[ci] = blob
    if sorted(by_index) != list(range(len(bounds))):
        raise RuntimeError("missing chunks in distributed gather")
    magic = pipeline.magic_header(settings, total)
    out.write(magic.encode())
    written = magic.header_len
    for ci in range(len(bounds)):
        out.write(by_index[ci])
        written += len(by_index[ci])
    if magic.hash_code:
        hasher = ArchiveHash(magic.hash_code)
        hasher.update(data)
        digest = hasher.digest()
        out.write(digest)
        written += len(digest)
    return written
