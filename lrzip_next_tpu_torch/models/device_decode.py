"""Decompress an archive into device memory.

Port of ``lrzip_next_tpu/models/device_decode.py``.  ``decompress``
returns host bytes; a consumer that wants the chunks on the card (a data
loader, a device pipeline) would pay a second upload.  Here the chunks
are built on the device and stay there:

- a rANS literal block (the device encode path's block type) decodes on
  the device (``DeviceLitPlane``, kernel K7): the literal plane never
  exists on the host;
- a host-codec literal block (lzma, zstd, gzip, ...) decodes on the pool
  threads and is uploaded once;
- either way the tokens replay through
  ``device_path.replay_tokens_device_array`` (kernels K8a-c).

Pass ``verify=True`` to read the chunks back and check the stored
per-chunk CRCs, at the cost of the read-back this entry point exists to
avoid.
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..format.container import read_chunk_header
from ..ops.matcher import require_runtime
from ..utils.hashing import crc32_combine
from .device_path import replay_tokens_device_array
from .pipeline import Settings, _ChunkDecodeJob, check_chunk_crc, \
    parse_tokens, read_archive_head


def decompress_to_device(data, settings: Optional[Settings] = None,
                         verify: bool = False, device="cuda"
                         ) -> List[torch.Tensor]:
    """Decompress ``data`` (archive bytes or a binary file object) to a
    list of per-chunk ``torch.uint8`` tensors on ``device``.  Raises
    ``ValueError`` on cross-chunk archives (their history walk is
    host-ordered; the default chunk-local format always qualifies)."""
    require_runtime(device)
    dev = resolve_device(device)
    settings = settings or Settings()
    fd = io.BytesIO(data) if isinstance(
        data, (bytes, bytearray, memoryview)) else data
    magic, crypto, cfg = read_archive_head(fd, settings)
    chunks = []
    stored_crcs = []
    with ThreadPoolExecutor(max_workers=settings.resolved_threads()) as pool:
        while True:
            hdr = read_chunk_header(fd, encrypted=crypto is not None)
            if hdr is None:
                break
            job = _ChunkDecodeJob(fd, hdr, magic, cfg, pool, dev, crypto)
            fd.seek(job.end_offset)
            stream0, stream1 = job.streams()
            kinds, lengths, dists, stored_crc = parse_tokens(
                stream0, hdr.chunk_bytes)
            plane = job.device_plane
            job = None
            if plane is not None:
                # the replay sizes its plan from the tokens: the plane
                # must hold exactly their literals
                lit_total = int(np.asarray(lengths)[
                    np.asarray(kinds) == 0].sum())
                if plane.n != lit_total:
                    raise ValueError("literal stream length mismatch")
                lit_dev = plane.plane if plane.plane is not None \
                    else torch.zeros(1, dtype=torch.uint8, device=dev)
            else:
                lit_dev = torch.frombuffer(
                    bytearray(stream1 if stream1 else b"\0"),
                    dtype=torch.uint8).to(dev)
            out = replay_tokens_device_array(kinds, lengths, dists, lit_dev)
            del lit_dev
            if out is None:
                raise ValueError(
                    "archive has cross-chunk matches: device "
                    "decode needs chunk-local distances")
            if plane is not None:
                plane.check()
                plane = None    # the literal plane is needed no further
            chunks.append(out)
            stored_crcs.append(stored_crc)
            if hdr.eof:
                break
    if verify:
        cum = 0
        for arr, sc in zip(chunks, stored_crcs):
            b = arr.cpu().numpy()
            cum = crc32_combine(cum, check_chunk_crc(b, sc, cum), len(b))
    return chunks
