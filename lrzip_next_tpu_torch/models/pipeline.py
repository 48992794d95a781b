"""Archive pipeline of the port: the single-device chunk loop.

A copy of the single-device path of
``lrzip_next_tpu.models.pipeline.compress_stream`` (its ``TpuMatchJob``
loop) and of ``_compress_chunk``, built on the shared helpers: chunk
planning, the container, the token stream, the backend codecs, the lz4
gate, the cross-chunk splice and the hasher.  Each chunk goes through
the GPU matcher (``ops/matcher.py``); with ``method="rans"`` and no
filter its literal stream is then rANS-encoded on the device from the
chunk the matcher uploaded (``models/device_path.py``), and only the
payload comes back.  Every other method compresses the literals on the
host.

The settings are copied with ``use_tpu=True`` so that chunk planning
(the 256 MiB device chunk cap) matches the JAX package's device path,
which makes the archives equal.  Not ported, and raising
``NotImplementedError``: the dense stride-1 matcher, ``-U`` over several
chunks and the multi-device mesh.  The one-chunk lookahead is left out:
each chunk runs to its end before the next starts.
"""

from __future__ import annotations

import dataclasses
import io
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Optional

import numpy as np

from lrzip_next_tpu.backends import compress_block, ctype_for_method
from lrzip_next_tpu.backends.rans_codec import ctx_bits_for_level
from lrzip_next_tpu.format import constants as C
from lrzip_next_tpu.format.container import Block, write_chunk
from lrzip_next_tpu.format.tokens import encode_token_stream, \
    split_long_runs
from lrzip_next_tpu.models import pipeline as shared
from lrzip_next_tpu.models import rzip_host
from lrzip_next_tpu.models.pipeline import Settings
from lrzip_next_tpu.ops.filters import apply_filter
from lrzip_next_tpu.utils.hashing import ArchiveHash, stored_crc_int

from ..device import resolve_device
from ..ops.matcher import MatchJob, default_anchor_stride
from .device_path import DeviceLiteralEncode


def anchor_stride(settings: Settings) -> int:
    return settings.anchor_stride or \
        default_anchor_stride(settings.resolved_rzip_level())


def _check_supported(settings: Settings, n_chunks: int) -> None:
    """Raise for the settings whose device path is not ported yet."""
    if anchor_stride(settings) == 1:
        raise NotImplementedError(
            "anchor_stride=1 (the dense stride-1 matcher, kernel K9) is not "
            "ported yet; see ROADMAP.md")
    if settings.unlimited and n_chunks > 1:
        raise NotImplementedError(
            "unlimited=True over several chunks is not ported yet; see "
            "ROADMAP.md")
    if settings.use_mesh and n_chunks > 1:
        raise NotImplementedError(
            "use_mesh=True (the multi-device chunk mesh) is not ported yet; "
            "see ROADMAP.md")


def compress_stream(data, out: BinaryIO, settings: Optional[Settings] = None,
                    device="cuda") -> int:
    """Compress a whole input to an .lrz archive on ``device``; returns the
    bytes written."""
    dev = resolve_device(device)
    settings = dataclasses.replace(settings or Settings(), use_tpu=True)
    data = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(
            data, dtype=np.uint8)
    total = len(data)
    try:
        ctype = ctype_for_method(settings.method)
    except KeyError:
        raise ValueError(f"unknown compression method {settings.method!r}")
    chunk_sizes = shared.plan_chunks(total, settings)
    _check_supported(settings, len(chunk_sizes))
    stride = anchor_stride(settings)

    crypto = None
    if settings.passphrase is not None:
        from lrzip_next_tpu.crypto import CryptoContext, keys as ckeys
        exp = settings.costfactor_exp or ckeys.default_costfactor_exp()
        crypto = CryptoContext.fresh(settings.passphrase,
                                     settings.enc_code or 1,
                                     costfactor_exp=exp)

    magic = shared._magic_for(settings, total, eof_known=True)
    if crypto is not None:
        magic.enc_code = crypto.enc_code
        magic.salt = crypto.salt
    out.write(magic.encode())
    written = magic.header_len

    hasher = ArchiveHash(magic.hash_code) if magic.hash_code else None
    cfg = shared._backend_cfg(settings)

    # cross-chunk matching: distances may reach into earlier chunks, so
    # the chunk byte width covers the whole file
    xindex = None
    w_override = None
    if settings.cross_chunk and not settings.unlimited and \
            len(chunk_sizes) > 1:
        from lrzip_next_tpu.models.crosschunk import CrossChunkIndex
        xindex = CrossChunkIndex()
        w_override = C.chunk_byte_width(total)

    p0 = 0
    with ThreadPoolExecutor(max_workers=settings.resolved_threads()) as pool:
        for ci, csize in enumerate(chunk_sizes):
            chunk = np.asarray(data[p0:p0 + csize])
            job = MatchJob(chunk, stride, dev)
            tokens = job.collect()
            if xindex is not None:
                from lrzip_next_tpu.models.crosschunk import \
                    find_cross_matches, splice_cross_matches
                max_dist = (1 << (8 * w_override)) - 1
                cross = find_cross_matches(data, xindex, p0, csize,
                                           max_dist)
                tokens = splice_cross_matches(*tokens, cross, p0)
                xindex.add_chunk(chunk, p0)
            written += _compress_chunk(
                out, chunk, ci == len(chunk_sizes) - 1, ctype, cfg,
                settings, pool, tokens, job, crypto, w_override)
            if hasher is not None:
                hasher.update(chunk)
            if settings.stats_sink is not None:
                settings.stats_sink(dict(job.stats, chunk=ci))
            if settings.progress:
                settings.progress("rzip", p0 + csize, total)
            p0 += csize
    if hasher is not None:
        digest = hasher.digest()
        if crypto is not None:
            digest = crypto.encrypt_block(digest, crypto.salt_pass)
        out.write(digest)
        written += len(digest)
    return written


def _device_literal_block(job: MatchJob, chunk: np.ndarray, kinds, lengths,
                          settings: Settings) -> Optional[Block]:
    """The chunk's literal block from the device rANS encode: rANS when
    the payload is smaller than the literals, else the raw literals;
    None when the chunk has no literals."""
    enc = DeviceLiteralEncode(job.dev, kinds, lengths,
                              ctx_bits_for_level(settings.compression_level))
    payload = enc.payload()
    job.stats["literal_ms"] = enc.stage_ms
    job.stats["literal_lanes"] = enc.lanes
    if payload is None:
        return None
    if len(payload) < enc.n_lit:
        block = Block(streamno=1, c_type=C.CTYPE_RANS, c_len=len(payload),
                      u_len=enc.n_lit, payload=payload)
    else:
        raw = rzip_host.literals_of(chunk, kinds, lengths).tobytes()
        block = Block(streamno=1, c_type=C.CTYPE_NONE, c_len=len(raw),
                      u_len=len(raw), payload=raw)
    job.stats["literal_coder"] = "rans" if block.c_type == C.CTYPE_RANS \
        else "none"
    return block


def _compress_chunk(out: BinaryIO, chunk: np.ndarray, eof: bool, ctype: int,
                    cfg, settings: Settings, pool: ThreadPoolExecutor,
                    tokens, job: MatchJob, crypto=None,
                    w_override: Optional[int] = None) -> int:
    """One chunk's blocks, written to ``out`` (shared._compress_chunk with
    the device literal encode)."""
    csize = len(chunk)
    w = w_override or C.chunk_byte_width(max(csize, 1))
    crc_fut = pool.submit(lambda: zlib.crc32(chunk) & 0xFFFFFFFF)
    kinds, lengths, dists = split_long_runs(*tokens)

    # the device literal path: with the rans codec and no filter, the
    # literals are encoded from the chunk the matcher uploaded; a trivial
    # chunk never reached the device and takes the host codec
    device_literals = ctype == C.CTYPE_RANS and not settings.filter_flag \
        and job.dev is not None
    lit_block = None
    if device_literals:
        lit_block = _device_literal_block(job, chunk, kinds, lengths,
                                          settings)
    job.dev = None      # the padded chunk is needed no further
    stream0 = encode_token_stream(kinds, lengths, dists, w,
                                  stored_crc_int(crc_fut.result()))
    stream1 = np.zeros(0, np.uint8) if device_literals \
        else rzip_host.literals_of(chunk, kinds, lengths)

    gate = shared._lz4_gate(settings)
    jobs = []
    for streamno, stream in ((0, stream0), (1, stream1)):
        for part in shared._split_stream(stream, settings.block_size):
            raw = part.tobytes()
            if streamno == 1 and settings.filter_flag:
                raw = apply_filter(raw, settings.filter_flag,
                                   settings.delta_offset)
            jobs.append((streamno, raw))

    def compress_one(item):
        streamno, raw = item
        use_ctype = ctype
        if use_ctype != C.CTYPE_NONE and gate is not None \
                and not gate(raw):
            use_ctype = C.CTYPE_NONE
        ct, payload = compress_block(raw, use_ctype, cfg)
        return Block(streamno=streamno, c_type=ct, c_len=len(payload),
                     u_len=len(raw), payload=payload)

    blocks = list(pool.map(compress_one, jobs))
    if lit_block is not None:
        blocks.append(lit_block)
    return write_chunk(out, w, eof, csize, blocks, crypto=crypto)


def compress(data: bytes, settings: Optional[Settings] = None,
             device="cuda") -> bytes:
    buf = io.BytesIO()
    compress_stream(data, buf, settings, device=device)
    return buf.getvalue()


def compress_file(in_path: str, out_path: str,
                  settings: Optional[Settings] = None, device="cuda") -> int:
    size = os.path.getsize(in_path)
    data = np.memmap(in_path, dtype=np.uint8, mode="r") if size else \
        np.zeros(0, dtype=np.uint8)
    with open(out_path, "wb") as out:
        return compress_stream(data, out, settings, device=device)
