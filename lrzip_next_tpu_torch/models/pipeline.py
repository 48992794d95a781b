"""Archive pipeline of the port: compress and decompress on one device.

The port's own ``Settings`` (the same fields, defaults and ``resolved_*``
methods as ``lrzip_next_tpu/models/pipeline.py``), chunk planning, and
both directions of the single-device chunk loop.

Compress: one loop in ``compress_stream`` takes each window (a chunk)
from one source, ``_windows``, the only code that knows where a window's
tokens come from.  Its three producers: the GPU matcher (``ops/
matcher.py``: the anchor-seed pipeline, or with ``anchor_stride=1`` the
dense one), a ``MatchJob`` a window, windows k+1 and k+2 queued on the
device, each job on its own stream and worker thread, while window k is
written (the JAX package's lookahead); with two cards or more and
``use_mesh=True``, or ``use_mesh`` left to choose on ``device="cuda"``
(no card named), batches of consecutive equal-size chunks across the
mesh's dp rows instead, a ``MatchJob`` a chunk on its row's first card
and split over the row's sp cards, two batches queued ahead
(``parallel/mesh.py``; below two cards ``use_mesh=True`` takes the
lookahead, as the JAX package does below two devices); and the host
matcher (``device=None``, with the chunk plan of ``use_tpu=False``) or
the ``encode_tokens=`` hook, with no job.  Chunks are planned with the
256 MiB device chunk cap (``use_tpu=True`` in the JAX package's terms),
which makes the archives equal to that package's device path.

For each window the loop runs the cross-window step where an index runs
(``-U`` and ``cross_chunk``: ``_cross_window``), hands the window to the
writer chosen once, and hands its stats dict on.  ``ChunkWriter`` writes
a chunk a window; with ``method="rans"`` and no filter a chunk's literal
stream is rANS-encoded on the device from the chunk the matcher uploaded
(``models/device_path.py``), and only the payload comes back, while
every other method compresses the literals on the host.
``_WholeFileWriter`` (``-U`` over several windows) collects the windows'
tokens and literals and writes one whole-file chunk whose literals take
the host codecs.  Both code their blocks on the pool.  The archive hash
runs over the whole input on a thread of its own
(``utils/hashing.HashThread``) beside all of it; the archives are the
same whatever the source.

Decompress: a chunk whose literal stream is one ``CTYPE_RANS`` block of
an archive without a filter decodes its literals on the device
(``DeviceLitPlane``, kernel K7); every other block goes through the host
codecs.  Such a chunk is then rebuilt on the device from the literal
plane (``device_path.replay_device``, kernels K8a-c) and read back once;
a chunk whose tokens reach into earlier chunks, and every chunk whose
literals were decoded on the host, replays on the host
(``runtime.replay_tokens``), where the history lies.  ``device=None``
decodes every chunk on the host.  Chunk k+1's payload IO and backend
decode run in the pool while chunk k replays.  Each chunk's bytes go,
as they land (the device read-back in slices), to its CRC, one pass on
the calling thread, and to the archive hash on a thread of its own
(``_ChunkVerify``), which runs on beside the next chunk's decode.
Where the native host runtime is missing, the token parse, the replay
and the matcher's host steps take their numpy counterparts, as the JAX
package's do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..backends import BackendConfig, compress_block, ctype_for_method, \
    decompress_block
from ..backends.rans_codec import ctx_bits_for_level
from ..device import resolve_device
from ..format import constants as C
from ..format.container import Block, ChunkReader, read_chunk_header, \
    write_chunk
from ..format.magic import MagicHeader
from ..format.tokens import decode_token_stream, encode_token_stream, \
    replay_tokens, split_long_runs
from ..ops.filters import apply_filter, undo_filter
from ..ops.matcher import MatchJob, default_anchor_stride, require_runtime
from ..parallel import mesh as pmesh
from ..utils.hashing import ArchiveHash, HashThread, crc32_combine, \
    stored_crc_int
from ..utils.memplan import default_max_chunk
from ..utils.spans import OpStats, stage, timed
from . import rzip_host
from .crosschunk import CrossChunkIndex, anchor_set, find_cross_matches, \
    splice_cross_matches
from .device_path import DeviceLiteralEncode, DeviceLitPlane, \
    replay_device


@dataclasses.dataclass
class Settings:
    """User-facing compression settings (the rzip_control analogue,
    reference src/include/lrzip_private.h:472-581)."""

    method: str = "lzma"           # lzma|gzip|bzip2|zstd|lzo|zpaq|bzip3|none
    compression_level: int = 7
    rzip_level: int = -1           # -1: follow compression_level (main.c:787)
    hash_name: str = "MD5"
    window: int = 0                # -w N: chunk = N * 100MB
    unlimited: bool = False        # -U
    threads: int = 0               # 0 = cpu count
    block_size: int = C.STREAM_BUFSIZE
    max_chunk: int = 0             # explicit chunk cap (testing / RAM plan)
    comment: bytes = b""
    progress: Optional[Callable[[str, int, int], None]] = None
    # progress(stage, done_bytes, total_bytes); stage in
    # {"rzip", "backend", "write", "decompress"}
    stats_sink: Optional[Callable[[dict], None]] = None
    # a dict a chunk, compress and decompress: the matcher counters of
    # max verbosity (reference st->stats, src/rzip.c:1238-1246) and the
    # stage milliseconds of utils/spans.py
    filter_flag: int = 0           # FILTER_* BCJ code or FILTER_DELTA
    delta_offset: int = 1
    dict_size: int = 0             # lzma dictionary (0 = default by level)
    zstd_level: int = 0            # 0 = derive from compression_level
    zpaq_level: int = 0
    zpaq_bs: int = 6
    bzip3_bs: int = 4
    use_tpu: bool = False          # device chunk planning (the port
    # sets this from compress_stream's device: False for device=None)
    use_mesh: Optional[bool] = None  # the (dp, sp) chunk mesh over
    # several cards (parallel/mesh.py); None = auto: two cards or more
    anchor_stride: int = 0         # matcher sampling; 0 = by level
    cross_chunk: bool = False      # matches reaching into earlier chunks
    lz4_test: bool = True          # compressibility gate before backends
    threshold: int = 100
    bemt: bool = True              # backend-internal MT (--nobemt off,
    # the reference's LzFindMt toggle at src/stream.c:456)
    lzma_mf: int = 0               # 0 = bt4 default; 2..5 = bt2..bt5
    # (--lzma-mf, the SDK numHashBytes dial, LzFind.c:962-1400)
    passphrase: Optional[bytes] = None  # -e: enables encryption
    enc_code: int = 0              # 1=AES128, 2=AES256 (default 1 w/ pass)
    costfactor_exp: int = 0        # SCRYPT 2^N; 0 = auto

    def resolved_threads(self) -> int:
        return self.threads or os.cpu_count() or 1

    def resolved_rzip_level(self) -> int:
        return self.compression_level if self.rzip_level < 0 \
            else self.rzip_level

    def resolved_dict_size(self) -> int:
        if self.dict_size:
            return self.dict_size
        # reference defaults by level (src/util.c:109-126)
        lvl = min(max(self.compression_level, 1), 9)
        if lvl <= 3:
            return 1 << (lvl * 2 + 16)
        if lvl <= 6:
            return 1 << (lvl + 19)
        return 1 << (18 + lvl)  # 7->2^25, 8->2^26, 9->2^27

    def resolved_zpaq_level(self) -> int:
        # reference: round(level * 5 / 9) (src/util.c:134)
        return self.zpaq_level or max(1, round(
            self.compression_level * 5 / 9))

    def resolved_anchor_stride(self) -> int:
        if self.anchor_stride:
            return self.anchor_stride
        return default_anchor_stride(self.resolved_rzip_level())

    def resolved_zstd(self) -> Tuple[int, int]:
        lvl = min(max(self.compression_level, 1), 9)
        return (self.zstd_level or C.ZSTD_LEVEL_FROM_LRZIP_LEVEL[lvl],
                C.ZSTD_STRATEGY_FROM_LRZIP_LEVEL[lvl])


def _magic_for(settings: Settings, expected_size: int,
               eof_known: bool) -> MagicHeader:
    h = MagicHeader(expected_size=expected_size, eof_known=eof_known,
                    hash_code=C.HASH_CODE[settings.hash_name.upper()],
                    rzip_level=settings.resolved_rzip_level(),
                    compression_level=settings.compression_level,
                    comment=settings.comment,
                    filter_flag=settings.filter_flag,
                    delta_offset=settings.delta_offset)
    m = settings.method
    if m == "lzma":
        h.method_code = C.MAGIC_CTYPE_LZMA
        h.lzma_dict_size = settings.resolved_dict_size()
    elif m == "zpaq":
        h.method_code = C.MAGIC_CTYPE_ZPAQ
        h.zpaq_level = settings.resolved_zpaq_level()
        h.zpaq_bs = settings.zpaq_bs
    elif m == "bzip3":
        h.method_code = C.MAGIC_CTYPE_BZIP3
        h.bzip3_bs = settings.bzip3_bs
    elif m == "zstd":
        h.zstd_level, h.zstd_strategy = settings.resolved_zstd()
        h.method_code = C.MAGIC_CTYPE_ZSTD
    return h


def magic_header(settings: Settings, total: int,
                 crypto=None) -> MagicHeader:
    """The magic header of an archive of ``total`` input bytes, with
    ``crypto``'s code and salt where the archive is encrypted."""
    magic = _magic_for(settings, total, eof_known=True)
    if crypto is not None:
        magic.enc_code = crypto.enc_code
        magic.salt = crypto.salt
    return magic


def _backend_cfg(settings: Settings) -> BackendConfig:
    zl, zs = settings.resolved_zstd()
    return BackendConfig(
        compression_level=settings.compression_level,
        dict_size=settings.resolved_dict_size(),
        zpaq_level=settings.resolved_zpaq_level(), zpaq_bs=settings.zpaq_bs,
        bzip3_bs=settings.bzip3_bs, zstd_level=zl, zstd_strategy=zs,
        threads=settings.resolved_threads(), bemt=settings.bemt,
        lzma_mf=settings.lzma_mf)


# Largest chunk the single-device matcher takes.  Part of the archive
# layout (it fixes the chunk boundaries), so it equals the JAX package's
# cap.  Bigger windows come from cross-chunk matching, not bigger chunks.
DEVICE_CHUNK_CAP = 256 << 20


def plan_chunks(total: int, settings: Settings,
                ram_budget: Optional[int] = None) -> List[int]:
    """Split the input into rzip chunk sizes (reference src/rzip.c:999-1020:
    chunk = min(file, 2/3 ram), -w window override, -U whole file)."""
    if total == 0:
        return [0]
    if settings.unlimited:
        # -U: window = whole file. Beyond the RAM budget this becomes
        # RAM-sized chunks + cross-chunk matching (models/crosschunk.py),
        # the memory-bounded analog of the reference's sliding mmap
        # (src/rzip.c:84-181).
        max_chunk = min(total,
                        settings.max_chunk or default_max_chunk(ram_budget))
    elif settings.window:
        max_chunk = settings.window * C.CHUNK_MULTIPLE
    elif settings.max_chunk:
        max_chunk = settings.max_chunk
    else:
        max_chunk = default_max_chunk(ram_budget)
    if settings.use_tpu and not settings.max_chunk:
        max_chunk = min(max_chunk, DEVICE_CHUNK_CAP)
    sizes = []
    left = total
    while left > 0:
        c = min(left, max_chunk)
        sizes.append(c)
        left -= c
    return sizes


def chunk_bounds(total: int, settings: Settings) -> List[Tuple[int, int]]:
    """``(offset, size)`` of each chunk that ``plan_chunks`` plans."""
    bounds = []
    pos = 0
    for csize in plan_chunks(total, settings):
        bounds.append((pos, csize))
        pos += csize
    return bounds


def settings_from_reference(obj) -> Settings:
    """The port's ``Settings`` from another package's settings object.

    ``obj`` is a dict of fields, a dataclass instance, or any object
    whose public attributes are the fields.  Every field it carries must
    be one the port knows (``ValueError`` otherwise); fields it lacks
    keep their defaults."""
    if isinstance(obj, dict):
        given = dict(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        given = {f.name: getattr(obj, f.name)
                 for f in dataclasses.fields(obj)}
    else:
        given = {k: v for k, v in vars(obj).items()
                 if not k.startswith("_")}
    known = {f.name for f in dataclasses.fields(Settings)}
    unknown = sorted(set(given) - known)
    if unknown:
        raise ValueError(f"unknown settings field(s): {', '.join(unknown)}")
    return Settings(**given)


def _split_stream(buf: np.ndarray, block_size: int) -> List[np.ndarray]:
    if len(buf) == 0:
        return []
    return [buf[i:i + block_size] for i in range(0, len(buf), block_size)]


def _lz4_gate(settings: Settings) -> Optional[Callable[[bytes], bool]]:
    if not settings.lz4_test or settings.method == "none":
        return None
    from ..ops.lz4gate import compressibility_gate
    return lambda raw: compressibility_gate(raw, settings.threshold)


def _code_block(streamno: int, raw: bytes, ctype: int, cfg: BackendConfig,
                gate) -> Block:
    """One stream block through the backend, stored raw where the LZ4
    gate finds it incompressible."""
    if ctype != C.CTYPE_NONE and gate is not None and not gate(raw):
        ctype = C.CTYPE_NONE
    ct, payload = compress_block(raw, ctype, cfg)
    return Block(streamno=streamno, c_type=ct, c_len=len(payload),
                 u_len=len(raw), payload=payload)


def _two_ahead(n: int, make):
    """Yield ``(i, make(i))`` for i < n, where ``make(i + 2)`` runs before
    item i is yielded: items i+1 and i+2 are under way while the caller
    uses item i (the JAX package's lookahead depth)."""
    items = {i: make(i) for i in range(min(2, n))}
    for i in range(n):
        if i + 2 < n:
            items[i + 2] = make(i + 2)
        yield i, items.pop(i)


def compress_stream(data, out: BinaryIO, settings: Optional[Settings] = None,
                    device="cuda", encode_tokens=None) -> int:
    """Compress a whole input to an .lrz archive; returns the bytes
    written.

    ``device`` is where the matcher runs: ``"cuda"`` (the default) or
    ``"cpu"`` (the kernels' plain versions), with the device chunk cap;
    ``None`` takes the host matcher (``rzip_host.rzip_encode_chunk``)
    and plans chunks without the cap, as the JAX package does with
    ``use_tpu=False``.  The port sets ``settings.use_tpu`` from it.
    ``encode_tokens(chunk) -> (kinds, lengths, dists)`` replaces the
    matcher, as the JAX package's hook does: its chunks are neither
    queued ahead nor matched as ``-U`` windows on the device.

    One loop takes every window from ``_windows`` and hands it, after
    the cross-window step where an index runs, to one of two writers
    chosen once: ``ChunkWriter`` (a chunk a window) or, for ``-U`` over
    several windows, ``_WholeFileWriter`` (one whole-file chunk).

    The archive hash (none with hash code 0) runs over the whole input
    on a thread of its own from the end of set-up; the calling thread
    waits for it after the last chunk (``compress.hash_wait``), and
    ``compress.hash`` writes the digest.

    ``settings.stats_sink`` takes a dict a chunk: the matcher's counters
    (``chunk_bytes`` alone from the host matcher), ``chunk``, ``op``
    ("compress"), ``main_ms`` (the calling thread's stages,
    ``utils/spans.py``) and the pool threads' ``backend_ms``; the last
    chunk's dict, with the operation's own stages and the hash thread's
    ``hash_ms``, when it ends."""
    ops = OpStats(settings.stats_sink if settings is not None else None,
                  "compress")
    with stage("compress.setup", ops.op_ms):
        require_runtime(device)
        dev = None if device is None else resolve_device(device)
        settings = dataclasses.replace(settings or Settings(),
                                       use_tpu=dev is not None)
        data = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.asarray(
                data, dtype=np.uint8)
        total = len(data)
        bounds = chunk_bounds(total, settings)
        last = len(bounds) - 1
        unlimited = settings.unlimited and last > 0 and encode_tokens is None
        queued = dev is not None and encode_tokens is None
        mesh = None
        if queued and not unlimited and last > 0 \
                and (settings.use_mesh or settings.use_mesh is None):
            mesh = pmesh.pipeline_mesh(dev, settings.use_mesh)

        crypto = None
        if settings.passphrase is not None:
            from ..crypto import CryptoContext, keys as ckeys
            exp = settings.costfactor_exp or ckeys.default_costfactor_exp()
            crypto = CryptoContext.fresh(settings.passphrase,
                                         settings.enc_code or 1,
                                         costfactor_exp=exp)

        # -U and cross-chunk matching: a window's matches may reach into
        # every earlier window, so the chunk byte width covers the file
        xindex = width = None
        if unlimited or (settings.cross_chunk and not settings.unlimited
                         and last > 0):
            xindex = CrossChunkIndex()
            width = C.chunk_byte_width(total)
            max_dist = (1 << (8 * width)) - 1
        pool = ThreadPoolExecutor(max_workers=settings.resolved_threads())
        writer = (_WholeFileWriter if unlimited else ChunkWriter)(
            out, settings, pool, ops, crypto, width)
        magic = magic_header(settings, total, crypto)
        out.write(magic.encode())
        written = magic.header_len
        windows = _windows(data, bounds, settings.resolved_anchor_stride(),
                           dev, mesh, None if queued else
                           encode_tokens or rzip_host.rzip_encode_chunk,
                           ops.main)
        hashing = HashThread(ArchiveHash(magic.hash_code), data) \
            if magic.hash_code else None
    try:
        for ci, p0, chunk, tokens, job, stats in windows:
            counts = {}
            if xindex is not None:
                tokens = _cross_window(data, xindex, p0, chunk, tokens,
                                       max_dist, counts, ops.main,
                                       job.dev if job is not None else None)
            writer.add(chunk, tokens, job, ci == last)
            ops.chunk(dict(stats, chunk=ci, **counts), last=ci == last)
            if settings.progress:
                settings.progress("rzip", p0 + len(chunk), total)
        written += writer.close()
        with stage("compress.hash_wait", ops.op_ms):
            if hashing is not None:
                hashing.wait()
    finally:
        with stage("compress.setup", ops.op_ms):
            if hashing is not None:
                hashing.stop()
            pool.shutdown()
    with stage("compress.hash", ops.op_ms):
        if hashing is not None:
            digest = hashing.hasher.digest()
            if crypto is not None:
                digest = crypto.encrypt_block(digest, crypto.salt_pass)
            out.write(digest)
            written += len(digest)
    ops.counters["hash_ms"] = hashing.busy_ms if hashing is not None else 0.0
    ops.close()
    return written


def _windows(data: np.ndarray, bounds, stride: int, dev, mesh, encode,
             main: Optional[dict]):
    """The window source: ``(index, offset, chunk, tokens, job or None,
    stats)`` of each window in order, from one of three producers.

    - ``mesh``: batches of consecutive equal-size chunks, at most dp a
      batch, each a ``parallel/mesh.MeshMatchBatch`` (chunk j of a batch
      on dp row j, its matcher split over the row's sp devices), two
      batches queued ahead (the JAX package's ``_compress_chunks_mesh``);
      the stats are the batch's, and the job is the chunk's on its row.
    - ``encode`` None: a ``MatchJob`` a window on ``dev``, two queued
      ahead, each on its own stream and worker thread (the lookahead).
    - else ``encode(chunk)``, the host matcher or the ``encode_tokens``
      hook, with no job.

    ``main`` takes the stages of the queueing (``compress.queue``), the
    waits (``compress.match_wait``) and the host matching
    (``compress.host_match``)."""

    def window(ci):
        p0, csize = bounds[ci]
        return np.asarray(data[p0:p0 + csize])

    if mesh is not None:
        groups: List[List[int]] = []
        for ci, (_, csize) in enumerate(bounds):
            if not groups or len(groups[-1]) == mesh.devices.shape[0] or \
                    bounds[groups[-1][0]][1] != csize:
                groups.append([])
            groups[-1].append(ci)

        def dispatch(gi):
            with stage("compress.queue", main):
                return pmesh.MeshMatchBatch(
                    mesh, [window(ci) for ci in groups[gi]], stride)

        for gi, batch in _two_ahead(len(groups), dispatch):
            for j, ci in enumerate(groups[gi]):
                with stage("compress.match_wait", main):
                    tokens = batch.collect(j)
                    job = batch.job_for(j)
                yield ci, bounds[ci][0], job.data, tokens, job, \
                    batch.stats[j]
    elif encode is None:
        def queue(ci):
            with stage("compress.queue", main):
                return MatchJob(window(ci), stride, dev)

        for ci, job in _two_ahead(len(bounds), queue):
            with stage("compress.match_wait", main):
                tokens = job.collect()
            yield ci, bounds[ci][0], job.data, tokens, job, job.stats
    else:
        for ci, (p0, csize) in enumerate(bounds):
            with stage("compress.host_match", main):
                chunk = window(ci)
                tokens = encode(chunk)
            yield ci, p0, chunk, tokens, None, {"chunk_bytes": csize}


def _cross_window(data: np.ndarray, xindex: CrossChunkIndex, p0: int,
                  chunk: np.ndarray, tokens, max_dist: int, counts: dict,
                  main: Optional[dict], dev: Optional[torch.Tensor] = None):
    """The window's tokens with its matches into the earlier windows
    spliced in (``compress.cross_find``: the window's anchor set, the
    index lookup, the verify and extend, the splice), then the window
    added to the index (``compress.cross_index``); ``counts`` takes
    ``crosschunk.COUNTERS`` and ``cross_scan_card``: 1 where K11 scanned
    the window on the card (``dev``, the job's padded window, a CUDA
    tensor; ``collect()`` made the current stream wait on the job's), 0
    where the host did (no job, a trivial chunk, the CPU).  The one
    anchor set serves the lookup and the index."""
    on_card = dev is not None and dev.is_cuda
    with stage("compress.cross_find", main):
        anchors = anchor_set(chunk, xindex.mask_bits, dev)
        cross = find_cross_matches(data, xindex, p0, len(chunk), max_dist,
                                   counts, anchors)
        tokens = splice_cross_matches(*tokens, cross, p0)
    with stage("compress.cross_index", main):
        xindex.add_chunk(chunk, p0, anchors)
    counts["cross_scan_card"] = int(on_card)
    return tokens


class ChunkWriter:
    """A chunk a window, and what ``-U``'s writer shares with it.

    A writer takes each window's chunk, its tokens and its job or None
    (``add``) in order, and ``close()`` returns the bytes it wrote.
    Here each chunk's CRC runs on the pool (``compress.crc_wait``); with
    the rans codec and no filter its literals are rANS-coded on the
    device from the job's padded window (a trivial chunk never reached
    the device and the host matcher has no job: both take the host
    codec); its blocks are coded on the pool (``compress.backend_wait``)
    and the chunk written (``compress.write``).  ``width`` fixes the
    chunk byte width (the file's, where windows match across the file),
    else each chunk has its own.  ``ops`` takes the stages and the
    pool's ``backend_ms``."""

    def __init__(self, out: BinaryIO, settings: Settings,
                 pool: ThreadPoolExecutor, ops: Optional[OpStats] = None,
                 crypto=None, width: Optional[int] = None):
        try:
            self.ctype = ctype_for_method(settings.method)
        except KeyError:
            raise ValueError(
                f"unknown compression method {settings.method!r}")
        self.out, self.settings, self.pool = out, settings, pool
        self.crypto, self.width = crypto, width
        self.ops = ops or OpStats(None, "compress")
        self.main = self.ops.main
        self.cfg = _backend_cfg(settings)
        self.gate = _lz4_gate(settings)
        self.on_device = self.ctype == C.CTYPE_RANS and \
            not settings.filter_flag
        self.written = 0

    def add(self, chunk: np.ndarray, tokens, job: Optional[MatchJob] = None,
            last: bool = True) -> None:
        times = self.ops.pool_times()
        code = timed(_code_block, times)
        with stage("compress.tokens", self.main):
            w = self.width or C.chunk_byte_width(max(len(chunk), 1))
            crc_fut = self.pool.submit(lambda: zlib.crc32(chunk) & 0xFFFFFFFF)
            kinds, lengths, dists = split_long_runs(*tokens)
        lit_block, lits = self._literals(job, chunk, kinds, lengths)
        with stage("compress.crc_wait", self.main):
            crc = crc_fut.result()
        with stage("compress.tokens", self.main):
            stream0 = encode_token_stream(kinds, lengths, dists, w,
                                          stored_crc_int(crc))
            futures = self._submit(0, stream0, code) + \
                self._submit(1, lits, code)
        with stage("compress.backend_wait", self.main):
            blocks = [f.result() for f in futures]
        self.ops.count(times)
        if lit_block is not None:
            blocks.append(lit_block)
        with stage("compress.write", self.main):
            self.written += write_chunk(self.out, w, last, len(chunk),
                                        blocks, crypto=self.crypto)

    def close(self) -> int:
        return self.written

    def _literals(self, job, chunk, kinds, lengths):
        """``(literal block, no host literals)`` from the device rANS
        encode (``compress.literal_encode``) where the writer codes there
        and the job kept its padded window, else ``(None, the host
        literals)``.  The device block is rANS where the payload is
        smaller than the literals, else the raw literals; None where
        there are none.  The encode runs with the job's card as the
        current device: the kernels launch onto the current stream of
        the tensors' card, which a mesh row's chunk may hold while
        another card is current.  The job lets go of its padded window
        here: no later step reads it."""
        block, lits = None, np.zeros(0, np.uint8)
        if self.on_device and job is not None and job.dev is not None:
            with stage("compress.literal_encode", self.main), (
                    torch.cuda.device(job.device) if job.device.type ==
                    "cuda" else contextlib.nullcontext()):
                enc = DeviceLiteralEncode(
                    job.dev, kinds, lengths,
                    ctx_bits_for_level(self.settings.compression_level))
                payload = enc.payload()
                job.stats["literal_ms"] = enc.stage_ms
                job.stats["literal_lanes"] = enc.lanes
                if payload is not None:
                    rans = len(payload) < enc.n_lit
                    if not rans:
                        payload = rzip_host.literals_of(chunk, kinds,
                                                        lengths).tobytes()
                    block = Block(streamno=1, c_type=C.CTYPE_RANS if rans
                                  else C.CTYPE_NONE, c_len=len(payload),
                                  u_len=enc.n_lit, payload=payload)
                    job.stats["literal_coder"] = "rans" if rans else "none"
        else:
            with stage("compress.tokens", self.main):
                lits = rzip_host.literals_of(chunk, kinds, lengths)
        if job is not None:
            job.dev = None
        return block, lits

    def _submit(self, streamno: int, stream: np.ndarray, code) -> list:
        """Futures of ``stream``'s blocks, each coded on the pool by
        ``code``; stream 1 through the filter first."""
        s = self.settings
        futures = []
        for part in _split_stream(stream, s.block_size):
            raw = part.tobytes()
            if streamno == 1 and s.filter_flag:
                raw = apply_filter(raw, s.filter_flag, s.delta_offset)
            futures.append(self.pool.submit(code, streamno, raw, self.ctype,
                                            self.cfg, self.gate))
        return futures


class _WholeFileWriter(ChunkWriter):
    """``-U`` over several windows: ONE rzip chunk spanning the whole
    file, built from the window passes (the memory-bounded analogue of
    the reference's sliding mmap, src/rzip.c:84-181; the JAX package's
    ``_compress_unlimited``), at the file's chunk byte width.  The split
    tokens are collected, the literals go through the host codecs in
    blocks sent to the pool as they fill, the CRC runs on the calling
    thread (``compress.crc``); ``close()`` codes the one token stream and
    writes the chunk.  The pool's ``backend_ms`` lands in the last
    window's dict."""

    def __init__(self, *args):
        super().__init__(*args)
        self.on_device = False
        self.tokens: List[tuple] = []   # each window's split tokens
        self.lits: List[np.ndarray] = []   # less than a block, in order
        self.futures: list = []
        self.crc = self.total = 0
        self.times = self.ops.pool_times()
        self.code = timed(_code_block, self.times)

    def add(self, chunk: np.ndarray, tokens, job: Optional[MatchJob] = None,
            last: bool = False) -> None:
        with stage("compress.tokens", self.main):
            kinds, lengths, dists = split_long_runs(*tokens)
            self.tokens.append((kinds, lengths, dists))
            self.total += len(chunk)
        _, lits = self._literals(job, chunk, kinds, lengths)
        with stage("compress.tokens", self.main):
            self._flush(lits)
        with stage("compress.crc", self.main):
            self.crc = zlib.crc32(chunk, self.crc)

    def _flush(self, lits: np.ndarray, final: bool = False) -> None:
        """Add ``lits`` and send every whole block of the literals held
        to the pool (with ``final``, the rest too)."""
        if len(lits):
            self.lits.append(lits)
        held = sum(len(a) for a in self.lits)
        if held >= self.settings.block_size or (final and held):
            buf = np.concatenate(self.lits) if len(self.lits) > 1 \
                else self.lits[0]
            cut = held if final else held - held % self.settings.block_size
            self.futures += self._submit(1, buf[:cut], self.code)
            self.lits = [buf[cut:]] if cut < held else []

    def close(self) -> int:
        with stage("compress.tokens", self.main):
            self._flush(np.zeros(0, np.uint8), final=True)
            stream0 = encode_token_stream(
                *map(np.concatenate, zip(*self.tokens)), self.width,
                stored_crc_int(self.crc & 0xFFFFFFFF))
            futures = self._submit(0, stream0, self.code) + self.futures
        with stage("compress.backend_wait", self.main):
            blocks = [f.result() for f in futures]
        self.ops.count(self.times)
        with stage("compress.write", self.main):
            return write_chunk(self.out, self.width, True, self.total,
                               blocks, crypto=self.crypto)


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


# Decode ---------------------------------------------------------------------

class _ChunkDecodeJob:
    """Stage A of chunk decode: payload IO, the device literal decode and
    block-parallel backend decompression, submitted so that they overlap
    the previous chunk's replay (the reference's read-ahead pool P3,
    src/stream.c:2022-2195, at chunk granularity)."""

    def __init__(self, fd: BinaryIO, hdr, magic: MagicHeader,
                 cfg: BackendConfig, pool: ThreadPoolExecutor,
                 device: Optional[torch.device], crypto=None, times=None):
        self.hdr = hdr
        reader = ChunkReader(fd, hdr, crypto=crypto)
        refs0 = list(reader.blocks(0))
        refs1 = list(reader.blocks(1))
        payloads = {id(r): reader.read_payload(r) for r in refs0 + refs1}
        self.end_offset = reader.end_offset()

        # Device literal path: a single rANS literal block (the shape the
        # device encode writes) is decoded on the device; the launch is
        # queued here and the chunk replayed there in _finish_chunk_decode.
        # Without a device (None) every block takes the host codecs.
        self.device = device
        self.device_plane = None
        if (device is not None and not magic.filter_flag
                and len(refs1) == 1
                and refs1[0].c_type == C.CTYPE_RANS):
            r = refs1[0]
            self.device_plane = DeviceLitPlane(payloads[id(r)], r.u_len,
                                               device)
            refs1 = []
        self.n0 = len(refs0)

        def decomp(ref):
            raw = decompress_block(payloads[id(ref)], ref.c_type,
                                   ref.u_len, cfg)
            if ref.streamno == 1 and magic.filter_flag:
                raw = undo_filter(raw, magic.filter_flag,
                                  magic.delta_offset,
                                  magic.minor_version)
            return raw

        # times: a list (``utils/spans.timed``) for the blocks' host ms
        self.times = times
        decomp = timed(decomp, times)
        self.futures = [pool.submit(decomp, r) for r in refs0 + refs1]

    def streams(self) -> Tuple[bytes, bytes]:
        results = [f.result() for f in self.futures]
        return (b"".join(results[:self.n0]),
                b"".join(results[self.n0:]))


def read_archive_head(fd: BinaryIO, settings: Settings):
    """Parse the magic header and leave ``fd`` at the first chunk:
    ``(magic, crypto context or None, backend config)``.  Raises
    ``ValueError`` for a short header and for an encrypted archive without
    a passphrase."""
    head = fd.read(C.MAGIC_LEN + 64)
    if len(head) < C.MAGIC_LEN:
        raise ValueError("archive too short for magic header")
    magic = MagicHeader.decode(head)
    fd.seek(magic.header_len)
    crypto = None
    if magic.enc_code:
        if settings.passphrase is None:
            raise ValueError(
                "archive is encrypted: a passphrase is required")
        from ..crypto import CryptoContext
        crypto = CryptoContext(settings.passphrase, magic.salt,
                               magic.enc_code,
                               minor_version=magic.minor_version)
    cfg = BackendConfig(
        compression_level=magic.compression_level or 7,
        dict_size=magic.lzma_dict_size,
        zpaq_level=magic.zpaq_level, zpaq_bs=magic.zpaq_bs,
        bzip3_bs=magic.bzip3_bs, zstd_level=magic.zstd_level,
        zstd_strategy=magic.zstd_strategy,
        threads=settings.resolved_threads())
    return magic, crypto, cfg


def check_chunk_crc(chunk_bytes: bytes, stored_crc: int,
                    cumulative_crc: int, crc: Optional[int] = None) -> int:
    """Raise ``ValueError`` unless the chunk matches its stored CRC under
    one of the two readings: the chunk's own CRC (this writer's), or the
    CRC of the whole output so far.  Returns the chunk's own CRC:
    ``crc`` where the caller has computed it, else one pass here.  The
    second reading combines it with ``cumulative_crc``
    (``crc32_combine``), so neither takes another pass.

    The reference never resets its gcry CRC handle between chunks
    (src/rzip.c:943-950 opens it once per file), so reference multi-chunk
    archives store the CRC of the whole prefix.  Both readings coincide on
    chunk 0 (``cumulative_crc`` is 0 there); for later chunks a corrupt
    chunk passing the other reading by chance is a 2^-32 event, the same
    strength as a single CRC32."""
    if crc is None:
        crc = zlib.crc32(chunk_bytes)
    crc &= 0xFFFFFFFF
    if stored_crc == stored_crc_int(crc):
        return crc
    if cumulative_crc != 0:
        cum = crc32_combine(cumulative_crc, crc, len(chunk_bytes))
        if stored_crc == stored_crc_int(cum):
            return crc
    raise ValueError(f"chunk CRC mismatch: stored 0x{stored_crc:08x}")


class _ChunkVerify:
    """The verify tail of one decompress: each chunk's CRC, one pass on
    the calling thread, and the archive hash on a thread of its own
    (``HashThread``; none with hash code 0), both fed the chunk's bytes
    in order as they land (``add``).  ``begin`` starts a chunk; the hash
    may still hold the chunk before it, but no older one, so what the
    thread holds stays within two chunks."""

    def __init__(self, hash_code: int):
        self.hashing = HashThread(ArchiveHash(hash_code)) \
            if hash_code else None
        self.crc = 0
        # parts handed to the hash in all, and before this chunk began
        self._put = self._held = 0

    def begin(self, main: Optional[dict]) -> None:
        self.crc = 0
        older, self._held = self._held, self._put
        if older:
            with stage("decompress.hash_wait", main):
                self.hashing.wait_for(older)

    def add(self, part) -> None:
        if self.hashing is not None:
            self._put = self.hashing.put(part)
        self.crc = zlib.crc32(part, self.crc)

    def wait(self) -> None:
        if self.hashing is not None:
            self.hashing.wait()

    def stop(self) -> None:
        if self.hashing is not None:
            self.hashing.stop()


def parse_tokens(stream0: bytes, chunk_bytes: int):
    """(kinds, lengths, dists, stored_crc) of a chunk's token stream: the
    native parse, or ``format.tokens.decode_token_stream`` where the
    runtime is missing."""
    s0 = np.frombuffer(stream0, dtype=np.uint8)
    parsed = runtime.parse_token_stream(s0, chunk_bytes) \
        if runtime.available() else None
    if parsed is None:
        parsed = decode_token_stream(s0, chunk_bytes)
    return parsed[:4]


def _finish_chunk_decode(job: _ChunkDecodeJob, history: np.ndarray,
                         cumulative_crc: int, verify: _ChunkVerify,
                         main: Optional[dict] = None) -> Tuple[bytes, int]:
    """Token parse, replay and the chunk CRC check; returns the chunk and
    its own CRC.  ``verify`` takes the chunk's bytes as they land: the
    slices of the device read-back, or the whole chunk of the host
    replay.  ``main`` takes the stage milliseconds."""
    with stage("decompress.backend_wait", main):
        stream0, stream1 = job.streams()
    with stage("decompress.parse", main):
        kinds, lengths, dists, stored_crc = parse_tokens(
            stream0, job.hdr.chunk_bytes)
    verify.begin(main)
    chunk_bytes = None
    if job.device_plane is not None:
        plane = job.device_plane
        chunk_bytes = replay_device(kinds, lengths, dists, plane,
                                    job.device, main, verify.add)
        if chunk_bytes is None:
            # cross-chunk reach: history lives host-side; read the
            # literal plane back and continue on the host path
            with stage("decompress.readback_wait", main):
                plane.check()
                stream1 = plane.literals()
    if chunk_bytes is None:
        with stage("decompress.host_replay", main):
            literals = np.frombuffer(stream1, dtype=np.uint8)
            chunk = None
            if runtime.available():
                # distances are chunk-local in practice; retry with
                # history only when an archive actually reaches back past
                # the chunk
                try:
                    chunk = runtime.replay_tokens(kinds, lengths, dists,
                                                  literals,
                                                  int(lengths.sum()))
                except ValueError:
                    chunk = runtime.replay_tokens(
                        kinds, lengths, dists, literals, int(lengths.sum()),
                        history=history if len(history) else None)
            if chunk is None:
                chunk = replay_tokens(
                    kinds, lengths, dists, literals,
                    history=history if len(history) else None)
        # the hash starts on the replayed chunk, beside its CRC and the
        # copy that makes its bytes
        with stage("decompress.crc", main):
            verify.add(chunk)
        with stage("decompress.host_replay", main):
            chunk_bytes = chunk.tobytes()
    with stage("decompress.crc", main):
        crc = check_chunk_crc(chunk_bytes, stored_crc, cumulative_crc,
                              verify.crc)
    return chunk_bytes, crc


def iter_decompress(fd: BinaryIO, settings: Optional[Settings] = None,
                    history_source=None, device="cuda"):
    """Generator over decompressed chunks with integrity verification.

    ``device``: where a rANS literal block is decoded and its chunk
    replayed (``"cuda"``, or ``"cpu"`` for the kernels' plain versions);
    ``None`` decodes every chunk on the host, as the JAX package does
    with ``use_tpu=False``.

    ``history_source``: optional zero-arg callable returning the
    already-written output prefix as a uint8 array (e.g. a memmap of
    the output file).  Without it, history for cross-chunk matches is
    accumulated in RAM.

    Each chunk's CRC (one pass) and the archive hash (on a thread of its
    own) take its bytes as they land; a chunk is yielded once its CRC
    holds, and after the last the calling thread waits for the hash
    (``decompress.hash_wait``) and compares it (``decompress.hash``).

    ``settings.stats_sink`` takes a dict a chunk: ``op``
    ("decompress"), ``chunk``, ``chunk_bytes``, ``main_ms`` (the calling
    thread's stages, ``utils/spans.py``) and the pool's ``backend_ms``;
    the last chunk's dict, with the operation's own stages and the hash
    thread's ``hash_ms``, when the operation ends.
    """
    ops = _decode_stats(settings)
    yield from _decode_chunks(fd, settings, history_source, device, ops)
    ops.close()


def _decode_stats(settings: Optional[Settings]) -> OpStats:
    return OpStats(settings.stats_sink if settings is not None else None,
                   "decompress")


def _decode_chunks(fd: BinaryIO, settings: Optional[Settings],
                   history_source, device, ops: OpStats):
    """``iter_decompress``'s chunks; the caller closes ``ops``."""
    with stage("decompress.setup", ops.op_ms):
        require_runtime(device)
        dev = None if device is None else resolve_device(device)
        settings = settings or Settings()
        magic, crypto, cfg = read_archive_head(fd, settings)
        pool = ThreadPoolExecutor(max_workers=settings.resolved_threads())
        verify = _ChunkVerify(magic.hash_code)
    main = ops.main
    out_total = 0
    cumulative_crc = 0
    # History for cross-chunk match distances (the fd_hist analog,
    # reference src/runzip.c:172-182): multi-chunk archives may reach
    # into earlier chunks.  With a history_source (file-backed decode)
    # the written output file itself is the history - zero extra RAM;
    # otherwise prior output accumulates in memory.
    history = bytearray()

    def finish(job, last=False):
        nonlocal cumulative_crc, out_total, history, n_done
        with stage("decompress.history", main):
            # RAM path: copy (frombuffer views would pin the bytearray
            # against resize); file path: zero-copy memmap
            hist_arr = history_source() if history_source is not None \
                else np.frombuffer(bytes(history), dtype=np.uint8)
        chunk_bytes, crc = _finish_chunk_decode(job, hist_arr,
                                                cumulative_crc, verify, main)
        with stage("decompress.history", main):
            if not job.hdr.eof and history_source is None:
                history += chunk_bytes
        with stage("decompress.crc", main):
            cumulative_crc = crc32_combine(cumulative_crc, crc,
                                           len(chunk_bytes))
        ops.count(job.times)
        ops.chunk({"chunk": n_done, "chunk_bytes": len(chunk_bytes)}, last)
        n_done += 1
        out_total += len(chunk_bytes)
        return chunk_bytes

    # one-chunk lookahead: chunk k+1's payload IO, literal decode and
    # backend decode run while chunk k replays (reference P3 read-ahead
    # parity at chunk granularity, src/stream.c:2022-2195); chunk k's
    # hash runs on beside both
    prev = None
    n_done = 0
    try:
        while True:
            with stage("decompress.read", main):
                hdr = read_chunk_header(fd, encrypted=crypto is not None)
                if hdr is not None:
                    job = _ChunkDecodeJob(fd, hdr, magic, cfg, pool, dev,
                                          crypto, ops.pool_times())
                    fd.seek(job.end_offset)
            if hdr is None:
                break
            if prev is not None:
                yield finish(prev)
            prev = job
            if hdr.eof:
                break
        if prev is not None:
            yield finish(prev, last=True)
        with stage("decompress.hash_wait", ops.op_ms):
            verify.wait()
    finally:
        with stage("decompress.setup", ops.op_ms):
            verify.stop()
            pool.shutdown()
    with stage("decompress.hash", ops.op_ms):
        if magic.eof_known and magic.expected_size and \
                out_total != magic.expected_size:
            raise ValueError(f"decompressed size {out_total} != expected "
                             f"{magic.expected_size}")
        hashing = verify.hashing
        if hashing is not None:
            hasher = hashing.hasher
            stored = fd.read(hasher.digest_size)
            if len(stored) != hasher.digest_size:
                # a short tail means corruption consumed the stored hash -
                # never skip the check silently (reference fatals on short
                # reads, src/runzip.c:446-447)
                raise ValueError(
                    f"archive truncated: stored {hasher.name} missing")
            if crypto is not None:
                stored = crypto.decrypt_block(stored, crypto.salt_pass)
            if stored != hasher.digest():
                raise ValueError(f"{hasher.name} mismatch: archive corrupt")
    ops.counters["hash_ms"] = hashing.busy_ms if hashing is not None else 0.0


def decompress_stream(fd: BinaryIO, settings: Optional[Settings] = None,
                      device="cuda") -> bytes:
    """Decompress a full .lrz archive (self- or reference-produced); the
    join of the chunks is the stage ``decompress.join``."""
    ops = _decode_stats(settings)
    chunks = list(_decode_chunks(fd, settings, None, device, ops))
    with stage("decompress.join", ops.op_ms):
        out = b"".join(chunks)
    ops.close()
    return out


def decompress_stream_to(fd: BinaryIO, out_fd: BinaryIO,
                         settings: Optional[Settings] = None,
                         device="cuda") -> int:
    """Decompress chunk-by-chunk, writing each chunk as it completes
    (bounded memory; the reference streams through fd_out the same way,
    src/runzip.c:375-502).

    When ``out_fd`` is a real file, cross-chunk match history is read
    back from the written file via memmap - the fd_hist analog
    (reference src/runzip.c:184-241) - so RAM use stays bounded by one
    chunk regardless of archive size.
    """
    history_source = None
    try:
        out_fd.fileno()
        usable = out_fd.seekable() and out_fd.readable()
    except (OSError, AttributeError, io.UnsupportedOperation):
        usable = False
    if usable:
        def history_source() -> np.ndarray:
            out_fd.flush()
            size = out_fd.tell()
            if size == 0:
                return np.zeros(0, dtype=np.uint8)
            mm = np.memmap(out_fd, dtype=np.uint8, mode="r",
                           shape=(size,))
            out_fd.seek(size)  # memmap construction moves the fd
            return mm
    total = 0
    for chunk_bytes in iter_decompress(fd, settings,
                                       history_source=history_source,
                                       device=device):
        out_fd.write(chunk_bytes)
        total += len(chunk_bytes)
    return total


def decompress_file(in_path: str, out_path: str,
                    settings: Optional[Settings] = None,
                    device="cuda") -> int:
    # w+b: the written file doubles as readable match history (fd_hist)
    with open(in_path, "rb") as fd, open(out_path, "w+b") as out:
        return decompress_stream_to(fd, out, settings, device=device)


def decompress(archive: bytes, settings: Optional[Settings] = None,
               device="cuda") -> bytes:
    return decompress_stream(io.BytesIO(archive), settings, device=device)
