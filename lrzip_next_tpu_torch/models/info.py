"""Archive inspection / validation: the -i info walk.

Mirrors the reference's get_fileinfo (src/lrzip.c:1069-1459): parse the
magic header, walk every chunk's two stream chains validating block
headers, and report per-stream totals, method parameters, and the rzip /
backend / overall compression ratios.  Also used silently as the
pre-decompression validation pass (src/lrzip.c:1748-1756).
"""

from __future__ import annotations

import dataclasses
import io
from typing import BinaryIO, List, Optional

from ..format import constants as C
from ..format.container import ChunkReader, read_chunk_header
from ..format.magic import MagicHeader


@dataclasses.dataclass
class StreamInfo:
    blocks: int = 0
    c_len: int = 0
    u_len: int = 0


@dataclasses.dataclass
class ChunkInfo:
    chunk_bytes: int
    size: int
    eof: bool
    streams: List[StreamInfo] = dataclasses.field(default_factory=list)
    block_details: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ArchiveInfo:
    magic: MagicHeader
    chunks: List[ChunkInfo] = dataclasses.field(default_factory=list)
    stored_hash: bytes = b""
    archive_size: int = 0

    @property
    def total_c_len(self) -> int:
        return sum(s.c_len for c in self.chunks for s in c.streams)

    @property
    def total_u_len(self) -> int:
        return sum(s.u_len for c in self.chunks for s in c.streams)

    @property
    def decompressed_size(self) -> int:
        return sum(c.size for c in self.chunks)

    def method_name(self) -> str:
        m = self.magic
        if m.method_code == C.MAGIC_CTYPE_LZMA:
            return f"rzip + lzma (dict {m.lzma_dict_size})"
        if m.method_code == C.MAGIC_CTYPE_ZPAQ:
            return f"rzip + zpaq (level {m.zpaq_level}, bs {m.zpaq_bs})"
        if m.method_code == C.MAGIC_CTYPE_BZIP3:
            bs = C.bzip3_block_size_from_prop(m.bzip3_bs)
            return f"rzip + bzip3 (block {bs})"
        if m.method_code == C.MAGIC_CTYPE_ZSTD:
            strat = C.ZSTD_STRATEGY_NAMES[m.zstd_strategy] \
                if m.zstd_strategy < 10 else "?"
            return f"rzip + zstd (level {m.zstd_level}, {strat})"
        return "rzip + lzo/gzip/bzip2/none (see block headers)"


def get_fileinfo(fd: BinaryIO,
                 passphrase: Optional[bytes] = None) -> ArchiveInfo:
    """Full structural walk + validation of an archive.

    Encrypted archives (reference -e) need ``passphrase`` to decrypt
    the chunk/block headers (reference decrypt_header, src/util.c:
    621-639); without it only the magic-level fields are reported.
    """
    start = fd.tell()
    fd.seek(0, io.SEEK_END)
    total = fd.tell() - start
    fd.seek(start)
    head = fd.read(C.MAGIC_LEN + 64)
    magic = MagicHeader.decode(head)
    crypto = None
    if magic.enc_code:
        if passphrase is None:
            info = ArchiveInfo(magic=magic, archive_size=total)
            return info  # headers unreadable without passphrase
        from ..crypto import CryptoContext
        crypto = CryptoContext(passphrase, magic.salt, magic.enc_code,
                               minor_version=magic.minor_version)
    fd.seek(start + magic.header_len)
    info = ArchiveInfo(magic=magic, archive_size=total)
    while True:
        hdr = read_chunk_header(fd, encrypted=crypto is not None)
        if hdr is None:
            break
        reader = ChunkReader(fd, hdr, crypto=crypto)
        ci = ChunkInfo(chunk_bytes=hdr.chunk_bytes, size=hdr.size,
                       eof=hdr.eof)
        for streamno in range(C.NUM_STREAMS):
            si = StreamInfo()
            for ref in reader.blocks(streamno):
                si.blocks += 1
                si.c_len += ref.c_len
                si.u_len += ref.u_len
                ci.block_details.append(
                    (streamno, ref.c_type, ref.c_len, ref.u_len))
            ci.streams.append(si)
        info.chunks.append(ci)
        fd.seek(reader.end_offset())
        if hdr.eof:
            break
    if magic.hash_code:
        hlen = C.HASH_LEN[magic.hash_code]
        tail = fd.read(hlen)
        if len(tail) == hlen:
            if crypto is not None:
                # stored hash is encrypted with salt_pass (reference
                # src/rzip.c:1214-1217)
                tail = crypto.decrypt_block(tail, crypto.salt_pass)
            info.stored_hash = tail
    return info


def format_fileinfo(info: ArchiveInfo, filename: str = "",
                    verbose: bool = False) -> str:
    """Human-readable report, shaped like the reference's -i output."""
    m = info.magic
    lines = []
    lines.append(f"{filename}")
    lines.append(f"lrzip version: {m.major_version}.{m.minor_version} file")
    lines.append(f"Compression: {info.method_name()}")
    if m.filter_flag == C.FILTER_DELTA:
        lines.append(f"Filter: Delta (offset {m.delta_offset})")
    elif m.filter_flag:
        lines.append(
            f"Filter: {C.FILTER_NAMES.get(m.filter_flag, m.filter_flag)}")
    dsize = info.decompressed_size or m.expected_size
    lines.append(f"Decompressed file size: {dsize:,}")
    lines.append(f"Compressed file size: {info.archive_size:,}")
    if info.archive_size and dsize:
        lines.append(
            f"Compression ratio: {dsize / info.archive_size:.3f}")
    hname = C.HASH_NAME.get(m.hash_code, "CRC")
    if m.hash_code and info.stored_hash:
        lines.append(f"{hname}: {info.stored_hash.hex()}")
    else:
        lines.append("CRC32 used for integrity testing")
    if m.enc_code:
        lines.append(f"Encrypted: AES{128 if m.enc_code == 1 else 256}")
        if not info.chunks:  # walked without a passphrase
            return "\n".join(lines)
    if m.comment:
        lines.append(f"Comment: {m.comment.decode('utf-8', 'replace')}")
    rzip_u = info.total_u_len
    if rzip_u and dsize:
        lines.append(f"rzip stage ratio: {dsize / rzip_u:.3f}")
    if info.total_c_len and rzip_u:
        lines.append(f"back end ratio: {rzip_u / info.total_c_len:.3f}")
    for i, ch in enumerate(info.chunks):
        lines.append(f"Rzip chunk {i + 1}: decompressed size {ch.size:,} "
                     f"(byte width {ch.chunk_bytes}, eof {int(ch.eof)})")
        for sno, s in enumerate(ch.streams):
            lines.append(f"  Stream {sno}: {s.blocks} block(s), "
                         f"compressed {s.c_len:,}, "
                         f"uncompressed {s.u_len:,}")
        if verbose:
            for bi, (sno, ct, cl, ul) in enumerate(ch.block_details):
                cname = C.CTYPE_NAMES.get(ct, str(ct))
                lines.append(f"    Block {bi + 1} stream {sno}: {cname} "
                             f"{cl:,} -> {ul:,}")
    return "\n".join(lines)
