"""Stream container: rzip chunk framing + per-stream block linked lists.

On-disk layout of one rzip chunk (unencrypted, v0.6+; reference
src/stream.c:1550-1834 ``compthread`` write side and
src/stream.c:1352-1506 / 2022-2195 ``open_stream_in`` / ``fill_buffer``
read side):

    u8   chunk_bytes (w, 1..8)
    u8   eof flag (1 if no chunk follows)
    w    chunk decompressed size (LE)
    -- initial_pos: all block offsets below are relative to here --
    per stream j in {0, 1}: blank header  u8 CTYPE_NONE + w*3 zeros,
        whose final w bytes ("next block head") get patched to the offset
        of stream j's first real block header
    blocks (any physical order, contiguous):
        u8 c_type | w c_len | w u_len | w next_head
        c_len bytes of payload

Each stream's headers form a forward-linked list via next_head offsets
(0 terminates).  The reference patches next_head by seeking back
(src/stream.c:1772-1783); we know every block size up front, so offsets
are computed with a prefix sum and written in one pass - no seeking.
"""

from __future__ import annotations

import dataclasses
import io
from typing import BinaryIO, Iterator, List, Optional, Sequence, Tuple

from .constants import CTYPE_NONE, NUM_STREAMS


@dataclasses.dataclass
class Block:
    """One compressed block belonging to a stream."""

    streamno: int
    c_type: int
    c_len: int
    u_len: int
    payload: bytes  # len == c_len (unencrypted)


@dataclasses.dataclass
class ChunkHeader:
    chunk_bytes: int
    eof: bool
    size: int  # decompressed chunk size


def write_chunk(fd: BinaryIO, chunk_bytes: int, eof: bool, size: int,
                blocks: Sequence[Block], crypto=None) -> int:
    """Serialise one rzip chunk; returns bytes written.

    ``blocks`` are written in the given physical order; the per-stream
    linked lists are computed up front via a prefix sum over block sizes
    (replacing the reference's seek-back patching, src/stream.c:1772-1783).

    With a ``crypto`` context (lrzip -e): header fields widen to 8 bytes,
    the chunk size is omitted, every header gets an 8-byte salt prefix
    and is AES-CBC-CTS encrypted with it, and payloads (padded to the key
    length) are encrypted under their own trailing-salt - matching the
    layout the reference produces via rewrite_encrypted
    (src/stream.c:1513-1546, 1654-1664, 1722-1828).
    """
    w = chunk_bytes
    out = io.BytesIO()
    out.write(bytes([w, 1 if eof else 0]))
    if crypto is None:
        out.write(size.to_bytes(w, "little"))

    fw = 8 if crypto is not None else w  # header field width
    salt_sz = 8 if crypto is not None else 0
    hdr_sz = salt_sz + 1 + 3 * fw

    padded = []
    for b in blocks:
        if len(b.payload) != b.c_len:
            raise ValueError("payload length does not match c_len")
        p = crypto.pad_for_crypt(b.payload) if crypto is not None \
            else b.payload
        padded.append(p)

    # initial_pos-relative offset layout; offsets point at each block's
    # salt (encrypted) / c_type byte (plain)
    pos = 0
    blank_next_field_unused = None
    for _ in range(NUM_STREAMS):
        pos += hdr_sz
    block_ofs = []
    for i, b in enumerate(blocks):
        block_ofs.append(pos)
        pos += hdr_sz + (salt_sz if crypto is not None else 0) \
            + len(padded[i])

    next_of = [0] * len(blocks)
    blank_next = [0] * NUM_STREAMS
    last_seen = [None] * NUM_STREAMS
    for i, b in enumerate(blocks):
        s = b.streamno
        if last_seen[s] is None:
            blank_next[s] = block_ofs[i]
        else:
            next_of[last_seen[s]] = block_ofs[i]
        last_seen[s] = i

    def emit_header(c_type: int, c_len: int, u_len: int, nxt: int) -> None:
        hdr = bytes([c_type]) + c_len.to_bytes(fw, "little") \
            + u_len.to_bytes(fw, "little") + nxt.to_bytes(fw, "little")
        if crypto is not None:
            hsalt = crypto.new_block_salt()
            out.write(hsalt)
            out.write(crypto.encrypt_block(hdr, hsalt))
        else:
            out.write(hdr)

    for j in range(NUM_STREAMS):
        emit_header(CTYPE_NONE, 0, 0, blank_next[j])
    for i, b in enumerate(blocks):
        emit_header(b.c_type, b.c_len, b.u_len, next_of[i])
        if crypto is not None:
            bsalt = crypto.new_block_salt()
            out.write(bsalt)
            out.write(crypto.encrypt_block(padded[i], bsalt))
        else:
            out.write(padded[i])

    data = out.getvalue()
    fd.write(data)
    return len(data)


def read_chunk_header(fd: BinaryIO, encrypted: bool = False
                      ) -> Optional[ChunkHeader]:
    """Read the chunk preamble; None at clean EOF.

    Encrypted archives omit the chunk size (reference
    src/stream.c:1404-1426).
    """
    b = fd.read(1)
    if not b:
        return None
    w = b[0]
    if not 1 <= w <= 8:
        raise ValueError(f"chunk_bytes {w} is invalid")
    eof = fd.read(1)[0]
    size = 0
    if not encrypted:
        size = int.from_bytes(fd.read(w), "little")
    return ChunkHeader(chunk_bytes=w, eof=bool(eof), size=size)


@dataclasses.dataclass
class BlockRef:
    """Location/metadata of a block discovered by walking the chain."""

    streamno: int
    c_type: int
    c_len: int
    u_len: int
    data_ofs: int  # absolute file offset of payload


class ChunkReader:
    """Walk one chunk's stream chains and expose blocks.

    Mirrors the validation the reference applies while walking
    (src/stream.c:2091-2109 and src/lrzip.c:1222-1239): header chains must
    move strictly forward and lengths must be positive.
    """

    def __init__(self, fd: BinaryIO, header: ChunkHeader, crypto=None):
        self.fd = fd
        self.header = header
        self.w = header.chunk_bytes
        self.crypto = crypto
        self.fw = 8 if crypto is not None else self.w
        self.salt_sz = 8 if crypto is not None else 0
        self.initial_pos = fd.tell()
        self.stream_head: List[int] = []
        self.total_read = 0
        hdr_sz = self.salt_sz + 1 + 3 * self.fw
        for j in range(NUM_STREAMS):
            c_type, c_len, u_len, nxt = self._read_header_at(
                self.initial_pos + j * hdr_sz)
            if c_type != CTYPE_NONE or c_len or u_len:
                raise ValueError(
                    f"unexpected initial stream header (tag {c_type})"
                    + (" - wrong password?" if crypto is not None else ""))
            self.stream_head.append(nxt)
            self.total_read += hdr_sz

    def _read_header_at(self, abs_ofs: int) -> Tuple[int, int, int, int]:
        self.fd.seek(abs_ofs)
        raw = self.fd.read(self.salt_sz + 1 + 3 * self.fw)
        if len(raw) < self.salt_sz + 1 + 3 * self.fw:
            raise ValueError("truncated block header")
        if self.crypto is not None:
            salt, enc = raw[:8], raw[8:]
            hdr = self.crypto.decrypt_block(enc, salt)
        else:
            hdr = raw
        c_type = hdr[0]
        w = self.fw
        c_len = int.from_bytes(hdr[1:1 + w], "little")
        u_len = int.from_bytes(hdr[1 + w:1 + 2 * w], "little")
        nxt = int.from_bytes(hdr[1 + 2 * w:1 + 3 * w], "little")
        return c_type, c_len, u_len, nxt

    def blocks(self, streamno: int) -> Iterator[BlockRef]:
        """Yield the blocks of one stream in chain order."""
        pos = self.stream_head[streamno]
        prev = 0
        while pos:
            if pos <= prev:
                raise ValueError("block chain moves backwards: corrupt")
            c_type, c_len, u_len, nxt = self._read_header_at(
                self.initial_pos + pos)
            hdr_sz = self.salt_sz + 1 + 3 * self.fw
            if self.crypto is not None:
                padded = max(c_len, self.crypto.keylen)
                self.total_read += hdr_sz + self.salt_sz + padded
            else:
                self.total_read += hdr_sz + c_len
            if c_len == 0 and u_len == 0:
                # empty trailing block (reference writes one when a stream
                # buffer is empty at close, skipped at src/stream.c:2086)
                if nxt:
                    raise ValueError("empty block with successor: corrupt")
                return
            if c_len < 1 or u_len < 1:
                raise ValueError(
                    f"invalid block lengths c_len={c_len} u_len={u_len}")
            yield BlockRef(
                streamno=streamno, c_type=c_type, c_len=c_len, u_len=u_len,
                data_ofs=self.initial_pos + pos + self.salt_sz + 1
                + 3 * self.fw)
            prev = pos
            pos = nxt

    def read_payload(self, ref: BlockRef) -> bytes:
        self.fd.seek(ref.data_ofs)
        if self.crypto is not None:
            bsalt = self.fd.read(8)
            padded = max(ref.c_len, self.crypto.keylen)
            enc = self.fd.read(padded)
            if len(bsalt) < 8 or len(enc) < padded:
                raise ValueError("truncated block payload")
            return self.crypto.decrypt_block(enc, bsalt)[:ref.c_len]
        data = self.fd.read(ref.c_len)
        if len(data) < ref.c_len:
            raise ValueError("truncated block payload")
        return data

    def end_offset(self) -> int:
        """Absolute offset just past this chunk's data.

        Matches the reference's initial_pos + total_read bookkeeping
        (src/stream.c:2299-2307 ``close_stream_in``), which assumes blocks
        are contiguous after the chunk header.
        """
        return self.initial_pos + self.total_read
