"""A plain decoder of the ``.lrz`` archives the benchmark's cells write.

NumPy and the standard library only (``lzma``, ``hashlib``, ``zlib``);
it imports nothing of the program and reads nothing the program made
but the archive's bytes.  It covers what the cells write: the v0.14
magic header (no encryption, no filter), the rzip chunks with their two
streams of linked blocks, blocks stored raw (c_type 3), raw LZMA1 blocks
(c_type 6, lc 3 lp 0 pb 2) and interleaved-rANS blocks (c_type 11), the
token stream, the replay, each chunk's CRC32 and the trailing MD5.

Layout (lrzip-next ``doc/magic.header.txt``; the rANS block is the
program's own ``CTYPE_RANS`` wire format):

- magic: ``LRZI``, major 0, minor 11-14, u64 size, hash code (1 = MD5),
  encryption (0), filter (0), method, dictionary prop, levels, comment
  length, the comment;
- chunk: u8 width ``w``, u8 eof, ``w``-byte size, two blank headers whose
  last field points at the first block of stream 0 and of stream 1, then
  blocks ``u8 c_type, w c_len, w u_len, w next`` and their payloads;
  offsets count from the byte after the size;
- token stream: ``u8 kind, u16 len`` and for a match a ``w``-byte
  backward distance; ``0, 0`` ends it, then the chunk's CRC32 as 4 bytes
  most significant first;
- rANS block: ``<BBBBQIII`` (version 1, ctx_bits, log2 K, 0, n, words,
  table bytes, T), the zlib'd table of 12-bit frequencies, K u32 states,
  the u16 words.  Lane ``l`` holds bytes ``[l*T, (l+1)*T)``; the K states
  step forward together; a state under 2^16 takes the next word, lanes
  in order; each lane's context is its previous byte's top ``ctx_bits``.
"""

from __future__ import annotations

import hashlib
import lzma
import struct
import zlib
from dataclasses import dataclass, field
from typing import List

import numpy as np

CTYPE_NONE, CTYPE_LZMA, CTYPE_RANS = 3, 6, 11
MAGIC_LEN = 21
HASH_LEN = {1: 16}
RANS_HDR = struct.Struct("<BBBBQIII")
M_BITS = 12
M = 1 << M_BITS
L_INIT = 1 << 16


class Corrupt(ValueError):
    """The archive does not decode."""


@dataclass
class Magic:
    header_len: int
    size: int
    hash_code: int
    dict_size: int


@dataclass
class Chunk:
    offset: int
    width: int
    eof: bool
    size: int
    end: int
    blocks: List[list] = field(default_factory=lambda: [[], []])


def lzma_dict_size(prop: int) -> int:
    return (2 | (prop & 1)) << (prop // 2 + 11)


def read_magic(buf) -> Magic:
    b = bytes(buf[:MAGIC_LEN])
    if len(b) < MAGIC_LEN or b[:4] != b"LRZI" or b[4] != 0 or \
            not 11 <= b[5] <= 14:
        raise Corrupt("not a v0.11-0.14 lrz archive")
    if b[15] or b[16]:
        raise Corrupt("encrypted or filtered archives are not covered")
    return Magic(header_len=MAGIC_LEN + b[20],
                 size=int.from_bytes(b[6:14], "little"), hash_code=b[14],
                 dict_size=lzma_dict_size(b[18]) if b[17] & 0x0F == 1 else 0)


def read_chunks(buf, offset: int) -> List[Chunk]:
    """Every chunk's header and block list, without decoding a block."""
    out = []
    while True:
        w, eof = buf[offset], buf[offset + 1]
        if not 1 <= w <= 8:
            raise Corrupt(f"chunk width {w}")
        size = int.from_bytes(bytes(buf[offset + 2:offset + 2 + w]), "little")
        base = offset + 2 + w
        hdr = 1 + 3 * w
        ch = Chunk(offset=offset, width=w, eof=bool(eof), size=size, end=0)
        end = base + 2 * hdr

        def field_at(pos, k):
            p = base + pos + 1 + k * w
            return int.from_bytes(bytes(buf[p:p + w]), "little")

        for s in (0, 1):
            pos = field_at(s * hdr, 2)
            while pos:
                c_type = buf[base + pos]
                c_len, u_len, nxt = (field_at(pos, k) for k in range(3))
                data = base + pos + hdr
                end = max(end, data + c_len)
                if c_len == 0 and u_len == 0:
                    break
                ch.blocks[s].append((c_type, c_len, u_len, data))
                if nxt and nxt <= pos:
                    raise Corrupt("block chain moves backwards")
                pos = nxt
        ch.end = end
        out.append(ch)
        offset = end
        if eof:
            return out


def rans_decode(payload, u_len: int) -> bytes:
    magic, ctx_bits, klog, _, n, nw, tlen, t_len = RANS_HDR.unpack_from(
        payload, 0)
    if magic != 1 or ctx_bits not in (0, 4, 6, 8) or n != u_len:
        raise Corrupt("bad rANS block header")
    if n == 0:
        return b""
    k = 1 << klog
    off = RANS_HDR.size
    tri = np.frombuffer(zlib.decompress(bytes(payload[off:off + tlen])),
                        np.uint8).reshape(-1, 3).astype(np.int64)
    off += tlen
    freqs = np.empty(tri.shape[0] * 2, np.int64)
    freqs[0::2] = tri[:, 0] | ((tri[:, 1] & 0x0F) << 8)
    freqs[1::2] = (tri[:, 1] >> 4) | (tri[:, 2] << 4)
    c_ctx = 1 << ctx_bits
    freqs = freqs.reshape(c_ctx, 256)
    if (freqs.sum(1) != M).any() or (freqs < 1).any():
        raise Corrupt("bad rANS frequency table")
    cum = np.cumsum(freqs, 1) - freqs
    sym = np.concatenate([np.repeat(np.arange(256, dtype=np.int64), row)
                          for row in freqs])            # (C * M,)
    f_flat, cum_flat = freqs.reshape(-1), cum.reshape(-1)
    x = np.frombuffer(bytes(payload[off:off + 4 * k]), "<u4").astype(
        np.int64)
    off += 4 * k
    words = np.frombuffer(bytes(payload[off:off + 2 * nw]), "<u2").astype(
        np.int64)
    if x.shape[0] != k or words.shape[0] != nw:
        raise Corrupt("rANS block truncated")
    words = np.concatenate([words, np.zeros(k, np.int64)])
    cq = np.zeros(k, np.int64)
    plane = np.zeros((t_len, k), np.uint8)
    ptr = 0
    for t in range(t_len):
        nv = min(k, (n - t + t_len - 1) // t_len)
        if nv <= 0:
            break
        xv = x[:nv]
        slot = xv & (M - 1)
        s = sym[(cq[:nv] << M_BITS) | slot]
        idx = (cq[:nv] << 8) | s
        xv = f_flat[idx] * (xv >> M_BITS) + slot - cum_flat[idx]
        e = xv < L_INIT
        ne = int(np.count_nonzero(e))
        if ne:
            if ptr + ne > words.shape[0]:
                raise Corrupt("rANS stream overrun")
            xv[e] = (xv[e] << 16) | words[ptr:ptr + ne]
            ptr += ne
        x[:nv] = xv
        if ctx_bits:
            cq[:nv] = s >> (8 - ctx_bits)
        plane[t, :nv] = s
    if (x != L_INIT).any():
        raise Corrupt("rANS final states")
    return plane.T.reshape(-1)[:n].tobytes()


def decode_block(buf, block, dict_size: int) -> bytes:
    c_type, c_len, u_len, data = block
    payload = memoryview(buf)[data:data + c_len]
    try:
        if c_type == CTYPE_NONE:
            out = bytes(payload)
        elif c_type == CTYPE_RANS:
            out = rans_decode(payload, u_len)
        elif c_type == CTYPE_LZMA:
            dec = lzma.LZMADecompressor(format=lzma.FORMAT_RAW, filters=[{
                "id": lzma.FILTER_LZMA1, "dict_size": max(dict_size, 4096),
                "lc": 3, "lp": 0, "pb": 2}])
            out = dec.decompress(bytes(payload), max_length=u_len)
        else:
            raise Corrupt(f"c_type {c_type} is not covered")
    except (zlib.error, lzma.LZMAError, struct.error, IndexError) as e:
        raise Corrupt(f"c_type {c_type} block: {e}") from e
    if len(out) != u_len:
        raise Corrupt(f"block of {len(out)} bytes, {u_len} stored")
    return out


def parse_tokens(stream0: bytes, w: int):
    """(tokens [(kind, len, dist)], stored CRC bytes) of a token stream."""
    toks = []
    p, n = 0, len(stream0)
    while True:
        if p + 3 > n:
            raise Corrupt("token stream without its end")
        kind = stream0[p]
        ln = stream0[p + 1] | stream0[p + 2] << 8
        if kind == 0:
            if ln == 0:
                break
            toks.append((0, ln, 0))
            p += 3
        else:
            toks.append((1, ln, int.from_bytes(stream0[p + 3:p + 3 + w],
                                               "little")))
            p += 3 + w
    return toks, stream0[p + 3:p + 7]


def replay(tokens, literals: bytes, size: int) -> bytes:
    out = bytearray(size)
    pos = lit = 0
    for kind, ln, dist in tokens:
        if pos + ln > size:
            raise Corrupt("tokens overrun the chunk")
        if kind == 0:
            out[pos:pos + ln] = literals[lit:lit + ln]
            lit += ln
        else:
            src = pos - dist
            if dist <= 0 or src < 0:
                raise Corrupt("match before the chunk")
            if dist >= ln:
                out[pos:pos + ln] = out[src:src + ln]
            else:
                out[pos:pos + ln] = (out[src:pos] * (ln // dist + 1))[:ln]
        pos += ln
    if pos != size or lit != len(literals):
        raise Corrupt("tokens do not fill the chunk")
    return bytes(out)


def decode_chunk(buf, chunk: Chunk, magic: Magic) -> bytes:
    streams = [b"".join(decode_block(buf, b, magic.dict_size)
                        for b in chunk.blocks[s]) for s in (0, 1)]
    tokens, crc = parse_tokens(streams[0], chunk.width)
    data = replay(tokens, streams[1], chunk.size)
    if crc != (zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "big"):
        raise Corrupt("chunk CRC32")
    return data


def stored_hash(buf, chunks: List[Chunk], magic: Magic) -> bytes:
    n = HASH_LEN.get(magic.hash_code)
    if n is None:
        raise Corrupt(f"hash code {magic.hash_code} is not covered")
    return bytes(buf[chunks[-1].end:chunks[-1].end + n])


def md5(data) -> bytes:
    return hashlib.md5(data).digest()


def decode(buf) -> bytes:
    """The whole archive, every check applied."""
    magic = read_magic(buf)
    chunks = read_chunks(buf, magic.header_len)
    data = b"".join(decode_chunk(buf, c, magic) for c in chunks)
    if len(data) != magic.size or stored_hash(buf, chunks, magic) != md5(data):
        raise Corrupt("size or MD5")
    return data
