"""lzo backend: from-scratch LZO1X codec.

No liblzo2 exists on this system, so unlike gzip/bzip2/zstd this one is
implemented from the bitstream spec.  The decoder handles the full LZO1X
instruction set (what the reference's lzo1x_decompress_safe consumes,
src/stream.c:781-813); the encoder emits a valid LZO1X subset (literal
runs + M2/M3/M4 matches) found with a greedy hash-4 matcher.

The native runtime (runtime/csrc/hostops.cpp) holds the C++ fast path;
this pure-Python version is the correctness reference and interop
fallback.
"""

from __future__ import annotations

from typing import Optional

from ..format.constants import CTYPE_LZO
from . import BackendConfig, register


def lzo1x_decompress(src: bytes, expected_len: int) -> bytes:
    dst = bytearray()
    ip = 0
    n = len(src)

    def copy_match(dist: int, length: int) -> None:
        pos = len(dst) - dist
        if pos < 0:
            raise ValueError("LZO match before start of output")
        for _ in range(length):
            dst.append(dst[pos])
            pos += 1

    state = 0
    t = src[ip]
    if t > 17:
        ip += 1
        t -= 17
        dst += src[ip:ip + t]
        ip += t
        state = 4 if t >= 4 else t

    while True:
        if ip >= n:
            raise ValueError("LZO stream truncated")
        t = src[ip]
        ip += 1
        if t < 16:
            if state == 0:
                if t == 0:
                    while src[ip] == 0:
                        t += 255
                        ip += 1
                    t += 15 + src[ip]
                    ip += 1
                t += 3
                dst += src[ip:ip + t]
                ip += t
                state = 4
                continue
            elif state == 4:
                # match after long literal run: len 3, dist 2049..3072
                d = (t >> 2) + (src[ip] << 2) + 2049
                ip += 1
                copy_match(d, 3)
            else:
                # match after short literal run: len 2, dist 1..1024
                d = (t >> 2) + (src[ip] << 2) + 1
                ip += 1
                copy_match(d, 2)
            trailing = t & 3
        elif t >= 64:
            # M2: len 3..8, dist 1..2048
            length = (t >> 5) + 1
            d = ((t >> 2) & 7) + (src[ip] << 3) + 1
            ip += 1
            copy_match(d, length)
            trailing = t & 3
        elif t >= 32:
            # M3: dist 1..16384
            length = t & 31
            if length == 0:
                while src[ip] == 0:
                    length += 255
                    ip += 1
                length += 31 + src[ip]
                ip += 1
            ds = src[ip] | (src[ip + 1] << 8)
            ip += 2
            d = (ds >> 2) + 1
            copy_match(d, length + 2)
            trailing = ds & 3
        else:
            # M4: dist 16384..49151, or end-of-stream
            length = t & 7
            dbits = (t & 8) << 11
            if length == 0:
                while src[ip] == 0:
                    length += 255
                    ip += 1
                length += 7 + src[ip]
                ip += 1
            ds = src[ip] | (src[ip + 1] << 8)
            ip += 2
            d = 16384 + dbits + (ds >> 2)
            if d == 16384:
                break  # end of stream marker
            copy_match(d, length + 2)
            trailing = ds & 3
        if trailing:
            dst += src[ip:ip + trailing]
            ip += trailing
            state = trailing
        else:
            state = 0

    if len(dst) != expected_len:
        raise ValueError(
            f"LZO decompressed {len(dst)} bytes, expected {expected_len}")
    return bytes(dst)


def _emit_literals(out: bytearray, lits: bytes, first: bool) -> None:
    t = len(lits)
    if t == 0:
        return
    if first and t <= 238:
        out.append(t + 17)
        out += lits
        return
    if t <= 3:
        # folded into the previous instruction's trailing-literal bits by
        # the caller; standalone short runs get a 3-byte-min run instead
        pass
    if t < 4:
        raise ValueError("standalone literal runs must be >= 4 bytes")
    if t <= 18:
        out.append(t - 3)
    else:
        tt = t - 18
        out.append(0)
        while tt > 255:
            out.append(0)
            tt -= 255
        out.append(tt)
    out += lits


def lzo1x_compress(data: bytes) -> Optional[bytes]:
    """Greedy LZO1X encoder (hash-4 chains, M2/M3/M4 instructions).

    Emits: initial literal run, then alternating match / literal-run
    instructions with trailing-literal folding, closed by the M4
    end-of-stream marker (dist 16384, len 3).
    """
    try:
        import numpy as np
    except ImportError:  # pragma: no cover
        return None
    n = len(data)
    if n < 16:
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    # 4-gram rolling keys and previous-occurrence table
    keys = (arr[:-3].astype(np.uint32)
            | (arr[1:-2].astype(np.uint32) << 8)
            | (arr[2:-1].astype(np.uint32) << 16)
            | (arr[3:].astype(np.uint32) << 24))
    HB = 16
    hashes = ((keys * np.uint32(2654435761)) >> np.uint32(32 - HB)).astype(
        np.int64)
    # nearest previous position with same hash bucket
    order = np.argsort(hashes, kind="stable")
    sh = hashes[order]
    prev_in_sorted = np.full(len(order), -1, dtype=np.int64)
    same = sh[1:] == sh[:-1]
    prev_in_sorted[1:][same] = order[:-1][same]
    cand = np.full(len(keys), -1, dtype=np.int64)
    cand[order] = prev_in_sorted

    out = bytearray()
    lit_start = 0
    i = 0
    first = True
    pending_trailing = 0  # where to fold <=3 trailing literals

    def flush_literals(upto: int) -> int:
        """Emit literals [lit_start, upto); returns trailing count folded."""
        nonlocal first
        t = upto - lit_start
        if t == 0:
            return 0
        if not first and t <= 3 and pending_trailing >= 0:
            # fold into previous instruction's low bits
            out[pending_trailing] |= t
            out.extend(data[lit_start:upto])
            return t
        _emit_literals(out, data[lit_start:upto], first)
        first = False
        return 0

    limit = n - 4  # last position where a match could start (need len>=3+lookup)
    while i < limit:
        j = cand[i] if i < len(cand) else -1
        match_len = 0
        if j >= 0 and j < i and data[j:j + 4] == data[i:i + 4]:
            dist = i - j
            if dist <= 49151:
                # extend
                m = 4
                maxm = n - i
                while m < maxm and data[j + m] == data[i + m]:
                    m += 1
                match_len = m
        if match_len >= 3 and (match_len >= 4 or (i - int(cand[i])) <= 2048):
            dist = i - int(cand[i])
            flush_literals(i)
            lit_pending = 0
            # choose instruction
            ml = match_len
            if 3 <= ml <= 8 and dist <= 2048:
                d = dist - 1
                instr_pos = len(out)
                out.append(((ml - 1) << 5) | ((d & 7) << 2))
                out.append(d >> 3)
            elif dist <= 16384:
                d = dist - 1
                instr_pos = len(out)
                ml2 = ml - 2
                if ml2 <= 31:
                    out.append(32 | ml2)
                else:
                    out.append(32)
                    rem = ml2 - 31
                    while rem > 255:
                        out.append(0)
                        rem -= 255
                    out.append(rem)
                out.append((d << 2) & 0xFF)
                out.append(d >> 6)
                instr_pos = len(out) - 2  # trailing bits live in ds low bits
            else:  # 16384 < dist <= 49151
                d = dist - 16384
                instr_pos = len(out)
                ml2 = ml - 2
                hi = 16 | ((d >> 11) & 8)
                if ml2 <= 7:
                    out.append(hi | ml2)
                else:
                    out.append(hi)
                    rem = ml2 - 7
                    while rem > 255:
                        out.append(0)
                        rem -= 255
                    out.append(rem)
                out.append((d << 2) & 0xFF)
                out.append((d >> 6) & 0xFF)
                instr_pos = len(out) - 2
            pending_trailing = instr_pos
            i += match_len
            lit_start = i
            first = False
        else:
            i += 1
    # trailing literals
    t = n - lit_start
    if t:
        if not first and t <= 3:
            out[pending_trailing] |= t
            out.extend(data[lit_start:])
        else:
            _emit_literals(out, data[lit_start:], first)
    # end-of-stream marker: M4 with dist 16384, len 3
    out.append(17)
    out.append(0)
    out.append(0)
    if len(out) >= n:
        return None
    return bytes(out)


def compress(data: bytes, cfg: BackendConfig) -> Optional[bytes]:
    from .. import runtime
    if runtime.available():
        return runtime.lzo1x_encode(data)
    return lzo1x_compress(data)


def decompress(payload: bytes, u_len: int, cfg: BackendConfig) -> bytes:
    from .. import runtime
    if runtime.available():
        out = runtime.lzo1x_decode(payload, u_len)
        if out is not None:
            return out
    return lzo1x_decompress(payload, u_len)


register("lzo", CTYPE_LZO, compress, decompress)
