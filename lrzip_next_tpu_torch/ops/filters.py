"""Pre-compression filters: delta + BCJ branch converters.

The reference applies these to stream-1 (literal) blocks before the
backend codec (src/stream.c:1586-1628 encode, 1936-1990 decode), using
the LZMA SDK implementations (src/lzma/C/Bra.c, Bra86.c, Delta.c).

These are pure byte-level transforms, re-implemented here as vectorised
numpy ops (they are embarrassingly parallel except for the x86 filter's
small sequential state, handled with a scan).
"""

from __future__ import annotations

import numpy as np

from ..format.constants import (FILTER_ARM, FILTER_ARM64, FILTER_ARMT,
                                FILTER_DELTA, FILTER_IA64, FILTER_PPC,
                                FILTER_RISCV, FILTER_SPARC, FILTER_X86)


# ---------------------------------------------------------------- delta

def delta_encode(data: bytes, offset: int) -> bytes:
    """out[i] = in[i] - in[i-offset] (mod 256); first `offset` bytes raw.

    Matches Delta_Encode (reference src/lzma/C/Delta.c:16-113) with a
    zero-initialised state buffer.
    """
    a = np.frombuffer(data, dtype=np.uint8)
    out = a.copy()
    if len(a) > offset:
        out[offset:] = a[offset:] - a[:-offset]
    return out.tobytes()


def delta_decode(data: bytes, offset: int) -> bytes:
    """Inverse of delta_encode: prefix-sum with stride ``offset``."""
    a = np.frombuffer(data, dtype=np.uint8).copy()
    n = len(a)
    if n > offset:
        # per-residue-class cumulative sum (wraps mod 256)
        for r in range(offset):
            lane = a[r::offset]
            np.cumsum(lane, dtype=np.uint8, out=lane)
    return a.tobytes()


# ------------------------------------------------------------ BCJ: ARM

def _arm_conv(data: bytes, ip: int, encoding: bool) -> bytes:
    """ARM BL: 4-byte words with byte3 == 0xEB get their 24-bit word
    offset converted between relative and absolute (Bra.c ARM path)."""
    a = np.frombuffer(data, dtype=np.uint8).copy()
    n = len(a) & ~3
    if n < 4:
        return data
    w = a[:n].view("<u4").copy()
    mask = (w >> 24) == 0xEB
    idx = np.flatnonzero(mask)
    if len(idx):
        src = (w[idx] & 0x00FFFFFF) << 2
        pc = (ip + idx.astype(np.uint64) * 4 + 8).astype(np.uint32)
        dest = (src + pc) if encoding else (src - pc)
        w[idx] = (0xEB << 24) | ((dest >> 2) & 0x00FFFFFF)
    a[:n] = w.view(np.uint8)
    return a.tobytes()


def _armt_conv(data: bytes, ip: int, encoding: bool) -> bytes:
    """ARM Thumb BL: pairs of 16-bit words (0xF0xx, 0xF8xx) (Bra.c ARMT)."""
    a = bytearray(data)
    n = len(a)
    i = 0
    while i + 4 <= n:
        if (a[i + 1] & 0xF8) == 0xF0 and (a[i + 3] & 0xF8) == 0xF8:
            src = (((a[i + 1] & 0x7) << 19) | (a[i] << 11)
                   | ((a[i + 3] & 0x7) << 8) | a[i + 2]) << 1
            pc = ip + i + 4
            dest = (src + pc if encoding else src - pc) & 0xFFFFFFFF
            dest >>= 1
            a[i + 1] = 0xF0 | ((dest >> 19) & 0x7)
            a[i] = (dest >> 11) & 0xFF
            a[i + 3] = 0xF8 | ((dest >> 8) & 0x7)
            a[i + 2] = dest & 0xFF
            i += 2
        i += 2
    return bytes(a)


def _arm64_conv(data: bytes, ip: int, encoding: bool) -> bytes:
    """ARM64 BL (imm26) + ADRP conversion - exact transliteration of
    z7_BranchConv_ARM64 (reference src/lzma/C/Bra.c:75-124); every
    4-byte word transforms independently, so fully vectorised."""
    a = np.frombuffer(data, dtype=np.uint8).copy()
    n = len(a) & ~3
    if n < 4:
        return data
    with np.errstate(over="ignore"):
        w = a[:n].view("<u4").copy()
        pos = (np.uint32(ip) + np.arange(len(w), dtype=np.uint32) * 4)
        flag = np.uint32(1 << 20)
        mask = np.uint32((1 << 24) - (1 << 21))

        # BL: ((v - 0x94000000) & 0xfc000000) == 0
        bl = ((w - np.uint32(0x94000000)) & np.uint32(0xFC000000)) == 0
        c = pos >> 2
        vbl = (w + c) if encoding else (w - c)
        vbl = (vbl & np.uint32(0x03FFFFFF)) | np.uint32(0x94000000)

        # ADRP: v = w - 0x90000000; (v & 0x9f000000) == 0;
        # v += flag; (v & mask) == 0
        v = w - np.uint32(0x90000000)
        adrp0 = (v & np.uint32(0x9F000000)) == 0
        v2 = v + flag
        adrp = adrp0 & ((v2 & mask) == 0)
        z = (v2 & np.uint32(0xFFFFFFE0)) | (v2 >> 26)
        ca = (pos >> np.uint32(12 - 3)) & ~np.uint32(7)
        z = (z + ca) if encoding else (z - ca)
        vout = (np.uint32(0x90000000) | (v2 & np.uint32(0x1F))
                | (z << 26)
                | (np.uint32(0x00FFFFE0)
                   & ((z & np.uint32((1 << 21) - 1)) - flag)))

        w = np.where(bl, vbl, np.where(adrp, vout, w))
        a[:n] = w.view(np.uint8)
    return a.tobytes()


def _ppc_conv(data: bytes, ip: int, encoding: bool) -> bytes:
    """PPC bl: big-endian words matching (w & 0xFC000003) == 0x48000001."""
    a = np.frombuffer(data, dtype=np.uint8).copy()
    n = len(a) & ~3
    if n < 4:
        return data
    w = a[:n].view(">u4").copy()
    mask = (w & 0xFC000003) == 0x48000001
    idx = np.flatnonzero(mask)
    if len(idx):
        src = w[idx] & 0x03FFFFFC
        pc = (np.uint32(ip) + idx.astype(np.uint32) * 4)
        dest = (src + pc) if encoding else (src - pc)
        w[idx] = np.uint32(0x48000001) | (dest & 0x03FFFFFC)
    a[:n] = w.view(np.uint8)
    return a.tobytes()


def _sparc_conv(data: bytes, ip: int, encoding: bool) -> bytes:
    """SPARC CALL conversion - exact transliteration of
    z7_BranchConv_SPARC (reference src/lzma/C/Bra.c:198-256, non-rotate
    variant); per-word independent, vectorised."""
    a = np.frombuffer(data, dtype=np.uint8).copy()
    n = len(a) & ~3
    if n < 4:
        return data
    with np.errstate(over="ignore"):
        w = a[:n].view(">u4").astype(np.uint32)
        pos = (np.uint32(ip) + np.arange(len(w), dtype=np.uint32) * 4)
        flag = np.uint32(1 << 22)
        t = w + np.uint32(5 << 29)
        t ^= np.uint32(7 << 29)
        t += flag
        match = (t & (np.uint32(0) - (flag << 1))) == 0
        v = t << 2
        v = (v + pos) if encoding else (v - pos)
        v &= (flag << 3) - np.uint32(1)
        v -= flag << 2
        v >>= 2
        v |= np.uint32(1) << 30
        out = np.where(match, v, w)
        a[:n] = out.astype(">u4").view(np.uint8)
    return a.tobytes()


# ------------------------------------------------------------- BCJ: x86

def _test_ms_byte(b: int) -> bool:
    return ((b + 1) & 0xFE) == 0  # b == 0 or b == 0xFF


def _x86_conv(data: bytes, ip: int, encoding: bool) -> bytes:
    """x86 CALL/JMP rel32 conversion (reference src/lzma/C/Bra86.c).

    Faithful port of the SDK's x86 branch converter semantics (the
    goto-optimised z7_BranchConvSt_X86 computes the same function as the
    classic x86_Convert): scan for 0xE8/0xE9 opcode bytes, convert the
    following 32-bit offset between relative and absolute when its most
    significant byte is 0x00/0xFF, with the 3-bit mask state machine
    suppressing overlapping false positives.  State starts at 0
    (Z7_BRANCH_CONV_ST_X86_STATE_INIT_VAL, used by the reference at
    src/stream.c:1597).
    """
    a = bytearray(data)
    size = len(a)
    if size < 5:
        return data
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    # candidate opcode positions below the 4-byte tail limit
    cands = np.flatnonzero((arr[:size - 4] & 0xFE) == 0xE8)
    mask = 0
    pos = 0
    ipp = (ip + 5) & 0xFFFFFFFF
    ci = 0
    ncand = len(cands)
    while ci < ncand:
        p = int(cands[ci])
        if p < pos:
            ci += 1
            continue
        d = p - pos
        pos = p
        if d > 2:
            mask = 0
        else:
            mask = (mask >> d) & 7
            if mask != 0 and (mask > 4 or mask == 3 or
                              _test_ms_byte(a[p + (mask >> 1) + 1])):
                mask = ((mask >> 1) | 4) & 7
                pos += 1
                continue
        if _test_ms_byte(a[p + 4]):
            v = (a[p + 1] | (a[p + 2] << 8) | (a[p + 3] << 16)
                 | (a[p + 4] << 24))
            cur = (ipp + pos) & 0xFFFFFFFF
            pos += 5
            v = (v + cur if encoding else v - cur) & 0xFFFFFFFF
            if mask != 0:
                sh = (mask & 6) << 2
                if _test_ms_byte((v >> sh) & 0xFF):
                    v ^= ((0x100 << sh) - 1) & 0xFFFFFFFF
                    v = (v + cur if encoding else v - cur) & 0xFFFFFFFF
                mask = 0
            a[p + 1] = v & 0xFF
            a[p + 2] = (v >> 8) & 0xFF
            a[p + 3] = (v >> 16) & 0xFF
            a[p + 4] = (0 - ((v >> 24) & 1)) & 0xFF
        else:
            mask = ((mask >> 1) | 4) & 7
            pos += 1
    return bytes(a)


# ----------------------------------------------------------- BCJ: IA64

def _ia64_conv(data: bytes, ip: int, encoding: bool) -> bytes:
    """IA64 branch conversion - exact transliteration of
    z7_BranchConv_IA64 (reference src/lzma/C/Bra.c:343-430): 16-byte
    bundles, template byte selects which 41-bit slots hold branches."""
    a = bytearray(data)
    size = len(a) & ~15
    if size == 0:
        return data
    M32 = 0xFFFFFFFF
    pc = ((ip - 16) & M32) >> 3
    p = 0
    while p < size:
        m = (0x334B0000 >> (a[p] & 0x1E)) & 3
        p += 16
        pc = (pc + 2) & M32
        if not m:
            continue
        q = p + m * 5 - 20
        while True:
            t = a[q] | (a[q + 1] << 8)
            z = (a[q + 1] | (a[q + 2] << 8) | (a[q + 3] << 16)
                 | (a[q + 4] << 24)) >> m
            q += 5
            if ((t >> m) & (0x70 << 1)) == 0 and \
                    ((z - (0x5000000 << 1)) & (0xF000000 << 1)) == 0:
                v = ((0x8FFFFF << 1) | 1) & z
                z ^= v
                if encoding:
                    c = pc & ((0x1FFFFF << 1) | 1)
                    v = (v + c) & M32
                else:
                    c = (pc | (~((0x1FFFFF << 1) | 1) & M32)) & M32
                    v = (v - c) & M32
                v &= ~(0x600000 << 1) & M32
                v = (v + (0x700000 << 1)) & M32
                v &= (0x8FFFFF << 1) | 1
                z |= v
                z = (z << m) & M32
                a[q - 4] = z & 0xFF
                a[q - 3] = (z >> 8) & 0xFF
                a[q - 2] = (z >> 16) & 0xFF
                a[q - 1] = (z >> 24) & 0xFF
            m = (m + 1) & 3
            if not m:
                break
    return bytes(a)


# ---------------------------------------------------------- BCJ: RISCV

def _riscv_check1(v: int, b: int) -> bool:
    return (((b - 3) ^ (v << 8)) & (0xF8000 + 3)) & 0xFFFFFFFF == 0


def _riscv_check2(v: int, r: int) -> bool:
    return (((v - ((3 << 12) | (2 << 7) | 8)) << 18) & 0xFFFFFFFF) \
        < (r & 0x1D)


def _riscv_conv(data: bytes, ip: int, encoding: bool) -> bytes:
    """RISC-V JAL/AUIPC conversion - exact transliteration of
    z7_BranchConv_RISCV_Enc/Dec (reference src/lzma/C/Bra.c:480-709)."""
    a = bytearray(data)
    M32 = 0xFFFFFFFF
    size = len(a) & ~1
    if size <= 6:
        return data
    lim = size - 6
    p = 0

    def u16(i):
        return a[i] | (a[i + 1] << 8)

    def u32(i):
        return a[i] | (a[i + 1] << 8) | (a[i + 2] << 16) | (a[i + 3] << 24)

    def set32(i, v):
        a[i] = v & 0xFF
        a[i + 1] = (v >> 8) & 0xFF
        a[i + 2] = (v >> 16) & 0xFF
        a[i + 3] = (v >> 24) & 0xFF

    while True:
        # scan for JAL/AUIPC opcode low bytes (0x6f/0xef/0x17/0x97)
        while True:
            if p >= lim:
                return bytes(a)
            av = ((u16(p) ^ 0x10) + 1) & M32
            if (av & 0x77) == 0:
                break
            av = ((u16(p + 2) ^ 0x10) + 1) & M32
            p += 4
            if (av & 0x77) == 0:
                p -= 2
                if p >= lim:
                    return bytes(a)
                break
        v = av
        if encoding:
            af = u32(p)
            if (v & 8) == 0:  # JAL
                if (v - 0x100) & 0xD80:
                    p += 2
                    continue
                w = (((af & (1 << 31)) >> 11)
                     | ((af & (0x3FF << 21)) >> 20)
                     | ((af & (1 << 20)) >> 9)
                     | (af & (0xFF << 12)))
                w = (w + ip + p) & M32
                a[p + 1] = ((w >> 13) & 0xF0) | ((af >> 8) & 0xF)
                a[p + 2] = (w >> 9) & 0xFF
                a[p + 3] = (w >> 1) & 0xFF
                p += 4
                continue
            # AUIPC
            if v & 0xE80:  # not x0/x2
                b = u32(p + 4)
                if _riscv_check1(v, b):
                    set32(p, ((b << 12) & M32) | (0x17 + (2 << 7)))
                    af &= 0xFFFFF000
                    af = (af + ((b >> 20) - ((b >> 19) & 0x1000))) & M32
                    af = (af + ip + p) & M32
                    # store big-endian
                    a[p + 4] = (af >> 24) & 0xFF
                    a[p + 5] = (af >> 16) & 0xFF
                    a[p + 6] = (af >> 8) & 0xFF
                    a[p + 7] = af & 0xFF
                    p += 8
                else:
                    p += 6
            else:
                r = af >> 27
                if _riscv_check2(v, r):
                    v2 = u32(p + 4)
                    set32(p, ((r << 7) + 0x17 + (v2 & 0xFFFFF000)) & M32)
                    set32(p + 4, ((af >> 12) | ((v2 << 20) & M32)) & M32)
                    p += 8
                else:
                    p += 4
        else:  # decode
            if (v & 8) == 0:  # JAL
                v = (v - (0x100 - 0x7F)) & M32
                if v & 0xD80:
                    p += 2
                    continue
                a_old = (v + (0xEF - 0x7F)) & 0xFFF
                w = ((a[p + 3] << 1) | (a[p + 2] << 9)
                     | ((v & 0xF000) << 5))
                w = (w - (ip + p)) & M32
                nv = (a_old
                      | ((w << 11) & (1 << 31))
                      | ((w << 20) & (0x3FF << 21))
                      | ((w << 9) & (1 << 20))
                      | (w & (0xFF << 12)))
                set32(p, nv & M32)
                p += 4
                continue
            # AUIPC
            af = (v | (u16(p + 2) << 16)) & M32
            if (v & 0xE80) == 0:  # x0/x2
                r = af >> 27
                if _riscv_check2(v, r):
                    b = (a[p + 4] << 24) | (a[p + 5] << 16) \
                        | (a[p + 6] << 8) | a[p + 7]  # big-endian read
                    w = af >> 12
                    b = (b - (ip + p)) & M32
                    nv = ((r << 7) + 0x17 + ((b + 0x800) & 0xFFFFF000)) \
                        & M32
                    w = (w | ((b << 20) & M32)) & M32
                    set32(p, nv)
                    set32(p + 4, w)
                    p += 8
                else:
                    p += 4
            else:
                b = u32(p + 4)
                if not _riscv_check1(v, b):
                    p += 6
                else:
                    w = (af & 0xFFFFF000) | (b >> 20)
                    nb = ((b << 12) & M32) | (0x17 + (2 << 7))
                    set32(p, nb)
                    set32(p + 4, w)
                    p += 8


# ------------------------------------------------------------- dispatch

_BCJ = {
    FILTER_X86: _x86_conv,
    FILTER_ARM: _arm_conv,
    FILTER_ARMT: _armt_conv,
    FILTER_ARM64: _arm64_conv,
    FILTER_PPC: _ppc_conv,
    FILTER_SPARC: _sparc_conv,
    FILTER_IA64: _ia64_conv,
    FILTER_RISCV: _riscv_conv,
}


def apply_filter(data: bytes, filter_flag: int, delta_offset: int = 1,
                 ip: int = 0) -> bytes:
    if filter_flag == FILTER_DELTA:
        return delta_encode(data, delta_offset)
    fn = _BCJ.get(filter_flag)
    if fn is None:
        raise NotImplementedError(
            f"BCJ filter {filter_flag} encode not implemented yet")
    return fn(data, ip, encoding=True)


def undo_filter(data: bytes, filter_flag: int, delta_offset: int = 1,
                minor_version: int = 14, ip: int = 0) -> bytes:
    if filter_flag == FILTER_DELTA:
        return delta_decode(data, delta_offset)
    fn = _BCJ.get(filter_flag)
    if fn is None:
        raise NotImplementedError(
            f"BCJ filter {filter_flag} decode not implemented yet")
    return fn(data, ip, encoding=False)
