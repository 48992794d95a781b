"""Format-level constants of the .lrz (lrzip-next v0.14) archive format.

These mirror the on-disk codes of the reference implementation so that
archives interoperate in both directions:

- CTYPE block codec codes: reference src/include/lrzip_private.h:287-294
- hash registry:           reference src/main.c:64-85, doc/CURRENT_HASHES
- encryption registry:     reference src/main.c:82-85, doc/CURRENT_ENCMETHODS
- LZMA2 dictionary-size prop coding: reference src/include/lrzip_private.h:236-245
- bzip3 block-size prop coding:      reference src/include/lrzip_private.h:248-256
- filter flags:            reference src/include/lrzip_private.h:389-406
- zstd level/strategy map: reference src/main.c:87-104
"""

from __future__ import annotations

MAGIC_BYTES = b"LRZI"
MAGIC_LEN = 21  # reference src/lrzip.c:46
LRZIP_MAJOR_VERSION = 0
LRZIP_MINOR_VERSION = 14

# Number of multiplexed streams per rzip chunk (stream 0 = match/control
# tokens, stream 1 = literals). reference src/include/lrzip_private.h NUM_STREAMS.
NUM_STREAMS = 2

# rzip matcher parameters (reference src/rzip.c:50-51)
MINIMUM_MATCH = 31
GREAT_MATCH = 1024
CHUNK_MULTIPLE = 100 * 1024 * 1024  # -w window unit (reference src/rzip.c:48)
MAX_TOKEN_LEN = 0xFFFF  # match/literal run length limit per token

STREAM_BUFSIZE = 10 * 1024 * 1024  # reference src/include/lrzip_private.h:16

# Block codec codes stored in stream block headers.
CTYPE_NONE = 3
CTYPE_BZIP2 = 4
CTYPE_LZO = 5
CTYPE_LZMA = 6
CTYPE_GZIP = 7
CTYPE_ZPAQ = 8
CTYPE_BZIP3 = 9
CTYPE_ZSTD = 10
# Framework extension (no reference equivalent): the device-resident
# interleaved-rANS block codec (ops/rans.py, runtime/csrc/rans.cpp).
# Reference CTYPEs stop at 10 (src/include/lrzip_private.h:287-294);
# archives using it are decodable by this framework only.
CTYPE_RANS = 11

CTYPE_NAMES = {
    CTYPE_NONE: "none",
    CTYPE_BZIP2: "bzip2",
    CTYPE_LZO: "lzo",
    CTYPE_LZMA: "lzma",
    CTYPE_GZIP: "gzip",
    CTYPE_ZPAQ: "zpaq",
    CTYPE_BZIP3: "bzip3",
    CTYPE_ZSTD: "zstd",
    CTYPE_RANS: "rans",
}

# Method codes stored in magic byte 17 (v0.11+): 0=none/other, 1=lzma,
# 2=zpaq, 3=bzip3, 4=zstd (strategy in high nibble for zstd).
MAGIC_CTYPE_NONE = 0
MAGIC_CTYPE_LZMA = 1
MAGIC_CTYPE_ZPAQ = 2
MAGIC_CTYPE_BZIP3 = 3
MAGIC_CTYPE_ZSTD = 4

# Hash registry: name -> (code, digest_len). Code is stored in magic byte 14.
HASHES = [
    ("CRC", 0, 4),
    ("MD5", 1, 16),
    ("RIPEMD", 2, 20),
    ("SHA256", 3, 32),
    ("SHA384", 4, 48),
    ("SHA512", 5, 64),
    ("SHA3_256", 6, 32),
    ("SHA3_512", 7, 64),
    ("SHAKE128_16", 8, 16),
    ("SHAKE128_32", 9, 32),
    ("SHAKE128_64", 10, 64),
    ("SHAKE256_16", 11, 16),
    ("SHAKE256_32", 12, 32),
    ("SHAKE256_64", 13, 64),
]
HASH_CODE = {name: code for name, code, _ in HASHES}
HASH_LEN = {code: ln for _, code, ln in HASHES}
HASH_NAME = {code: name for name, code, _ in HASHES}
MAXHASH = 13

# Encryption registry: magic byte 15. (name, code, keylen, ivlen)
ENCRYPTIONS = [
    ("NONE", 0, 0, 0),
    ("AES128", 1, 16, 16),
    ("AES256", 2, 32, 16),
]
ENC_CODE = {name: code for name, code, _, _ in ENCRYPTIONS}
ENC_KEYLEN = {code: kl for _, code, kl, _ in ENCRYPTIONS}
SALT_LEN = 8  # reference src/include/lrzip_private.h:298

# Filter flags, magic byte 16 (v0.13+ coding): 0=none, 1..8 BCJ filters,
# bit 7 set = delta with offset stored in low bits.
FILTER_NONE = 0
FILTER_X86 = 1
FILTER_ARM = 2
FILTER_ARMT = 3
FILTER_ARM64 = 4
FILTER_PPC = 5
FILTER_SPARC = 6
FILTER_IA64 = 7
FILTER_RISCV = 8
FILTER_DELTA = 128  # bit-7 marker; low bits encode delta offset

FILTER_NAMES = {
    FILTER_NONE: "none",
    FILTER_X86: "x86",
    FILTER_ARM: "ARM",
    FILTER_ARMT: "ARMT",
    FILTER_ARM64: "ARM64",
    FILTER_PPC: "PPC",
    FILTER_SPARC: "SPARC",
    FILTER_IA64: "IA64",
    FILTER_RISCV: "RISC-V",
}

# zstd: lrzip-next level (1-9) -> (zstd level, strategy code) per
# reference src/main.c:87-104.
ZSTD_LEVEL_FROM_LRZIP_LEVEL = [None, 2, 4, 5, 7, 12, 15, 17, 18, 22]
ZSTD_STRATEGY_FROM_LRZIP_LEVEL = [None, 1, 2, 3, 4, 5, 6, 7, 8, 9]
ZSTD_STRATEGY_NAMES = [
    "none", "fast", "dfast", "greedy", "lazy",
    "lazy2", "btlazy2", "btopt", "btultra", "btultra2",
]

LZMA_LC = 3
LZMA_LP = 0
LZMA_PB = 2
LZMA_LC_LP_PB = 0x5D  # (pb*5 + lp)*9 + lc = 93


def lzma2_dict_size_from_prop(p: int) -> int:
    """Decode an LZMA2 dictionary-size prop byte (0..40) to bytes."""
    if p == 40:
        return 0xFFFFFFFF
    return (2 | (p & 1)) << (p // 2 + 11)


def lzma2_prop_from_dict_size(dict_size: int) -> int:
    """Encode a dictionary size to the smallest covering LZMA2 prop byte."""
    for i in range(41):
        if dict_size <= lzma2_dict_size_from_prop(i):
            return i
    return 40


def bzip3_block_size_from_prop(p: int) -> int:
    if p == 8:
        return 0x1FF00000
    return (2 | (p & 1)) << (p // 2 + 24)


def bzip3_prop_from_block_size(bs: int) -> int:
    for i in range(9):
        if bs <= bzip3_block_size_from_prop(i):
            return i
    return 8


def chunk_byte_width(chunk_size: int) -> int:
    """Byte width used for all offsets/sizes of a chunk.

    Mirrors reference src/rzip.c:1124-1134: the number of bytes needed to
    represent chunk_size (bits rounded up to whole bytes, with an extra bit
    of headroom from the `>> bits > 0` loop starting at bits=8).
    """
    bits = 8
    while (chunk_size >> bits) > 0:
        bits += 1
    return (bits + 7) // 8
