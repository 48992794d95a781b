"""Magic header encode/decode for .lrz archives (lrzip-next v0.6 -> v0.14).

Write path emits the 21-byte v0.14 header (reference src/lrzip.c:131-208,
``write_magic``); read path understands every format the reference's
``get_magic`` dispatcher handles (reference src/lrzip.c:348-537).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import constants as C


@dataclasses.dataclass
class MagicHeader:
    """Parsed/parameterised .lrz magic header."""

    major_version: int = C.LRZIP_MAJOR_VERSION
    minor_version: int = C.LRZIP_MINOR_VERSION
    expected_size: int = 0          # decompressed size; 0 if unknown (stdin)
    eof_known: bool = True          # whether expected_size is meaningful
    hash_code: int = C.HASH_CODE["MD5"]
    enc_code: int = 0               # 0=none, 1=AES128, 2=AES256
    salt: bytes = b""               # 8 bytes when encrypted
    filter_flag: int = 0            # 0 or FILTER_* code
    delta_offset: int = 0           # 1..256 when delta filter active
    method_code: int = 0            # magic byte 17 low nibble (v0.11+)
    # method-specific parameters
    lzma_dict_size: int = 0
    zpaq_level: int = 0
    zpaq_bs: int = 0
    bzip3_bs: int = 0
    zstd_level: int = 0
    zstd_strategy: int = 0
    rzip_level: int = 0
    compression_level: int = 0
    comment: bytes = b""

    # ------------------------------------------------------------------ write

    def encode(self) -> bytes:
        """Produce the on-disk magic header (21 bytes + optional comment)."""
        m = bytearray(C.MAGIC_LEN)
        m[0:4] = C.MAGIC_BYTES
        m[4] = self.major_version
        m[5] = self.minor_version

        if self.enc_code:
            if len(self.salt) != 8:
                raise ValueError("encrypted archives need an 8-byte salt")
            m[6:14] = self.salt
            m[15] = self.enc_code
        elif self.eof_known:
            m[6:14] = self.expected_size.to_bytes(8, "little")

        if self.hash_code:
            m[14] = self.hash_code

        if self.filter_flag == C.FILTER_DELTA:
            # v0.13 coding: 128 + offset (offsets 17..256 stored /16)
            d = self.delta_offset
            m[16] = 128 + (d if d <= 16 else (d >> 4) + 15)
        elif self.filter_flag:
            m[16] = self.filter_flag

        mc = self.method_code
        if mc == C.MAGIC_CTYPE_LZMA:
            m[17] = 1
            m[18] = C.lzma2_prop_from_dict_size(self.lzma_dict_size)
        elif mc == C.MAGIC_CTYPE_ZPAQ:
            m[17] = 2
            m[18] = (self.zpaq_level << 4) + self.zpaq_bs
        elif mc == C.MAGIC_CTYPE_BZIP3:
            m[17] = 3
            m[18] = self.bzip3_bs & 0x0F
        elif mc == C.MAGIC_CTYPE_ZSTD:
            m[17] = (self.zstd_strategy << 4) + 4
            m[18] = self.zstd_level

        m[19] = ((self.rzip_level & 0x0F) << 4) | (self.compression_level & 0x0F)
        m[20] = len(self.comment)
        return bytes(m) + self.comment

    # ------------------------------------------------------------------- read

    @classmethod
    def decode(cls, data: bytes) -> "MagicHeader":
        """Parse a magic header.

        ``data`` must contain at least MAGIC_LEN bytes (plus the comment for
        v0.9+ archives carrying one).
        """
        if data[0:4] != C.MAGIC_BYTES:
            raise ValueError("not an lrzip archive (bad magic)")
        major, minor = data[4], data[5]
        h = cls(major_version=major, minor_version=minor, hash_code=0,
                method_code=0, eof_known=False)
        if major != 0:
            raise ValueError(f"unsupported lrzip version {major}.{minor}")
        if minor < 6:
            raise ValueError(f"lrzip version {major}.{minor} archives are "
                             "not supported (reference drops pre-0.6 too)")
        if minor in (6, 7):
            cls._decode_v6_v7(h, data, minor)
        elif minor in (8, 9, 10):
            cls._decode_v8(h, data)
            if minor >= 9:
                h.compression_level = data[18] & 0x0F
                h.rzip_level = data[18] >> 4
                clen = data[19]
                if clen:
                    h.comment = bytes(data[20:20 + clen])
        elif minor in (11, 12, 13, 14):
            cls._decode_v11(h, data, minor)
        else:
            raise ValueError(f"unsupported lrzip-next version 0.{minor}")
        return h

    @staticmethod
    def _get_expected_size(h: "MagicHeader", data: bytes) -> None:
        h.expected_size = int.from_bytes(data[6:14], "little")
        h.eof_known = True

    @staticmethod
    def _get_filter(h: "MagicHeader", b: int, minor: int) -> None:
        if not b:
            return
        if minor >= 13:
            if b & 0x80:  # delta
                h.filter_flag = C.FILTER_DELTA
                v = b - 128
                h.delta_offset = v if v <= 16 else (v - 15) << 4
            else:
                h.filter_flag = b
        elif minor == 12:
            # v0.12: delta offset (0..31 meaning 1..32) in high 5 bits
            if b >> 3 and b & 0x07 == 0 and b > 8:
                pass
            if b <= 8:
                h.filter_flag = b
            else:
                h.filter_flag = C.FILTER_DELTA
                h.delta_offset = (b >> 3) + 1
        else:
            # v0.7-0.11: filters 1..7 (no ARM64/RISCV); 7=delta w/ offset
            low = b & 0x07
            if low == 7 or (b >> 3):
                h.filter_flag = C.FILTER_DELTA
                h.delta_offset = (b >> 3) + 1
            else:
                h.filter_flag = low

    @classmethod
    def _decode_v6_v7(cls, h: "MagicHeader", data: bytes, minor: int) -> None:
        enc_ofs = 22 if minor == 6 else 23
        hash_ofs = 21 if minor == 6 else 22
        if not data[enc_ofs]:
            cls._get_expected_size(h, data)
        h.enc_code = data[enc_ofs]
        if h.enc_code:
            h.salt = bytes(data[6:14])
        if minor == 7 and data[16]:
            cls._get_filter(h, data[16], minor)
        lzma_ofs = 16 if minor == 6 else 17
        if data[lzma_ofs]:
            # 5-byte classic LZMA props: lc/lp/pb byte + 4-byte LE dict size
            h.method_code = C.MAGIC_CTYPE_LZMA
            h.lzma_dict_size = int.from_bytes(
                data[lzma_ofs + 1:lzma_ofs + 5], "little")
        h.hash_code = C.HASH_CODE["MD5"] if data[hash_ofs] else 0

    @classmethod
    def _decode_v8(cls, h: "MagicHeader", data: bytes) -> None:
        if not data[15]:
            cls._get_expected_size(h, data)
        h.enc_code = data[15]
        if h.enc_code:
            h.salt = bytes(data[6:14])
        if data[16]:
            cls._get_filter(h, data[16], 8)
        b17 = data[17]
        if 0 < b17 <= 40:
            h.method_code = C.MAGIC_CTYPE_LZMA
            h.lzma_dict_size = C.lzma2_dict_size_from_prop(b17)
        elif b17 & 0x80:
            if (b17 & 0xF0) == 0xF0:
                h.method_code = C.MAGIC_CTYPE_BZIP3
                h.bzip3_bs = b17 & 0x0F
            else:
                h.method_code = C.MAGIC_CTYPE_ZPAQ
                h.zpaq_bs = b17 & 0x0F
                h.zpaq_level = (b17 & 0x70) >> 4
        h.hash_code = data[14]

    @classmethod
    def _decode_v11(cls, h: "MagicHeader", data: bytes, minor: int) -> None:
        if not data[15]:
            cls._get_expected_size(h, data)
        h.enc_code = data[15]
        if h.enc_code:
            h.salt = bytes(data[6:14])
        if data[16]:
            cls._get_filter(h, data[16], minor)
        b17 = data[17]
        if b17 == 1:
            h.method_code = C.MAGIC_CTYPE_LZMA
            h.lzma_dict_size = C.lzma2_dict_size_from_prop(data[18])
        elif b17 == 2:
            h.method_code = C.MAGIC_CTYPE_ZPAQ
            h.zpaq_bs = data[18] & 0x0F
            h.zpaq_level = data[18] >> 4
        elif b17 == 3:
            h.method_code = C.MAGIC_CTYPE_BZIP3
            h.bzip3_bs = data[18] & 0x0F
        elif (b17 & 0x0F) == 4:
            h.method_code = C.MAGIC_CTYPE_ZSTD
            h.zstd_strategy = b17 >> 4
            h.zstd_level = data[18]
        elif b17 != 0:
            raise ValueError(f"invalid compression type {b17} in magic header")
        h.hash_code = data[14]
        h.compression_level = data[19] & 0x0F
        h.rzip_level = data[19] >> 4
        clen = data[20]
        if clen:
            h.comment = bytes(data[21:21 + clen])

    @property
    def header_len(self) -> int:
        """Total on-disk length of magic + comment for this version."""
        if self.minor_version >= 11:
            return C.MAGIC_LEN + len(self.comment)
        if self.minor_version >= 9:
            return 20 + len(self.comment)
        if self.minor_version == 8:
            return 18
        return 24
