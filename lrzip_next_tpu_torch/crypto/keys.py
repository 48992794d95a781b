"""Key derivation: SCRYPT master stretch + per-block SHAKE key/IV.

Mirrors the reference exactly:

- master hash: scrypt(salt+passphrase, salt=salt[8], N=2^costfactor,
  r=8 (gcrypt's fixed r), p=1, dklen=64) -> 64-byte master
  (src/util.c:580-617 ``lrz_stretch``; salt_pass layout from
  src/lrzip.c:991-993: 8 salt bytes then the passphrase)
- per-block: key = SHAKE(master[64] || blocksalt[8] || salt_pass),
  iv = SHAKE(key || blocksalt[8] || salt_pass); SHAKE128 for AES-128,
  SHAKE256 for AES-256 (src/util.c:471-509 ``lrz_keygen``)
- salt byte 0 stores the costfactor exponent (10..40), bytes 1..7 are
  random (doc/magic.header.txt v0.14)
"""

from __future__ import annotations

import hashlib
import os
from typing import Tuple

from ..format.constants import SALT_LEN

HASH_LEN = 64
PASS_LEN = 512


def make_salt(costfactor_exp: int) -> bytes:
    if not 10 <= costfactor_exp <= 40:
        raise ValueError("costfactor exponent must be 10..40")
    return bytes([costfactor_exp]) + os.urandom(SALT_LEN - 1)


def default_costfactor_exp(ram_bytes: int | None = None) -> int:
    """Pick an exponent so scrypt memory (~128 * r * N) stays sane."""
    import math
    ram = ram_bytes or (1 << 31)
    # gcrypt scrypt r=8: memory ~ 1KiB * N
    exp = int(math.log2(max(ram // 8, 1 << 20) // 1024))
    return max(10, min(exp, 20))


def salt_pass_of(salt: bytes, passphrase: bytes) -> bytes:
    """salt || passphrase (the reference's control->salt_pass)."""
    if len(passphrase) > PASS_LEN - SALT_LEN - 1:
        passphrase = passphrase[:PASS_LEN - SALT_LEN - 1]
    return salt + passphrase


def stretch(salt: bytes, passphrase: bytes,
            minor_version: int = 14) -> bytes:
    """SCRYPT master hash (64 bytes)."""
    sp = salt_pass_of(salt, passphrase)
    if minor_version >= 14:
        n = 1 << salt[0]
    else:
        # pre-0.14 coding: loops derived from salt bytes 0/1
        # (src/util.c:595-605)
        exp = salt[1].bit_length() - 1 if salt[1] else 0
        encloops = (1 << exp) << salt[0]
        i = 1
        while i <= 30 and encloops >= (1 << i):
            i += 1
        n = 1 << (i - 1)
    # cap maxmem generously; gcrypt has no explicit limit
    return hashlib.scrypt(sp, salt=salt, n=n, r=8, p=1, dklen=HASH_LEN,
                          maxmem=max(n * 1024 * 2, 64 << 20))


def block_key_iv(master: bytes, block_salt: bytes, salt_pass: bytes,
                 enc_code: int) -> Tuple[bytes, bytes]:
    """Per-block AES key + IV via SHAKE XOF.

    Only SALT_LEN=8 bytes of the block salt enter the hash (reference
    lrz_keygen, src/util.c:486-503) - significant for the stored-hash
    slot, whose "salt" is the whole salt_pass (src/rzip.c:1211).
    """
    block_salt = block_salt[:8]
    keylen = 16 if enc_code == 1 else 32
    shake = hashlib.shake_128 if enc_code == 1 else hashlib.shake_256
    key = shake(master + block_salt + salt_pass).digest(keylen)
    iv = shake(key + block_salt + salt_pass).digest(16)
    return key, iv
