"""Encryption: SCRYPT key stretch + AES-CBC-CTS block crypto (lrzip -e).

High-level API mirroring the reference's lrz_encrypt/lrz_decrypt
(src/util.c:511-570) and decrypt_header (src/util.c:621-639).
"""

from __future__ import annotations

import os
from typing import Tuple

from ..format.constants import SALT_LEN
from . import aes, keys


class CryptoContext:
    """Per-archive encryption state (master hash + salt_pass)."""

    def __init__(self, passphrase: bytes, salt: bytes, enc_code: int,
                 minor_version: int = 14):
        if enc_code not in (1, 2):
            raise ValueError("enc_code must be 1 (AES128) or 2 (AES256)")
        self.enc_code = enc_code
        self.salt = salt
        self.keylen = 16 if enc_code == 1 else 32
        self.salt_pass = keys.salt_pass_of(salt, passphrase)
        self.master = keys.stretch(salt, passphrase, minor_version)

    @classmethod
    def fresh(cls, passphrase: bytes, enc_code: int = 1,
              costfactor_exp: int | None = None) -> "CryptoContext":
        exp = costfactor_exp or keys.default_costfactor_exp()
        return cls(passphrase, keys.make_salt(exp), enc_code)

    def encrypt_block(self, data: bytes, block_salt: bytes) -> bytes:
        key, iv = keys.block_key_iv(self.master, block_salt,
                                    self.salt_pass, self.enc_code)
        return aes.cbc_cts_encrypt(key, iv, data)

    def decrypt_block(self, data: bytes, block_salt: bytes) -> bytes:
        key, iv = keys.block_key_iv(self.master, block_salt,
                                    self.salt_pass, self.enc_code)
        return aes.cbc_cts_decrypt(key, iv, data)

    def pad_for_crypt(self, data: bytes) -> bytes:
        """Blocks must be at least keylen bytes (src/stream.c:1654-1664);
        the reference pads with random bytes and stores the true c_len."""
        if len(data) >= self.keylen:
            return data
        return data + os.urandom(self.keylen - len(data))

    def new_block_salt(self) -> bytes:
        return os.urandom(SALT_LEN)


__all__ = ["CryptoContext", "aes", "keys"]
