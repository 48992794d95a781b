"""AES-CBC with ciphertext stealing, bound to OpenSSL libcrypto via ctypes.

Reproduces the reference's gcrypt usage (src/util.c:511-570 ``lrz_crypt``):
whole-buffer AES-128/256 CBC with GCRY_CIPHER_CBC_CTS.  gcrypt's CTS
always steals when the buffer exceeds one block - including exact
multiples of the block size (Kerberos-style CS3: the last two ciphertext
blocks are emitted swapped, the final one truncated to the residue).

Bulk blocks go through one EVP CBC call; only the stolen tail needs
single-block ECB operations.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_BS = 16

_crypto = None
_checked = False


def _load():
    global _crypto, _checked
    if _checked:
        return _crypto
    _checked = True
    for name in ("libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so",
                 ctypes.util.find_library("crypto")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            for f in ("EVP_aes_128_ecb", "EVP_aes_256_ecb",
                      "EVP_aes_128_cbc", "EVP_aes_256_cbc"):
                getattr(lib, f).restype = ctypes.c_void_p
            lib.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
            lib.EVP_CipherInit_ex.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
            lib.EVP_CipherUpdate.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            lib.EVP_CIPHER_CTX_set_padding.argtypes = [
                ctypes.c_void_p, ctypes.c_int]
            lib.EVP_CIPHER_CTX_free.argtypes = [ctypes.c_void_p]
            _crypto = lib
            break
        except OSError:
            continue
    return _crypto


def available() -> bool:
    return _load() is not None


def _cipher_op(key: bytes, iv: bytes | None, data: bytes, encrypt: bool,
               mode: str) -> bytes:
    """One-shot EVP cipher over a block-aligned buffer, no padding."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libcrypto unavailable: AES not supported")
    ctx = lib.EVP_CIPHER_CTX_new()
    try:
        name = f"EVP_aes_{len(key) * 8}_{mode}"
        cipher = getattr(lib, name)()
        if not lib.EVP_CipherInit_ex(ctx, cipher, None, key, iv,
                                     1 if encrypt else 0):
            raise RuntimeError("EVP_CipherInit_ex failed")
        lib.EVP_CIPHER_CTX_set_padding(ctx, 0)
        out = ctypes.create_string_buffer(len(data) + _BS)
        outl = ctypes.c_int(0)
        if not lib.EVP_CipherUpdate(ctx, out, ctypes.byref(outl), data,
                                    len(data)):
            raise RuntimeError("EVP_CipherUpdate failed")
        return out.raw[:outl.value]
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


def _ecb(key: bytes, data: bytes, encrypt: bool) -> bytes:
    return _cipher_op(key, None, data, encrypt, "ecb")


def _cbc(key: bytes, iv: bytes, data: bytes, encrypt: bool) -> bytes:
    return _cipher_op(key, iv, data, encrypt, "cbc")


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def cbc_cts_encrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    n = len(data)
    if n < _BS:
        raise ValueError("CBC-CTS needs at least one block")
    if n == _BS:
        return _cbc(key, iv, data, True)
    rest = n % _BS or _BS
    lead = (n - rest) // _BS  # >= 1 leading full blocks, CBC as usual
    out = bytearray(_cbc(key, iv, data[:lead * _BS], True))
    pn = data[lead * _BS:]
    cn_1 = bytes(out[-_BS:])
    padded = pn + bytes(_BS - rest)
    cn = _ecb(key, _xor(padded, cn_1), True)
    out[-_BS:] = cn                 # Cn replaces Cn-1 ...
    out += cn_1[:rest]              # ... truncated Cn-1 goes last
    return bytes(out)


def cbc_cts_decrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    n = len(data)
    if n < _BS:
        raise ValueError("CBC-CTS needs at least one block")
    if n == _BS:
        return _cbc(key, iv, data, False)
    rest = n % _BS or _BS
    lead = (n - rest) // _BS
    body = data[:lead * _BS]
    tail = data[lead * _BS:]        # truncated Cn-1
    cn = body[-_BS:]
    dn = _ecb(key, cn, False)
    cn_1 = bytes(tail) + dn[rest:]  # reconstruct stolen block
    pn = _xor(dn[:rest], tail)
    chain = body[:-_BS] + cn_1
    out = _cbc(key, iv, chain, False)
    return out + pn
