"""End to end, decode: lrzip_next_tpu_torch.decompress on the CPU returns
the input and the same bytes as lrzip_next_tpu.decompress, for archives
written by either package, and both raise ``ValueError`` on the same
damaged archives.  Bytes are compared exactly."""

import io

import numpy as np
import pytest
import torch

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu.format.constants import CTYPE_RANS, FILTER_DELTA
from lrzip_next_tpu.models import pipeline as jpipeline
from lrzip_next_tpu_torch.models import pipeline as P
from lrzip_next_tpu_torch.models.info import get_fileinfo
from lrzip_next_tpu_torch.ops import rans_kernels as RK


def _zipf(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


def _mixed(n: int, seed: int) -> bytes:
    """Random base with segments of it pasted far apart, then skewed
    symbols: matches and compressible literals."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, max(n // 4, 64), dtype=np.uint8).tobytes()
    out = bytearray()
    while len(out) < n // 2:
        s = int(rng.integers(0, max(len(base) - 256, 1)))
        out += base[s:s + int(rng.integers(16, 256))]
    return bytes(out[:n // 2]) + _zipf(n - n // 2, seed + 1)


def _archives(data: bytes, **kw) -> dict:
    """The archive of ``data`` from each package, from one JAX
    ``Settings``: the JAX package's host path and device path, and the
    port."""
    js = lrz.Settings(use_tpu=True, use_mesh=False, **kw)
    return {"jax_host": lrz.compress(data, lrz.Settings(**kw)),
            "jax_device": lrz.compress(data, js),
            "port": lrzt.compress(data, lrzt.settings_from_reference(js),
                                  device="cpu")}


def _both_decode(archive: bytes, data: bytes, **kw) -> None:
    js = lrz.Settings(**kw)
    ours = lrzt.decompress(archive, lrzt.settings_from_reference(js),
                           device="cpu")
    assert ours == data
    assert ours == lrz.decompress(archive, js)


def _literal_ctypes(archive: bytes, passphrase=None) -> list:
    info = get_fileinfo(io.BytesIO(archive), passphrase=passphrase)
    return [[ct for sno, ct, _, _ in ch.block_details if sno == 1]
            for ch in info.chunks]


@pytest.mark.parametrize("writer", ["jax_host", "jax_device", "port"])
@pytest.mark.parametrize("method", ["rans", "gzip", "lzma", "none"])
def test_decompress_equals_input_and_jax(method, writer):
    data = _mixed(260_000, 11)
    _both_decode(_archives(data, method=method)[writer], data)


@pytest.mark.parametrize("method", ["bzip2", "zstd", "lzo", "zpaq", "bzip3"])
def test_decompress_other_codecs(method):
    data = _mixed(120_000, 12)
    arch = _archives(data, method=method)
    assert arch["port"] == arch["jax_device"]
    _both_decode(arch["port"], data)
    _both_decode(arch["jax_host"], data)


@pytest.mark.parametrize("level", [1, 3, 7, 8])
def test_rans_levels_decode_through_the_literal_plane(level, monkeypatch):
    """Levels 1/3/7/8 take ctx_bits 0/4/6/8; the single rANS literal block
    goes through DeviceLitPlane (on the CPU: K7's plain version, no
    launch)."""
    data = _mixed(200_000, 20 + level)
    arch = _archives(data, method="rans", compression_level=level)
    assert _literal_ctypes(arch["port"]) == [[CTYPE_RANS]]
    planes = []
    real = P.DeviceLitPlane

    class Spy(real):
        def __init__(self, *a):
            super().__init__(*a)
            planes.append(self)

    monkeypatch.setattr(P, "DeviceLitPlane", Spy)
    before = RK.decode_launches
    for name in ("port", "jax_device"):
        _both_decode(arch[name], data)
    assert len(planes) == 2 and all(p.n > 0 for p in planes)
    assert RK.decode_launches == before


def test_rans_host_blocks_take_the_host_codec(monkeypatch):
    """With a filter the rANS literal blocks go through the host codec,
    never the literal plane, whichever package wrote them."""
    data = _mixed(150_000, 31)

    def no_plane(*a):
        raise AssertionError("a filtered archive must not reach the plane")

    arch = _archives(data, method="rans", filter_flag=FILTER_DELTA)
    monkeypatch.setattr(P, "DeviceLitPlane", no_plane)
    for name, a in arch.items():
        _both_decode(a, data)


@pytest.mark.parametrize("method", ["rans", "gzip"])
def test_three_chunks(method):
    data = _mixed(300_000, 41)
    arch = _archives(data, method=method, max_chunk=100_000)
    assert arch["port"] == arch["jax_device"]
    assert len(_literal_ctypes(arch["port"])) == 3
    for a in arch.values():
        _both_decode(a, data)


@pytest.mark.parametrize("method", ["rans", "lzma"])
def test_cross_chunk(method):
    """Later chunks reach into earlier ones: the replay needs history."""
    base = _mixed(120_000, 51)
    data = base + _zipf(40_000, 52) + base[30_000:]
    arch = _archives(data, method=method, max_chunk=120_000,
                     cross_chunk=True)
    assert arch["port"] == arch["jax_device"]
    for a in arch.values():
        _both_decode(a, data)


def test_all_match_chunk_without_literal_block():
    half = _zipf(100_000, 4)
    arch = _archives(half + half, method="rans", max_chunk=100_000,
                     cross_chunk=True)
    assert _literal_ctypes(arch["port"]) == [[CTYPE_RANS], []]
    _both_decode(arch["port"], half + half)


@pytest.mark.parametrize("method", ["rans", "gzip"])
@pytest.mark.parametrize("enc_code", [1, 2])
def test_encrypted(method, enc_code):
    data = _mixed(90_000, 61)
    kw = dict(method=method, passphrase=b"correct horse", enc_code=enc_code,
              costfactor_exp=10)
    port = lrzt.compress(data, lrzt.settings_from_reference(
        lrz.Settings(**kw)), device="cpu")
    jax_a = lrz.compress(data, lrz.Settings(use_tpu=True, use_mesh=False,
                                            **kw))
    for a in (port, jax_a):
        _both_decode(a, data, passphrase=b"correct horse")
    with pytest.raises(ValueError):
        lrzt.decompress(port, device="cpu")
    with pytest.raises(ValueError):
        lrzt.decompress(port, lrzt.Settings(passphrase=b"wrong"),
                        device="cpu")


@pytest.mark.parametrize("method", ["gzip", "lzma"])
def test_with_a_filter(method):
    data = _mixed(100_000, 71)
    for a in _archives(data, method=method, filter_flag=FILTER_DELTA,
                       delta_offset=3).values():
        _both_decode(a, data)


@pytest.mark.parametrize("size", [0, 1, 31])
@pytest.mark.parametrize("method", ["rans", "gzip"])
def test_trivial_sizes(method, size):
    data = _zipf(size, size)
    for a in _archives(data, method=method).values():
        _both_decode(a, data)


@pytest.mark.parametrize("hash_name", ["CRC", "MD5", "SHA256", "SHA3_512"])
def test_hashes(hash_name):
    data = _mixed(70_000, 81)
    arch = _archives(data, method="gzip", hash_name=hash_name)
    assert arch["port"] == arch["jax_device"]
    _both_decode(arch["port"], data)


@pytest.mark.parametrize("method", ["rans", "gzip"])
def test_decompress_file_with_file_backed_history(tmp_path, method):
    """decompress_file replays cross-chunk matches from the file it is
    writing."""
    base = _mixed(110_000, 91)
    data = base + base[5_000:] + _zipf(20_000, 92)
    arch = _archives(data, method=method, max_chunk=110_000,
                     cross_chunk=True)
    for name, a in arch.items():
        src = tmp_path / f"{name}.lrz"
        dst = tmp_path / f"{name}.out"
        src.write_bytes(a)
        n = lrzt.decompress_file(str(src), str(dst), device="cpu")
        assert n == len(data) and dst.read_bytes() == data
        ref = tmp_path / f"{name}.ref"
        assert jpipeline.decompress_file(str(src), str(ref)) == n
        assert ref.read_bytes() == data


def test_decompress_stream_to_a_pipe_like_sink():
    """A sink with no file descriptor: history accumulates in memory."""
    base = _mixed(100_000, 95)
    data = base + base
    a = _archives(data, method="rans", max_chunk=100_000,
                  cross_chunk=True)["port"]
    sink = io.BytesIO()
    assert lrzt.decompress_stream_to(io.BytesIO(a), sink,
                                     device="cpu") == len(data)
    assert sink.getvalue() == data
    assert b"".join(lrzt.iter_decompress(io.BytesIO(a), device="cpu")) == data
    assert lrzt.decompress_stream(io.BytesIO(a), device="cpu") == data


def _damage(archive: bytes, how: str) -> bytes:
    if how == "truncated_mid":
        return archive[:len(archive) // 2]
    if how == "truncated_tail":
        return archive[:-5]
    if how == "too_short":
        return archive[:10]
    if how == "bad_stored_hash":
        return archive[:-1] + bytes([archive[-1] ^ 1])
    b = bytearray(archive)
    at = len(b) // 2 if how == "flipped_payload_bit" else len(b) - 40
    b[at] ^= 0x10
    return bytes(b)


@pytest.mark.parametrize("how", ["truncated_mid", "truncated_tail",
                                 "too_short", "bad_stored_hash",
                                 "flipped_payload_bit",
                                 "flipped_late_payload_bit"])
@pytest.mark.parametrize("method", ["rans", "gzip", "none"])
def test_damaged_archives_raise_in_both(method, how):
    data = _mixed(150_000, 101)
    bad = _damage(_archives(data, method=method)["port"], how)
    with pytest.raises(ValueError):
        lrzt.decompress(bad, device="cpu")
    with pytest.raises(ValueError):
        lrz.decompress(bad)


def test_flipped_rans_word_raises_in_the_plane():
    """A flipped word of the literal payload is caught by the final-state
    check of the plane (or the chunk CRC), never returned as bytes."""
    data = _zipf(120_000, 111)
    a = lrzt.compress(data, lrzt.Settings(method="rans", hash_name="CRC"),
                      device="cpu")
    assert _literal_ctypes(a) == [[CTYPE_RANS]]
    b = bytearray(a)
    b[len(b) - 2_000] ^= 0x04
    with pytest.raises(ValueError, match="rans|CRC"):
        lrzt.decompress(bytes(b), device="cpu")
    with pytest.raises(ValueError):
        lrz.decompress(bytes(b), lrz.Settings(use_tpu=True, use_mesh=False))


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = lrzt.compress(b"x" * 1000, lrzt.Settings(method="none"),
                      device="cpu")
    with pytest.raises(RuntimeError):
        lrzt.decompress(a)
    with pytest.raises(RuntimeError):
        lrzt.decompress(a, device="cuda")
    with pytest.raises(ValueError):
        lrzt.decompress(a, device="meta")


def test_fileinfo_equals_jax():
    from lrzip_next_tpu.models.info import format_fileinfo as jfmt, \
        get_fileinfo as jinfo
    from lrzip_next_tpu_torch.models.info import format_fileinfo
    a = _archives(_mixed(150_000, 121), method="rans",
                  max_chunk=60_000)["port"]
    ours = get_fileinfo(io.BytesIO(a))
    theirs = jinfo(io.BytesIO(a))
    assert format_fileinfo(ours, "x.lrz") == jfmt(theirs, "x.lrz")
    assert len(ours.chunks) == 3
