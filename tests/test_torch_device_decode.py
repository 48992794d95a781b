"""decompress_to_device of the port (lrzip_next_tpu_torch, on the CPU)
against the input and against lrzip_next_tpu's decompress_to_device with
its replay kernel in interpret mode.  Bytes are compared exactly."""

import io

import numpy as np
import pytest
import torch

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu.models.device_decode import \
    decompress_to_device as jax_to_device


def _corpus(n=24_000, seed=4) -> bytes:
    """The corpus of tests/test_device_decode.py."""
    rng = np.random.default_rng(seed)
    base = rng.integers(32, 127, size=n // 3, dtype=np.uint8).tobytes()
    return (base + b"runrunrun" * 120 + base[: n // 4]
            + rng.integers(0, 256, 313, dtype=np.uint8).tobytes())[:n]


def _joined(chunks) -> bytes:
    return b"".join(c.numpy().tobytes() for c in chunks)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("method", ["zstd", "rans", "lzma", "gzip", "none"])
def test_roundtrip_equals_input_and_jax(method, writer):
    data = _corpus()
    if writer == "jax":
        arch = lrz.compress(data, lrz.Settings(method=method))
    else:
        arch = lrzt.compress(data, lrzt.Settings(method=method),
                             device="cpu")
    chunks = lrzt.decompress_to_device(arch, verify=True, device="cpu")
    assert all(c.dtype == torch.uint8 and c.device.type == "cpu"
               and c.dim() == 1 for c in chunks)
    assert _joined(chunks) == data
    if method != "lzma":    # slow under the JAX interpreter
        theirs = jax_to_device(arch, verify=True, interpret=True)
        assert len(theirs) == len(chunks)
        for c, t in zip(chunks, theirs):
            assert np.array_equal(c.numpy(), np.asarray(t))


@pytest.mark.parametrize("method", ["gzip", "rans"])
def test_multichunk(method):
    data = _corpus(60_000)
    arch = lrz.compress(data, lrz.Settings(method=method, max_chunk=8_192,
                                           cross_chunk=False))
    chunks = lrzt.decompress_to_device(arch, verify=True, device="cpu")
    full, rest = divmod(len(data), 8_192)
    assert full >= 3 and rest
    assert [len(c) for c in chunks] == [8_192] * full + [rest]
    assert _joined(chunks) == data
    theirs = jax_to_device(arch, verify=True, interpret=True)
    assert _joined(chunks) == b"".join(np.asarray(t).tobytes()
                                       for t in theirs)


def test_rans_block_decodes_through_the_literal_plane(monkeypatch):
    """A rANS literal block goes through ``DeviceLitPlane`` (K7's wrapper)
    and its final-state check, and no plane outlives the call."""
    from lrzip_next_tpu_torch.models import pipeline as P
    made, checked = [], []

    class Spy(P.DeviceLitPlane):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def check(self):
            checked.append(self)
            return super().check()

    monkeypatch.setattr(P, "DeviceLitPlane", Spy)
    rng = np.random.default_rng(2)
    p = 1.0 / np.arange(1, 257) ** 1.2
    data = rng.choice(256, 90_000, p=p / p.sum()).astype(np.uint8).tobytes()
    data = data + data[:30_000]
    arch = lrzt.compress(data, lrzt.Settings(method="rans"), device="cpu")
    chunks = lrzt.decompress_to_device(arch, device="cpu")
    assert _joined(chunks) == data
    assert len(made) == 1 and checked == made


def test_file_object_and_empty_archive():
    data = _corpus(5_000)
    arch = lrzt.compress(data, lrzt.Settings(method="gzip"), device="cpu")
    assert _joined(lrzt.decompress_to_device(io.BytesIO(arch),
                                             device="cpu")) == data
    empty = lrzt.compress(b"", lrzt.Settings(method="gzip"), device="cpu")
    chunks = lrzt.decompress_to_device(empty, verify=True, device="cpu")
    assert _joined(chunks) == b""
    assert [np.asarray(t).size for t in
            jax_to_device(empty, verify=True, interpret=True)] == \
        [len(c) for c in chunks]


@pytest.mark.parametrize("method", ["zstd", "rans"])
def test_bad_crc(method):
    data = _corpus(12_000)
    arch = bytearray(lrz.compress(data, lrz.Settings(method=method)))
    arch[len(arch) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        lrzt.decompress_to_device(bytes(arch), verify=True, device="cpu")
    with pytest.raises(ValueError):
        jax_to_device(bytes(arch), verify=True, interpret=True)


def test_verify_reads_the_stored_crc(monkeypatch):
    """``verify=True`` compares each chunk with its stored CRC: an intact
    archive whose stored CRC is misread fails, and passes unverified."""
    data = _corpus(12_000)
    arch = lrzt.compress(data, lrzt.Settings(method="gzip"), device="cpu")
    from lrzip_next_tpu_torch.models import pipeline as P
    monkeypatch.setattr(P, "stored_crc_int", lambda crc: crc ^ 1)
    assert _joined(lrzt.decompress_to_device(arch, device="cpu")) == data
    with pytest.raises(ValueError, match="CRC"):
        lrzt.decompress_to_device(arch, verify=True, device="cpu")


def test_cross_chunk_archive_raises():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    data = base + base
    arch = lrz.compress(data, lrz.Settings(method="gzip", max_chunk=40_000,
                                           cross_chunk=True))
    assert lrzt.decompress(arch, device="cpu") == data
    with pytest.raises(ValueError, match="cross-chunk"):
        lrzt.decompress_to_device(arch, device="cpu")
    with pytest.raises(ValueError, match="cross-chunk"):
        jax_to_device(arch, interpret=True)


def test_encrypted_archive_needs_the_passphrase():
    data = _corpus(9_000)
    arch = lrzt.compress(data, lrzt.Settings(
        method="gzip", passphrase=b"secret", costfactor_exp=10),
        device="cpu")
    with pytest.raises(ValueError, match="passphrase"):
        lrzt.decompress_to_device(arch, device="cpu")
    chunks = lrzt.decompress_to_device(
        arch, lrzt.Settings(passphrase=b"secret"), verify=True,
        device="cpu")
    assert _joined(chunks) == data


def test_short_archive_and_literal_length_mismatch(monkeypatch):
    with pytest.raises(ValueError, match="too short"):
        lrzt.decompress_to_device(b"LRZI", device="cpu")
    rng = np.random.default_rng(6)
    p = 1.0 / np.arange(1, 257) ** 1.2
    data = rng.choice(256, 60_000, p=p / p.sum()).astype(np.uint8).tobytes()
    arch = lrzt.compress(data, lrzt.Settings(method="rans"), device="cpu")
    from lrzip_next_tpu_torch.models import pipeline as P

    class Short(P.DeviceLitPlane):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.n -= 1

    monkeypatch.setattr(P, "DeviceLitPlane", Short)
    with pytest.raises(ValueError, match="literal stream length"):
        lrzt.decompress_to_device(arch, device="cpu")


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    arch = lrzt.compress(b"x" * 1000, lrzt.Settings(method="gzip"),
                         device="cpu")
    with pytest.raises(RuntimeError):
        lrzt.decompress_to_device(arch)
    with pytest.raises(ValueError):
        lrzt.decompress_to_device(arch, device="meta")
