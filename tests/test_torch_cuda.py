"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
False.  This file imports no JAX, so on a machine without it run:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu_torch.ops import anchor as A
from lrzip_next_tpu_torch.ops import compact as C
from lrzip_next_tpu_torch.ops import matcher as PM
from lrzip_next_tpu_torch.ops import rans as R
from lrzip_next_tpu_torch.ops import rans_kernels as RK
from lrzip_next_tpu_torch.ops import streampack as SP

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _repeating(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, n // 2 + 1000, dtype=np.uint8)
    return np.concatenate([base, base[7:]])[:n]


@pytest.mark.parametrize("n", [39, 4_127, 65_536, 300_001])
@pytest.mark.parametrize("stride", [2, 4, 8, 16, 32])
def test_k1_kernel_equals_plain(cuda, stride, n):
    if n < stride + 31:
        n = stride + 31
    data = torch.from_numpy(_repeating(n, n + stride)).to(cuda)
    ma = ((n - 31) // stride) * stride
    before = A.launches
    fpa, fpb = A.anchor_fps(data, stride, ma)
    torch.cuda.synchronize()
    assert A.launches == before + 1
    rfpa, rfpb = A.anchor_fps_reference(data, stride, ma)
    assert torch.equal(fpa, rfpa)
    assert torch.equal(fpb, rfpb)


@pytest.mark.parametrize("k", [1, 4_095, 4_096, 4_097, 100_003])
@pytest.mark.parametrize("kind", ["empty", "full", "first", "last", "half"])
def test_k2_kernel_equals_plain(cuda, kind, k):
    rng = np.random.default_rng(k)
    start = {"empty": np.zeros(k, bool), "full": np.ones(k, bool),
             "first": np.arange(k) == 0, "last": np.arange(k) == k - 1,
             "half": rng.random(k) < 0.5}[kind]
    vals = [rng.integers(-2**31, 2**31, k, dtype=np.int64).astype(np.int32)
            for _ in range(3)]
    args = [torch.from_numpy(x).to(cuda) for x in (start, *vals)]
    before = C.launches
    out = C.compact_starts3(*args)
    torch.cuda.synchronize()
    assert C.launches == before + 1
    ref = C.compact_starts3_reference(*args)
    n = int(ref[3])
    assert int(out[3]) == n and out[3].dtype == torch.int32
    for x, y in zip(out[:3], ref[:3]):
        assert torch.equal(x[:n], y[:n])


@pytest.mark.parametrize("stride", [2, 8, 16])
def test_match_job_card_equals_cpu(cuda, stride):
    data = _repeating(300_000, stride)
    got = PM.rzip_encode_chunk(data, stride, cuda)
    want = PM.rzip_encode_chunk(data, stride, torch.device("cpu"))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_compress_card_equals_cpu(cuda):
    data = _repeating(500_000, 3).tobytes()
    s = lrzt.Settings(method="gzip")
    archive = lrzt.compress(data, s, device=cuda)
    assert archive == lrzt.compress(data, s, device="cpu")
    assert lrzt.decompress(archive) == data


def _flags(kind: str, m: int, rng) -> np.ndarray:
    return {"none": np.zeros(m, bool), "all": np.ones(m, bool),
            "last": np.arange(m) == m - 1,
            "half": rng.random(m) < 0.5}[kind]


@pytest.mark.parametrize("m", [1, 4_095, 4_096, 4_097, 300_001])
@pytest.mark.parametrize("kind", ["none", "all", "last", "half"])
def test_k3_kernel_equals_plain(cuda, kind, m):
    rng = np.random.default_rng(m + len(kind))
    vals = torch.from_numpy(rng.integers(0, 256, m, dtype=np.uint8)).to(cuda)
    flags = torch.from_numpy(_flags(kind, m, rng)).to(cuda)
    for cap in (m, m + 1000, max(m // 3, 1)):
        before = SP.stream_launches
        got, n = SP.pack_stream(vals, flags, cap)
        torch.cuda.synchronize()
        assert SP.stream_launches == before + 1
        ref, ref_n = SP.pack_stream_reference(vals, flags, cap)
        assert int(n) == int(ref_n) and n.dtype == torch.int32
        assert torch.equal(got, ref)


@pytest.mark.parametrize("t,k", [(1, 64), (1, 16384), (37, 64),
                                 (5, 16384)])
@pytest.mark.parametrize("kind", ["none", "all", "half"])
def test_k6_kernel_equals_plain(cuda, kind, t, k):
    rng = np.random.default_rng(t * k + len(kind))
    flags = _flags(kind, t * k, rng).reshape(t, k)
    words = rng.integers(0, 1 << 16, (t, k), dtype=np.int64)
    plane = torch.from_numpy(((words | (flags.astype(np.int64) << 16)) *
                              flags).astype(np.int32)).to(cuda)
    before = SP.plane_launches
    got, n = SP.pack_plane(plane, t * k)
    torch.cuda.synchronize()
    assert SP.plane_launches == before + 1
    ref, ref_n = SP.pack_plane_reference(plane, t * k)
    assert int(n) == int(ref_n) == int(flags.sum())
    assert torch.equal(got, ref)


def _lane_block(rng, t: int, k: int) -> np.ndarray:
    return rng.integers(0, 24, t * k, dtype=np.uint8)


@pytest.mark.parametrize("t,k,srate", [(1, 64, 1), (1, 16384, 1),
                                       (64, 16384, 4), (1024, 64, 1)])
@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_k4_kernel_equals_plain(cuda, ctx_bits, t, k, srate):
    rng = np.random.default_rng(ctx_bits + t + k)
    lit = torch.from_numpy(_lane_block(rng, t, k)).to(cuda)
    for n in (t * k - 1, t * k, max(t * k // 3, 1)):
        before = RK.hist_launches
        got = RK.joint_histogram(lit, n, ctx_bits, srate, k)
        torch.cuda.synchronize()
        assert RK.hist_launches == before + 1
        ref = RK.joint_histogram_reference(lit, n, ctx_bits, srate, k)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("t,k", [(1, 64), (1, 16384), (33, 64),
                                 (20, 16384)])
@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_k5_kernel_equals_plain(cuda, ctx_bits, t, k):
    rng = np.random.default_rng(ctx_bits * 7 + t + k)
    lit = torch.from_numpy(_lane_block(rng, t, k)).to(cuda)
    n = t * k - 1
    freqs = R.quantize_freqs(RK.joint_histogram_reference(
        lit, n, ctx_bits, 1, k))
    before = RK.encode_launches
    states, plane = RK.encode_scan(lit, n, freqs, ctx_bits, k)
    torch.cuda.synchronize()
    assert RK.encode_launches == before + 1
    rs, rp = RK.encode_scan_reference(lit, n, freqs, ctx_bits, k)
    assert torch.equal(states, rs)
    assert torch.equal(plane, rp)


@pytest.mark.parametrize("ctx_bits", [0, 8])
def test_encode_block_card_equals_cpu(cuda, ctx_bits):
    rng = np.random.default_rng(ctx_bits)
    data = rng.integers(0, 40, 300_001, dtype=np.uint8)
    assert R.encode_block(data, ctx_bits, device=cuda) == \
        R.encode_block(data, ctx_bits, device="cpu")


def test_compress_rans_card_equals_cpu(cuda):
    rng = np.random.default_rng(4)
    skewed = rng.integers(0, 40, 300_000, dtype=np.uint8).tobytes()
    data = skewed + _repeating(400_000, 5).tobytes()
    s = lrzt.Settings(method="rans")
    before = (SP.stream_launches, RK.hist_launches, RK.encode_launches,
              SP.plane_launches)
    archive = lrzt.compress(data, s, device=cuda)
    after = (SP.stream_launches, RK.hist_launches, RK.encode_launches,
             SP.plane_launches)
    assert all(a == b + 1 for a, b in zip(after, before))
    assert archive == lrzt.compress(data, s, device="cpu")
    assert lrzt.decompress(archive) == data
