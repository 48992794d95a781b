"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
False.  This file imports neither JAX nor the JAX package, but
``tests/conftest.py`` imports JAX, so on a machine without it run:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu_torch.ops import anchor as A
from lrzip_next_tpu_torch.ops import compact as C
from lrzip_next_tpu_torch.ops import matcher as PM
from lrzip_next_tpu_torch.ops import rans as R
from lrzip_next_tpu_torch.models import device_path as DP
from lrzip_next_tpu_torch.ops import rans_kernels as RK
from lrzip_next_tpu_torch.ops import replay_ragged as RR
from lrzip_next_tpu_torch.ops import streampack as SP
from lrzip_next_tpu_torch.parallel import mesh as MESH
from lrzip_next_tpu_torch.models import crosschunk as XC
from lrzip_next_tpu_torch.ops import gearscan as GS
from test_torch_gearscan import CASES as GEAR_CASES, _case as gear_case, \
    _host_pair as gear_host_pair, _kernel_trees_window

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


# --- K7: the rANS decode scan ------------------------------------------------


def _encoded(rng, t: int, k: int, n: int, ctx_bits: int, cuda):
    """A lane-major block of t*k bytes (n real) encoded on the card with a
    forced lane count: (lit, freqs, states, words)."""
    block = _lane_block(rng, t, k)
    block[n:] = 0
    lit = torch.from_numpy(block).to(cuda)
    freqs = R.quantize_freqs(RK.joint_histogram_reference(
        lit, n, ctx_bits, 1, k))
    states, plane = RK.encode_scan(lit, n, freqs, ctx_bits, k)
    packed, n_words = SP.pack_plane(plane, t * k)
    return lit, freqs, states, packed[:int(n_words)].contiguous()


def _k7_equals_plain(words, states, freqs, n, ctx_bits, t):
    before = RK.decode_launches
    plane, xf = RK.decode_scan(words, states, freqs, n, ctx_bits, t)
    torch.cuda.synchronize()
    assert RK.decode_launches == before + 1
    ref_plane, ref_xf = RK.decode_scan_reference(words, states, freqs, n,
                                                 ctx_bits, t)
    assert torch.equal(plane, ref_plane)
    assert torch.equal(xf, ref_xf)
    return plane, xf


@pytest.mark.parametrize("t,k", [(1, 64), (1, 16384), (33, 64), (8, 1024),
                                 (7, 2048), (12, 4096), (5, 8192),
                                 (20, 16384)])
@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_k7_kernel_equals_plain(cuda, ctx_bits, t, k):
    """Every lanes-per-thread variant (K = 64 .. 16384), T = 1, T a
    multiple of 4 (word stores) and not (byte stores), n full, one short
    and with whole lanes of padding."""
    rng = np.random.default_rng(ctx_bits * 11 + t + k)
    for n in (t * k, t * k - 1, max(t * k // 3, 1), 1):
        lit, freqs, states, words = _encoded(rng, t, k, n, ctx_bits, cuda)
        plane, xf = _k7_equals_plain(words, states, freqs, n, ctx_bits, t)
        assert torch.equal(plane[:n], lit[:n])
        assert not plane[n:].any()
        assert bool((xf == RK.L_INIT).all())


@pytest.mark.parametrize("k", [64, 1024, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_k7_on_every_cluster_size(cuda, ctx_bits, k):
    """One CTA up to K = 1024, then K / 1024 CTAs of one lane a thread (8
    of two lanes a thread where 16 do not fit at K = 16384); T = 13 (byte
    stores) and 16 (word stores), a partial last lane: K7 decodes what K5
    encoded, bit-equal to its plain version."""
    ctas = RK.decode_cluster(k, ctx_bits)
    want = 1 if k <= 1024 else k // 1024
    assert ctas == want or (k == 16384 and ctas == 8)
    assert k // ctas <= 2048
    rng = np.random.default_rng(ctx_bits * 13 + k)
    for t in (13, 16):
        n = t * k - 7
        lit, freqs, states, words = _encoded(rng, t, k, n, ctx_bits, cuda)
        plane, xf = _k7_equals_plain(words, states, freqs, n, ctx_bits, t)
        assert torch.equal(plane[:n], lit[:n])
        assert bool((xf == RK.L_INIT).all())


@pytest.mark.parametrize("k", [2048, 16384])
@pytest.mark.parametrize("fault", ["flipped_word", "short_stream",
                                   "empty_words"])
def test_k7_cluster_on_corrupt_streams(cuda, fault, k):
    """A damaged stream: the cluster kernel follows the plain version bit
    for bit, reads nothing past the words, and ends off 2^16."""
    rng = np.random.default_rng(k + len(fault))
    t, ctx_bits = 9, 6
    n = t * k - 3
    _, freqs, states, words = _encoded(rng, t, k, n, ctx_bits, cuda)
    if fault == "flipped_word":
        words = words.clone()
        words[words.shape[0] // 3] ^= 0x0100
    elif fault == "short_stream":
        words = words[:words.shape[0] // 2].contiguous()
    else:
        words = words[:0].contiguous()
    _, xf = _k7_equals_plain(words, states, freqs, n, ctx_bits, t)
    assert not bool((xf == RK.L_INIT).all())


def test_k7_back_to_back_and_on_a_side_stream(cuda):
    """20 calls back to back on the current stream, then one on a side
    stream: every result equal to the plain version's."""
    rng = np.random.default_rng(20)
    t, k, ctx_bits = 40, 16384, 6
    n = t * k - 11
    lit, freqs, states, words = _encoded(rng, t, k, n, ctx_bits, cuda)
    ref = RK.decode_scan_reference(words, states, freqs, n, ctx_bits, t)
    outs = [RK.decode_scan(words, states, freqs, n, ctx_bits, t)
            for _ in range(20)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs.append(RK.decode_scan(words, states, freqs, n, ctx_bits, t))
    torch.cuda.synchronize()
    for plane, xf in outs:
        assert torch.equal(plane, ref[0]) and torch.equal(xf, ref[1])
    assert torch.equal(ref[0][:n], lit[:n])


@pytest.mark.parametrize("layout", ["aligned", "unaligned", "short_tail"])
@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_k5_group_loads(cuda, ctx_bits, layout):
    """T % 16 == 0 on a 16-byte aligned block (16-byte loads), the same
    block one byte off alignment and T % 16 != 0 (byte loads), each with a
    partial last lane: K5 equals its plain version and K7 decodes it."""
    t = 21 if layout == "short_tail" else 48
    k = 2048
    rng = np.random.default_rng(ctx_bits * 3 + t + len(layout))
    n = t * k - 5
    block = torch.from_numpy(_lane_block(rng, t, k)).to(cuda)
    block[n:] = 0
    if layout == "unaligned":
        buf = torch.zeros(t * k + 1, dtype=torch.uint8, device=cuda)
        buf[1:] = block
        lit = buf[1:]
        assert lit.data_ptr() % 16 == 1
    else:
        lit = block
    freqs = R.quantize_freqs(RK.joint_histogram_reference(
        lit, n, ctx_bits, 1, k))
    before = RK.encode_launches
    states, plane = RK.encode_scan(lit, n, freqs, ctx_bits, k)
    torch.cuda.synchronize()
    assert RK.encode_launches == before + 1
    rs, rp = RK.encode_scan_reference(lit, n, freqs, ctx_bits, k)
    assert torch.equal(states, rs)
    assert torch.equal(plane, rp)
    packed, n_words = SP.pack_plane(plane, t * k)
    words = packed[:int(n_words)].contiguous()
    out, xf = _k7_equals_plain(words, states, freqs, n, ctx_bits, t)
    assert torch.equal(out[:n], lit[:n])
    assert bool((xf == RK.L_INIT).all())


def test_k5_reciprocals_on_the_card_equal_the_cpu_table(cuda):
    assert torch.equal(RK.reciprocals(cuda).cpu(), RK.reciprocals("cpu"))


def _random_table(rng, ctx_bits: int, cuda) -> torch.Tensor:
    counts = rng.integers(0, 500, (1 << ctx_bits, 256)) ** 2
    return R.quantize_freqs(torch.from_numpy(counts.astype(np.int32))
                            ).to(cuda)


@pytest.mark.parametrize("k", [64, 16384])
@pytest.mark.parametrize("kind", ["all_renormalise", "none_renormalises",
                                  "random_states", "stream_ends_early",
                                  "empty_stream"])
def test_k7_kernel_equals_plain_on_arbitrary_states(cuda, kind, k):
    """States and words that no encoder wrote: the kernel still follows
    the plain version bit for bit, and never reads past the stream."""
    rng = np.random.default_rng(k + len(kind))
    t, ctx_bits = 6, 6
    n = t * k - 3
    lo, hi = {"all_renormalise": (1 << 16, (1 << 16) + 4096),
              "none_renormalises": (1 << 31, 1 << 32)}.get(
                  kind, (1 << 16, 1 << 32))
    states = torch.from_numpy(rng.integers(lo, hi, k, dtype=np.int64)
                              .astype(np.uint32).view(np.int32)).to(cuda)
    if kind == "all_renormalise":   # f = 16 everywhere: x2 < 2^16 at t = 0
        freqs = torch.full((64, 256), 16, dtype=torch.int32, device=cuda)
    else:
        freqs = _random_table(rng, ctx_bits, cuda)
    n_words = {"stream_ends_early": k // 2, "empty_stream": 0}.get(
        kind, t * k)
    words = torch.from_numpy(rng.integers(0, 1 << 16, n_words, dtype=np.int64)
                             .astype(np.uint16).view(np.int16)).to(cuda)
    plane, xf = _k7_equals_plain(words, states, freqs, n, ctx_bits, t)
    assert not plane[n:].any()
    if kind == "none_renormalises":
        _, one = RK.decode_scan(words, states, freqs, k, ctx_bits, 1)
        _, other = RK.decode_scan(words[:0], states, freqs, k, ctx_bits, 1)
        assert torch.equal(one, other)      # step 0 took no word


def test_k7_wrapper_raises_on_cuda_tensors_it_does_not_take(cuda):
    words = torch.zeros(8, dtype=torch.int16, device=cuda)
    states = torch.full((64,), 1 << 16, dtype=torch.int32, device=cuda)
    freqs = torch.full((64, 256), 16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        RK.decode_scan(words, states[:32], freqs, 32, 6, 1)
    with pytest.raises(ValueError):
        RK.decode_scan(words.cpu(), states, freqs, 64, 6, 1)
    with pytest.raises(TypeError):
        RK.decode_scan(words, states, freqs.to(torch.int64), 64, 6, 1)


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
@pytest.mark.parametrize("n", [1, 70_001, 2_200_000])
def test_decode_block_card_equals_cpu(cuda, ctx_bits, n):
    rng = np.random.default_rng(ctx_bits + n)
    data = rng.integers(0, 40, n, dtype=np.uint8)
    payload = R.encode_block(data, ctx_bits, device=cuda)
    assert R.decode_block(payload, device=cuda) == data.tobytes()
    assert R.decode_block(payload, device="cpu") == data.tobytes()
    bad = bytearray(payload)
    bad[-1] ^= 0x01
    with pytest.raises(ValueError):
        R.decode_block(bytes(bad), device=cuda)


def test_decompress_rans_card_equals_cpu(cuda):
    rng = np.random.default_rng(6)
    skewed = rng.integers(0, 40, 300_000, dtype=np.uint8).tobytes()
    data = skewed + _repeating(400_000, 7).tobytes() + skewed[:100_000]
    s = lrzt.Settings(method="rans", max_chunk=300_000)
    archive = lrzt.compress(data, s, device="cpu")
    before = RK.decode_launches
    assert lrzt.decompress(archive, device=cuda) == data
    assert RK.decode_launches > before
    assert lrzt.decompress(archive, device="cpu") == data


# --- K8a, K8b, K8c: the ragged replay ---------------------------------------


def _random_plan(rng, out_len, lit_len, mode):
    """Piece lengths covering [0, out_len) and their literal sources."""
    lens = []
    left = out_len
    while left > 0:
        hi = {"tiny": 8, "short": RR.SHORT_LEN + 1, "big": 30_000}.get(
            mode, int(rng.choice([16, 1500, 20_000])))
        lo = {"big": RR.SHORT_LEN + 1}.get(mode, 1)
        n = min(int(rng.integers(lo, hi)), left)
        lens.append(n)
        left -= n
    lens = np.asarray(lens, np.int64)
    srcs = rng.integers(0, lit_len - lens + 1)
    return lens, srcs.astype(np.int64)


@pytest.mark.parametrize("mode", ["mixed", "tiny", "short", "big"])
@pytest.mark.parametrize("out_len", [1, 777, 8192, 8193, 300_000])
def test_k8a_k8c_kernels_equal_plain(cuda, mode, out_len):
    """A flat plan on the card against the same plan on the CPU (the plain
    versions) and against numpy slicing, at every misalignment of source
    against destination; K8a launches once, K8c when a piece is short."""
    rng = np.random.default_rng(out_len + len(mode))
    lit_len = out_len + 40_000
    lit = rng.integers(0, 256, lit_len, dtype=np.uint8)
    lens, srcs = _random_plan(rng, out_len, lit_len, mode)
    before = (RR.ragged_launches, RR.small_launches, RR.layered_launches)
    got = RR.replay_pieces_ragged(lens, srcs, torch.from_numpy(lit).to(cuda),
                                  out_len)
    torch.cuda.synchronize()
    merged = RR.merge_contiguous(lens, srcs)[0]
    assert RR.ragged_launches == before[0] + 1
    assert RR.small_launches == before[1] + int(
        (merged <= RR.SHORT_LEN).any())
    assert RR.layered_launches == before[2]
    want = np.concatenate([lit[s:s + n] for s, n in zip(srcs, lens)])
    assert np.array_equal(got.cpu().numpy(), want)
    ref = RR.replay_pieces_ragged(lens, srcs, torch.from_numpy(lit), out_len)
    assert torch.equal(got.cpu(), ref)


def _np_split(dst, srcs, lens):
    """The long and short piece tables, (3, n) int64 in dst order, as
    ``replay_ragged.split_pieces`` makes them on the device."""
    t = np.stack([dst, srcs, lens]).astype(np.int64)
    short = t[2] <= RR.SHORT_LEN
    return (np.ascontiguousarray(t[:, ~short]),
            np.ascontiguousarray(t[:, short]))


def _piece_tables(rng, out_len, lit_len, mode, cuda):
    """The long and short piece tables of a random plan, on the card."""
    lens, srcs = _random_plan(rng, out_len, lit_len, mode)
    long_t, short_t = _np_split(np.cumsum(lens) - lens, srcs, lens)
    return (torch.from_numpy(long_t).to(cuda),
            torch.from_numpy(short_t).to(cuda), -(-out_len // RR.CELL))


@pytest.mark.parametrize("mode", ["mixed", "big"])
def test_k8a_wrapper_equals_its_plain_version(cuda, mode):
    rng = np.random.default_rng(len(mode))
    lit = torch.from_numpy(rng.integers(0, 256, 90_000, dtype=np.uint8)
                           ).to(cuda)
    long_t, _, ncells = _piece_tables(rng, 70_000, 90_000, mode, cuda)
    out = RR.ragged_concat(lit, long_t, ncells)
    torch.cuda.synchronize()
    assert torch.equal(out, RR.ragged_concat_reference(lit, long_t, ncells))
    assert out.shape[0] == ncells * RR.CELL and not out[70_000:].any()


def _named_plan(name, rng):
    """(lens, srcs, lit) of the CPU tests' named plans
    (``tests/test_torch_k8_redesign.py``)."""
    mib = 1 << 20
    lit_len = 400_000

    def mixed(total, lo, hi):
        out, left = [], total
        while left > 0:
            out.append(min(int(rng.integers(lo, hi)), left))
            left -= out[-1]
        return out

    lens = {
        "several_mib_piece": [5000, 3 * mib + 123, 700, 100, 20_000],
        "ends_on_8k": [8192, 16384, 600, 7592, 300, 212, 7680, 24576, 1,
                       8191, 513, 15871],
        "ends_on_1k": [1024, 512, 512, 1000, 24, 2048, 100, 924, 3000, 72,
                       9216, 511, 513],
        "only_long": None, "only_short": None,
        "short_pieces_share_words": None,
    }.get(name)
    if name == "several_mib_piece":
        lit_len = 4 * mib
    if name.startswith("out_len_"):
        lens = mixed(int(name[8:]), 1, 1500)
    elif name == "only_long":
        lens = mixed(200_000, RR.SHORT_LEN + 1, 20_000)
    elif name == "only_short":
        lens = mixed(60_000, 1, RR.SHORT_LEN + 1)
    elif name == "short_pieces_share_words":
        lens = mixed(20_000, 1, 16)
    lens = np.asarray(lens, np.int64)
    srcs = np.asarray([rng.integers(0, lit_len - n + 1) for n in lens],
                      np.int64)
    return lens, srcs, rng.integers(0, 256, lit_len, dtype=np.uint8)


@pytest.mark.parametrize("name", [
    "several_mib_piece", "ends_on_8k", "ends_on_1k", "out_len_1",
    "out_len_8191", "out_len_8192", "out_len_8193", "only_long",
    "only_short", "short_pieces_share_words"])
@pytest.mark.parametrize("lit_offset", [0, 5])
def test_k8a_k8c_named_plans_card_equals_cpu(cuda, name, lit_offset):
    """The CPU tests' plans on the card, with the literal plane also a view
    5 bytes past its allocation: bit-equal to the plain versions."""
    rng = np.random.default_rng(len(name))
    lens, srcs, lit = _named_plan(name, rng)
    lit_dev = torch.from_numpy(np.concatenate(
        [np.zeros(lit_offset, np.uint8), lit])).to(cuda)[lit_offset:]
    out_len = int(lens.sum())
    got = RR.replay_pieces_ragged(lens, srcs, lit_dev, out_len)
    torch.cuda.synchronize()
    ref = RR.replay_pieces_ragged(lens, srcs, torch.from_numpy(lit), out_len)
    assert torch.equal(got.cpu(), ref)
    want = np.concatenate([lit[s:s + n] for s, n in zip(srcs, lens)])
    assert np.array_equal(ref.numpy(), want)


def _misaligned(k, short, rng):
    lens = []
    left = 30_000 if short else 60_000
    lo, hi = (1, RR.SHORT_LEN + 1) if short else (RR.SHORT_LEN + 1, 9000)
    while left > 0:
        lens.append(min(int(rng.integers(lo, hi)), left))
        left -= lens[-1]
    lens = np.asarray(lens, np.int64)
    dst = np.cumsum(lens) - lens
    srcs = np.asarray([(int(rng.integers(0, 100_000 - n - 32)) & ~15)
                       + ((int(d) + k) & 15) for n, d in zip(lens, dst)],
                      np.int64)
    return dst, srcs, lens


@pytest.mark.parametrize("k", range(16))
def test_k8a_k8c_every_misalignment(cuda, k):
    """Source against destination k mod 16, every k, for long pieces (K8a)
    and short ones (K8c into a buffer of other bytes, ``out`` a view k
    bytes past its allocation)."""
    rng = np.random.default_rng(40 + k)
    lit = torch.from_numpy(rng.integers(0, 256, 100_000, dtype=np.uint8))
    dst, srcs, lens = _misaligned(k, False, rng)
    long_t = torch.from_numpy(_np_split(dst, srcs, lens)[0])
    ncells = -(-int(lens.sum()) // RR.CELL)
    out = RR.ragged_concat(lit.to(cuda), long_t.to(cuda), ncells)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), RR.ragged_concat_reference(lit, long_t,
                                                             ncells))
    dst, srcs, lens = _misaligned(k, True, rng)
    short_t = torch.from_numpy(_np_split(dst, srcs, lens)[1])
    base = torch.from_numpy(rng.integers(0, 256, 40_000 + k,
                                         dtype=np.uint8))
    mine = base.to(cuda)[k:]
    before = RR.small_launches
    RR.small_merge(mine, lit.to(cuda), short_t.to(cuda))
    torch.cuda.synchronize()
    assert RR.small_launches == before + 1
    plain = RR.small_merge_reference(base[k:].clone(), lit, short_t)
    assert torch.equal(mine.cpu(), plain)


@pytest.mark.parametrize("gap", [0, 100])
def test_k8a_dense_long_pieces_after_tiny_ones(cuda, gap):
    """Tens of thousands of 1-byte pieces in K8a's first block (its cells
    one by one), then the densest long pieces, whose blocks load their
    window again from their first piece (``tests/test_torch_k8_redesign``
    emulates the same table)."""
    rng = np.random.default_rng(gap + 1)
    tiny, n = 49_979, 128
    dst = np.concatenate([np.arange(tiny), 8 * 8192 +
                          np.arange(n) * (RR.SHORT_LEN + 1 + gap)])
    lens = np.concatenate([np.ones(tiny, np.int64),
                           np.full(n, RR.SHORT_LEN + 1, np.int64)])
    lit = torch.from_numpy(rng.integers(0, 256, 50_000, dtype=np.uint8))
    srcs = rng.integers(0, 50_000 - 600, len(dst))
    table = torch.from_numpy(np.stack([dst, srcs, lens]).astype(np.int64))
    ncells = -(-int(dst[-1] + lens[-1]) // RR.CELL)
    out = RR.ragged_concat(lit.to(cuda), table.to(cuda), ncells)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), RR.ragged_concat_reference(lit, table,
                                                             ncells))


def test_k8a_zeroes_recycled_memory(cuda):
    """K8a handed memory that held 0xFF: every byte that no piece covers
    comes back 0 (the caching allocator hands the freed block back)."""
    rng = np.random.default_rng(77)
    lit = torch.from_numpy(rng.integers(0, 256, 300_000, dtype=np.uint8))
    lens = np.asarray([600, 9000, 513, 20_000, 700] * 20, np.int64)
    gaps = rng.integers(1, 600, len(lens))
    dst = np.cumsum(lens + gaps) - lens
    srcs = rng.integers(0, 300_000 - 20_000, len(lens))
    table = torch.from_numpy(np.stack([dst, srcs, lens]).astype(np.int64))
    ncells = -(-int(dst[-1] + lens[-1] + 5000) // RR.CELL)
    lit_d, table_d = lit.to(cuda), table.to(cuda)
    junk = torch.full((ncells * RR.CELL,), 0xFF, dtype=torch.uint8,
                      device=cuda)
    ptr = junk.data_ptr()
    del junk
    out = RR.ragged_concat(lit_d, table_d, ncells)
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr            # the recycled block
    assert torch.equal(out.cpu(), RR.ragged_concat_reference(lit, table,
                                                             ncells))
    covered = torch.zeros(ncells * RR.CELL, dtype=torch.bool)
    for d, n in zip(dst, lens):
        covered[d:d + n] = True
    assert not out.cpu()[~covered].any()


def _ordered_corrupt_table(seed):
    """A table in ``check_order``'s order with corrupt entries among the
    good ones, and its cell count (``tests/test_torch_k8_redesign.py``
    emulates the same tables)."""
    rng = np.random.default_rng(100 + seed)
    hi = (40, 600, 3000, 9000, 20_000, 700)[seed]
    n = 400
    lens = rng.integers(1, hi, n)
    gaps = np.where(rng.random(n) < 0.5, 0, rng.integers(0, 300, n))
    dst = np.cumsum(lens + gaps) - lens
    srcs = rng.integers(0, 30_000 - hi, n)
    bad = rng.random(n) < 0.2
    what = rng.integers(0, 4, n)
    lens = np.where(bad & (what == 0), 0, lens)
    lens = np.where(bad & (what == 1), -rng.integers(1, 50, n), lens)
    srcs = np.where(bad & (what == 2), -rng.integers(1, 50, n), srcs)
    srcs = np.where(bad & (what == 3), 30_000 - rng.integers(0, 9, n), srcs)
    dst[0] -= 37
    lens[-1] = 1 << 40
    table = np.stack([dst, srcs, lens]).astype(np.int64)
    return table, max(1, int(dst[-1]) // RR.CELL)


@pytest.mark.parametrize("seed", range(6))
def test_k8a_ordered_tables_with_corrupt_entries(cuda, seed):
    """Every table that ``check_order`` accepts is K8a's input: with
    corrupt entries among the good ones the kernel is bit-equal to its
    plain version."""
    rng = np.random.default_rng(seed)
    lit = torch.from_numpy(rng.integers(0, 256, 30_000, dtype=np.uint8))
    table, ncells = _ordered_corrupt_table(seed)
    t = torch.from_numpy(table)
    RR.check_order(t)
    out = RR.ragged_concat(lit.to(cuda)[seed:], t.to(cuda), ncells)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), RR.ragged_concat_reference(
        lit[seed:], t, ncells))


def test_k8a_k8c_past_2_gib(cuda):
    """An output of more than 2^31 bytes: pieces on both sides of 2^31 and
    at the end, through K8a and then K8c in place, equal to the plain
    versions on the card; every other byte is 0."""
    rng = np.random.default_rng(31)
    out_len = (1 << 31) + 3 * RR.CELL + 5
    lit = torch.from_numpy(rng.integers(0, 256, 100_000, dtype=np.uint8)
                           ).to(cuda)
    at = [(1 << 31) - 12_000, (1 << 31) - 2000, (1 << 31) - 3,
          out_len - 2000]
    lens = [8990, 1400, 515, 2000]
    long_t = torch.tensor([at, rng.integers(0, 90_000, 4).tolist(), lens],
                          dtype=torch.int64, device=cuda)
    sat = [(1 << 31) - 3010, (1 << 31) - 8, (1 << 31) + 512,
           out_len - 2013]
    slen = [3, 5, 17, 13]
    short_t = torch.tensor([sat, rng.integers(0, 90_000, 4).tolist(), slen],
                           dtype=torch.int64, device=cuda)
    ncells = -(-out_len // RR.CELL)
    out = RR.ragged_concat(lit, long_t, ncells)
    RR.small_merge(out, lit, short_t)
    torch.cuda.synchronize()
    ref = RR.ragged_concat_reference(lit, long_t, ncells)
    RR.small_merge_reference(ref, lit, short_t)
    assert torch.equal(out, ref)
    del ref
    host = lit.cpu().numpy()
    for d, s, n in zip(at + sat, long_t[1].tolist() + short_t[1].tolist(),
                       lens + slen):
        assert np.array_equal(out[d:d + n].cpu().numpy(), host[s:s + n])
    assert int(out.count_nonzero()) <= sum(lens) + sum(slen)


def test_k8c_keeps_neighbour_bytes(cuda):
    """Short pieces beside pre-filled bytes, some pieces sharing a 16-byte
    word with each other, some separated by gaps of 1..20 bytes: every
    byte outside the pieces survives unchanged."""
    rng = np.random.default_rng(78)
    lit = torch.from_numpy(rng.integers(0, 256, 50_000, dtype=np.uint8))
    lens = rng.integers(1, 40, 3000)
    gaps = np.where(rng.random(3000) < 0.5, 0, rng.integers(1, 21, 3000))
    dst = np.cumsum(lens + gaps) - lens
    srcs = rng.integers(0, 50_000 - 40, 3000)
    order = rng.permutation(3000)           # K8c takes any order
    table = torch.from_numpy(np.stack([dst, srcs, lens])[:, order].astype(
        np.int64).copy())
    fill = torch.from_numpy(rng.integers(0, 256, int(dst[-1] + 64),
                                         dtype=np.uint8))
    mine = fill.to(cuda)
    RR.small_merge(mine, lit.to(cuda), table.to(cuda))
    torch.cuda.synchronize()
    plain = RR.small_merge_reference(fill.clone(), lit, table)
    assert torch.equal(mine.cpu(), plain)
    covered = torch.zeros(fill.shape[0], dtype=torch.bool)
    for d, n in zip(dst, lens):
        covered[d:d + n] = True
    assert torch.equal(mine.cpu()[~covered], fill[~covered])


def test_k8_kernels_never_leave_their_tensors(cuda):
    """Tables that no planner wrote: sources and destinations outside the
    tensors, lengths past the output, ranges past the table.  K8a reads 0
    outside the plane, K8b and K8c skip the piece or fragment, as the
    plain versions do, and the bytes around the tensors stay untouched."""
    lit_all = torch.arange(0, 4096, dtype=torch.int32).to(torch.uint8).to(cuda)
    lit = lit_all[1024:3072]            # guarded on both sides
    # ascending by end and disjoint, as the replay's tables are
    rows = [[-5, 0, 100, 200, 9300, 16000, 16500],
            [0, 2040, -3, 5, 10, 0, 1 << 40],
            [5, 20, 10, 9000, 300, 500, 8]]
    pieces = torch.tensor(rows, dtype=torch.int64, device=cuda)
    out = RR.ragged_concat(lit, pieces, 2)
    torch.cuda.synchronize()
    assert torch.equal(out, RR.ragged_concat_reference(lit, pieces, 2))
    assert out[:20].tolist() == lit[2040:2048].tolist() + [0] * 12
    assert out[100:110].tolist() == [0, 0, 0] + lit[:7].tolist()
    assert out[200:9200].tolist() == lit[5:].tolist() + \
        [0] * (9000 - 2043)
    assert not out[16000:].any()
    buf_all = torch.zeros(3 * 8192, dtype=torch.uint8, device=cuda)
    buf = buf_all[8192:16384]
    plain = torch.zeros(8192, dtype=torch.uint8, device=cuda)
    RR.small_merge(buf, lit, pieces)
    torch.cuda.synchronize()
    RR.small_merge_reference(plain, lit, pieces)
    assert torch.equal(buf, plain)
    assert not buf_all[:8192].any() and not buf_all[16384:].any()
    # not ascending: K8a stays inside its tensors all the same, and a byte
    # that no valid piece covers stays 0
    shuffled = pieces[:, [3, 0, 6, 1, 5, 2, 4]].contiguous()
    out = RR.ragged_concat(lit, shuffled, 2)
    torch.cuda.synchronize()
    covered = torch.zeros(2 * 8192, dtype=torch.bool, device=cuda)
    for d, n in ((0, 20), (100, 10), (200, 9000), (9300, 300)):
        covered[d:d + n] = True
    assert out.shape[0] == 2 * 8192 and not out[~covered].any()
    with pytest.raises(ValueError, match="ascending and disjoint"):
        RR.ragged_concat_reference(lit, shuffled, 2)   # not its input
    # K8b: a layer's table in dst order whose pieces all lie outside the
    # view as a source or a destination, then one valid piece among them
    seq = torch.arange(0, 3 * 8192, dtype=torch.int32).to(torch.uint8).to(cuda)
    mine, plain = seq.clone(), seq.clone()
    lay = torch.tensor([[100, 9000, 8192 * 3 - 4], [8192 * 3 - 50, 10, 0],
                        [51, 64, 8]], dtype=torch.int64, device=cuda)
    RR.layered_pass(mine[8192:16384], lay)
    torch.cuda.synchronize()
    RR.layered_pass_reference(plain[8192:16384], lay)
    assert torch.equal(mine, plain) and torch.equal(mine, seq)
    lay = torch.tensor([[-3, 4000, 8100], [10, 8150, 8000], [3, 42, 2]],
                       dtype=torch.int64, device=cuda)
    RR.layered_pass(mine[8192:16384], lay)
    torch.cuda.synchronize()
    RR.layered_pass_reference(plain[8192:16384], lay)
    assert torch.equal(mine, plain)
    assert torch.equal(mine[8192 + 4000:8192 + 4042],
                       seq[8192 + 8150:8192 + 8192])
    assert torch.equal(mine[:8192], seq[:8192])
    assert torch.equal(mine[16384:], seq[16384:])


def _pasted(total, seed):
    """Short pieces of a skewed i.i.d. base pasted in random order, then
    copies of that region and of its copies: a layered replay plan."""
    rng = np.random.default_rng(seed)
    part = total // 4
    law = 1.0 / np.arange(1, 257) ** 1.2
    base = rng.choice(256, part, p=law / law.sum()).astype(np.uint8)
    lens = rng.integers(40, 400, part // 200)
    lens = lens[np.cumsum(lens) <= part]
    starts = rng.integers(0, part - 400, len(lens))
    idx = np.repeat(starts - (np.cumsum(lens) - lens), lens) + \
        np.arange(int(lens.sum()))
    frag = base[idx]
    return np.concatenate([base, frag, frag, frag[len(frag) // 3:], base,
                           frag])[:total]


@pytest.mark.parametrize("total", [1 << 20, 3_000_001])
def test_k8b_layered_replay_card_equals_cpu(cuda, total):
    from lrzip_next_tpu_torch import runtime
    from lrzip_next_tpu_torch.format.tokens import split_long_runs
    data = _pasted(total, total)
    kinds, lens, dists = split_long_runs(
        *PM.rzip_encode_chunk(data, 8, torch.device("cpu")))
    lay = runtime.flatten_replay_layered(kinds, lens, dists)
    assert lay is not None and lay[3] >= 1
    ends = np.cumsum(lens)
    lit = np.concatenate([data[e - n:e] for k, n, e in
                          zip(kinds, lens, ends) if k == 0])
    before = (RR.ragged_launches, RR.layered_launches)
    out = DP.replay_tokens_device_array(kinds, lens, dists,
                                        torch.from_numpy(lit).to(cuda))
    torch.cuda.synchronize()
    assert RR.ragged_launches == before[0] + 1
    assert 1 <= RR.layered_launches - before[1] <= lay[3]
    assert np.array_equal(out.cpu().numpy(), data)
    ref = DP.replay_tokens_device_array(kinds, lens, dists,
                                        torch.from_numpy(lit))
    assert torch.equal(out.cpu(), ref)


def _layer_table(rng, lens, buf_len, gap_hi=1, src_hi=None):
    """A layer's (3, P) table: destinations ascending from the buffer's
    second half with gaps of 0 to gap_hi - 1 bytes, sources below
    ``src_hi`` (the first half), so no source byte is a destination
    byte (``tests/test_torch_k8b_redesign.py`` emulates such tables)."""
    lens = np.asarray(lens, np.int64)
    gaps = rng.integers(0, gap_hi, len(lens))
    dst = buf_len // 2 + np.cumsum(lens + gaps) - lens
    assert int(dst[-1] + lens[-1]) <= buf_len
    src_hi = src_hi or buf_len // 2
    src = np.asarray([rng.integers(0, src_hi - n + 1) for n in lens],
                     np.int64)
    return torch.from_numpy(np.stack([dst, src, lens]).astype(np.int64))


def _k8b_card_equals_plain(cuda, base, table, view):
    """K8b on ``base[view:]`` on the card against the plain version on
    the CPU; the byte before the view is never written.  Returns the
    card's buffer, its view and the plain one."""
    RR.check_order(table)
    whole = base.to(cuda)
    mine = whole[view:]
    before = RR.layered_launches
    RR.layered_pass(mine, table.to(cuda))
    torch.cuda.synchronize()
    assert RR.layered_launches == before + 1
    plain = RR.layered_pass_reference(base[view:].clone(), table)
    assert torch.equal(mine.cpu(), plain)
    assert torch.equal(whole[:view].cpu(), base[:view])
    return mine, plain


@pytest.mark.parametrize("view", [0, 5])
@pytest.mark.parametrize("length", [1, 15, 16, 17, 511, 512, 513, 4096,
                                    8191, 8192, 8193])
def test_k8b_pieces_of_every_length(cuda, length, view):
    """A layer of pieces all of one length, with and without gaps, in a
    buffer view ``view`` bytes past its allocation."""
    rng = np.random.default_rng(length + view)
    n = 40
    buf_len = 4 * n * (length + 40) + 64
    table = _layer_table(rng, [length] * n, buf_len,
                         gap_hi=1 + 37 * (length % 2))
    base = torch.from_numpy(rng.integers(0, 256, buf_len + view,
                                         dtype=np.uint8))
    _k8b_card_equals_plain(cuda, base, table, view)


@pytest.mark.parametrize("k", range(16))
def test_k8b_every_misalignment(cuda, k):
    """Source k bytes past its destination mod 16, the buffer a view 3k
    mod 16 bytes past its allocation, pieces of 1 to 20000 bytes."""
    rng = np.random.default_rng(300 + k)
    lens = rng.integers(1, 20_000, 60)
    buf_len = 2 * int(lens.sum()) + 32 * len(lens) + 64
    table = _layer_table(rng, lens, buf_len, gap_hi=20,
                         src_hi=buf_len // 2 - 16).numpy()
    table[1] += (table[0] + k - table[1]) % 16
    assert ((table[1] - table[0]) % 16 == k).all()
    view = (3 * k) % 16
    base = torch.from_numpy(rng.integers(0, 256, buf_len + view,
                                         dtype=np.uint8))
    _k8b_card_equals_plain(cuda, base, torch.from_numpy(table), view)


@pytest.mark.parametrize("name", ["short_pieces_many_windows",
                                  "piece_over_many_spans", "sparse",
                                  "shared_words"])
def test_k8b_named_layers(cuda, name):
    """Hundreds of pieces of 1-40 bytes a span (the block's windows one
    after another), one piece over many 16 KiB spans, pieces far apart,
    and pieces with no gaps, so that neighbours share their edge
    words."""
    rng = np.random.default_rng(len(name))
    if name == "short_pieces_many_windows":
        lens = rng.integers(1, 40, 20_000)
        buf_len = 2 * int(lens.sum()) + 30 * len(lens)
        table = _layer_table(rng, lens, buf_len, gap_hi=10)
    elif name == "piece_over_many_spans":
        buf_len = 2_000_003
        table = _layer_table(rng, [7, 900_001, 33], buf_len, gap_hi=40)
    elif name == "sparse":
        buf_len = 8 << 20
        table = _layer_table(rng, rng.integers(100, 900, 30), buf_len,
                             src_hi=1 << 20).numpy()
        table[0] = buf_len // 2 + np.arange(30) * 70_001
        table = torch.from_numpy(table)
    else:
        lens = rng.integers(1, 3000, 500)
        buf_len = 2 * int(lens.sum())
        dst = buf_len // 2 + np.cumsum(lens) - lens
        src = dst - buf_len // 2 + rng.integers(-8, 9, len(lens))
        src = np.clip(src, 0, buf_len // 2 - lens)
        table = torch.from_numpy(np.stack([dst, src, lens]).astype(np.int64))
    base = torch.from_numpy(rng.integers(0, 256, buf_len + 3,
                                         dtype=np.uint8))
    _k8b_card_equals_plain(cuda, base, table, 3)


def test_k8b_keeps_recycled_bytes(cuda):
    """K8b in place on memory that held 0xFF (the caching allocator hands
    the freed block back), sources written below: every byte outside the
    pieces stays 0xFF, every piece byte is its source's."""
    rng = np.random.default_rng(79)
    buf_len = 3 << 20
    table = _layer_table(rng, rng.integers(1, 5000, 400), buf_len,
                         gap_hi=300)
    junk = torch.full((buf_len,), 0xFF, dtype=torch.uint8, device=cuda)
    ptr = junk.data_ptr()
    del junk
    buf = torch.empty(buf_len, dtype=torch.uint8, device=cuda)
    assert buf.data_ptr() == ptr            # the recycled block
    src = torch.from_numpy(rng.integers(0, 256, buf_len // 2,
                                        dtype=np.uint8))
    buf[:buf_len // 2] = src.to(cuda)
    host = buf.cpu()
    RR.layered_pass(buf, table.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), RR.layered_pass_reference(host.clone(),
                                                            table))
    covered = torch.zeros(buf_len, dtype=torch.bool)
    for d, s, n in table.T.tolist():
        covered[d:d + n] = True
        assert torch.equal(buf[d:d + n].cpu(), src[s:s + n])
    assert bool((buf.cpu()[buf_len // 2:][~covered[buf_len // 2:]]
                 == 0xFF).all())


def test_k8b_corrupt_and_unordered_tables_stay_inside(cuda):
    """Corrupt pieces in dst order are skipped whole, as the plain version
    skips them; a table out of order writes only bytes of its valid
    pieces, and nothing outside the view."""
    rng = np.random.default_rng(80)
    t = np.array([[-5, 6000, 6700, 8000, 9000, 9700, 11_000],
                  [10, 300, -7, 40, 1 << 40, 50, 20],
                  [600, 600, 1200, 0, 600, 600, 1 << 40]], np.int64)
    base = torch.from_numpy(rng.integers(0, 256, 12_000 + 8,
                                         dtype=np.uint8))
    _, plain = _k8b_card_equals_plain(cuda, base, torch.from_numpy(t), 8)
    assert torch.equal(plain[:6000], base[8:6008])   # the corrupt first
    shuffled = torch.from_numpy(np.ascontiguousarray(t[:, [0, 5, 3, 1]]))
    whole = base.to(cuda)
    RR.layered_pass(whole[8:], shuffled.to(cuda))
    torch.cuda.synchronize()
    changed = whole.cpu() != base
    allowed = torch.zeros_like(changed)
    for d, n in ((6000, 600), (9700, 600)):
        allowed[8 + d:8 + d + n] = True
    assert not bool((changed & ~allowed).any())


def test_k8b_past_2_gib(cuda):
    """A buffer of more than 2^31 bytes: pieces on both sides of 2^31 and
    at its end, their sources below; equal to the plain version run on
    the card."""
    rng = np.random.default_rng(32)
    buf_len = (1 << 31) + 3 * 8192 + 5
    buf = torch.empty(buf_len, dtype=torch.uint8, device=cuda)
    buf[:1 << 20] = torch.from_numpy(rng.integers(0, 256, 1 << 20,
                                                  dtype=np.uint8)).to(cuda)
    at = [(1 << 31) - 12_000, (1 << 31) - 2000, (1 << 31) - 3,
          (1 << 31) + 512, buf_len - 2013]
    lens = [8990, 1400, 515, 17, 2013]
    srcs = rng.integers(0, (1 << 20) - 9000, len(at)).tolist()
    table = torch.tensor([at, srcs, lens], dtype=torch.int64, device=cuda)
    ref = buf.clone()
    RR.layered_pass(buf, table)
    RR.layered_pass_reference(ref, table)
    torch.cuda.synchronize()
    assert torch.equal(buf, ref)
    del ref
    for d, s, n in zip(at, srcs, lens):
        assert torch.equal(buf[d:d + n], buf[s:s + n])


def test_byte_rle_pointer_doubling_on_the_card(cuda):
    kinds = np.array([0, 1, 0, 1], np.uint8)
    lens = np.array([3, 200_000, 5, 40], np.int64)
    dists = np.array([0, 1, 0, 7], np.int64)
    lit = torch.tensor([9, 8, 7, 1, 2, 3, 4, 5], dtype=torch.uint8)
    before = RR.ragged_launches
    out = DP.replay_tokens_device_array(kinds, lens, dists, lit.to(cuda))
    assert RR.ragged_launches == before     # no piece plan, no kernel
    assert torch.equal(out.cpu(), DP.replay_tokens_device_array(
        kinds, lens, dists, lit))


def test_k8_wrappers_raise_on_cuda_tensors_they_do_not_take(cuda):
    lit = torch.zeros(64, dtype=torch.uint8, device=cuda)
    frags = torch.tensor([[0], [0], [4]], dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        RR.ragged_concat(lit, frags.cpu(), 1)
    with pytest.raises(ValueError):
        RR.ragged_concat(lit, frags, 0)
    with pytest.raises(TypeError):
        RR.ragged_concat(lit, frags.to(torch.int32), 1)
    with pytest.raises(TypeError):
        RR.layered_pass(lit, frags.to(torch.int32))
    with pytest.raises(ValueError):
        RR.layered_pass(lit, frags.cpu())
    with pytest.raises(ValueError):
        RR.layered_pass(lit[::2], frags)
    with pytest.raises(ValueError):
        RR.small_merge(lit, lit[::2], frags)
    with pytest.raises(ValueError):
        RR.small_merge(lit, lit, frags.cpu())
    before = (RR.small_launches, RR.layered_launches)
    RR.small_merge(lit, lit, frags[:, :0])      # no piece: no launch
    RR.layered_pass(lit, frags[:, :0])
    assert (RR.small_launches, RR.layered_launches) == before


def test_decompress_layered_card_equals_cpu(cuda):
    data = _pasted(2 << 20, 9).tobytes()
    s = lrzt.Settings(method="rans")
    archive = lrzt.compress(data, s, device=cuda)
    assert archive == lrzt.compress(data, s, device="cpu")
    before = (RK.decode_launches, RR.ragged_launches, RR.small_launches,
              RR.layered_launches)
    assert lrzt.decompress(archive, device=cuda) == data
    after = (RK.decode_launches, RR.ragged_launches, RR.small_launches,
             RR.layered_launches)
    assert all(a > b for a, b in zip(after, before))
    assert lrzt.decompress(archive, device="cpu") == data
    assert after == (RK.decode_launches, RR.ragged_launches,
                     RR.small_launches, RR.layered_launches)


# --- K9 and K10: the masked compactions -------------------------------------

def _source_constant(src: str, name: str) -> int:
    """A ``constexpr int`` of one of the port's CUDA sources."""
    text = (Path(C.__file__).resolve().parent / "csrc" / src).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


_TILE = _source_constant("compact_masked.cu", "kTile")   # elements a K9 tile


def _masks(kind: str, k: int, rng):
    """(start, is_end) bool masks of length ``k``."""
    idx = np.arange(k)
    if kind == "none":
        return np.zeros(k, bool), np.zeros(k, bool)
    if kind == "all":
        return np.ones(k, bool), np.ones(k, bool)
    if kind == "only_starts":
        return rng.random(k) < 0.3, np.zeros(k, bool)
    if kind == "ends_without_starts_in_a_block":
        # one start in the first block, one end in every block: all blocks
        # after the first hold ends and no start
        return idx == 0, idx % _TILE == min(_TILE, k) - 1
    if kind == "runs":
        # alternating run starts and ends, the last run cut by the edge
        cut = np.sort(rng.choice(k, size=min(k, max(2, k // 7)),
                                 replace=False))
        start, is_end = np.zeros(k, bool), np.zeros(k, bool)
        start[cut[0::2]] = True
        is_end[cut[1::2]] = True
        return start, is_end
    return rng.random(k) < 0.5, rng.random(k) < 0.5


@pytest.mark.parametrize("k", [1, _TILE - 1, _TILE, _TILE + 1, 100_003])
@pytest.mark.parametrize("kind", ["none", "all", "only_starts",
                                  "ends_without_starts_in_a_block", "runs",
                                  "half"])
def test_k9_kernel_equals_plain(cuda, kind, k):
    rng = np.random.default_rng(k)
    start, is_end = _masks(kind, k, rng)
    pos, cand = (rng.integers(-2**31, 2**31, k, dtype=np.int64)
                 .astype(np.int32) for _ in range(2))
    args = [torch.from_numpy(x).to(cuda) for x in (start, is_end, pos, cand)]
    before = C.masked_launches
    out = C.compact_masked(*args)
    torch.cuda.synchronize()
    assert C.masked_launches == before + 1
    ref = C.compact_masked_reference(*args)
    n, n_end = int(start.sum()), int(is_end.sum())
    assert int(out[3]) == int(ref[3]) == n and out[3].dtype == torch.int32
    assert torch.equal(out[0][:n], ref[0][:n])
    assert torch.equal(out[1][:n_end], ref[1][:n_end])
    assert torch.equal(out[2][:n], ref[2][:n])


@pytest.mark.parametrize("k", [1, _TILE - 1, _TILE, _TILE + 1, 100_003])
@pytest.mark.parametrize("kind", ["none", "all", "only_starts", "half"])
def test_k10_kernel_equals_plain(cuda, kind, k):
    rng = np.random.default_rng(k)
    start, _ = _masks(kind, k, rng)
    pos, cand = (rng.integers(-2**31, 2**31, k, dtype=np.int64)
                 .astype(np.int32) for _ in range(2))
    args = [torch.from_numpy(x).to(cuda) for x in (start, pos, cand)]
    before = (C.starts_launches, C.launches)
    out = C.compact_starts(*args)
    torch.cuda.synchronize()
    assert (C.starts_launches, C.launches) == (before[0] + 1, before[1])
    ref = C.compact_starts_reference(*args)
    n = int(ref[2])
    assert int(out[2]) == n and out[2].dtype == torch.int32
    for x, y in zip(out[:2], ref[:2]):
        assert torch.equal(x[:n], y[:n])


def test_k9_k10_wrappers_raise_on_cuda_tensors_they_do_not_take(cuda):
    flag = torch.zeros(100, dtype=torch.bool, device=cuda)
    x = torch.zeros(100, dtype=torch.int32, device=cuda)
    before = (C.masked_launches, C.starts_launches)
    with pytest.raises(TypeError):
        C.compact_masked(flag, flag, x.long(), x)
    with pytest.raises(ValueError):
        C.compact_masked(flag, flag.cpu(), x, x)
    with pytest.raises(ValueError):
        C.compact_starts(flag[::2], x[::2], x[::2])
    assert (C.masked_launches, C.starts_launches) == before
    empty = C.compact_masked(flag[:0], flag[:0], x[:0], x[:0])
    assert int(empty[3]) == 0 and C.masked_launches == before[0]


def _k9_inputs(kind: str, k: int, seed: int, cuda, heads=(0, 0)):
    """(start, is_end, pos, cand) on the card; each mask a slice starting
    at its own byte (``heads``) of a larger buffer, the payloads int32."""
    rng = np.random.default_rng(seed)
    start, is_end = _masks(kind, k, rng)
    masks = []
    for mask, h in zip((start, is_end), heads):
        buf = torch.zeros(k + 32, dtype=torch.bool, device=cuda)
        at = h - buf.data_ptr() % 16 + 16
        buf[at:at + k] = torch.from_numpy(mask).to(cuda)
        masks.append(buf[at:at + k])
        assert masks[-1].data_ptr() % 16 == h
    pos, cand = (torch.from_numpy(rng.integers(-2**31, 2**31, k,
                                               dtype=np.int64)
                                  .astype(np.int32)).to(cuda)
                 for _ in range(2))
    return (*masks, pos, cand)


def _assert_k9_equal(out, args):
    ref = C.compact_masked_reference(*args)
    n, n_end = int(args[0].sum()), int(args[1].sum())
    assert out[3].is_cuda and out[3].dim() == 0 \
        and out[3].dtype == torch.int32 and int(out[3]) == int(ref[3]) == n
    assert all(x.shape == args[2].shape for x in out[:3])
    assert torch.equal(out[0][:n], ref[0][:n])
    assert torch.equal(out[1][:n_end], ref[1][:n_end])
    assert torch.equal(out[2][:n], ref[2][:n])


@pytest.mark.parametrize("kind", ["none", "all", "only_starts",
                                  "ends_without_starts_in_a_block", "runs",
                                  "half"])
def test_k9_over_more_than_32_tiles(cuda, kind):
    """40 tiles and a ragged tail: the look-back of most tiles reads more
    than one round of 32 predecessors."""
    args = _k9_inputs(kind, 40 * _TILE + 123, 40, cuda)
    before = C.masked_launches
    out = C.compact_masked(*args)
    torch.cuda.synchronize()
    assert C.masked_launches == before + 1
    _assert_k9_equal(out, args)


@pytest.mark.parametrize("heads", [(0, h) for h in range(1, 16)] +
                         [(h, 0) for h in (1, 7, 15)] +
                         [(3, 5), (5, 3), (9, 9), (15, 1), (1, 15)])
@pytest.mark.parametrize("kind", ["runs", "half"])
def test_k9_masks_at_different_heads(cuda, kind, heads):
    """start and is_end as slices at their own bytes mod 16 (such as
    is_end[3:]): the tiles are cut at start's 16-byte boundaries, is_end's
    vectors come from two aligned loads each."""
    args = _k9_inputs(kind, 3 * _TILE + 777, sum(heads), cuda, heads)
    out = C.compact_masked(*args)
    torch.cuda.synchronize()
    _assert_k9_equal(out, args)


def test_k9_on_recycled_memory(cuda):
    """Outputs and workspace in blocks that held 0xFF (the caching
    allocator hands the freed blocks back): the first n slots of each
    stream and the count are right all the same."""
    k = 5 * _TILE + 31
    args = _k9_inputs("runs", k, 9, cuda)
    torch.cuda.synchronize()
    junk = [torch.full((k,), -1, dtype=torch.int32, device=cuda)
            for _ in range(3)]
    junk.append(torch.full((k // 8,), -1, dtype=torch.int64, device=cuda))
    junk.append(torch.full((), -1, dtype=torch.int32, device=cuda))
    ptrs = {x.data_ptr() for x in junk}
    del junk
    out = C.compact_masked(*args)
    torch.cuda.synchronize()
    assert out[0].data_ptr() in ptrs        # a recycled block
    _assert_k9_equal(out, args)


def test_k9_is_one_kernel_and_at_most_one_memset(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = _k9_inputs("runs", 4 * _TILE + 3, 5, cuda)
    C.compact_masked(*args)                 # built and loaded before
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            C.compact_masked(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    kernels = [n for n in names if "compact_masked_kernel" in n]
    memsets = [n for n in names if "memset" in n.lower()]
    assert len(kernels) == 3, names
    assert len(memsets) <= 3 and len(kernels) + len(memsets) == len(names), \
        names


def test_dense_functions_card_equal_cpu(cuda):
    data = _repeating(300_000, 11)
    data[100_000:104_000] = 0
    t = torch.from_numpy(data)
    cand, ok = PM.match_candidates(t.to(cuda))
    rcand, rok = PM.match_candidates(t)
    assert torch.equal(cand.cpu(), rcand) and torch.equal(ok.cpu(), rok)
    before = C.masked_launches
    got = PM.runs_to_host(cand, ok, 290_000)
    assert C.masked_launches == before + 1
    for a, b in zip(got, PM.runs_to_host(rcand, rok, 290_000)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("stride", [2, 8])
def test_compact_seeds_card_equals_cpu(cuda, stride):
    data = _repeating(300_000, stride)
    padded = np.zeros(PM.bucket_size(len(data)), np.uint8)
    padded[:len(data)] = data
    t = torch.from_numpy(padded)
    limit = len(data) - 31
    before = C.starts_launches
    got = PM.compact_seeds(*PM.anchor_candidates_fporder(t.to(cuda), stride),
                           limit, PM.verify_gap(stride))
    assert C.starts_launches == before + 2
    want = PM.compact_seeds(*PM.anchor_candidates_fporder(t, stride), limit,
                            PM.verify_gap(stride))
    assert len(want[0]) > 0
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("method", ["gzip", "rans"])
def test_dense_compress_card_equals_cpu(cuda, method):
    data = _repeating(500_000, 5)
    data[::3] &= 15      # skewed, so that rANS shrinks the literals
    raw = data.tobytes()
    s = lrzt.Settings(method=method, anchor_stride=1)
    before = (C.masked_launches, C.launches, A.launches)
    archive = lrzt.compress(raw, s, device=cuda)
    assert (C.masked_launches, C.launches, A.launches) == \
        (before[0] + 1, before[1], before[2])
    assert archive == lrzt.compress(raw, s, device="cpu")
    assert lrzt.decompress(archive) == raw


def test_decompress_to_device_on_the_card(cuda):
    data = _repeating(500_000, 6)
    data[::3] &= 15
    raw = data.tobytes()
    for method in ("rans", "gzip"):
        archive = lrzt.compress(raw, lrzt.Settings(method=method,
                                                   max_chunk=200_000),
                                device="cpu")
        k7 = RK.decode_launches
        chunks = lrzt.decompress_to_device(archive, verify=True)
        assert all(c.is_cuda and c.dtype == torch.uint8 for c in chunks)
        assert b"".join(c.cpu().numpy().tobytes() for c in chunks) == raw
        assert RK.decode_launches == k7 + (3 if method == "rans" else 0)


# --- K2 and K10: the one-pass compaction of compact3.cu ---------------------

_ONE_PASS_TILE = 8_192    # flags a block of compact3.cu takes
_ONE_PASS_K = [1, 31, 32, _ONE_PASS_TILE - 1, _ONE_PASS_TILE,
               _ONE_PASS_TILE + 1, 3 * 132 * _ONE_PASS_TILE + 7, 2**22 + 3]
_DENSITIES = [0.0, 1e-4, 0.06, 0.5, 1.0]
_ONE_PASS = {
    "k2": (C.compact_starts3, C.compact_starts3_reference, 3,
           lambda: C.launches),
    "k10": (C.compact_starts, C.compact_starts_reference, 2,
            lambda: C.starts_launches),
}


def _one_pass_inputs(kernel: str, k: int, density: float, seed: int, cuda,
                     offset: int = 0):
    """(flags, payloads) on the card, each a slice starting ``offset``
    elements into a larger buffer."""
    rng = np.random.default_rng(seed)
    n = k + offset + 16
    flags = torch.from_numpy(rng.random(n) < density).to(cuda)
    vals = [torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                             .astype(np.int32)).to(cuda)
            for _ in range(_ONE_PASS[kernel][2])]
    return (flags[offset:offset + k],
            [v[offset:offset + k] for v in vals])


def _assert_one_pass_equal(kernel: str, out, flags, vals):
    want = _ONE_PASS[kernel][1](flags, *vals)
    n = int(want[-1])
    assert n == int(flags.sum())
    assert out[-1].is_cuda and out[-1].dtype == torch.int32 \
        and out[-1].dim() == 0 and int(out[-1]) == n
    for x, y in zip(out[:-1], want[:-1]):
        assert x.shape == y.shape and torch.equal(x[:n], y[:n])


@pytest.mark.parametrize("density", _DENSITIES)
@pytest.mark.parametrize("k", _ONE_PASS_K)
@pytest.mark.parametrize("kernel", ["k2", "k10"])
def test_one_pass_kernel_equals_plain(cuda, kernel, k, density):
    flags, vals = _one_pass_inputs(kernel, k, density, k, cuda)
    fn, _, _, count = _ONE_PASS[kernel]
    before = count()
    out = fn(flags, *vals)
    torch.cuda.synchronize()
    assert count() == before + 1
    _assert_one_pass_equal(kernel, out, flags, vals)


@pytest.mark.parametrize("offset", range(1, 16))
@pytest.mark.parametrize("kernel", ["k2", "k10"])
def test_one_pass_kernel_takes_slices_at_any_byte(cuda, kernel, offset):
    k = 3 * _ONE_PASS_TILE + 5
    flags, vals = _one_pass_inputs(kernel, k, 0.5, offset, cuda, offset)
    assert flags.data_ptr() % 16 == offset % 16
    out = _ONE_PASS[kernel][0](flags, *vals)
    torch.cuda.synchronize()
    _assert_one_pass_equal(kernel, out, flags, vals)


@pytest.mark.parametrize("kernel", ["k2", "k10"])
def test_one_pass_back_to_back_and_on_a_side_stream(cuda, kernel):
    """20 calls queued on one stream with no synchronise between them,
    then one call on a side stream while the main stream runs another:
    each has its own workspace."""
    fn = _ONE_PASS[kernel][0]
    k = 2 * 132 * _ONE_PASS_TILE + 99
    inputs = [_one_pass_inputs(kernel, k, _DENSITIES[i % 5], 100 + i, cuda)
              for i in range(21)]
    torch.cuda.synchronize()
    outs = [fn(f, *v) for f, v in inputs[:20]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = fn(inputs[20][0], *inputs[20][1])
    again = fn(inputs[0][0], *inputs[0][1])
    torch.cuda.synchronize()
    for (f, v), out in zip(inputs + inputs[:1], outs + [on_side, again]):
        _assert_one_pass_equal(kernel, out, f, v)


@pytest.mark.parametrize("kernel", ["k2", "k10"])
def test_one_pass_is_one_kernel_and_at_most_one_memset(cuda, kernel):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flags, vals = _one_pass_inputs(kernel, 4 * _ONE_PASS_TILE + 3, 0.06, 5,
                                   cuda)
    fn = _ONE_PASS[kernel][0]
    fn(flags, *vals)                       # built and loaded before
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn(flags, *vals)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    kernels = [n for n in names if "compact_kernel" in n]
    memsets = [n for n in names if "memset" in n.lower()]
    assert len(kernels) == 3, names
    assert len(memsets) <= 3 and len(kernels) + len(memsets) == len(names), \
        names


def test_one_pass_wrappers_raise_from_2_to_the_31_flags(cuda):
    k = 1 << 31
    flags = torch.empty(k, dtype=torch.bool, device=cuda)
    x = torch.empty(k, dtype=torch.int32, device=cuda)
    before = (C.launches, C.starts_launches, C.masked_launches)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        C.compact_starts(flags, x, x)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        C.compact_starts3(flags, x, x, x)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        C.compact_masked(flags, flags, x, x)
    assert (C.launches, C.starts_launches, C.masked_launches) == before
    del flags, x
    torch.cuda.empty_cache()


@pytest.mark.parametrize("stride", [2, 8, 32])
def test_compact_seeds_dual_card_equals_cpu(cuda, stride):
    """The chain stage on the card: K10 twice, K2 never, the CPU's fine
    and coarse records."""
    data = _repeating(300_000, stride)
    padded = np.zeros(PM.bucket_size(len(data)), np.uint8)
    padded[:len(data)] = data
    t = torch.from_numpy(padded)
    limit = len(data) - 31
    gap = PM.verify_gap(stride)
    seeds = PM.anchor_candidates_fporder(t.to(cuda), stride)
    before = (C.starts_launches, C.launches)
    got = PM.compact_seeds_dual(*seeds, limit, gap, PM._CHAIN_GAP)
    assert (C.starts_launches, C.launches) == (before[0] + 2, before[1])
    want = PM.compact_seeds_dual(*PM.anchor_candidates_fporder(t, stride),
                                 limit, gap, PM._CHAIN_GAP)
    assert len(want[0][0]) > 0 and len(want[1][0]) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.is_cuda and torch.equal(a.cpu(), b)


# --- the sp axis: one chunk's matcher split over a dp row's devices ---------

@pytest.mark.parametrize("n", [2 * 8160 + 31, 2 * 8160 + 31 + 8 * 3 + 5,
                               5 * 8160 + 777])
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("stride", [2, 8, 32])
def test_k1_on_sp_slabs_at_edge_sizes(cuda, stride, s, n):
    """K1 on each slab's own copy of its view (whole rows and a halo of
    one row a side, ``matcher.sp_slabs``), at sizes around K1's block of
    8160 positions: one launch a slab, and the slabs' rows concatenated
    equal the whole chunk's on the card and on the CPU."""
    raw = _repeating(n, n + s + stride)
    dev = torch.from_numpy(raw).to(cuda)
    k = (n - 31) // stride
    whole = PM.anchor_rows(dev[:k * stride + 31], stride,
                           (0, k, 0, k * stride))
    slabs = PM.sp_slabs(k, s, stride, 1)
    before = A.launches
    parts = [PM.anchor_rows(dev[lo:hi + 31].clone(), stride,
                            (u0, u1, lo, hi)) for u0, u1, lo, hi in slabs]
    torch.cuda.synchronize()
    assert A.launches == before + len(slabs)
    cpu = PM.anchor_rows(torch.from_numpy(raw[:k * stride + 31]), stride,
                         (0, k, 0, k * stride))
    for w, p, c in zip(whole, zip(*parts), cpu):
        assert torch.equal(w, torch.cat(p)) and torch.equal(w.cpu(), c)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("stride", [8, 1])
def test_sp_row_on_one_card_equals_one_device(cuda, stride, s):
    """A row that repeats cuda:0: each slab on a slab stream of its own
    (never a live job's), the tokens and counters of a one-device job on
    the CPU, and the slabs' stages in ``sp_device_ms``."""
    raw = _repeating(3_000_000, 90 + s)
    one = PM.MatchJob(raw, stride, "cpu")
    jobs = [PM.MatchJob(raw, stride, "cuda:0", sp_devices=["cuda:0"] * s)
            for _ in range(3)]
    ref = one.collect()
    for job in jobs:
        tokens = job.collect()
        assert all(np.array_equal(a, b) for a, b in zip(tokens, ref))
        assert {k: job.stats[k] for k in one.stats} == one.stats
        assert len(job.stats["sp_device_ms"]) == s - 1
        assert "gather" in job.stats["device_ms"]
        assert job.stats["sp_peer"] == [None] * (s - 1)


def test_sp_row_across_two_cards_equals_one_device(cuda, monkeypatch):
    """An sp row of cuda:0 and cuda:1: slab 1 runs on cuda:1 and its rows
    come back to cuda:0 (by a peer copy where the cards allow one); the
    tokens equal the one-device job's, and a 1 x 2 mesh writes the CPU's
    archive."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    raw = _repeating(3_000_000, 95)
    for stride in (8, 1):
        job = PM.MatchJob(raw, stride, "cuda:0",
                          sp_devices=["cuda:0", "cuda:1"])
        tokens = job.collect()
        ref = PM.MatchJob(raw, stride, "cpu").collect()
        assert all(np.array_equal(a, b) for a, b in zip(tokens, ref))
        assert job.stats["sp_peer"] == [
            torch.cuda.can_device_access_peer(0, 1)]
    data = _repeating(4_500_000, 96).tobytes()
    s = lrzt.Settings(method="rans", max_chunk=1 << 20, use_mesh=True)
    with torch.cuda.device(0):
        archive, seen = _mesh_archive(
            data, s, MESH.make_mesh(devices=["cuda:0", "cuda:1"], dp=1),
            monkeypatch)
    assert archive == lrzt.compress(data, lrzt.Settings(
        method="rans", max_chunk=1 << 20, use_mesh=False), device="cpu")
    assert lrzt.decompress(archive, device="cuda") == data


# --- K1 and K3 as redesigned: spans and tiles, slices, the zero tail ---------

_K1_TILE = 8160     # positions a K1 block writes (anchor_fps.cu kTile)
_K3_TILE = 8192     # elements a K3 tile (streampack.cu k3::kTile)


@pytest.mark.parametrize("n", [_K1_TILE + 30, _K1_TILE + 31, _K1_TILE + 32,
                               4 * _K1_TILE + 31 + 777])
@pytest.mark.parametrize("stride", [2, 4, 8, 16, 32])
def test_k1_around_its_tile(cuda, stride, n):
    """ma at one block's positions less one, equal and one more (rounded
    to the stride), and several blocks with a ragged tail; the whole
    input in one TMA-sized span or not."""
    data = torch.from_numpy(_repeating(n, 3 * n + stride)).to(cuda)
    ma = ((n - 31) // stride) * stride
    before = A.launches
    fpa, fpb = A.anchor_fps(data, stride, ma)
    torch.cuda.synchronize()
    assert A.launches == before + 1
    rfpa, rfpb = A.anchor_fps_reference(data, stride, ma)
    assert torch.equal(fpa, rfpa) and torch.equal(fpb, rfpb)


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
@pytest.mark.parametrize("stride", [2, 8, 32])
def test_k1_takes_a_slice_at_any_byte(cuda, stride, offset):
    n = 3 * _K1_TILE + 4_321
    buf = torch.from_numpy(_repeating(n + offset, offset + stride)).to(cuda)
    data = buf[offset:]
    assert data.data_ptr() % 16 == offset % 16
    ma = ((n - 31) // stride) * stride
    fpa, fpb = A.anchor_fps(data, stride, ma)
    torch.cuda.synchronize()
    rfpa, rfpb = A.anchor_fps_reference(data, stride, ma)
    assert torch.equal(fpa, rfpa) and torch.equal(fpb, rfpb)


def test_k1_all_equal_bytes_are_all_anchors(cuda):
    data = torch.full((2 * _K1_TILE + 100,), 0x61, dtype=torch.uint8,
                      device=cuda)
    ma = ((data.shape[0] - 31) // 8) * 8
    fpa, fpb = A.anchor_fps(data, 8, ma)
    rfpa, rfpb = A.anchor_fps_reference(data, 8, ma)
    assert torch.equal(fpa, rfpa) and torch.equal(fpb, rfpb)
    assert bool((fpa != 0x7FFFFFFF).all())


def _k3_inputs(m: int, kind: str, seed: int, cuda, offset_v: int = 0,
               offset_f: int = 0):
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.integers(0, 256, m + 16, dtype=np.uint8))
    if kind == "runs":
        lens = rng.geometric([1 / 40, 1 / 100] * (m // 70 + 2))
        f = np.repeat(np.arange(len(lens)) % 2 == 0, lens)[:m + 16]
    else:
        f = _flags(kind, m + 16, rng)
    flags = torch.from_numpy(f)
    return (vals.to(cuda)[offset_v:offset_v + m],
            flags.to(cuda)[offset_f:offset_f + m])


def _k3_equal(vals, flags, cap):
    before = SP.stream_launches
    got, n = SP.pack_stream(vals, flags, cap)
    torch.cuda.synchronize()
    assert SP.stream_launches == before + 1
    ref, ref_n = SP.pack_stream_reference(vals, flags, cap)
    assert n.is_cuda and n.dtype == torch.int32 and n.dim() == 0
    assert int(n) == int(ref_n) == int(flags.sum())
    assert got.shape == (cap,) and torch.equal(got, ref)


@pytest.mark.parametrize("m", [_K3_TILE - 1, _K3_TILE, _K3_TILE + 1,
                               5 * _K3_TILE + 777])
@pytest.mark.parametrize("kind", ["none", "all", "half", "runs"])
def test_k3_around_its_tile_with_every_cap(cuda, kind, m):
    """cap below, at and above the count, and past m: the full cap output
    (the zero tail included) equals the plain version's."""
    vals, flags = _k3_inputs(m, kind, m + len(kind), cuda)
    n = int(flags.sum())
    for cap in sorted({max(n // 3, 1), n, n + 1, m + 70_001}):
        _k3_equal(vals, flags, cap)


@pytest.mark.parametrize("offsets", [(1, 1), (0, 1), (1, 0), (5, 13)])
def test_k3_takes_slices_at_any_byte(cuda, offsets):
    m = 3 * _K3_TILE + 99
    vals, flags = _k3_inputs(m, "runs", sum(offsets), cuda, *offsets)
    assert vals.data_ptr() % 16 == offsets[0] % 16
    assert flags.data_ptr() % 16 == offsets[1] % 16
    n = int(flags.sum())
    for cap in (n // 2, n + 12_345):
        _k3_equal(vals, flags, cap)


def test_k3_zero_tail_is_zero_on_recycled_memory(cuda):
    """The output is torch.empty: a block the allocator hands back full of
    0xFF must still come out with a zero tail."""
    m, cap = 3 * _K3_TILE + 5, 400_000
    vals, flags = _k3_inputs(m, "half", 9, cuda)
    junk = torch.full((cap,), 0xFF, dtype=torch.uint8, device=cuda)
    del junk
    _k3_equal(vals, flags, cap)
    _k3_equal(vals, torch.zeros_like(flags), cap)


def test_k3_is_one_kernel_and_at_most_one_memset(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    vals, flags = _k3_inputs(4 * _K3_TILE + 3, "runs", 5, cuda)
    cap = 4 * _K3_TILE
    SP.pack_stream(vals, flags, cap)        # built and loaded before
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            SP.pack_stream(vals, flags, cap)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    kernels = [n for n in names if "pack_bytes_kernel" in n]
    memsets = [n for n in names if "memset" in n.lower()]
    assert len(kernels) == 3, names
    assert len(memsets) <= 3 and len(kernels) + len(memsets) == len(names), \
        names


def test_k3_back_to_back_and_on_a_side_stream(cuda):
    inputs = [_k3_inputs(2 * 132 * _K3_TILE + 99, ("runs", "half")[i % 2],
                         200 + i, cuda) for i in range(11)]
    caps = [int(f.sum()) + 1000 for _, f in inputs]
    torch.cuda.synchronize()
    outs = [SP.pack_stream(v, f, c) for (v, f), c in
            zip(inputs[:10], caps[:10])]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = SP.pack_stream(*inputs[10], caps[10])
    torch.cuda.synchronize()
    for (v, f), c, (got, n) in zip(inputs, caps, outs + [on_side]):
        ref, ref_n = SP.pack_stream_reference(v, f, c)
        assert int(n) == int(ref_n) and torch.equal(got, ref)


def test_k3_raises_from_2_to_the_31_elements(cuda):
    k = 1 << 31
    vals = torch.empty(k, dtype=torch.uint8, device=cuda)
    flags = torch.empty(k, dtype=torch.bool, device=cuda)
    before = SP.stream_launches
    with pytest.raises(ValueError, match="2\\*\\*31"):
        SP.pack_stream(vals, flags, 16)
    assert SP.stream_launches == before
    del vals, flags
    torch.cuda.empty_cache()


# --- K6: one pass with a decoupled look-back --------------------------------

_K6_TILE = 16384


def _k6_plane(m: int, density: float, seed: int, cuda, offset: int = 0):
    """K5's fused plane (word | 1 << 16 at a flag, 0 elsewhere) as a view
    ``offset`` int32 elements into a larger buffer."""
    rng = np.random.default_rng(seed)
    flags = rng.random(m + offset) < density
    words = rng.integers(0, 1 << 16, m + offset, dtype=np.int64)
    full = torch.from_numpy(np.where(flags, words | (1 << 16), 0
                                     ).astype(np.int32)).to(cuda)
    return full[offset:]


def _k6_equal(plane, cap):
    before = SP.plane_launches
    got, n = SP.pack_plane(plane, cap)
    torch.cuda.synchronize()
    assert SP.plane_launches == before + 1
    ref, ref_n = SP.pack_plane_reference(plane, cap)
    assert n.is_cuda and n.dtype == torch.int32 and n.dim() == 0
    assert int(n) == int(ref_n) == int(((plane >> 16) & 1).sum())
    assert got.shape == (cap,) and got.dtype == torch.int16
    assert torch.equal(got, ref)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k6_takes_a_plane_view_past_alignment(cuda, offset):
    plane = _k6_plane(3 * _K6_TILE + 99, 0.4, offset, cuda, offset)
    assert plane.data_ptr() % 16 == 4 * offset
    n = int(((plane >> 16) & 1).sum())
    for cap in (n // 2, n, plane.numel() + 1234):
        _k6_equal(plane, cap)


@pytest.mark.parametrize("m", [_K6_TILE - 1, _K6_TILE, _K6_TILE + 1,
                               7 * _K6_TILE + 333])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.4, 1.0])
def test_k6_count_crosses_tiles_with_every_cap(cuda, density, m):
    """Counts that cross tile boundaries at every place of a 16-byte
    group; cap below, at and above the count, and past m."""
    plane = _k6_plane(m, density, m + int(100 * density), cuda)
    n = int(((plane >> 16) & 1).sum())
    for cap in sorted({max(n // 3, 1), n, n + 1, m + 70_001}):
        _k6_equal(plane, cap)


def test_k6_zero_tail_is_zero_on_recycled_memory(cuda):
    """The output is torch.empty: a block the allocator hands back full of
    0xFF must come out with the kept words and a zero tail, compared over
    the full cap."""
    m = 5 * _K6_TILE + 17
    cap = m + 3_000
    for density in (0.4, 0.0):
        junk = torch.full((cap,), -1, dtype=torch.int16, device=cuda)
        del junk
        _k6_equal(_k6_plane(m, density, 11, cuda), cap)


def test_k6_main_shape(cuda):
    """The 64 MiB chunk's plane: 16384 lanes of 1280 steps, about 39% of
    the elements flagged, cap = m."""
    plane = _k6_plane(16384 * 1280, 0.386, 12, cuda).view(1280, 16384)
    _k6_equal(plane, plane.numel())


def test_k6_is_one_kernel_and_at_most_one_memset(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    plane = _k6_plane(4 * _K6_TILE + 3, 0.4, 5, cuda)
    cap = plane.numel()
    SP.pack_plane(plane, cap)        # built and loaded before
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            SP.pack_plane(plane, cap)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    kernels = [n for n in names if "pack_plane_kernel" in n]
    memsets = [n for n in names if "memset" in n.lower()]
    assert len(kernels) == 3, names
    assert len(memsets) <= 3 and len(kernels) + len(memsets) == len(names), \
        names


def test_k6_back_to_back_and_on_a_side_stream(cuda):
    planes = [_k6_plane(2 * 132 * _K6_TILE + 99, (0.2, 0.6)[i % 2], 300 + i,
                        cuda) for i in range(7)]
    torch.cuda.synchronize()
    outs = [SP.pack_plane(p, p.numel()) for p in planes[:6]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = SP.pack_plane(planes[6], planes[6].numel())
    torch.cuda.synchronize()
    for p, (got, n) in zip(planes, outs + [on_side]):
        ref, ref_n = SP.pack_plane_reference(p, p.numel())
        assert int(n) == int(ref_n) and torch.equal(got, ref)


def test_k6_raises_from_2_to_the_31_elements(cuda):
    plane = torch.empty(1 << 31, dtype=torch.int32, device=cuda)
    before = SP.plane_launches
    with pytest.raises(ValueError, match="2\\*\\*31"):
        SP.pack_plane(plane, 16)
    assert SP.plane_launches == before
    del plane
    torch.cuda.empty_cache()


# --- K4: one C call, a table a CTA in 16-bit counters ----------------------

def _k4_equal(lit, n, ctx_bits, srate, k):
    before = RK.hist_launches
    got = RK.joint_histogram(lit, n, ctx_bits, srate, k)
    torch.cuda.synchronize()
    assert RK.hist_launches == before + 1
    ref = RK.joint_histogram_reference(lit, n, ctx_bits, srate, k)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    return got


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_k4_one_symbol(cuda, ctx_bits):
    """Every sample on one cell: all atomics of a CTA on one 16-bit
    counter."""
    k, t = 16384, 1280
    lit = torch.full((k * t,), 0x61, dtype=torch.uint8, device=cuda)
    got = _k4_equal(lit, k * t, ctx_bits, 20, k)
    assert int(got.sum()) == k * 64


@pytest.mark.parametrize("srate", [1, 3])
def test_k4_full_alphabet_at_ctx_bits_8(cuda, srate):
    k, t = 1024, 512
    lit = torch.from_numpy(np.random.default_rng(srate).permutation(
        np.tile(np.arange(256, dtype=np.uint8), k * t // 256))).to(cuda)
    got = _k4_equal(lit, k * t - 77, 8, srate, k)
    assert bool((got.sum(0) > 0).all())


@pytest.mark.parametrize("t,k,srate", [(1280, 16384, 1280), (1280, 64, 1),
                                       (2048, 1024, 1), (75, 4096, 75),
                                       (85, 4096, 1)])
@pytest.mark.parametrize("ctx_bits", [0, 6, 8])
def test_k4_r_of_one_and_of_t(cuda, ctx_bits, t, k, srate):
    """r = 1 and r = T, with T a multiple of 16 and not; n cuts a lane."""
    rng = np.random.default_rng(t + k + ctx_bits)
    lit = torch.from_numpy(rng.integers(0, 256, t * k, dtype=np.uint8)
                           ).to(cuda)
    for n in (t * k, t * k - t // 2 - 1):
        _k4_equal(lit, n, ctx_bits, srate, k)


@pytest.mark.parametrize("k", [100, 1000, 4097])
@pytest.mark.parametrize("ctx_bits", [6, 8])
def test_k4_lanes_not_a_multiple_of_a_cta(cuda, ctx_bits, k):
    """K lanes whose vectors fill no whole CTA of K4's 512 threads."""
    rng = np.random.default_rng(k)
    lit = torch.from_numpy(rng.integers(0, 40, 96 * k, dtype=np.uint8)
                           ).to(cuda)
    _k4_equal(lit, 96 * k - 5, ctx_bits, 2, k)


@pytest.mark.parametrize("offset", [1, 5, 15])
def test_k4_takes_a_block_at_any_byte(cuda, offset):
    rng = np.random.default_rng(offset)
    full = torch.from_numpy(rng.integers(0, 256, 1024 * 128 + 16,
                                         dtype=np.uint8)).to(cuda)
    lit = full[offset:offset + 1024 * 128]
    assert lit.data_ptr() % 16 == offset
    for ctx_bits in (6, 8):
        _k4_equal(lit, lit.numel() - 9, ctx_bits, 2, 1024)


def test_k4_two_calls_in_a_row_on_one_stream(cuda):
    """Two calls queued back to back, neither synchronised before the
    second: each output is its own."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(0, 256, 16384 * 1280, dtype=np.uint8)
                         ).to(cuda)
    b = torch.from_numpy(rng.integers(0, 20, 16384 * 1280, dtype=np.uint8)
                         ).to(cuda)
    torch.cuda.synchronize()
    before = RK.hist_launches
    outs = [RK.joint_histogram(x, x.numel() - 3, cb, 20, 16384)
            for x in (a, b) for cb in (6, 8)]
    torch.cuda.synchronize()
    assert RK.hist_launches == before + 4
    refs = [RK.joint_histogram_reference(x, x.numel() - 3, cb, 20, 16384)
            for x in (a, b) for cb in (6, 8)]
    for got, ref in zip(outs, refs):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_k4_every_grid(cuda, ctx_bits):
    """The C entry at shapes it spreads over one CTA, four, its most of
    128, and more than 128 (where a CTA would otherwise take 2^16
    samples), on output memory full of garbage: the call zeroes it."""
    from lrzip_next_tpu_torch.ops import _build
    lib = _build.library()
    rng = np.random.default_rng(ctx_bits)
    # (K, T, srate): 512, 2048, 65536 and 1310720 vectors of 16 samples
    for k, t, srate in ((128, 640, 10), (512, 640, 10), (16384, 1280, 20),
                        (16384, 1280, 1)):
        lit = torch.from_numpy(rng.integers(0, 64, k * t, dtype=np.uint8)
                               ).to(cuda)
        n = k * t - 1000
        ref = RK.joint_histogram_reference(lit, n, ctx_bits, srate, k)
        out = torch.full_like(ref, -1)
        assert lib.lrzt_rans_hist(
            lit.data_ptr(), t, k, t // srate, n, ctx_bits, out.data_ptr(),
            _build.stream_ptr(lit.device)) == 0, (k, t, srate)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (k, t, srate)


def test_k4_wrapper_raises_on_what_it_does_not_take(cuda):
    from lrzip_next_tpu_torch.ops import _build
    lit = torch.zeros(64 * 16, dtype=torch.uint8, device=cuda)
    out = torch.empty((64, 256), dtype=torch.int32, device=cuda)
    lib = _build.library()
    for args in ((16, 0, 16, 1024, 6), (16, 64, 17, 1024, 6),
                 (16, 64, 16, 1024, 5), (0, 64, 16, 1024, 6)):
        assert lib.lrzt_rans_hist(lit.data_ptr(), *args, out.data_ptr(),
                                  _build.stream_ptr(lit.device)) != 0, args
    before = RK.hist_launches
    with pytest.raises(ValueError):
        RK.joint_histogram(lit, 1024, 5, 1, 64)
    with pytest.raises(ValueError):
        RK.joint_histogram(lit, 1024, 6, 0, 64)
    assert RK.hist_launches == before


# --- the queued MatchJob: dev=, the pinned upload, streams, counters --------


def _padded_on(dev, data: np.ndarray) -> torch.Tensor:
    padded = torch.zeros(PM.bucket_size(len(data)), dtype=torch.uint8,
                         device=dev)
    padded[:len(data)] = torch.from_numpy(data.copy()).to(dev)
    return padded


@pytest.mark.parametrize("stride", [1, 8])
def test_match_job_on_a_card_resident_chunk(cuda, stride):
    """``dev=`` takes a padded chunk already on the card, made on the
    caller's stream, and uses it as is; a wrong length raises."""
    data = _repeating(300_000, 40 + stride)
    padded = _padded_on(cuda, data)
    job = PM.MatchJob(data, stride, cuda, dev=padded)
    got = job.collect()
    assert job.dev is padded and "upload" in job.stats["device_ms"]
    assert "fill_ms" not in job.stats
    want = PM.rzip_encode_chunk(data, stride, torch.device("cpu"))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="dev="):
        PM.MatchJob(data, stride, cuda, dev=padded[:-16])


def test_match_job_pinned_upload(cuda):
    """The job's own copy of the chunk is the zero-padded chunk, uploaded
    on the job's stream from pinned memory: the stream is not the
    caller's, and ``dev`` equals the padded host chunk."""
    data = _repeating(200_000, 41)
    job = PM.MatchJob(data, 8, cuda)
    job.collect()
    assert job.stream != torch.cuda.current_stream(cuda)
    want = np.zeros(PM.bucket_size(len(data)), np.uint8)
    want[:len(data)] = data
    assert np.array_equal(job.dev.cpu().numpy(), want)
    assert job.stats["device_ms"]["upload"] >= 0.0
    assert job.stats["fill_ms"] >= 0.0


def test_three_queued_jobs_equal_jobs_one_at_a_time(cuda):
    chunks = [_repeating(400_000 + 5_000 * i, 50 + i) for i in range(3)]
    alone = []
    for c in chunks:
        alone.append(PM.MatchJob(c, 8, cuda).collect())
    jobs = [PM.MatchJob(c, 8, cuda) for c in chunks]
    assert len({id(j.stream) for j in jobs}) == 3
    for job, want in zip(jobs, alone):
        for a, b in zip(job.collect(), want):
            assert np.array_equal(a, b)
    # the caller's stream reads each chunk after the job's work
    sums = [int(j.dev[:len(c)].to(torch.int64).sum())
            for j, c in zip(jobs, chunks)]
    assert sums == [int(c.astype(np.int64).sum()) for c in chunks]


def test_launch_counters_exact_under_threads(cuda):
    """K1 once and K10 twice a job, counted by the jobs' worker threads,
    while the caller's thread launches K3 at the same time."""
    import threading
    n_jobs, n_packs = 6, 40
    chunks = [_repeating(300_000, 60 + i) for i in range(n_jobs)]
    vals = torch.arange(1 << 16, device=cuda).to(torch.uint8)
    flags = (torch.arange(1 << 16, device=cuda) % 3) == 0
    a0, k0, s0 = A.launches, C.starts_launches, SP.stream_launches
    jobs = [PM.MatchJob(c, 8, cuda) for c in chunks]
    for _ in range(n_packs):
        SP.pack_stream(vals, flags, 1 << 16)
    extra = []

    def more():
        for _ in range(n_packs):
            SP.pack_stream(vals, flags, 1 << 16)
        extra.append(1)

    t = threading.Thread(target=more)
    t.start()
    for job in jobs:
        job.collect()
    t.join()
    torch.cuda.synchronize()
    assert extra == [1]
    assert A.launches - a0 == n_jobs
    assert C.starts_launches - k0 == 2 * n_jobs
    assert SP.stream_launches - s0 == 2 * n_packs


def test_multichunk_compress_card_equals_cpu(cuda):
    """The lookahead (three chunks queued at once) and -U over several
    windows write the CPU's archives, and each device decodes the
    other's."""
    data = (_repeating(700_000, 70).tobytes()
            + _repeating(500_000, 71).tobytes())
    for kw in ({"method": "rans", "max_chunk": 250_000},
               {"method": "gzip", "max_chunk": 250_000, "cross_chunk": True},
               {"method": "gzip", "max_chunk": 250_000, "unlimited": True}):
        s = lrzt.Settings(**kw)
        on_card = lrzt.compress(data, s, device="cuda")
        assert on_card == lrzt.compress(data, s, device="cpu"), kw
        assert lrzt.decompress(on_card, device="cpu") == data
        assert lrzt.decompress(on_card, device="cuda") == data


def _same_anchors(got, want) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(got, want))


@pytest.mark.parametrize("name", GEAR_CASES)
def test_k11_kernel_equals_host_pair(cuda, name):
    """K11's positions, fingerprints and order are the host pair's (and
    its plain version's, on the card), on random bytes, text, a window of
    kernel trees, one repeated byte (every position an anchor, or none),
    fewer than 16 bytes, one position, a length not a multiple of 16, an
    anchor at n - 33, and bytes past n that would make anchors."""
    buf, n, bits = gear_case(name)
    n = len(buf) if n is None else n
    data = torch.from_numpy(buf.copy()).to(cuda)
    before = GS.launches
    got = GS.read_anchors(*GS.gear_anchors(data, n, XC._GEAR, bits))
    torch.cuda.synchronize()
    assert GS.launches == before + (n > 40)
    assert _same_anchors(got, gear_host_pair(buf[:n], bits))
    plain = GS.read_anchors(*GS.gear_anchors_reference(data, n, XC._GEAR,
                                                       bits))
    assert _same_anchors(got, plain)


@pytest.mark.parametrize("offset", [0, 3])
def test_k11_kernel_on_a_padded_cell_window(cuda, offset):
    """An 8 MiB window of kernel trees in its zero-padded bucket, as the
    matcher holds it, at an aligned address and at one 3 bytes on (the
    vectors not wholly inside are read byte by byte)."""
    win = _kernel_trees_window(8 << 20, tree_bytes=2 << 20)
    n = len(win)
    nb = PM.bucket_size(n) + 4096
    buf = torch.zeros(nb + offset, dtype=torch.uint8, device=cuda)
    buf[offset:offset + n] = torch.from_numpy(win).to(cuda)
    buf[offset + n:] = 101      # padding that would make anchors
    data = buf[offset:]
    got = GS.read_anchors(*GS.gear_anchors(data, n, XC._GEAR, 10))
    want = gear_host_pair(win, 10)
    assert len(want[0]) > 1000
    assert _same_anchors(got, want)


@pytest.mark.parametrize("mode", ["unlimited", "cross_chunk"])
def test_cross_window_scan_on_the_card(cuda, mode):
    """-U and cross_chunk over ten windows of kernel trees, lzma: the
    card's archive is the CPU's byte for byte, K11 scans every window
    once on the card (``cross_scan_card`` 1; 0 on the CPU), and the
    archive decodes."""
    data = _kernel_trees_window(10 * 100_000 + 5_000).tobytes()
    runs = {}
    for dev in ("cuda", "cpu"):
        stats = []
        s = lrzt.Settings(method="lzma", max_chunk=100_000,
                          stats_sink=stats.append, **{mode: True})
        before = GS.launches
        runs[dev] = (lrzt.compress(data, s, device=dev), stats,
                     GS.launches - before)
    (card, c_stats, c_k11), (cpu, h_stats, h_k11) = runs["cuda"], runs["cpu"]
    assert card == cpu
    assert len(c_stats) == 11 and c_k11 == 11 and h_k11 == 0
    assert [s["cross_scan_card"] for s in c_stats] == [1] * 11
    assert [s["cross_scan_card"] for s in h_stats] == [0] * 11
    assert [s["cross_bytes"] for s in c_stats] == \
        [s["cross_bytes"] for s in h_stats]
    assert sum(s["cross_bytes"] for s in c_stats) > len(data) // 2
    assert lrzt.decompress(card, device="cuda") == data


def _mesh_archive(data: bytes, settings, mesh, monkeypatch) -> tuple:
    """The archive of ``compress`` through ``mesh`` (pinned as the mesh
    of the card), the batches made and each batch's jobs' devices."""
    seen = []

    class Spy(MESH.MeshMatchBatch):
        def __init__(self, *args):
            super().__init__(*args)
            seen.append([job.device for job in self.jobs])

    monkeypatch.setattr(MESH, "pipeline_mesh", lambda *_: mesh)
    monkeypatch.setattr(MESH, "MeshMatchBatch", Spy)
    archive = lrzt.compress(data, settings, device="cuda")
    monkeypatch.undo()
    return archive, seen


@pytest.mark.parametrize("stride", [8, 1])
def test_mesh_of_two_rows_on_one_card_equals_single_device(cuda, stride,
                                                           monkeypatch):
    """Two dp rows on one card (``["cuda:0"] * 2``), rans: the mesh
    archive equals the single-device and the CPU archives, four chunks in
    two batches and the odd tail in a third, each job on cuda:0, and it
    decodes on the card."""
    data = _repeating(4_500_000, 80).tobytes()
    s = lrzt.Settings(method="rans", max_chunk=1 << 20, anchor_stride=stride,
                      use_mesh=True)
    archive, seen = _mesh_archive(
        data, s, MESH.make_mesh(devices=["cuda:0"] * 2), monkeypatch)
    assert len(seen) == 3 and [len(b) for b in seen] == [2, 2, 1]
    assert all(d == torch.device("cuda:0") for b in seen for d in b)
    single = lrzt.Settings(method="rans", max_chunk=1 << 20,
                           anchor_stride=stride, use_mesh=False)
    assert archive == lrzt.compress(data, single, device="cuda")
    assert archive == lrzt.compress(data, single, device="cpu")
    assert lrzt.decompress(archive, device="cuda") == data


def test_mesh_across_two_cards_launches_each_row_on_its_card(cuda,
                                                             monkeypatch):
    """dp rows on cuda:0 and cuda:1 with cuda:0 current: the second row's
    matcher and literal encode run on cuda:1 (the literal encode enters
    its job's card), and the archive equals the CPU's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    data = _repeating(4_500_000, 81).tobytes()
    s = lrzt.Settings(method="rans", max_chunk=1 << 20, use_mesh=True)
    with torch.cuda.device(0):
        archive, seen = _mesh_archive(
            data, s, MESH.make_mesh(devices=["cuda:0", "cuda:1"]),
            monkeypatch)
    assert [b[1] for b in seen if len(b) > 1] == [torch.device("cuda:1")] * 2
    assert archive == lrzt.compress(data, lrzt.Settings(
        method="rans", max_chunk=1 << 20, use_mesh=False), device="cpu")
    assert lrzt.decompress(archive, device="cuda") == data


# --- the decode's sliced read-back -------------------------------------------

# 0 bytes, one slice, a size that is no multiple of the slice, and
# Silesia's largest file (mozilla, 51,220,480 bytes)
READBACK_SIZES = [0, DP.READBACK_SLICE, 2 * DP.READBACK_SLICE + 12_345,
                  51_220_480]


class _CheckedPlane:
    """A literal plane whose final-state check passes."""

    def check(self):
        pass


def _skewed(n: int, seed: int) -> bytes:
    """Zipf-like bytes, so that rANS codes a chunk's literals smaller and
    the chunk takes the device literal decode and replay."""
    p = 1.0 / np.arange(1, 257) ** 1.2
    body = np.random.default_rng(seed).choice(256, n // 2 + 1, p=p / p.sum())
    body = body.astype(np.uint8)
    return np.concatenate([body, body[:n - len(body)]])[:n].tobytes()


@pytest.mark.parametrize("n", READBACK_SIZES)
def test_sliced_read_back_equals_the_whole_chunk(cuda, n):
    """The chunk read back in ``READBACK_SLICE`` slices through the pinned
    buffer: the bytes, the slices in order and their MD5 equal the whole
    chunk's read-back."""
    import hashlib
    res = torch.from_numpy(_repeating(n, n + 5)).to(cuda)
    whole = res.cpu().numpy().tobytes()
    parts = []
    assert DP.read_back(res, _CheckedPlane(), parts.append) == whole
    s = DP.READBACK_SLICE
    assert [len(p) for p in parts] == [min(s, n - a)
                                       for a in range(0, n, s)]
    h = hashlib.md5()
    for p in parts:
        h.update(p)
    assert h.digest() == hashlib.md5(whole).digest()
    assert b"".join(p.tobytes() for p in parts) == whole


@pytest.mark.parametrize("n", READBACK_SIZES)
def test_decode_through_the_sliced_read_back(cuda, n, monkeypatch):
    """A rans archive decoded on the card: the chunk is replayed there and
    its slices feed the CRC and the MD5, which the decode checks; the
    bytes equal those of a read-back in one piece.  A 0-byte chunk
    replays nothing and reads nothing back."""
    data = _skewed(n, n + 6)
    archive = lrzt.compress(data, lrzt.Settings(method="rans"),
                            device="cuda")
    calls = []
    read_back = DP.read_back

    def counted(res, plane, sink=None, main=None):
        calls.append(int(res.shape[0]))
        return read_back(res, plane, sink, main)

    monkeypatch.setattr(DP, "read_back", counted)
    assert lrzt.decompress(archive, device="cuda") == data
    assert calls == ([n] if n else [])
    monkeypatch.setattr(DP, "READBACK_SLICE", max(n, 1))
    assert lrzt.decompress(archive, device="cuda") == data


def test_read_back_takes_no_new_pinned_buffer(cuda):
    """Repeated decompresses of one archive read back through the pinned
    blocks the first one took: the host allocator creates none after."""
    data = _skewed(24 << 20, 7)
    archive = lrzt.compress(data, lrzt.Settings(method="rans"),
                            device="cuda")
    assert lrzt.decompress(archive, device="cuda") == data
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    for _ in range(4):
        assert lrzt.decompress(archive, device="cuda") == data
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
