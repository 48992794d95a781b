"""The dense stride-1 matcher and the seed compaction of the port
(lrzip_next_tpu_torch, plain PyTorch versions on the CPU) against
lrzip_next_tpu on the CPU: K9 and K10 against the Pallas kernels in
interpret mode and their XLA twins, the dense functions, the stride-1
match job and the archives.  Every comparison is exact (tolerance 0);
compacted outputs are compared up to their count, the slots past it are
unspecified."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu.ops import compact_pallas as JC
from lrzip_next_tpu.ops import matcher as M
from lrzip_next_tpu_torch.ops import anchor as PA
from lrzip_next_tpu_torch.ops import compact as C
from lrzip_next_tpu_torch.ops import matcher as PM

CPU = torch.device("cpu")


def make_chains(m: int, seed: int, p: float = 0.3) -> np.ndarray:
    """The candidate generator of tests/test_compact_pallas.py."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(-1, m, m).astype(np.int32)
    for i in range(1, m):
        if rng.random() < p and cand[i - 1] >= 0:
            cand[i] = cand[i - 1] + 1
    return cand


def _giant(m: int) -> np.ndarray:
    cand = np.arange(-1, m - 1, dtype=np.int32)
    cand[0] = -1
    return cand


def _repetitive(n: int, seed: int) -> np.ndarray:
    """Random bytes with far copies, a near copy and a zero run (a
    period-1 repeat)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, n // 2, dtype=np.uint8)
    parts = [base, base[:n // 5], np.zeros(n // 20, np.uint8),
             base[n // 10:n // 3], rng.integers(0, 256, 500, dtype=np.uint8),
             base[-n // 8:]]
    return np.concatenate(parts)[:n]


def _padded(data: np.ndarray) -> np.ndarray:
    out = np.zeros(PM.bucket_size(len(data)), np.uint8)
    out[:len(data)] = data
    return out


# --- K9: compact_masked under compact_runs -----------------------------------


def _assert_runs_equal(cand: np.ndarray, limit: int, pallas: bool = True):
    m = len(cand)
    ok = cand >= 0
    ref = M.compact_runs(jnp.asarray(cand), jnp.asarray(ok),
                         jnp.int32(limit), m)
    got = PM.compact_runs(torch.from_numpy(cand), torch.from_numpy(ok),
                          limit)
    k = int(ref[3])
    assert int(got[3]) == k and got[3].dtype == torch.int32
    refs = [ref]
    if pallas:
        refs.append(JC.compact_runs_pallas(
            jnp.asarray(cand), jnp.asarray(ok), jnp.int32(limit), m,
            interpret=True))
        assert int(refs[1][3]) == k
    for r in refs:
        for i in range(3):
            assert got[i].shape == (m,) and got[i].dtype == torch.int32
            assert np.array_equal(got[i].numpy()[:k], np.asarray(r[i])[:k])
    return got, k


@pytest.mark.parametrize("m,seed", [(1000, 0), (9000, 1), (20000, 2)])
def test_k9_plain_equals_xla_and_pallas(m, seed):
    _, k = _assert_runs_equal(make_chains(m, seed), m)
    assert k > m // 10


def test_k9_no_candidates():
    _, k = _assert_runs_equal(np.full(5000, -1, np.int32), 5000)
    assert k == 0


def test_k9_one_giant_chain():
    got, k = _assert_runs_equal(_giant(5000), 5000)
    assert k == 1
    assert [int(got[i][0]) for i in range(3)] == [1, 4999, 0]


def test_k9_run_ends_at_limit():
    """A chain that goes on into the padding is cut at ``limit``: its
    last real position is an end."""
    got, k = _assert_runs_equal(_giant(5000), 3000)
    assert k == 1 and int(got[1][0]) == 2999


def test_k9_single_element():
    got, k = _assert_runs_equal(np.array([5], np.int32), 1, pallas=False)
    assert k == 1
    assert [int(got[i][0]) for i in range(3)] == [0, 0, 5]


def test_k9_masked_reference_is_the_wrappers_cpu_path():
    cand = make_chains(3000, 7)
    start, is_end, idx = PM.run_masks(torch.from_numpy(cand),
                                      torch.from_numpy(cand >= 0), 2500)
    a = C.compact_masked(start, is_end, idx, torch.from_numpy(cand))
    b = C.compact_masked_reference(start, is_end, idx,
                                   torch.from_numpy(cand))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[3]) == int(start.sum()) == int(is_end.sum())


def test_runs_to_host_matches():
    cand = make_chains(9000, 3)
    for limit in (None, 7000):
        ref = M.runs_to_host(jnp.asarray(cand), jnp.asarray(cand >= 0),
                             limit)
        got = PM.runs_to_host(torch.from_numpy(cand),
                              torch.from_numpy(cand >= 0), limit)
        for g, r in zip(got, ref):
            assert g.dtype == np.int64 and np.array_equal(g, r)
    empty = PM.runs_to_host(torch.full((100,), -1, dtype=torch.int32),
                            torch.zeros(100, dtype=torch.bool))
    assert all(len(x) == 0 and x.dtype == np.int64 for x in empty)


# --- K10: compact_starts under compact_seeds ---------------------------------


@pytest.mark.parametrize("k", [1, 4_095, 20_001])
@pytest.mark.parametrize("kind", ["empty", "full", "sparse", "half"])
def test_k10_plain_equals_pallas(kind, k):
    rng = np.random.default_rng(k)
    start = {"empty": np.zeros(k, bool), "full": np.ones(k, bool),
             "sparse": rng.random(k) < 0.05,
             "half": rng.random(k) < 0.5}[kind]
    pos, cand = (rng.integers(-2**31, 2**31, k, dtype=np.int64)
                 .astype(np.int32) for _ in range(2))
    jp, jc, jn = JC.compact_starts_pallas(
        jnp.asarray(start), jnp.asarray(pos), jnp.asarray(cand), k,
        interpret=True)
    pp, pc, pn = C.compact_starts(*(torch.from_numpy(x)
                                    for x in (start, pos, cand)))
    n = int(jn)
    assert int(pn) == n == int(start.sum()) and pn.dtype == torch.int32
    for port, ref in ((pp, jp), (pc, jc)):
        assert port.shape == (k,) and port.dtype == torch.int32
        assert np.array_equal(port.numpy()[:n], np.asarray(ref)[:n])


@pytest.mark.parametrize("stride", [2, 8])
@pytest.mark.parametrize("gap", ["verify", 1024])
def test_compact_seeds_matches(stride, gap):
    data = _repetitive(150_000, stride)
    padded = _padded(data)
    jdev, tdev = jnp.asarray(padded), torch.from_numpy(padded)
    limit = len(data) - 31
    gap = M._verify_gap(stride) if gap == "verify" else gap
    jpos, jcand, jok = M.anchor_candidates_unordered(jdev, stride)
    k = int(jpos.shape[0])
    (ps, pe, ds), n_raw = M.compact_seeds(jpos, jcand, jok,
                                          jnp.int32(limit), k, stride, gap)
    n_raw = int(n_raw)
    tpos, tcand = PM.anchor_candidates_fporder(tdev, stride)
    got = PM.compact_seeds(tpos, tcand, limit, gap)
    assert n_raw > 3
    for g, r in zip(got, (ps, pe, ds)):
        assert g.dtype == torch.int32 and g.shape == (n_raw,)
        assert np.array_equal(g.numpy(), np.asarray(r)[:n_raw])
    # the Pallas route (compact_seeds_pallas), its kernel in interpret mode
    start, is_end, sp, sd = M._dist_sorted_seed_starts(
        jpos, jcand, jok, jnp.int32(limit), stride, gap)
    qs, qd, qn = JC.compact_starts_pallas(start, sp, sd, k, interpret=True)
    qe, _, _ = JC.compact_starts_pallas(is_end, sp, sd, k, interpret=True)
    assert int(qn) == n_raw
    for g, r in zip(got, M._order_chains(qs, qd, qe, qn, k)):
        assert np.array_equal(g.numpy(), np.asarray(r)[:n_raw])
    if gap == M._verify_gap(stride):
        fine, _ = PM.compact_seeds_dual(tpos, tcand, limit, gap,
                                        PM._CHAIN_GAP)
        assert all(torch.equal(g, f) for g, f in zip(got, fine))


def test_compaction_wrappers_check_their_input():
    k = 100
    flag = torch.zeros(k, dtype=torch.bool)
    x = torch.zeros(k, dtype=torch.int32)
    before = (C.masked_launches, C.starts_launches)
    with pytest.raises(TypeError):
        C.compact_starts(flag.to(torch.uint8), x, x)
    with pytest.raises(TypeError):
        C.compact_starts(flag, x.to(torch.int64), x)
    with pytest.raises(TypeError):
        C.compact_starts(flag, x[:50], x)
    with pytest.raises(ValueError):
        C.compact_starts(flag[::2], x[::2], x[::2])
    with pytest.raises(TypeError):
        C.compact_masked(flag, flag.to(torch.uint8), x, x)
    with pytest.raises(TypeError):
        C.compact_masked(flag, flag[:50], x, x)
    with pytest.raises(TypeError):
        C.compact_masked(flag, flag, x, x.to(torch.int64))
    with pytest.raises(ValueError):
        C.compact_masked(flag[::2], flag[::2], x[::2], x[::2])
    assert (C.masked_launches, C.starts_launches) == before


# --- the dense functions ------------------------------------------------------


def _numpy_candidates(fpa: np.ndarray, fpb: np.ndarray) -> np.ndarray:
    """Nearest previous window with the same pair, groups in the order
    that ``fpa``'s dtype sorts them in."""
    m = len(fpa)
    order = np.lexsort((np.arange(m), fpa))
    sa, sb = fpa[order], fpb[order]
    same = np.zeros(m, bool)
    same[1:] = (sa[1:] == sa[:-1]) & (sb[1:] == sb[:-1])
    cand = np.full(m, -1, np.int32)
    cand[order[1:][same[1:]]] = order[:-1][same[1:]]
    return cand


@pytest.mark.parametrize("n,seed", [(33, 1), (5_000, 2), (70_000, 3)])
def test_match_candidates_and_chain_runs_match(n, seed):
    data = _repetitive(n, seed) if n > 100 else \
        np.arange(n, dtype=np.uint8)
    jcand, jok = M.match_candidates(jnp.asarray(data))
    tcand, tok = PM.match_candidates(torch.from_numpy(data))
    assert tcand.dtype == torch.int32 and tok.dtype == torch.bool
    assert np.array_equal(tcand.numpy(), np.asarray(jcand))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    jstart, jid = M.chain_runs(jcand, jok)
    tstart, tid = PM.chain_runs(tcand, tok)
    assert tid.dtype == torch.int32
    assert np.array_equal(tstart.numpy(), np.asarray(jstart))
    assert np.array_equal(tid.numpy(), np.asarray(jid))


def test_match_candidates_group_order_does_not_matter():
    """Matched windows have fingerprints on both sides of 2^31 and a
    period-1 run; sorting the groups in uint32 order (the JAX package's)
    or in signed order gives the same candidates."""
    data = _repetitive(70_000, 4)
    fpa, fpb = (x.numpy() for x in PA.window_fps_pair(
        torch.from_numpy(data)))
    tcand, tok = PM.match_candidates(torch.from_numpy(data))
    cand = tcand.numpy()
    matched = fpa[cand >= 0]
    assert (matched >= 1 << 31).sum() > 1000
    assert (matched < 1 << 31).sum() > 1000
    unsigned = _numpy_candidates(fpa.astype(np.uint32),
                                 fpb.astype(np.uint32))
    signed = _numpy_candidates(fpa.astype(np.uint32).view(np.int32),
                               fpb.astype(np.uint32))
    assert np.array_equal(cand, unsigned)
    assert np.array_equal(cand, signed)
    # inside the zero run every window's candidate is its predecessor
    z0 = 35_000 + 14_000
    assert not data[z0:z0 + 3500].any()
    assert np.array_equal(cand[z0 + 1:z0 + 3400],
                          np.arange(z0, z0 + 3399, dtype=np.int32))
    # the first element of the sorted order has no candidate
    assert cand[np.lexsort((np.arange(len(fpa)), fpa))[0]] == -1


# --- the stride-1 match job ---------------------------------------------------


def _assert_same_dense_job(data: np.ndarray):
    jjob = M.TpuMatchJob(data, stride=1)
    jtok = jjob.collect()
    tjob = PM.MatchJob(data, 1, CPU)
    ttok = tjob.collect()
    for a, b in zip(ttok, jtok):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tjob.stats == jjob.stats
    return tjob


@pytest.mark.parametrize("kind", ["repetitive", "zeros", "random", "text"])
def test_dense_tokens_match(corpus_factory, kind):
    if kind == "repetitive":
        data = _repetitive(200_000, 6)
    else:
        data = np.frombuffer(corpus_factory(120_000, kind), np.uint8)
    job = _assert_same_dense_job(data)
    assert not job.select and not job.walked
    if kind != "random":
        assert job.stats["matches"] > 0 and job.stats["chains"] > 0


def test_dense_job_of_a_full_bucket():
    """A chunk that fills its bucket has no padding."""
    _assert_same_dense_job(_repetitive(1 << 16, 8))


@pytest.mark.parametrize("n", [0, 1, 31, 36, 37, 63])
def test_dense_trivial_and_tiny_chunks_match(n):
    _assert_same_dense_job(np.arange(n, dtype=np.uint8) % 7)


def test_dense_job_keeps_the_chunk_for_the_literal_encode():
    data = _repetitive(100_000, 9)
    job = PM.MatchJob(data, 1, CPU)
    job.collect()
    assert job.dev is not None and job.dev.shape[0] == 1 << 17
    assert job.runs is None


def test_bad_stride_raises():
    with pytest.raises(ValueError):
        PM.MatchJob(np.zeros(1000, np.uint8), 3, CPU)


# --- archives -----------------------------------------------------------------


def _same_archive(data: bytes, **kw) -> bytes:
    js = lrz.Settings(use_tpu=True, use_mesh=False, anchor_stride=1, **kw)
    ours = lrzt.compress(data, lrzt.settings_from_reference(js),
                         device="cpu")
    assert ours == lrz.compress(data, js)
    assert lrz.decompress(ours) == data
    assert lrzt.decompress(ours, device="cpu") == data
    return ours


def _zipf(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8)


def _compressible(n: int, seed: int) -> bytes:
    """Skewed literals (rANS shrinks them) with far copies."""
    z = _zipf(n // 2, seed)
    return np.concatenate([z, z[:n // 4], _zipf(n // 8, seed + 1),
                           z[n // 8:n // 4]])[:n].tobytes()


@pytest.mark.parametrize("method", ["gzip", "none", "rans"])
@pytest.mark.parametrize("size", [0, 1, 31, 36, 37, 200_000])
def test_dense_archive_bytes_match(method, size):
    ours = _same_archive(_compressible(size, size), method=method)
    if size == 200_000 and method != "none":
        assert len(ours) < size // 2


@pytest.mark.parametrize("method", ["gzip", "none", "rans"])
def test_dense_archive_three_chunks(method):
    data = _compressible(240_000, 11)
    stats = []
    ours = lrzt.compress(data, lrzt.Settings(
        method=method, anchor_stride=1, max_chunk=80_000,
        stats_sink=stats.append), device="cpu")
    assert ours == lrz.compress(data, lrz.Settings(
        method=method, anchor_stride=1, max_chunk=80_000, use_tpu=True,
        use_mesh=False))
    assert lrz.decompress(ours) == data
    assert lrzt.decompress(ours, device="cpu") == data
    assert [s["chunk"] for s in stats] == [0, 1, 2]


@pytest.mark.parametrize("method", ["gzip", "rans"])
def test_dense_archive_cross_chunk(method):
    base = _compressible(120_000, 12)
    data = base + _zipf(30_000, 13).tobytes() + base[20_000:]
    ours = _same_archive(data, method=method, max_chunk=100_000,
                         cross_chunk=True)
    plain = _same_archive(data, method=method, max_chunk=100_000)
    assert len(ours) < len(plain)


def test_dense_archive_decodes_in_the_other_package():
    data = _compressible(150_000, 14)
    theirs = lrz.compress(data, lrz.Settings(
        method="rans", anchor_stride=1, use_tpu=True, use_mesh=False))
    assert lrzt.decompress(theirs, device="cpu") == data
    ours = lrzt.compress(data, lrzt.Settings(method="rans",
                                             anchor_stride=1), device="cpu")
    assert lrz.decompress(ours) == data


def test_dense_finds_what_the_anchors_miss():
    """Every window is a seed: 40-byte repeats, too short for the stride-8
    anchors to certify, are matched by the dense matcher."""
    rng = np.random.default_rng(15)
    pieces = rng.integers(0, 256, (50, 40), dtype=np.uint8)
    body = [np.concatenate([pieces[i], rng.integers(0, 256, 60,
                                                    dtype=np.uint8)])
            for i in rng.integers(0, 50, 1500)]
    data = np.concatenate(body)
    dense = PM.MatchJob(data, 1, CPU)
    dense.collect()
    coarse = PM.MatchJob(data, 8, CPU)
    coarse.collect()
    assert dense.stats["match_bytes"] > coarse.stats["match_bytes"]
    assert dense.stats["match_bytes"] > len(data) // 4
