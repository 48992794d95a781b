"""The port's matcher (lrzip_next_tpu_torch.ops.matcher, plain PyTorch
versions on the CPU) against lrzip_next_tpu.ops.matcher on the CPU: anchor
candidates, fine and coarse chain records, the selection, and the final
tokens of a chunk, all exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu.ops import matcher as M
from lrzip_next_tpu_torch.ops import matcher as PM

CPU = torch.device("cpu")


def _padded(data: np.ndarray) -> np.ndarray:
    nb = PM.bucket_size(len(data))
    assert nb == M._bucket_size(len(data))
    out = np.zeros(nb, np.uint8)
    out[:len(data)] = data
    return out


def _holed(base: bytes) -> np.ndarray:
    """tests/test_ops_matcher.py's interrupted-copy layout: base, a copy
    with 8-byte random holes every 23,000 bytes, and a tail repeat."""
    rng = np.random.default_rng(5)
    b = bytearray(base)
    for off in range(5_000, 190_000, 23_000):
        b[off:off + 8] = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
    return np.frombuffer(base + bytes(b) + base[:50_000], np.uint8)


def _corpus(factory, kind: str) -> np.ndarray:
    if kind == "interrupted":
        return _holed(factory(200_000, "mixed"))
    if kind == "dense_text":
        return _holed(factory(200_000, "text"))
    return np.frombuffer(factory(300_000, kind), np.uint8)


def test_bucket_and_stride_tables_match():
    for n in (0, 1, 65_536, 65_537, 300_000, 1 << 23, (1 << 23) + 1,
              64 << 20, 200 << 20):
        assert PM.bucket_size(n) == M._bucket_size(n)
    for level in range(1, 10):
        assert PM.default_anchor_stride(level) == \
            M.default_anchor_stride(level)
    for stride in (2, 4, 8, 16, 32):
        assert PM.verify_gap(stride) == M._verify_gap(stride)
    assert PM._CHAIN_GAP == M._CHAIN_GAP


@pytest.mark.parametrize("stride", [2, 8, 16])
def test_records_and_selection_match(corpus_factory, stride):
    data = _corpus(corpus_factory, "mixed")
    padded = _padded(data)
    jdev, tdev = jnp.asarray(padded), torch.from_numpy(padded)
    limit = len(data) - 31

    # anchors and candidates, fingerprint order (signed fpa, then pos)
    jspos, jcand = M._anchor_candidates_fporder(jdev, stride)
    tspos, tcand = PM.anchor_candidates_fporder(tdev, stride)
    assert np.array_equal(tspos.numpy(), np.asarray(jspos))
    assert np.array_equal(tcand.numpy(), np.asarray(jcand))

    # fine (gap_v) and coarse (gap_w) chain records, uncapped
    gap_v = M._verify_gap(stride)
    k = len(np.asarray(jspos))
    fine, n_raw, coarse, n_w = M.compact_seeds_dual(
        *M.anchor_candidates_unordered(jdev, stride), jnp.int32(limit), k,
        stride, gap_v, M._CHAIN_GAP)
    tfine, tcoarse = PM.compact_seeds_dual(tspos, tcand, limit, gap_v,
                                           PM._CHAIN_GAP)
    n_raw, n_w = int(n_raw), int(n_w)
    assert n_raw > 100 and len(tfine[0]) == n_raw and len(tcoarse[0]) == n_w
    for port, ref, cnt in [(tfine, fine, n_raw), (tcoarse, coarse, n_w)]:
        for p, r in zip(port, ref):
            assert np.array_equal(p.numpy(), np.asarray(r)[:cnt])

    # prefix-max selection and both coverage sums
    ss, sl, sd, n_sel = M.select_records(*fine, n_raw)
    n_sel = int(n_sel)
    tss, tsl, tsd = PM.select_records(*tfine)
    for p, r in ((tss, ss), (tsl, sl), (tsd, sd)):
        assert np.array_equal(p.numpy(), np.asarray(r)[:n_sel])
    assert int(tsl.sum()) == int(np.asarray(sl)[:n_sel].sum())
    assert int(PM.selected_coverage(*tcoarse[:2])) == \
        int(M._selected_coverage(*coarse, n_w))


def _assert_same_job(data, stride, select=True):
    jjob = M.TpuMatchJob(data, stride=stride, select=select)
    jtok = jjob.collect()
    tjob = PM.MatchJob(data, stride, CPU, select=select)
    ttok = tjob.collect()
    for a, b in zip(ttok, jtok):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)
    assert tjob.stats == jjob.stats
    return tjob


@pytest.mark.parametrize("stride", [2, 8, 16])
@pytest.mark.parametrize("kind", ["mixed", "zeros", "random"])
def test_tokens_match(corpus_factory, kind, stride):
    _assert_same_job(_corpus(corpus_factory, kind), stride)


def test_tokens_match_interrupted_copies(corpus_factory):
    job = _assert_same_job(_corpus(corpus_factory, "interrupted"), 8)
    assert not job.walked


def test_walk_fallback_taken_by_both(corpus_factory, monkeypatch):
    """Dense text: the coarse chains cover much more than the exact spans,
    so both packages fall back to the coarse-chain walk."""
    walks = []
    orig = M.TpuMatchJob._collect_walk

    def spy(self):
        walks.append(1)
        return orig(self)

    monkeypatch.setattr(M.TpuMatchJob, "_collect_walk", spy)
    before = PM.walk_fallbacks
    job = _assert_same_job(_corpus(corpus_factory, "dense_text"), 8)
    assert job.walked and PM.walk_fallbacks == before + 1
    assert walks == [1]


def test_walk_mode_matches(corpus_factory):
    job = _assert_same_job(_corpus(corpus_factory, "interrupted"), 8,
                           select=False)
    assert job.walked


@pytest.mark.parametrize("n", [0, 1, 36, 37, 63])
def test_trivial_chunks_match(n):
    data = np.arange(n, dtype=np.uint8)
    _assert_same_job(data, 16)


def test_stride_one_not_ported():
    """Stride 1 is the dense matcher and raises nothing: the port has no
    ``NotImplementedError`` left for it; a stride that is no power of two
    up to 32 is a ``ValueError``."""
    _assert_same_job(np.zeros(1000, np.uint8), 1)
    with pytest.raises(ValueError):
        PM.MatchJob(np.zeros(1000, np.uint8), 64, CPU)


# --- the native runtime guard ----------------------------------------------


def _runtime_state():
    from lrzip_next_tpu_torch import runtime
    return runtime, (runtime._lib, runtime._build_failed, runtime._SO)


def test_runtime_guard_reloads_after_lost_build_race(monkeypatch):
    """The port's runtime builds through a per-process temporary, so no
    build can lose its file to another; a process that comes second
    finds the current library on disk and loads it without building."""
    runtime, saved = _runtime_state()
    PM.require_runtime()

    def no_build(*a, **kw):
        raise AssertionError("a current library must not be rebuilt")

    try:
        runtime._lib = None
        runtime._build_failed = False
        monkeypatch.setattr(runtime, "_build", no_build)
        PM.require_runtime()
        assert runtime.available()
        assert runtime._lib is not None and not runtime._build_failed
    finally:
        runtime._lib, runtime._build_failed, runtime._SO = saved


@pytest.mark.parametrize("library", ["missing", "garbage"])
def test_runtime_guard_raises_without_a_library(tmp_path, library):
    runtime, saved = _runtime_state()
    PM.require_runtime()
    so = tmp_path / "liblrzt_hostops.so"
    if library == "garbage":
        so.write_bytes(b"not a shared library")
    try:
        runtime._lib = None
        runtime._build_failed = library == "missing"
        runtime._SO = str(so)
        with pytest.raises(RuntimeError, match="native host runtime"):
            PM.require_runtime()
        assert not runtime.available()
    finally:
        runtime._lib, runtime._build_failed, runtime._SO = saved
    assert runtime.available()
