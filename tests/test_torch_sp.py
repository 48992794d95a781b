"""The mesh's sp axis in the port: one chunk's matcher split over the
devices of its dp row (``ops/matcher.py`` ``sp_slabs``, ``anchor_rows``,
``MatchJob(sp_devices=)``; ``parallel/mesh.py``), against the one-device
job and against the JAX package's (dp, sp) mesh on its eight virtual CPU
devices (``tests/conftest.py``).  The port's rows repeat the CPU device
(``["cpu"] * s``).  Everything is compared exactly."""

import dataclasses
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu.models import pipeline as JP
from lrzip_next_tpu.parallel import mesh as JM
from lrzip_next_tpu_torch.ops import matcher as M
from lrzip_next_tpu_torch.ops.anchor import HASH_W, _to_i32, window_fps_pair
from lrzip_next_tpu_torch.parallel import dryrun as PDR
from lrzip_next_tpu_torch.parallel import mesh as PM


@pytest.fixture(scope="module", autouse=True)
def warm_jax_lz4_gate():
    """The JAX package's LZ4 gate loads its library racily on the first
    pool threads (ROADMAP.md, Faults): load it before any compare."""
    from lrzip_next_tpu.ops import lz4gate
    lz4gate._load_lz4()


@pytest.fixture(scope="module")
def data() -> bytes:
    """230 KB in 50 KB chunks (four and a 30 KB tail), as in
    tests/test_torch_parallel.py: repeats inside chunks and across them,
    and a skewed stretch for the rANS coder."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    p = 1.0 / np.arange(1, 257) ** 1.2
    z = rng.choice(256, 60_000, p=p / p.sum()).astype(np.uint8).tobytes()
    return (base + z + base[:20_000] + z[10_000:] + base + z)[:230_000]


def _edged(n: int, stride: int, s: int, seed: int, on_edges: bool = True
           ) -> np.ndarray:
    """Seeded bytes with a long repeat and runs of one byte value over
    the chunk's two ends: every window inside such a run has the same
    fingerprint, so each position there is an anchor.  At each interior
    slab edge of an s-way split: with ``on_edges`` such a run too (the
    edge row's anchor lies on the edge itself); else bytes redrawn until
    the smallest fingerprint of the edge's two rows lies within h of the
    edge, on its left at even edges and on its right at odd ones, so the
    anchors next to the edge depend on what lies across it."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, n, dtype=np.uint8)
    out[n // 2:n // 2 + n // 4] = out[:n // 4]
    k = (n - HASH_W + 1) // stride
    h = max(stride // 2, 1)
    for i, e in enumerate(u * stride for u in sorted(
            {k * j // s for j in range(1, s)}) if 0 < u < k):
        if on_edges:
            out[max(e - 64, 0):e + 64 + HASH_W] = 0x5A
            continue
        want = range(e - h, e) if i % 2 == 0 else range(e, e + h)
        lo = max(e - stride, 0)
        for _ in range(500):
            out[max(e - 48, 0):e + 48] = rng.integers(0, 256, 96,
                                                      dtype=np.uint8)[
                :e + 48 - max(e - 48, 0)]
            fpa = _to_i32(window_fps_pair(torch.from_numpy(
                out[lo:e + stride + HASH_W - 1].copy()))[0])
            if lo + int(torch.argmin(fpa)) in want:
                break
        else:
            raise AssertionError(f"no anchor placed near the edge {e}")
    out[:64 + HASH_W] = 0x33
    out[-(2 * stride + HASH_W + 64):] = 0xA5
    return out


@pytest.mark.parametrize("k,s", [(10, 2), (10, 3), (10, 4), (2, 4),
                                 (1, 3), (12, 4), (8188, 3)])
@pytest.mark.parametrize("unit,halo", [(8, 1), (1, 0)])
def test_sp_slabs_cut_whole_units(k, s, unit, halo):
    slabs = M.sp_slabs(k, s, unit, halo)
    assert len(slabs) == min(k, s)
    assert [u0 for u0, *_ in slabs] == [0] + [u1 for _, u1, *_ in slabs[:-1]]
    assert slabs[-1][1] == k
    sizes = [u1 - u0 for u0, u1, *_ in slabs]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    for u0, u1, lo, hi in slabs:
        assert lo == max(u0 - halo, 0) * unit
        assert hi == min(u1 + halo, k) * unit


@pytest.mark.parametrize("on_edges", [True, False], ids=["on", "near"])
@pytest.mark.parametrize("n", [20_000, 20_000 + 8 * 7 + 5, 65_536])
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("stride", [2, 8, 32])
def test_split_anchor_rows_equal_one_device(stride, s, n, on_edges):
    """The slabs' rows (K1 on each view, cropped) concatenated equal the
    whole chunk's rows, and the split ``(spos, cand)`` the one-device
    ones, with anchors on or next to every slab edge and at the chunk's
    ends; row counts that do and do not divide by s."""
    dev = torch.from_numpy(_edged(n, stride, s, n + 10 * s + stride,
                                  on_edges))
    k = (n - HASH_W + 1) // stride
    whole = M.anchor_rows(dev[:k * stride + HASH_W - 1], stride,
                          (0, k, 0, k * stride))
    slabs = M.sp_slabs(k, s, stride, 1)
    parts = [M.anchor_rows(dev[lo:hi + HASH_W - 1].clone(), stride,
                           (u0, u1, lo, hi)) for u0, u1, lo, hi in slabs]
    for w, p in zip(whole, zip(*parts)):
        assert torch.equal(w, torch.cat(p))
    # the chunk's first row, and with on_edges every slab's, holds an
    # anchor on its first position
    for u0, *_ in slabs if on_edges else slabs[:1]:
        assert int(whole[1][u0]) == u0 * stride
    one = M.anchor_candidates_fporder(dev, stride)
    split = M.anchor_candidates_fporder(dev, stride, ["cpu"] * s)
    assert all(torch.equal(a, b) for a, b in zip(one, split))
    assert int((one[1] >= 0).sum()) > 0


@pytest.mark.parametrize("stride", [2, 8, 32])
def test_split_with_fewer_rows_than_devices(stride):
    """Two anchor rows over four devices: two slabs, never an empty
    launch, and the one-device result."""
    dev = torch.from_numpy(np.random.default_rng(stride).integers(
        0, 256, HASH_W - 1 + 2 * stride, dtype=np.uint8))
    assert len(M.sp_slabs(2, 4, stride, 1)) == 2
    one = M.anchor_candidates_fporder(dev, stride)
    split = M.anchor_candidates_fporder(dev, stride, ["cpu"] * 4)
    assert all(torch.equal(a, b) for a, b in zip(one, split))


@pytest.mark.parametrize("n", [3_000, 65_536 + 7])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_split_fingerprints_equal_one_device(s, n):
    """Stride 1: the slabs' fingerprints, narrowed to int32 for the trip,
    equal the whole chunk's, through ``split_stage`` too, and so do the
    candidates."""
    raw = _edged(n, 1, s, n + s)
    dev = torch.from_numpy(raw)
    whole = [_to_i32(f) for f in window_fps_pair(dev)]
    slabs = M.sp_slabs(n - HASH_W + 1, s, 1, 0)
    parts = [M._slab_fps(dev[lo:hi + HASH_W - 1], (u0, u1, lo, hi))
             for u0, u1, lo, hi in slabs]
    assert all(p.dtype == torch.int32 for part in parts for p in part)
    for i in (0, 1):
        assert torch.equal(torch.cat([p[i] for p in parts]), whole[i])
    fps, clocks = M.split_stage(dev, 1, [torch.device("cpu")] * s)
    assert len(clocks) == s - 1
    assert all(torch.equal(a, b) for a, b in zip(fps, whole))
    one = M.match_candidates(dev)
    split = M.match_candidates(dev, sp_devices=["cpu"] * s)
    assert all(torch.equal(a, b) for a, b in zip(one, split))


@pytest.mark.parametrize("stride", [8, 1])
def test_split_stage_copies_back_after_slab_0(stride, monkeypatch):
    """The order ``split_stage`` queues work in: every other slab's copy
    in and work first, then slab 0's work on the first device (the job
    clock's stage mark), and only then each slab's outputs back (its
    ``gather`` mark).  A copy between two cards makes the current streams
    of both wait on each other, so a copy back queued before slab 0
    would hold the first device's stream until that slab had run."""
    events = []
    mark = M.StageClock.mark

    def spy(self, name):
        events.append((self.device.type if self is not job_clock else
                       "job", name))
        return mark(self, name)

    monkeypatch.setattr(M.StageClock, "mark", spy)
    job_clock = M.StageClock(torch.device("cpu"))
    dev = torch.from_numpy(_edged(20_000, stride, 3, 7))
    stage = "fingerprints" if stride == 1 else "anchors"
    M.split_stage(dev, stride, [torch.device("cpu")] * 3, clock=job_clock)
    slab = [name for who, name in events if who == "cpu"]
    assert slab == ["start", "upload", stage] * 2 + ["gather"] * 2
    at = events.index(("job", stage))
    assert [name for _, name in events[:at]] == \
        ["start", "upload", stage] * 2
    assert events[at + 1:] == [("cpu", "gather")] * 2 + [("job", "gather")]


def _tokens_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("stride", [1, 2, 8, 32])
def test_match_job_split_equals_one_device(data, stride, s):
    raw = np.frombuffer(data, dtype=np.uint8)[:120_000]
    one = M.MatchJob(raw, stride, "cpu")
    split = M.MatchJob(raw, stride, "cpu", sp_devices=["cpu"] * s)
    assert _tokens_equal(split.collect(), one.collect())
    assert split.stats == one.stats
    if stride > 1:
        assert split.coarse_chains == one.coarse_chains


def test_match_job_split_with_dev_and_in_walk_mode(data):
    """A chunk handed over on the device (``dev=``) and the walk mode
    (``select=False``) split as they run whole."""
    raw = np.frombuffer(data, dtype=np.uint8)[:90_000]
    padded = torch.zeros(M.bucket_size(len(raw)), dtype=torch.uint8)
    padded[:len(raw)] = torch.from_numpy(raw.copy())
    for kw in ({"dev": padded}, {"select": False}):
        one = M.MatchJob(raw, 8, "cpu", **kw)
        split = M.MatchJob(raw, 8, "cpu", sp_devices=["cpu"] * 3, **kw)
        assert _tokens_equal(split.collect(), one.collect())
        assert split.stats == one.stats


def test_match_job_rejects_a_row_not_led_by_its_device():
    raw = np.zeros(10_000, np.uint8)
    with pytest.raises(ValueError):
        M.MatchJob(raw, 8, "cpu", sp_devices=["meta", "cpu"])
    with pytest.raises(ValueError):
        M.MatchJob(raw, 8, "cpu", sp_devices=["cpu", "meta"])


# (port mesh devices, JAX mesh): 4 x 2, 1 x 4 and 2 x 2
_MESHES = [((8, None), (8, None)), ((4, 1), (4, 1)), ((4, None), (4, None))]


def _meshes(which):
    (n, dp), (jn, jdp) = which
    return (PM.make_mesh(n, dp=dp, devices=["cpu"] * n),
            JM.make_mesh(jn, dp=jdp))


@pytest.mark.parametrize("stride", [8, 1])
@pytest.mark.parametrize("which", _MESHES, ids=["4x2", "1x4", "2x2"])
def test_mesh_batch_split_equals_jax_and_one_device(data, which, stride):
    ours_mesh, jax_mesh = _meshes(which)
    dp, sp = ours_mesh.devices.shape
    assert (dp, sp) == jax_mesh.devices.shape and sp > 1
    raw = np.frombuffer(data, dtype=np.uint8)
    chunks = [raw[i * 50_000:(i + 1) * 50_000] for i in range(min(dp, 4))]
    theirs = JM.MeshMatchBatch(jax_mesh, chunks, stride)
    ours = PM.MeshMatchBatch(ours_mesh, chunks, stride)
    for i, chunk in enumerate(chunks):
        assert len(ours.job_for(i).sp_devices) == sp
        tokens = ours.collect(i)
        assert _tokens_equal(tokens, theirs.collect(i))
        assert ours.stats[i] == theirs.stats[i]
        assert _tokens_equal(tokens, M.MatchJob(chunk, stride,
                                                "cpu").collect())


def _jax_mesh_archive(data: bytes, js, jax_mesh) -> bytes:
    orig = JM.pipeline_mesh
    JM.pipeline_mesh = lambda: jax_mesh
    try:
        out = io.BytesIO()
        JP.compress_stream(data, out, dataclasses.replace(js, use_mesh=True))
    finally:
        JM.pipeline_mesh = orig
    return out.getvalue()


@pytest.mark.parametrize("method", ["rans", "gzip"])
@pytest.mark.parametrize("which", _MESHES[1:], ids=["1x4", "2x2"])
def test_sp_mesh_archive_equals_jax_and_single_device(data, which, method,
                                                      monkeypatch):
    """Through ``pipeline_mesh`` pinned as ``parallel/dryrun.py`` pins it:
    the port's archive equals the JAX package's mesh archive and the
    single-device one, and decodes in both packages."""
    ours_mesh, jax_mesh = _meshes(which)
    js = lrz.Settings(method=method, use_tpu=True, max_chunk=50_000)
    before = PM.batches
    monkeypatch.setattr(PM, "pipeline_mesh", lambda *_: ours_mesh)
    ours = lrzt.compress(data, lrzt.settings_from_reference(
        dataclasses.replace(js, use_mesh=True)), device="cpu")
    monkeypatch.undo()
    dp = ours_mesh.devices.shape[0]
    assert PM.batches - before == -(-4 // dp) + 1
    assert ours == _jax_mesh_archive(data, js, jax_mesh)
    assert ours == lrz.compress(data, dataclasses.replace(js, use_mesh=False))
    assert lrzt.decompress(ours, device="cpu") == data
    assert lrz.decompress(ours) == data


@pytest.mark.parametrize("which", _MESHES[:2], ids=["4x2", "1x4"])
def test_sharded_match_step_split_equals_jax(which):
    ours_mesh, jax_mesh = _meshes(which)
    dp, sp = jax_mesh.devices.shape
    b_rows, length = dp * 2, sp * 4096
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, length // 2, dtype=np.uint8)
    batch = np.stack([np.concatenate([base, base])] * b_rows)
    batch[-1, :100] = 9
    jc, jo, jcov = JM.sharded_match_step(jax_mesh)(jnp.asarray(batch))
    pc, po, pcov = PM.sharded_match_step(ours_mesh)(torch.from_numpy(batch))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    assert pcov == int(jcov) > 0


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_splits_chunks_at_four_and_eight_entries(n, monkeypatch):
    """``dryrun_multichip`` on 4 and 8 entries builds meshes with sp = 2,
    so every matcher job of its mesh runs split, as the JAX dry run's
    does."""
    rows = []

    class Spy(M.MatchJob):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            rows.append(len(self.sp_devices))

    monkeypatch.setattr(PM, "MatchJob", Spy)
    PDR.dryrun_multichip(n, device="cpu")
    assert rows and set(rows) == {2}
