"""The port's chunk mesh (``lrzip_next_tpu_torch/parallel/mesh.py``), the
mesh loop of ``compress_stream`` and the dry run, against the JAX
package on the CPU: JAX on its eight virtual CPU devices
(``tests/conftest.py``), the port on meshes pinned over ``["cpu"] * n``.
Archives, tokens and stats are compared exactly."""

import dataclasses
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu.models import pipeline as JP
from lrzip_next_tpu.parallel import mesh as JM
from lrzip_next_tpu_torch.models import pipeline as P
from lrzip_next_tpu_torch.parallel import distributed as PD
from lrzip_next_tpu_torch.parallel import dryrun as PDR
from lrzip_next_tpu_torch.parallel import mesh as PM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def warm_jax_lz4_gate():
    """The JAX package's LZ4 gate loads its library racily on the first
    pool threads (ROADMAP.md, Faults): load it before any compare."""
    from lrzip_next_tpu.ops import lz4gate
    lz4gate._load_lz4()


def _cpu_mesh(n: int) -> PM.Mesh:
    return PM.make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def data() -> bytes:
    """230 KB in 50 KB chunks: four full chunks and a 30 KB tail, so the
    last batch is uneven; repeats inside chunks and across them, and a
    skewed stretch that the rANS coder compresses."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    p = 1.0 / np.arange(1, 257) ** 1.2
    z = rng.choice(256, 60_000, p=p / p.sum()).astype(np.uint8).tobytes()
    return (base + z + base[:20_000] + z[10_000:] + base + z)[:230_000]


def _jax_mesh_archive(data: bytes, js, n: int) -> bytes:
    """The JAX package's mesh archive on ``make_mesh(n)``, pinned as
    ``__graft_entry__.dryrun_multichip`` pins it."""
    mesh = JM.make_mesh(n)
    orig = JM.pipeline_mesh
    JM.pipeline_mesh = lambda: mesh
    try:
        out = io.BytesIO()
        JP.compress_stream(data, out, dataclasses.replace(js, use_mesh=True))
    finally:
        JM.pipeline_mesh = orig
    return out.getvalue()


def _port_mesh_archive(data: bytes, settings, n: int) -> tuple:
    """The port's mesh archive on a mesh of n CPU entries, and the mesh
    batches it made."""
    mesh = _cpu_mesh(n)
    orig, before = PM.pipeline_mesh, PM.batches
    PM.pipeline_mesh = lambda *_: mesh
    try:
        archive = lrzt.compress(data, dataclasses.replace(
            settings, use_mesh=True), device="cpu")
    finally:
        PM.pipeline_mesh = orig
    return archive, PM.batches - before


@pytest.mark.parametrize("n,dp", [(1, None), (2, None), (4, None),
                                  (8, None), (8, 8), (8, 2)])
def test_make_mesh_shapes_equal_jax(n, dp):
    theirs = JM.make_mesh(n, dp=dp)
    ours = PM.make_mesh(n, dp=dp, devices=["cpu"] * 8)
    assert ours.devices.shape == theirs.devices.shape
    assert ours.axis_names == tuple(theirs.axis_names) == ("dp", "sp")
    assert all(d == torch.device("cpu") for d in ours.devices.flat)


def test_make_mesh_rejects_what_it_cannot_shape():
    with pytest.raises(ValueError):
        PM.make_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        PM.make_mesh(6, dp=4, devices=["cpu"] * 6)


@pytest.mark.parametrize("n_blocks,n_shards", [(0, 3), (7, 1), (10, 4),
                                                (3, 8)])
def test_shard_blocks_equals_jax(n_blocks, n_shards):
    assert PM.shard_blocks(n_blocks, n_shards) == \
        JM.shard_blocks(n_blocks, n_shards)


def test_sharded_match_step_equals_jax():
    """tests/test_parallel.py's mirrored batch on make_mesh(8)."""
    jmesh = JM.make_mesh(8)
    dp, sp = jmesh.devices.shape
    b_rows, length = dp * 2, sp * 4096
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, length // 2, dtype=np.uint8)
    batch = np.stack([np.concatenate([base, base])] * b_rows)
    batch[1, :100] = 7               # rows differ
    jc, jo, jcov = JM.sharded_match_step(jmesh)(jnp.asarray(batch))
    pc, po, pcov = PM.sharded_match_step(_cpu_mesh(8))(
        torch.from_numpy(batch))
    assert pc.shape == (b_rows, length) and pc.dtype == torch.int32
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    assert pcov == int(jcov) > 0
    assert bool(po[0, length // 2]) and int(pc[0, length // 2]) == 0


def test_sharded_match_step_rejects_a_batch_not_a_multiple_of_dp():
    with pytest.raises(ValueError):
        PM.sharded_match_step(_cpu_mesh(8))(np.zeros((3, 4096), np.uint8))


@pytest.mark.parametrize("stride", [8, 1])
def test_mesh_batch_tokens_and_stats_equal_jax(data, stride):
    raw = np.frombuffer(data, dtype=np.uint8)
    chunks = [raw[i * 50_000:(i + 1) * 50_000] for i in range(4)]
    theirs = JM.MeshMatchBatch(JM.make_mesh(8), chunks, stride)
    before = PM.batches
    ours = PM.MeshMatchBatch(_cpu_mesh(8), chunks, stride)
    assert PM.batches - before == 1
    for i in range(len(chunks)):
        for a, b in zip(ours.collect(i), theirs.collect(i)):
            np.testing.assert_array_equal(a, b)
        assert ours.stats[i] == theirs.stats[i]
        assert ours.job_for(i).dev is not None


@pytest.mark.parametrize("n", [0, 20, 36])
def test_mesh_batch_of_trivial_chunks(n):
    """Chunks too short for the matcher: one literal token and the
    counters of the JAX mesh path's trivial branch
    (lrzip_next_tpu/parallel/mesh.py:230-238), equal to the JAX
    package's single-device tokens; nothing goes to a device.  (The JAX
    ``MeshMatchBatch`` itself raises ``AttributeError`` there: its
    ``stats`` is set after the trivial branch returns.)"""
    from lrzip_next_tpu.ops.matcher import rzip_encode_chunk_tpu
    chunks = [np.arange(n, dtype=np.uint8)] * 2
    ours = PM.MeshMatchBatch(_cpu_mesh(8), chunks, 8)
    for i in range(2):
        for a, b in zip(ours.collect(i), rzip_encode_chunk_tpu(chunks[i])):
            np.testing.assert_array_equal(a, b)
        assert ours.stats[i] == {"chunk_bytes": n, "chains": 0,
                                 "matches": 0, "match_bytes": 0,
                                 "literals": 1 if n else 0,
                                 "literal_bytes": n}
        assert ours.job_for(i).dev is None


def test_mesh_batch_rejects_uneven_or_too_many_chunks():
    mesh = _cpu_mesh(4)             # dp 2
    with pytest.raises(ValueError):
        PM.MeshMatchBatch(mesh, [np.zeros(100, np.uint8)] * 3, 8)
    with pytest.raises(ValueError):
        PM.MeshMatchBatch(mesh, [np.zeros(100, np.uint8),
                                 np.zeros(99, np.uint8)], 8)


@pytest.mark.parametrize("kw", [
    {"method": "gzip"}, {"method": "rans"},
    {"method": "rans", "anchor_stride": 1},
    {"method": "gzip", "cross_chunk": True}],
    ids=["gzip", "rans", "dense", "cross_chunk"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_archive_equals_jax_and_single_device(data, n, kw):
    """Port mesh == JAX mesh == JAX single device == port single device,
    and the archive decodes in both packages."""
    js = lrz.Settings(use_tpu=True, max_chunk=50_000, **kw)
    ours, n_batches = _port_mesh_archive(
        data, lrzt.settings_from_reference(js), n)
    dp = JM.make_mesh(n).devices.shape[0]
    assert n_batches == -(-4 // dp) + 1     # the full chunks, the tail
    assert ours == _jax_mesh_archive(data, js, n)
    single = dataclasses.replace(js, use_mesh=False)
    assert ours == lrz.compress(data, single)
    assert ours == lrzt.compress(data, lrzt.settings_from_reference(single),
                                 device="cpu")
    assert lrzt.decompress(ours, device="cpu") == data
    assert lrz.decompress(ours) == data


def test_mesh_passphrase_round_trips_in_both_packages(data):
    js = lrz.Settings(method="gzip", use_tpu=True, max_chunk=50_000,
                      passphrase=b"mesh-pw")
    ours, n_batches = _port_mesh_archive(
        data, lrzt.settings_from_reference(js), 4)
    assert n_batches == 3
    theirs = _jax_mesh_archive(data, js, 4)
    for archive in (ours, theirs):
        assert lrzt.decompress(archive, lrzt.Settings(passphrase=b"mesh-pw"),
                               device="cpu") == data
        assert JP.decompress_stream(io.BytesIO(archive), lrz.Settings(
            passphrase=b"mesh-pw")) == data


def test_mesh_stats_in_chunk_order_with_an_uneven_tail(data):
    """tests/test_parallel.py's stats check: the tail chunk of another
    size falls into its own batch; the stats equal the JAX mesh path's
    in its keys and cover the input; the port's dicts add the compress
    stages and the pool's time (``utils/spans.py``)."""
    js = lrz.Settings(method="gzip", use_tpu=True, max_chunk=50_000)
    theirs, ours = [], []
    _jax_mesh_archive(data, dataclasses.replace(js, stats_sink=theirs.append),
                      8)
    archive, _ = _port_mesh_archive(data, lrzt.settings_from_reference(
        dataclasses.replace(js, stats_sink=ours.append)), 8)
    assert [s["chunk"] for s in ours] == [0, 1, 2, 3, 4]
    assert all(s["chunk_bytes"] in (50_000, 30_000) for s in ours)
    assert sum(s["match_bytes"] + s["literal_bytes"] for s in ours) \
        == len(data)
    assert len(ours) == len(theirs)
    assert [{k: s[k] for k in t} for s, t in zip(ours, theirs)] == theirs
    # the last dict also carries the hash thread's busy time
    assert [set(s) - set(t) for s, t in zip(ours, theirs)] == \
        [{"op", "main_ms", "backend_ms"}] * 4 + \
        [{"op", "main_ms", "backend_ms", "hash_ms"}]
    assert lrzt.decompress(archive, device="cpu") == data


@pytest.mark.parametrize("use_mesh", [True, None])
def test_use_mesh_without_a_mesh_takes_the_single_device_loop(data,
                                                              use_mesh):
    """Below two cards (and on the CPU) ``pipeline_mesh`` is None and
    ``use_mesh=True`` writes the ``use_mesh=False`` archive, as the JAX
    package does below two devices (the parent raised
    NotImplementedError)."""
    assert PM.pipeline_mesh("cpu") is None
    assert PM.pipeline_mesh(None) is None
    before = PM.batches
    s = lrzt.Settings(method="rans", max_chunk=50_000)
    on = lrzt.compress(data, dataclasses.replace(s, use_mesh=use_mesh),
                       device="cpu")
    assert PM.batches == before
    assert on == lrzt.compress(data, dataclasses.replace(s, use_mesh=False),
                               device="cpu")
    assert on == lrz.compress(data, lrz.Settings(
        method="rans", use_tpu=True, use_mesh=False, max_chunk=50_000))


def test_pipeline_mesh_needs_two_cards_and_puts_all_on_dp(monkeypatch):
    """Below two cards no mesh; from two, the JAX package's ``make_mesh()``
    shape over every card: 2 -> (2, 1), 4 -> (2, 2), 8 -> (4, 2).  (The
    name is the test's from when the port ran dp only and put every card
    on dp; every card is still in the mesh, now in the JAX shape.)"""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert PM.pipeline_mesh("cuda") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for n, shape in ((2, (2, 1)), (4, (2, 2)), (8, (4, 2))):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        mesh = PM.pipeline_mesh("cuda")
        assert mesh.devices.shape == shape == JM.make_mesh(n).devices.shape
        assert list(mesh.devices.flat) == [torch.device("cuda", i)
                                           for i in range(n)]
    assert PM.pipeline_mesh("cpu") is None


def test_use_mesh_false_never_takes_the_mesh(data):
    def boom(*_):
        raise AssertionError("pipeline_mesh asked with use_mesh=False")
    orig = PM.pipeline_mesh
    PM.pipeline_mesh = boom
    try:
        lrzt.compress(data, lrzt.Settings(method="gzip", max_chunk=50_000,
                                          use_mesh=False), device="cpu")
    finally:
        PM.pipeline_mesh = orig


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_on_the_cpu(n):
    PDR.dryrun_multichip(n, device="cpu")


def test_entry_equals_jax_entry():
    import __graft_entry__ as g
    jfn, (jx,) = g.entry()
    fn, (x,) = PDR.entry(device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    for a, b in zip(fn(x), jfn(jx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("call", [
    lambda: PM.make_mesh(),
    lambda: PM.make_mesh(devices=["cuda:0"] * 2),
    lambda: PDR.entry(),
    lambda: PDR.dryrun_multichip(2),
    lambda: PD.compress_chunk_blob(np.zeros(1000, np.uint8), True,
                                   P.Settings()),
    lambda: PD.compress_distributed(np.zeros(1000, np.uint8), io.BytesIO()),
], ids=["make_mesh", "make_mesh_devices", "entry", "dryrun", "blob",
        "distributed"])
def test_cuda_entry_points_raise_without_cuda(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        call()


def test_parallel_modules_import_no_jax(tmp_path):
    """A fresh process that runs a mesh compress, the dry run's entry and
    a one-process distributed compress holds neither JAX nor the JAX
    package."""
    code = textwrap.dedent("""
        import io, sys
        import numpy as np
        import lrzip_next_tpu_torch as lrzt
        from lrzip_next_tpu_torch.parallel import distributed, dryrun, mesh
        cpu_mesh = mesh.make_mesh(devices=["cpu"] * 4)
        mesh.pipeline_mesh = lambda *_: cpu_mesh
        raw = np.random.default_rng(0).integers(0, 256, 3000, np.uint8)
        data = raw.tobytes() * 20
        s = lrzt.Settings(method="rans", max_chunk=10_000)
        archive = lrzt.compress(data, s, device="cpu")
        assert mesh.batches == 3
        assert lrzt.decompress(archive, device="cpu") == data
        fn, args = dryrun.entry(device="cpu")
        assert fn(*args)[0].shape == (8188,)
        out = io.BytesIO()
        data = np.zeros(5000, np.uint8)
        assert distributed.compress_distributed(data, out, device="cpu") \\
            == len(out.getvalue())
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "lrzip_next_tpu")]
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_pipeline_mesh_keeps_a_named_card_unless_asked(monkeypatch):
    """Left to choose, the mesh is taken only for ``device="cuda"``; a
    named card (``cuda:1``) keeps the chunks unless ``use_mesh=True``;
    ``use_mesh=False`` never takes it."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert PM.pipeline_mesh("cuda:1") is None
    assert PM.pipeline_mesh("cuda:0", None) is None
    assert PM.pipeline_mesh("cuda", False) is None
    assert PM.pipeline_mesh("cuda:1", False) is None
    for device, use_mesh in (("cuda", None), ("cuda", True),
                             ("cuda:1", True)):
        mesh = PM.pipeline_mesh(device, use_mesh)
        assert mesh.devices.shape == (2, 1)
        assert list(mesh.devices[:, 0]) == [torch.device("cuda", 0),
                                            torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert PM.pipeline_mesh("cuda:0", True) is None


def test_match_jobs_have_a_worker_pool_a_device(monkeypatch):
    """Each device has its own pool of ``_JOB_STREAMS`` worker threads,
    so the rows of a mesh over several cards do not queue behind one
    pool (no card is touched: the pools are only made)."""
    from lrzip_next_tpu_torch.ops import matcher
    monkeypatch.setattr(matcher, "_workers", {})
    c0 = matcher._worker_pool(torch.device("cuda", 0))
    c1 = matcher._worker_pool(torch.device("cuda", 1))
    cpu = matcher._worker_pool(torch.device("cpu"))
    assert len({id(c0), id(c1), id(cpu)}) == 3
    assert matcher._worker_pool(torch.device("cuda", 1)) is c1
    for pool in (c0, c1, cpu):
        assert pool._max_workers == matcher._JOB_STREAMS
        pool.shutdown()
