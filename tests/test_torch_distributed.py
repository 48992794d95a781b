"""The port's chunk-parallel compression across processes
(``lrzip_next_tpu_torch/parallel/distributed.py``) against the JAX
package's ``parallel/distributed.py`` on the CPU: chunk blobs and
archives byte for byte, the ordered commit, and a real two-process gloo
run over ``torch.distributed`` on 127.0.0.1."""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu.parallel import distributed as JD
from lrzip_next_tpu_torch.parallel import distributed as PD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def warm_jax_lz4_gate():
    """The JAX package's LZ4 gate loads its library racily on the first
    pool threads (ROADMAP.md, Faults): load it before any compare."""
    from lrzip_next_tpu.ops import lz4gate
    lz4gate._load_lz4()


def _corpus(n: int = 300_000, seed: int = 42) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, 60_000, dtype=np.uint8)
    p = 1.0 / np.arange(1, 257) ** 1.2
    z = rng.choice(256, 50_000, p=p / p.sum()).astype(np.uint8)
    reps = n // 110_000 + 1
    return np.concatenate([base, z] * reps)[:n]


def _host_blobs(mod, data, settings, n_hosts, **kw):
    """Each host's ``[(chunk index, blob)]``, as the JAX package's test
    builds them."""
    sizes = mod.pipeline.plan_chunks(len(data), settings)
    bounds = list(zip(np.cumsum([0] + sizes[:-1]), sizes))
    out = []
    for host in range(n_hosts):
        out.append([(ci, mod.compress_chunk_blob(
            data[p0:p0 + cs], ci == len(bounds) - 1, settings, **kw))
            for ci in mod.chunk_assignment(len(bounds), n_hosts, host)
            for p0, cs in [bounds[ci]]])
    return out


@pytest.mark.parametrize("n_chunks", [1, 5, 8, 17])
def test_chunk_assignment_covers_all_and_equals_jax(n_chunks):
    for n_hosts in (1, 2, 4):
        seen = []
        for h in range(n_hosts):
            mine = PD.chunk_assignment(n_chunks, n_hosts, h)
            assert mine == JD.chunk_assignment(n_chunks, n_hosts, h)
            seen += mine
        assert sorted(seen) == list(range(n_chunks))


@pytest.mark.parametrize("method", ["gzip", "rans", "lzma"])
@pytest.mark.parametrize("device", ["cpu", None], ids=["matcher", "host"])
def test_chunk_blob_equals_jax(method, device):
    """JAX ``use_tpu=True`` <-> the port on ``device="cpu"``;
    ``use_tpu=False`` <-> ``device=None`` (the host matcher)."""
    data = _corpus(120_000)
    js = lrz.Settings(method=method, use_tpu=device is not None)
    ps = lrzt.settings_from_reference(js)
    for eof in (False, True):
        assert PD.compress_chunk_blob(data, eof, ps, device=device) == \
            JD.compress_chunk_blob(data, eof, js)


@pytest.mark.parametrize("device", ["cpu", None], ids=["matcher", "host"])
def test_two_host_gather_equals_jax_archive(device):
    data = _corpus()
    js = lrz.Settings(method="gzip", max_chunk=80_000,
                      use_tpu=device is not None)
    ps = lrzt.settings_from_reference(js)
    ours = _host_blobs(PD, data, ps, 2, device=device)
    theirs = _host_blobs(JD, data, js, 2)
    assert ours == theirs
    out = io.BytesIO()
    n = PD.compress_distributed(data, out, ps, n_hosts=2, host=0,
                                gather=lambda my: ours, device=device)
    archive = out.getvalue()
    assert n == len(archive)
    j_out = io.BytesIO()
    JD.compress_distributed(data, j_out, js, n_hosts=2, host=0,
                            gather=lambda my: theirs)
    assert archive == j_out.getvalue()
    assert lrzt.decompress(archive, device="cpu") == data.tobytes()
    assert lrz.decompress(archive) == data.tobytes()
    # one process alone writes the same archive
    one = io.BytesIO()
    PD.compress_distributed(data, one, ps, device=device)
    assert one.getvalue() == archive


def test_non_root_host_returns_none():
    data = _corpus(50_000)
    s = lrzt.Settings(method="none", max_chunk=20_000)
    assert PD.compress_distributed(data, io.BytesIO(), s, n_hosts=2, host=1,
                                   gather=lambda b: [b],
                                   device="cpu") is None


def test_missing_chunk_raises():
    data = _corpus(50_000)
    s = lrzt.Settings(method="none", max_chunk=20_000)
    with pytest.raises(RuntimeError, match="missing chunks"):
        PD.compress_distributed(data, io.BytesIO(), s, n_hosts=2, host=0,
                                gather=lambda b: [b], device="cpu")


def test_passphrase_is_refused():
    with pytest.raises(ValueError):
        PD.compress_distributed(_corpus(10_000), io.BytesIO(),
                                lrzt.Settings(passphrase=b"pw"),
                                device="cpu")


def test_kv_gather_raises_uninitialised(monkeypatch):
    monkeypatch.setattr(PD, "_store", None)
    with pytest.raises(RuntimeError, match="not initialised"):
        PD.kv_gather_blobs([(0, b"x")], 2, 0)


def test_init_distributed_one_process_does_nothing():
    assert PD.init_distributed() == 1
    assert PD.init_distributed("127.0.0.1:1", 1, 0) == 1


def test_blob_records_round_trip_and_reject_truncation():
    blobs = [(3, b"abc"), (0, b""), (7, bytes(range(256)) * 10)]
    framed = PD._frame(blobs)
    assert PD._unframe(framed) == blobs
    assert PD._unframe(b"") == []
    for cut in (5, 16 + 2):
        with pytest.raises(ValueError):
            PD._unframe(framed[:cut])


_WORKER = r"""
import sys
import time
sys.path.insert(0, %(repo)r)
pid = int(sys.argv[1])
import numpy as np
import torch.distributed as dist
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu_torch.parallel import distributed
assert distributed.init_distributed(%(coord)r, 2, pid) == 2
s = lrzt.Settings(method="gzip", max_chunk=70_000)
for i, seed in enumerate(%(seeds)r):
    rng = np.random.default_rng(seed)
    data = np.frombuffer(rng.integers(0, 256, 60_000, dtype=np.uint8)
                         .tobytes() * 5, dtype=np.uint8)[:260_000]
    if pid == 0:
        with open(%(out)r + str(i), "wb") as f:
            n = distributed.compress_distributed(data, f, s, n_hosts=2,
                                                 host=0, device="cpu")
        assert n is not None and n > 0
    else:
        if i:
            # rank 1 lags: rank 0 reaches this gather while rank 1's keys
            # of the one before are all the store holds of it
            time.sleep(1.0)
        assert distributed.compress_distributed(
            data, None, s, n_hosts=2, host=1, device="cpu") is None
dist.destroy_process_group()
print("worker %%d done" %% pid)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two_processes(tmp_path, seeds) -> list:
    """Run ``_WORKER`` as ranks 0 and 1 of one gloo group, one
    ``compress_distributed`` call a seed; rank 0's archives."""
    out = str(tmp_path / "dist.lrz")
    script = _WORKER % {"repo": ROOT, "coord": f"127.0.0.1:{_free_port()}",
                        "out": out, "seeds": list(seeds)}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for pid in (0, 1)]
    results = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=150)
            results.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, so, se in results:
        assert rc == 0, f"worker failed: {se.decode()[-2000:]}"
    return [open(out + str(i), "rb").read() for i in range(len(seeds))]


def _injected_archive(seed: int):
    """The input of ``_WORKER`` for ``seed`` and the archive the injected
    two-host gather writes for it."""
    rng = np.random.default_rng(seed)
    data = np.frombuffer(rng.integers(0, 256, 60_000, dtype=np.uint8)
                         .tobytes() * 5, dtype=np.uint8)[:260_000]
    s = lrzt.Settings(method="gzip", max_chunk=70_000)
    blobs = _host_blobs(PD, data, s, 2, device="cpu")
    expect = io.BytesIO()
    PD.compress_distributed(data, expect, s, n_hosts=2, host=0,
                            gather=lambda my: blobs, device="cpu")
    return data, expect.getvalue()


def test_two_process_gloo_gather(tmp_path):
    """Two processes join over ``init_distributed`` on 127.0.0.1, each
    compresses its chunks, rank 0 gathers them through the store and
    writes the archive that the injected gather writes."""
    archive, = _run_two_processes(tmp_path, [42])
    data, expect = _injected_archive(42)
    assert archive == expect
    assert lrzt.decompress(archive, device="cpu") == data.tobytes()


def test_two_gathers_in_one_group_read_their_own_blobs(tmp_path):
    """Two ``compress_distributed`` calls on different inputs in one
    group, rank 1 late to the second: rank 0's second archive holds the
    second input's chunks, never rank 1's blobs of the first call (the
    store overwrites a key silently, so each gather has keys of its
    own)."""
    archives = _run_two_processes(tmp_path, [42, 7])
    for archive, seed in zip(archives, (42, 7)):
        data, expect = _injected_archive(seed)
        assert archive == expect
        assert lrzt.decompress(archive, device="cpu") == data.tobytes()


def test_kv_gather_deletes_its_keys_and_counts_generations(monkeypatch):
    """On one rank's store: each gather returns its own blobs under a
    key of its generation, and rank 0 deletes the keys it read."""
    import datetime
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", _free_port(), 1, True,
                          timeout=datetime.timedelta(seconds=30))
    monkeypatch.setattr(PD, "_store", store)
    monkeypatch.setattr(PD, "_generations", {})
    assert PD.kv_gather_blobs([(0, b"first")], 1, 0) == [[(0, b"first")]]
    assert PD.kv_gather_blobs([(0, b"second")], 1, 0) == [[(0, b"second")]]
    assert PD._generations == {"gather": 2}
    assert not store.check(["lrz/gather/0/0"])
    assert not store.check(["lrz/gather/1/0"])
