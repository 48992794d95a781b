"""The multi-chunk compress path of the port on the CPU, against the JAX
package: the lookahead (jobs k+1 and k+2 queued while chunk k is
written), ``-U`` over several windows, the host-matcher branch
(``device=None`` against ``use_tpu=False``), the ``encode_tokens=`` hook,
the ``MatchJob`` worker, and the numpy fallbacks where the native runtime
is missing.  Archives must be byte-identical, and each package decodes
the other's."""

import dataclasses
import hashlib
import io
import os
import threading
import time

import numpy as np
import pytest
import torch

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu.models import pipeline as JP
from lrzip_next_tpu.ops import matcher as JM
from lrzip_next_tpu_torch import runtime as PR
from lrzip_next_tpu_torch.models import pipeline as P
from lrzip_next_tpu_torch.ops import matcher as PM

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def warm_jax_lz4_gate():
    """The JAX package's LZ4 gate loads its library racily on the first
    pool threads (ROADMAP.md, Faults): load it before any compare."""
    from lrzip_next_tpu.ops import lz4gate
    lz4gate._load_lz4()


def _zipf(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


@pytest.fixture(scope="module")
def data() -> bytes:
    """450 KB: compressible, with repeats inside the 100 KB chunks and
    across them."""
    rng = np.random.default_rng(21)
    base = rng.integers(0, 256, 60_000, dtype=np.uint8).tobytes()
    z = _zipf(90_000, 22)
    return base + z + base[5_000:55_000] + z[:70_000] + base + z[20_000:] \
        + base[:50_000]


def _same(data: bytes, device="cpu", **kw) -> bytes:
    """The port on ``device`` and the JAX package (``use_tpu`` when there
    is a device) write the same archive, and each decodes the other's."""
    js = lrz.Settings(use_tpu=device is not None, use_mesh=False, **kw)
    ours = lrzt.compress(data, lrzt.settings_from_reference(js),
                         device=device)
    theirs = lrz.compress(data, js)
    assert ours == theirs
    assert lrz.decompress(ours, js) == data
    assert lrzt.decompress(theirs, device=device) == data
    return ours


def _chunks(archive: bytes) -> int:
    from lrzip_next_tpu_torch.models.info import get_fileinfo
    return len(get_fileinfo(io.BytesIO(archive)).chunks)


# --- the lookahead -----------------------------------------------------------


@pytest.mark.parametrize("cross_chunk", [False, True])
@pytest.mark.parametrize("method", ["gzip", "lzma", "rans"])
def test_lookahead_archives_match(data, method, cross_chunk):
    ours = _same(data, method=method, max_chunk=100_000,
                 cross_chunk=cross_chunk)
    assert _chunks(ours) == 5


def test_jobs_queued_two_ahead(data, monkeypatch):
    """Jobs k+1 and k+2 are built before chunk k's blocks are written."""
    events = []
    orig_write = P.write_chunk

    class Spy(P.MatchJob):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            events.append(("job", sum(e[0] == "job" for e in events)))

    def write_spy(*a, **kw):
        events.append(("write", sum(e[0] == "write" for e in events)))
        return orig_write(*a, **kw)

    monkeypatch.setattr(P, "MatchJob", Spy)
    monkeypatch.setattr(P, "write_chunk", write_spy)
    lrzt.compress(data, lrzt.Settings(method="gzip", max_chunk=100_000),
                  device="cpu")
    n = 5
    assert events.count(("write", 0)) == 1 and len(events) == 2 * n
    for k in range(n):
        at = events.index(("write", k))
        assert ("job", min(k + 2, n - 1)) in events[:at]
    assert events[:3] == [("job", 0), ("job", 1), ("job", 2)]


def test_lookahead_stats_in_chunk_order(data):
    stats = []
    lrzt.compress(data, lrzt.Settings(method="rans", max_chunk=100_000,
                                      stats_sink=stats.append),
                  device="cpu")
    assert [s["chunk"] for s in stats] == list(range(5))
    assert sum(s["chunk_bytes"] for s in stats) == len(data)
    assert all("literal_coder" in s for s in stats)


def test_lookahead_progress_in_order(data):
    seen = []
    lrzt.compress(data, lrzt.Settings(method="gzip", max_chunk=100_000,
                                      progress=lambda *a: seen.append(a)),
                  device="cpu")
    assert [d for st, d, _ in seen if st == "rzip"] == \
        [min(100_000 * (k + 1), len(data)) for k in range(5)]


# --- -U over several windows -------------------------------------------------


@pytest.mark.parametrize("method", ["gzip", "rans", "none", "lzma"])
def test_unlimited_archives_match(data, method):
    """One whole-file chunk from device-matched windows; the literals take
    the host codecs."""
    stats = []
    js = lrz.Settings(use_tpu=True, use_mesh=False, method=method,
                      unlimited=True, max_chunk=100_000)
    ours = lrzt.compress(data, dataclasses.replace(
        lrzt.settings_from_reference(js), stats_sink=stats.append),
        device="cpu")
    assert ours == lrz.compress(data, js)
    assert _chunks(ours) == 1
    assert [s["chunk"] for s in stats] == list(range(5))
    assert lrz.decompress(ours, js) == data
    assert lrzt.decompress(ours, device="cpu") == data


def test_unlimited_kernel_trees_archive():
    """The ``-U`` cell's shape at six 100 KiB trees (``portbench``'s
    ``kernel_trees``) in windows of 2/3 of a tree, lzma: one whole-file
    chunk, the JAX package's bytes, decoded by the plain reference; the
    cross-window index covers most of trees 2-6, and the first window,
    with no earlier window, counts nothing."""
    import json
    from pathlib import Path
    from lrzip_next_tpu_torch.models import crosschunk
    from portbench.corpus import kernel_trees
    from portbench.reference import lrz as ref
    root = Path(__file__).resolve().parents[1]
    p = json.loads((root / "portbench" / "traffic" / "kernel-trees.json")
                   .read_text())["params"]
    tb = 100 << 10
    # members of at most 16 KiB, so that a tree holds a dozen or more
    # (at the traffic's 1 MiB cap one member can fill a small tree)
    p.update(tree_bytes=tb, copy_window=tb, file_max=16 << 10)
    data = kernel_trees.generate(p, 2**33 + 21, 0, "cpu").tobytes()
    stats = []
    js = lrz.Settings(use_tpu=True, use_mesh=False, method="lzma",
                      unlimited=True, max_chunk=tb * 2 // 3)
    ours = lrzt.compress(data, dataclasses.replace(
        lrzt.settings_from_reference(js), stats_sink=stats.append),
        device="cpu")
    assert _chunks(ours) == 1
    assert ours == lrz.compress(data, js)
    assert ref.decode(ours) == data
    assert len(stats) == 10 and [s["chunk"] for s in stats] == \
        list(range(10))
    assert all(set(crosschunk.COUNTERS) <= set(s) for s in stats)
    assert all(stats[0][k] == 0 for k in crosschunk.COUNTERS)
    assert sum(s["cross_bytes"] for s in stats) >= len(data) // 2, \
        [s["cross_bytes"] for s in stats]
    assert all(s["cross_hits"] <= s["cross_anchors"] and
               s["cross_matches"] <= s["cross_hits"] for s in stats)


def test_unlimited_host_matcher_matches(data):
    _same(data, device=None, method="gzip", unlimited=True,
          max_chunk=100_000)


def test_unlimited_queues_two_ahead(data, monkeypatch):
    """When window k is collected, the jobs of windows k+1 and k+2 are
    built, and every earlier window's device buffer is released."""
    jobs = []
    at_collect = []

    class Spy(P.MatchJob):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            jobs.append(self)

        def collect(self):
            at_collect.append((len(jobs),
                               sum(j.dev is not None for j in jobs)))
            return super().collect()

    monkeypatch.setattr(P, "MatchJob", Spy)
    lrzt.compress(data, lrzt.Settings(method="gzip", unlimited=True,
                                      max_chunk=100_000), device="cpu")
    assert at_collect == [(min(k + 3, 5), min(3, 5 - k)) for k in range(5)]
    assert all(j.dev is None for j in jobs)


# --- the host-matcher branch -------------------------------------------------


@pytest.mark.parametrize("method", ["gzip", "lzma", "rans"])
def test_host_matcher_matches_use_tpu_false(data, method):
    ours = _same(data, device=None, method=method, max_chunk=150_000)
    assert _chunks(ours) == 3


def test_host_matcher_launches_no_job(data, monkeypatch):
    def no_job(*a, **kw):
        raise AssertionError("the host branch built a MatchJob")

    monkeypatch.setattr(P, "MatchJob", no_job)
    archive = lrzt.compress(data, lrzt.Settings(method="rans"), device=None)
    assert lrzt.decompress(archive, device=None) == data


def test_host_plan_has_no_device_cap(monkeypatch):
    """Past 256 MiB the host branch plans one chunk where the device
    branch plans 256 MiB chunks, as the JAX package does; checked through
    ``plan_chunks`` alone, and the branch's own call of it."""
    total = 600 << 20
    budget = 3 << 30
    for use_tpu in (False, True):
        ours = P.plan_chunks(total, lrzt.Settings(use_tpu=use_tpu), budget)
        assert ours == JP.plan_chunks(total, lrz.Settings(use_tpu=use_tpu),
                                      budget)
    assert P.plan_chunks(total, lrzt.Settings(), budget) == [total]
    assert P.plan_chunks(total, lrzt.Settings(use_tpu=True), budget) == \
        [256 << 20, 256 << 20, 88 << 20]
    seen = []
    orig = P.plan_chunks

    def spy(total, settings, ram_budget=None):
        seen.append(settings.use_tpu)
        return orig(total, settings, ram_budget)

    monkeypatch.setattr(P, "plan_chunks", spy)
    lrzt.compress(b"x" * 1000, lrzt.Settings(method="gzip"), device=None)
    lrzt.compress(b"x" * 1000, lrzt.Settings(method="gzip", use_tpu=False),
                  device="cpu")
    assert seen == [False, True]


def _literal_tokens(chunk):
    """A hook that matches nothing: one literal token a chunk."""
    n = len(chunk)
    if n == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    return (np.zeros(1, np.uint8), np.array([n], np.int64),
            np.zeros(1, np.int64))


@pytest.mark.parametrize("device,kw", [
    (None, {"method": "gzip", "max_chunk": 150_000}),
    ("cpu", {"method": "rans", "max_chunk": 150_000}),
    ("cpu", {"method": "gzip", "max_chunk": 150_000, "unlimited": True}),
])
def test_encode_tokens_hook(data, monkeypatch, device, kw):
    """A custom encoder replaces the matcher as the JAX hook does: no job
    is queued, ``-U`` keeps its windows as chunks, rans codes on the
    host."""
    js = lrz.Settings(use_tpu=device is not None, use_mesh=False, **kw)
    jbuf = io.BytesIO()
    JP.compress_stream(data, jbuf, js, encode_tokens=_literal_tokens)

    def no_job(*a, **k):
        raise AssertionError("a custom encoder must not queue a MatchJob")

    monkeypatch.setattr(P, "MatchJob", no_job)
    buf = io.BytesIO()
    lrzt.compress_stream(data, buf, lrzt.settings_from_reference(js),
                         device=device, encode_tokens=_literal_tokens)
    assert buf.getvalue() == jbuf.getvalue()
    assert _chunks(buf.getvalue()) == 3
    assert lrz.decompress(buf.getvalue(), js) == data


# --- the archive hash on its own thread --------------------------------------

# hashlib's digest of the input by hash code (magic byte 14): the name and,
# for the SHAKE codes, the digest length
_HASHLIB = {1: ("md5", None), 2: ("ripemd160", None), 3: ("sha256", None),
            4: ("sha384", None), 5: ("sha512", None), 6: ("sha3_256", None),
            7: ("sha3_512", None), 8: ("shake_128", 16),
            9: ("shake_128", 32), 10: ("shake_128", 64),
            11: ("shake_256", 16), 12: ("shake_256", 32),
            13: ("shake_256", 64)}

# each compress path, as (device, settings, how the port is called)
_HASH_PATHS = {
    "one_chunk": ("cpu", {"method": "gzip"}, "compress"),
    "lookahead": ("cpu", {"method": "gzip", "max_chunk": 50_000},
                  "compress"),
    "unlimited": ("cpu", {"method": "gzip", "max_chunk": 50_000,
                          "unlimited": True}, "compress"),
    "host_matcher": (None, {"method": "gzip", "max_chunk": 50_000},
                     "compress"),
    "encode_tokens": ("cpu", {"method": "gzip", "max_chunk": 50_000},
                      "encode_tokens"),
    "encrypted": ("cpu", {"method": "gzip", "max_chunk": 50_000,
                          "passphrase": b"pw", "costfactor_exp": 10},
                  "compress"),
    "compress_file": ("cpu", {"method": "gzip", "max_chunk": 50_000},
                      "compress_file"),
}


def _urandom_from(seed: int):
    """A stand-in for ``os.urandom`` that repeats its bytes for a seed, so
    two encrypted archives of one input can be compared byte for byte."""
    rng = np.random.default_rng(seed)
    return lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("path", sorted(_HASH_PATHS))
@pytest.mark.parametrize("code", range(14))
def test_archive_hash_from_its_thread(data, path, code, monkeypatch,
                                      tmp_path):
    """Every compress path hashes the whole input on the hash thread: the
    stored digest (decrypted where the archive is encrypted) is hashlib's
    digest of the input, code 0 writes none, and the archive is the JAX
    package's byte for byte."""
    from lrzip_next_tpu_torch.format.constants import HASH_NAME
    from lrzip_next_tpu_torch.models.info import get_fileinfo

    data = data[:150_000]
    device, kw, call = _HASH_PATHS[path]
    js = lrz.Settings(use_tpu=device is not None, use_mesh=False,
                      hash_name=HASH_NAME[code], **kw)
    ps = lrzt.settings_from_reference(js)
    hook = _literal_tokens if call == "encode_tokens" else None
    monkeypatch.setattr(os, "urandom", _urandom_from(code))
    if call == "compress_file":
        src, dst = tmp_path / "in.bin", tmp_path / "out.lrz"
        src.write_bytes(data)
        lrzt.compress_file(str(src), str(dst), ps, device=device)
        ours = dst.read_bytes()
    else:
        buf = io.BytesIO()
        lrzt.compress_stream(data, buf, ps, device=device,
                             encode_tokens=hook)
        ours = buf.getvalue()
    monkeypatch.setattr(os, "urandom", _urandom_from(code))
    jbuf = io.BytesIO()
    JP.compress_stream(data, jbuf, js, encode_tokens=hook)
    assert ours == jbuf.getvalue()

    fd = io.BytesIO(ours)
    info = get_fileinfo(fd, passphrase=js.passphrase)
    assert fd.tell() == len(ours)      # the archive ends at its digest
    if code == 0:
        assert info.stored_hash == b""
    else:
        name, xof = _HASHLIB[code]
        h = hashlib.new(name, data)
        assert info.stored_hash == (h.digest(xof) if xof else h.digest())
    assert lrzt.decompress(ours, ps, device=device) == data


@pytest.mark.parametrize("fault", ["encoder", "hasher"])
def test_error_leaves_no_hash_thread(data, monkeypatch, fault):
    """An error in the chunk loop (the encoder fails on chunk 1 of 3) or
    on the hash thread reaches the caller of ``compress_stream``, and no
    hash thread outlives the call: after a chunk-loop error it stops
    after the slice it is hashing."""
    from lrzip_next_tpu_torch.utils import hashing

    slices = []
    update = hashing.ArchiveHash.update

    def slow_update(self, part):
        if fault == "hasher" and slices:
            raise OSError("input unreadable")
        slices.append(len(part))
        time.sleep(0.002)
        update(self, part)

    monkeypatch.setattr(hashing, "HASH_SLICE", 1_000)
    monkeypatch.setattr(hashing.ArchiveHash, "update", slow_update)
    calls = []

    def encoder(chunk):
        calls.append(len(chunk))
        if fault == "encoder" and len(calls) == 2:
            raise RuntimeError("encoder failed on chunk 1")
        return _literal_tokens(chunk)

    with pytest.raises((RuntimeError, OSError),
                       match="chunk 1" if fault == "encoder"
                       else "unreadable"):
        lrzt.compress_stream(data, io.BytesIO(),
                             lrzt.Settings(method="gzip", max_chunk=150_000),
                             device="cpu", encode_tokens=encoder)
    assert not [t for t in threading.enumerate()
                if t.name == hashing.HASH_THREAD_NAME]
    if fault == "encoder":
        assert len(calls) == 2 and sum(slices) < len(data)
    else:
        assert len(calls) == 3 and slices == [1_000]


# --- MatchJob: the worker, dev= ----------------------------------------------


def test_job_on_a_given_device_chunk(data):
    chunk = np.frombuffer(data[:100_000], np.uint8)
    padded = torch.zeros(PM.bucket_size(len(chunk)), dtype=torch.uint8)
    padded[:len(chunk)] = torch.from_numpy(chunk.copy())
    job = PM.MatchJob(chunk, 8, CPU, dev=padded)
    got = job.collect()
    assert job.dev is padded
    for a, b in zip(got, JM.TpuMatchJob(chunk, stride=8).collect()):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="dev="):
        PM.MatchJob(chunk, 8, CPU, dev=padded[:-1])


def test_job_error_reaches_collect(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("anchor stage failed")

    # the job's anchor stage begins in split_stage (K1 and the row minima)
    monkeypatch.setattr(PM, "split_stage", boom)
    job = PM.MatchJob(np.arange(10_000, dtype=np.uint8), 8, CPU)
    with pytest.raises(RuntimeError, match="anchor stage failed"):
        job.collect()


def test_walk_counter_exact_under_threads(corpus_factory):
    """More queued jobs than cores, each taking the walk fallback on one
    of the worker threads, with a short switch interval: the shared
    counter loses no update, and every job gives the same tokens."""
    import os
    import sys
    from concurrent.futures import wait
    base = corpus_factory(200_000, "text")
    rng = np.random.default_rng(5)
    holed = bytearray(base)
    for off in range(5_000, 190_000, 23_000):
        holed[off:off + 8] = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
    data = np.frombuffer(base + bytes(holed) + base[:50_000], np.uint8)
    n = (os.cpu_count() or 1) + 2
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = PM.walk_fallbacks
        jobs = [PM.MatchJob(data, 8, CPU) for _ in range(n)]
        done, _ = wait([job._future for job in jobs], timeout=120)
        assert len(done) == n
        tokens = [job.collect() for job in jobs]
    finally:
        sys.setswitchinterval(old)
    assert PM.walk_fallbacks - before == n
    assert all(job.walked for job in jobs)
    assert all(_same_tokens(t, tokens[0]) for t in tokens)


def test_jobs_queued_together_equal_one_at_a_time(data):
    chunks = [np.frombuffer(data[i:i + 100_000], np.uint8)
              for i in range(0, 300_000, 100_000)]
    alone = [PM.MatchJob(c, 8, CPU).collect() for c in chunks]
    jobs = [PM.MatchJob(c, 8, CPU) for c in chunks]
    for job, want in zip(jobs, alone):
        for a, b in zip(job.collect(), want):
            assert np.array_equal(a, b)


# --- without the native runtime ----------------------------------------------


def _matcher_records(data: np.ndarray):
    """Through the port's device stages on the CPU: the selected pieces
    and the coarse chain records at stride 8, and the dense runs."""
    nb = PM.bucket_size(len(data))
    dev = torch.zeros(nb, dtype=torch.uint8)
    dev[:len(data)] = torch.from_numpy(data.copy())
    pos, cand = PM.anchor_candidates_fporder(dev, 8)
    fine, coarse = PM.compact_seeds_dual(pos, cand, len(data) - 31,
                                         PM.verify_gap(8), 1024)
    sel = [t.numpy().astype(np.int64) for t in PM.select_records(*fine)]
    pw, ew, dw = (t.numpy().astype(np.int64) for t in coarse)
    runs = PM.runs_to_host(*PM.match_candidates(dev), len(data) - 31)
    return sel, (pw, ew - pw + 1, pw - dw), runs


def _host_steps(pkg, data, sel, walk, runs):
    n = len(data)
    return [pkg.finalize_selected(*sel, n, data),
            pkg.greedy_cover_from_runs(*runs, n, data=data),
            pkg.greedy_cover_from_runs(*runs, n),
            pkg.greedy_cover_from_runs(*walk, n, data=data,
                                       gap_merged=True)]


def _off(monkeypatch, *runtimes):
    for rt in runtimes:
        monkeypatch.setattr(rt, "_lib", None)
        monkeypatch.setattr(rt, "_build_failed", True)
        assert not rt.available()


def _same_tokens(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [1, 2])
def test_numpy_fallbacks(corpus_factory, monkeypatch, seed):
    """Without the runtime, ``finalize_selected`` and the dense
    ``greedy_cover_from_runs`` (verified and unverified) give the
    runtime's tokens; every fallback gives the JAX package's fallback's
    tokens (both runtimes switched off).  The walk over gap-merged
    records is the one place where the JAX package's numpy walk, which
    the port copies, and the native walk part (ROADMAP.md, Faults)."""
    from lrzip_next_tpu import runtime as JR
    rng = np.random.default_rng(seed)
    text = np.frombuffer(corpus_factory(60_000, "text"), np.uint8)
    mixed = np.frombuffer(corpus_factory(90_000, "mixed"), np.uint8)
    data = np.concatenate([mixed, text, mixed[rng.integers(0, 1000):]])
    recs = _matcher_records(data)
    native = _host_steps(PM, data, *recs)
    _off(monkeypatch, PR, JR)
    port = _host_steps(PM, data, *recs)
    jax = _host_steps(JM, data, *recs)
    for a, b, c in zip(native, port, jax):
        assert int(a[1].sum()) == int(b[1].sum()) == len(data)
        assert _same_tokens(b, c)
    for a, b in zip(native[:3], port[:3]):
        assert _same_tokens(a, b)
    assert native[0][0].sum() > 0 and native[1][0].sum() > 0
    with pytest.raises(ValueError, match="gap-merged"):
        PM.greedy_cover_from_runs(*recs[1], len(data), gap_merged=True)


def test_walk_fallback_without_runtime_matches_jax(corpus_factory,
                                                   monkeypatch):
    """Dense text takes the coarse-chain walk; without either runtime
    both packages write the same archive."""
    from lrzip_next_tpu import runtime as JR
    base = corpus_factory(60_000, "text")
    data = base + corpus_factory(60_000, "mixed") + base[:40_000]
    _off(monkeypatch, PR, JR)
    walks = PM.walk_fallbacks
    _same(data, method="gzip")
    assert PM.walk_fallbacks > walks


@pytest.mark.parametrize("method,stride", [("gzip", 0), ("rans", 0),
                                           ("gzip", 1)])
def test_archive_without_runtime(data, method, stride, monkeypatch):
    """An archive made and decoded with the runtime unavailable equals
    the one made with it; the rans decode takes the pointer-doubling
    replay on the CPU device, and the host decode the numpy replay."""
    s = lrzt.Settings(method=method, max_chunk=150_000,
                      anchor_stride=stride)
    want = lrzt.compress(data, s, device="cpu")
    _off(monkeypatch, PR)
    assert lrzt.compress(data, s, device="cpu") == want
    assert lrzt.decompress(want, device="cpu") == data
    if method == "gzip":
        assert lrzt.decompress(want, device=None) == data
        chunks = lrzt.decompress_to_device(want, verify=True, device="cpu")
        assert b"".join(c.numpy().tobytes() for c in chunks) == data


@pytest.mark.parametrize("piece", [100, 10])
def test_flat_plan_past_six_pieces_a_token(piece):
    """A region of 1,000 literal tokens interleaved with 1,000 short
    copies from a 20 KB literal head (2,000 pieces), copied ten times:
    about 22,000 pieces for 2,011 tokens, past the JAX wrapper's 6 a
    token, at 100 or at 11 bytes a piece.  The port's flat plan, made
    again up to its bound of a piece for two output bytes, takes them,
    and its replay equals the host replay."""
    from lrzip_next_tpu import runtime as JR
    from lrzip_next_tpu_torch.models import device_path as DP
    rng = np.random.default_rng(3)
    head, pairs, copies = 20_000, 1_000, 10
    region = 2 * pairs * piece
    kinds = [0]
    lens = [head]
    dists = [0]
    pos = head
    for _ in range(pairs):
        kinds += [0, 1]
        lens += [piece, piece]
        src = int(rng.integers(0, head - piece))
        dists += [0, pos + piece - src]
        pos += 2 * piece
    kinds += [1] * copies
    lens += [region] * copies
    dists += [region] * copies
    kinds = np.array(kinds, np.uint8)
    lens = np.array(lens, np.int64)
    dists = np.array(dists, np.int64)
    literals = rng.integers(0, 256, head + pairs * piece, dtype=np.uint8)
    assert JR.flatten_replay(kinds, lens, dists) is None
    flat = PR.flatten_replay(kinds, lens, dists)
    assert flat is not None and len(flat[0]) > 6 * len(kinds) + 1024
    want = PR.replay_tokens(kinds, lens, dists, literals, int(lens.sum()))
    got = DP.replay_tokens_device_array(kinds, lens, dists,
                                        torch.from_numpy(literals))
    assert np.array_equal(got.numpy(), want)


def test_byte_rle_counts_a_doubling_replay():
    """A byte run far longer than its distance: neither piece plan takes
    it, and the replay by pointer doubling adds one to the counter."""
    from lrzip_next_tpu_torch.models import device_path as DP
    kinds = np.array([0, 1, 0], np.uint8)
    lens = np.array([3, 50_000, 4], np.int64)
    dists = np.array([0, 1, 0], np.int64)
    lit = np.array([9, 8, 7, 1, 2, 3, 4], np.uint8)
    assert PR.flatten_replay(kinds, lens, dists) is None
    before = DP.doubling_replays
    got = DP.replay_tokens_device_array(kinds, lens, dists,
                                        torch.from_numpy(lit))
    assert DP.doubling_replays == before + 1
    assert np.array_equal(got.numpy(), PR.replay_tokens(
        kinds, lens, dists, lit, int(lens.sum())))


@pytest.mark.parametrize("entry", [
    "require_runtime", "match_job", "compress", "compress_unlimited",
    "decompress", "decompress_to_device"])
def test_card_run_requires_runtime(data, monkeypatch, entry):
    """The numpy finalize and the pointer-doubling replay stand in for
    the native runtime only on the CPU and for the host matcher: asked
    for CUDA without the runtime, every entry point raises before it
    reaches the card."""
    archive = lrzt.compress(data[:20_000], lrzt.Settings(method="rans"),
                            device="cpu")
    chunk = np.frombuffer(data[:20_000], np.uint8)
    calls = {
        "require_runtime": lambda: PM.require_runtime(torch.device("cuda")),
        "match_job": lambda: PM.MatchJob(chunk, 8, "cuda"),
        "compress": lambda: lrzt.compress(data, device="cuda"),
        "compress_unlimited": lambda: lrzt.compress(
            data, lrzt.Settings(unlimited=True, max_chunk=100_000),
            device="cuda"),
        "decompress": lambda: lrzt.decompress(archive, device="cuda"),
        "decompress_to_device": lambda: lrzt.decompress_to_device(
            archive, device="cuda"),
    }
    _off(monkeypatch, PR)
    with pytest.raises(RuntimeError, match="native host runtime"):
        calls[entry]()
    PM.require_runtime("cpu")
    PM.require_runtime(None)
