"""End to end: lrzip_next_tpu_torch.compress on the CPU writes the same
archive bytes as lrzip_next_tpu.compress with use_tpu=True, and the port
imports neither JAX nor the JAX package."""

import io
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu.format.constants import CTYPE_NONE, CTYPE_RANS
from lrzip_next_tpu.models.info import get_fileinfo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def warm_jax_lz4_gate():
    """The JAX package's LZ4 gate loads its library racily on the first
    pool threads (ROADMAP.md, Faults): load it before any compare."""
    from lrzip_next_tpu.ops import lz4gate
    lz4gate._load_lz4()


def _jax_settings(**kw) -> lrz.Settings:
    return lrz.Settings(use_tpu=True, use_mesh=False, **kw)


def _jax_archive(data: bytes, **kw) -> bytes:
    return lrz.compress(data, _jax_settings(**kw))


def _same_archive(data: bytes, **kw) -> bytes:
    """One JAX ``Settings`` per case; the port computes from its
    conversion, so both run the same configuration."""
    js = _jax_settings(**kw)
    ours = lrzt.compress(data, lrzt.settings_from_reference(js),
                         device="cpu")
    assert ours == lrz.compress(data, js)
    assert lrz.decompress(ours) == data
    assert lrzt.decompress(ours, device="cpu") == data
    return ours


@pytest.mark.parametrize("level", [3, 7, 8])
@pytest.mark.parametrize("method", ["gzip", "lzma", "none"])
@pytest.mark.parametrize("size", [0, 1, 31, 300_000])
def test_archive_bytes_match(corpus_factory, method, level, size):
    _same_archive(corpus_factory(size, "mixed"), method=method,
                  compression_level=level)


def test_archive_bytes_match_dense_text(corpus_factory):
    """Word-soup text takes the walk fallback in both packages."""
    base = corpus_factory(200_000, "text")
    rng = np.random.default_rng(5)
    b = bytearray(base)
    for off in range(5_000, 190_000, 23_000):
        b[off:off + 8] = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
    _same_archive(base + bytes(b) + base[:50_000], method="gzip")


def test_archive_bytes_match_three_chunks(corpus_factory):
    data = corpus_factory(300_000, "mixed")
    stats = []
    ours = lrzt.compress(data, lrzt.Settings(method="gzip",
                                             max_chunk=100_000,
                                             stats_sink=stats.append),
                         device="cpu")
    assert ours == _jax_archive(data, method="gzip", max_chunk=100_000)
    assert lrz.decompress(ours) == data
    assert [s["chunk"] for s in stats] == [0, 1, 2]
    assert sum(s["chunk_bytes"] for s in stats) == len(data)


def test_compress_file_matches(corpus_factory, tmp_path):
    data = corpus_factory(120_000, "mixed")
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    dst = tmp_path / "out.lrz"
    lrzt.compress_file(str(src), str(dst), lrzt.Settings(method="gzip"),
                       device="cpu")
    assert dst.read_bytes() == _jax_archive(data, method="gzip")


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        lrzt.compress(b"x" * 1000)
    with pytest.raises(RuntimeError):
        lrzt.compress(b"x" * 1000, device="cuda")


def test_unknown_device_type_raises():
    with pytest.raises(ValueError):
        lrzt.compress(b"x" * 1000, device="meta")


@pytest.mark.parametrize("kw", [
    {"anchor_stride": 1},
    {"unlimited": True, "max_chunk": 50_000, "method": "rans"},
    {"unlimited": True, "max_chunk": 50_000},
    {"use_mesh": True, "max_chunk": 50_000},
])
def test_unported_settings_raise(kw):
    """Nothing raises any more: ``anchor_stride=1`` (the dense matcher)
    and ``-U`` over several chunks write the JAX package's archive, and
    ``use_mesh=True`` with no mesh (the CPU, or one card) takes the
    single-device loop and writes the ``use_mesh=False`` archive, as the
    JAX package does below two devices."""
    data = b"ab" * 60_000
    if "use_mesh" not in kw:
        assert _same_archive(data, **kw)
        return
    ours = lrzt.compress(data, lrzt.Settings(**kw), device="cpu")
    assert ours == _jax_archive(data, max_chunk=kw["max_chunk"])
    assert lrzt.decompress(ours, device="cpu") == data


def test_rans_with_filter_takes_host_literal_coder(corpus_factory):
    from lrzip_next_tpu.format.constants import FILTER_DELTA
    _same_archive(corpus_factory(100_000, "mixed"), method="rans",
                  filter_flag=FILTER_DELTA)


def test_port_imports_no_jax(tmp_path):
    """A fresh process that compresses and decompresses on the CPU, and
    runs the port's CLI, ``lrzntar`` and ``speedtest``, holds neither JAX
    nor any module of the JAX package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import lrzip_next_tpu_torch as lrzt
        rng = np.random.default_rng(0)
        base = rng.integers(0, 256, 60_000, dtype=np.uint8).tobytes()
        data = base + base[:40_000] + base
        archive = lrzt.compress(data, lrzt.Settings(method="gzip"),
                                device="cpu")
        assert lrzt.decompress(archive, device="cpu") == data
        assert len(archive) < len(data) // 2
        archive_gzip = archive
        p = rng.random(256) ** 8
        skewed = rng.choice(256, 300_000, p=p / p.sum()).astype(np.uint8)
        text = (skewed.tobytes() + base)[:350_000]
        archive = lrzt.compress(text, lrzt.Settings(method="rans"),
                                device="cpu")
        assert lrzt.decompress(archive, device="cpu") == text
        from lrzip_next_tpu_torch.ops import rans_kernels
        assert rans_kernels.decode_launches == 0
        chunks = lrzt.decompress_to_device(archive, verify=True,
                                           device="cpu")
        assert b"".join(c.numpy().tobytes() for c in chunks) == text
        dense = lrzt.compress(data, lrzt.Settings(method="gzip",
                                                  anchor_stride=1),
                              device="cpu")
        assert lrzt.decompress(dense, device="cpu") == data
        from lrzip_next_tpu_torch.ops import compact, matcher
        pos, cand = matcher.anchor_candidates_fporder(
            torch.zeros(1 << 16, dtype=torch.uint8), 8)
        assert len(matcher.compact_seeds(pos, cand, 60_000, 64)[0]) == 1
        assert compact.masked_launches == compact.starts_launches == 0
        from lrzip_next_tpu_torch import api
        with open("in.bin", "wb") as fh:
            fh.write(data)
        handle = api.Lrzip(api.Mode.COMPRESS_ZLIB, device="cpu")
        handle.file_add("in.bin")
        assert handle.run()
        assert open("in.bin.lrz", "rb").read() == archive_gzip
        import os
        os.environ["LRZIP"] = "NOCONFIG"
        from lrzip_next_tpu_torch import cli, lrzntar
        from lrzip_next_tpu_torch.utils import speedtest
        assert cli.main(["-Q", "--tpu", "-g", "-o", "cli.lrz", "in.bin"],
                        device="cpu") == 0
        assert open("cli.lrz", "rb").read() == archive_gzip
        assert cli.main(["-Q", "-d", "--no-tpu", "-o", "back.bin",
                         "cli.lrz"]) == 0
        assert open("back.bin", "rb").read() == data
        os.mkdir("tree")
        with open("tree/in.bin", "wb") as fh:
            fh.write(data)
        lrzntar.tar_compress("tree", "tree.tar.lrz", device=None)
        assert lrzntar.tar_decompress("tree.tar.lrz", "out",
                                      device="cpu") == ["tree",
                                                        "tree/in.bin"]
        rows = speedtest.run_matrix(data, methods=["gzip"], levels=(1,),
                                    device="cpu")
        assert rows[0]["ok"] and rows[0]["comp_size"] < len(data)
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "jaxlib" or m.startswith("jaxlib.")
               or m == "lrzip_next_tpu" or m.startswith("lrzip_next_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_IMPORTS_JAX_PACKAGE = re.compile(
    r"^\s*(import|from)\s+(lrzip_next_tpu|jax|jaxlib)(\.|\s|$)", re.M)


def _port_sources() -> list:
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for folder, _, names in os.walk(os.path.join(ROOT,
                                                 "lrzip_next_tpu_torch")):
        files += [os.path.join(folder, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def test_port_sources_name_no_jax_import():
    """No file of the port, nor chip_smoke.py, imports ``lrzip_next_tpu``
    or JAX (``lrzip_next_tpu_torch`` starts with the same letters and is
    not meant)."""
    files = _port_sources()
    assert len(files) > 40
    bad = []
    for path in files:
        with open(path) as fh:
            for m in _IMPORTS_JAX_PACKAGE.finditer(fh.read()):
                bad.append((os.path.relpath(path, ROOT), m.group(0).strip()))
    assert not bad, bad


@pytest.mark.parametrize("line,hit", [
    ("import lrzip_next_tpu", True),
    ("from lrzip_next_tpu import runtime", True),
    ("    from lrzip_next_tpu.ops import rans", True),
    ("import lrzip_next_tpu.models.pipeline as p", True),
    ("import jax.numpy as jnp", True),
    ("import lrzip_next_tpu_torch as lrzt", False),
    ("from lrzip_next_tpu_torch.ops import rans", False),
    ("# port of lrzip_next_tpu/ops/rans.py", False),
])
def test_import_scan_pattern(line, hit):
    assert bool(_IMPORTS_JAX_PACKAGE.search(line)) == hit


# --- method="rans": the device literal encode ------------------------------


def _zipf(n: int, seed: int) -> bytes:
    """Skewed i.i.d. symbols: no long repeats, rANS-compressible."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


def _literal_ctypes(archive: bytes) -> list:
    """Per chunk, the c_type of every literal-stream block."""
    info = get_fileinfo(io.BytesIO(archive))
    return [[ct for sno, ct, _, _ in ch.block_details if sno == 1]
            for ch in info.chunks]


@pytest.mark.parametrize("level", [1, 3, 7, 8])
def test_rans_archive_bytes_match(corpus_factory, level):
    """Levels 1/3/7/8 take ctx_bits 0/4/6/8."""
    data = corpus_factory(150_000, "mixed") + _zipf(100_000, level)
    ours = _same_archive(data, method="rans", compression_level=level)
    assert _literal_ctypes(ours) == [[CTYPE_RANS]]


def test_rans_archive_bytes_match_2048_lanes():
    """Over 2 MiB of literals: K = 2048 lanes, one rANS literal block."""
    data = _zipf(2_200_000, 5)
    ours = _same_archive(data, method="rans")
    assert _literal_ctypes(ours) == [[CTYPE_RANS]]


def test_rans_random_literals_take_raw_block(corpus_factory):
    """rANS cannot shrink random literals: a raw CTYPE_NONE block."""
    ours = _same_archive(corpus_factory(200_000, "random"), method="rans")
    assert _literal_ctypes(ours) == [[CTYPE_NONE]]


def test_rans_all_match_chunk_has_no_literal_block():
    half = _zipf(100_000, 4)
    ours = _same_archive(half + half, method="rans", max_chunk=100_000,
                         cross_chunk=True)
    assert _literal_ctypes(ours) == [[CTYPE_RANS], []]


@pytest.mark.parametrize("size", [0, 1, 31])
def test_rans_trivial_chunks_take_host_codec(size):
    _same_archive(_zipf(size, size), method="rans")


def test_rans_three_chunks(corpus_factory):
    data = corpus_factory(200_000, "mixed") + _zipf(100_000, 9)
    stats = []
    ours = lrzt.compress(data, lrzt.Settings(method="rans",
                                             max_chunk=100_000,
                                             stats_sink=stats.append),
                         device="cpu")
    assert ours == _jax_archive(data, method="rans", max_chunk=100_000)
    assert lrz.decompress(ours) == data
    assert [s["chunk"] for s in stats] == [0, 1, 2]
    assert len(_literal_ctypes(ours)) == 3


def test_rans_cross_chunk(corpus_factory):
    base = corpus_factory(120_000, "mixed") + _zipf(60_000, 8)
    data = base + _zipf(40_000, 10) + base[30_000:]
    _same_archive(data, method="rans", max_chunk=120_000, cross_chunk=True)


@pytest.mark.parametrize("kind,coder", [("zipf", "rans"), ("random", "none")])
def test_rans_stats_name_the_literal_block(corpus_factory, kind, coder):
    """The chunk stats name the literal block's coder and lane count."""
    data = _zipf(200_000, 3) if kind == "zipf" else \
        corpus_factory(200_000, "random")
    stats = []
    ours = lrzt.compress(data, lrzt.Settings(method="rans",
                                             stats_sink=stats.append),
                         device="cpu")
    assert ours == _jax_archive(data, method="rans")
    want = {"rans": CTYPE_RANS, "none": CTYPE_NONE}[coder]
    assert _literal_ctypes(ours) == [[want]]
    assert [s["literal_coder"] for s in stats] == [coder]
    from lrzip_next_tpu_torch.ops.rans import pick_lanes
    assert stats[0]["literal_lanes"] == pick_lanes(stats[0]["literal_bytes"])


@pytest.mark.parametrize("method", ["gzip", "rans"])
def test_chunk_leaves_no_device_buffer(corpus_factory, monkeypatch, method):
    """Each chunk's padded device copy is released once its blocks are
    written, and the lookahead holds at most three chunks' buffers at
    once: the one being packaged and the two queued ahead."""
    from lrzip_next_tpu_torch.models import pipeline as P
    jobs = []
    released = []
    orig_write = P.write_chunk

    class Spy(P.MatchJob):
        def __init__(self, *a, **kw):
            assert sum(j.dev is not None for j in jobs) <= 2
            super().__init__(*a, **kw)
            jobs.append(self)

    def write_spy(*a, **kw):
        released.append([j.dev is None for j in jobs])
        return orig_write(*a, **kw)

    monkeypatch.setattr(P, "MatchJob", Spy)
    monkeypatch.setattr(P, "write_chunk", write_spy)
    data = corpus_factory(400_000, "mixed") + _zipf(100_000, 2)
    ours = lrzt.compress(data, lrzt.Settings(method=method,
                                             max_chunk=100_000),
                         device="cpu")
    assert len(jobs) == 5 and all(j.dev is None for j in jobs)
    # when chunk k is written, jobs 0..k have given their buffers back
    assert [r[:k + 1] for k, r in enumerate(released)] == \
        [[True] * (k + 1) for k in range(5)]
    assert lrz.decompress(ours) == data


@pytest.mark.parametrize("size", [0, 1, 31])
def test_trivial_input_needs_no_runtime(size):
    """Inputs too small for the matcher never load the port's native
    runtime, as in lrzip_next_tpu."""
    from lrzip_next_tpu_torch import runtime
    data = _zipf(size, size)
    want = _jax_archive(data, method="gzip")
    saved = (runtime._lib, runtime._build_failed, runtime._SO)
    try:
        runtime._lib = None
        runtime._build_failed = True
        runtime._SO = os.path.join(ROOT, "no-such-dir", "none.so")
        assert not runtime.available()
        got = lrzt.compress(data, lrzt.Settings(method="gzip"),
                            device="cpu")
    finally:
        runtime._lib, runtime._build_failed, runtime._SO = saved
    assert got == want
