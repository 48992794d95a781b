"""The handle API of the port (lrzip_next_tpu_torch.api, on the CPU)
against lrzip_next_tpu.api on temporary files: the same archives, the
same decoded files, the same info report."""

import numpy as np
import pytest
import torch

from lrzip_next_tpu import api as JA
from lrzip_next_tpu_torch import api as PA


def _data(n: int = 150_000) -> bytes:
    rng = np.random.default_rng(21)
    base = rng.integers(32, 127, n // 3, dtype=np.uint8).tobytes()
    return (base + b"handle " * 500 + base[:n // 4] + base)[:n]


def _handles(mode_name: str):
    j = JA.Lrzip(JA.Mode[mode_name])
    j.flags_set(use_tpu=True, use_mesh=False)
    return j, PA.Lrzip(PA.Mode[mode_name], device="cpu")


def test_modes_and_methods_are_the_same():
    assert [(m.name, m.value) for m in PA.Mode] == \
        [(m.name, m.value) for m in JA.Mode]
    assert {k.name: v for k, v in PA._MODE_METHOD.items()} == \
        {k.name: v for k, v in JA._MODE_METHOD.items()}


@pytest.mark.parametrize("mode", ["COMPRESS_ZLIB", "COMPRESS_NONE",
                                  "COMPRESS_LZMA", "COMPRESS_BZIP2"])
def test_compress_modes_write_the_same_archive(tmp_path, mode):
    src = tmp_path / "in.bin"
    src.write_bytes(_data())
    outs = []
    for h, name in zip(_handles(mode), ("jax.lrz", "port.lrz")):
        logs = []
        h.log_cb = logs.append
        h.compression_level_set(5)
        h.file_add(str(src))
        h.outfile_set(str(tmp_path / name))
        assert h.run() is True
        assert logs == [f"{mode}: {src} done"]
        outs.append((tmp_path / name).read_bytes())
    assert outs[0] == outs[1]
    assert len(outs[1]) < len(_data())


def test_default_outfile_names(tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(_data(40_000))
    h = PA.Lrzip(PA.Mode.COMPRESS_ZLIB, device="cpu")
    h.file_add(str(src))
    h.run()
    archive = tmp_path / "in.bin.lrz"
    assert archive.exists()
    src.unlink()
    h = PA.Lrzip(PA.Mode.DECOMPRESS, device="cpu")
    h.file_add(str(archive))
    h.run()
    assert src.read_bytes() == _data(40_000)
    assert PA._strip_suffix("a.bin") == "a.bin.out"


def test_decompress_test_and_info_modes(tmp_path):
    data = _data()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    comp = PA.Lrzip(PA.Mode.COMPRESS_ZLIB, device="cpu")
    comp.file_add(str(src))
    comp.outfile_set(str(tmp_path / "a.lrz"))
    comp.run()
    reports, decoded = [], []
    for h, name in zip(_handles("DECOMPRESS"), ("jax.out", "port.out")):
        h.file_add(str(tmp_path / "a.lrz"))
        h.outfile_set(str(tmp_path / name))
        assert h.run()
        decoded.append((tmp_path / name).read_bytes())
    assert decoded == [data, data]
    for h in _handles("TEST"):
        h.file_add(str(tmp_path / "a.lrz"))
        assert h.run()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["a.lrz", "in.bin", "jax.out", "port.out"]
    for h in _handles("INFO"):
        seen = []
        h.info_cb = seen.append
        h.file_add(str(tmp_path / "a.lrz"))
        assert h.run()
        assert seen == [h.last_info]
        reports.append(h.last_info)
    assert reports[0] == reports[1] and "a.lrz" in reports[1]


def test_test_mode_raises_on_a_damaged_archive(tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(_data(60_000))
    comp = PA.Lrzip(PA.Mode.COMPRESS_ZLIB, device="cpu")
    comp.file_add(str(src))
    comp.outfile_set(str(tmp_path / "a.lrz"))
    comp.run()
    raw = bytearray((tmp_path / "a.lrz").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (tmp_path / "bad.lrz").write_bytes(bytes(raw))
    h = PA.Lrzip(PA.Mode.TEST, device="cpu")
    h.file_add(str(tmp_path / "bad.lrz"))
    with pytest.raises(ValueError):
        h.run()


def test_passphrase_and_flags(tmp_path):
    data = _data(50_000)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    comp = PA.Lrzip(PA.Mode.COMPRESS_ZLIB, device="cpu")
    comp.passphrase_set(b"pw")
    comp.flags_set(costfactor_exp=10, anchor_stride=1)
    comp.file_add(str(src))
    comp.outfile_set(str(tmp_path / "enc.lrz"))
    comp.run()
    for h in _handles("DECOMPRESS"):
        h.passphrase_set(b"pw")
        h.file_add(str(tmp_path / "enc.lrz"))
        h.outfile_set(str(tmp_path / "dec.bin"))
        h.run()
        assert (tmp_path / "dec.bin").read_bytes() == data
    bare = PA.Lrzip(PA.Mode.TEST, device="cpu")
    bare.file_add(str(tmp_path / "enc.lrz"))
    with pytest.raises(ValueError, match="passphrase"):
        bare.run()


def test_setters_check_their_input():
    h = PA.Lrzip(device="cpu")
    assert h.mode is PA.Mode.COMPRESS_LZMA
    h.mode_set(PA.Mode.TEST)
    assert h.mode is PA.Mode.TEST
    with pytest.raises(ValueError):
        h.compression_level_set(0)
    with pytest.raises(ValueError):
        h.compression_level_set(10)
    with pytest.raises(AttributeError):
        h.flags_set(no_such_flag=1)
    with pytest.raises(ValueError, match="no input files"):
        h.run()


def test_handle_runs_on_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "in.bin"
    src.write_bytes(_data(10_000))
    h = PA.Lrzip(PA.Mode.COMPRESS_ZLIB)
    assert h.device == "cuda"
    h.file_add(str(src))
    with pytest.raises(RuntimeError):
        h.run()
