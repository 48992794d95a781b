"""The seeded corpus generators: one seed gives the same bytes, and each
input has the profile its traffic file declares."""

import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest

from portbench.corpus import kernel_tar, silesia, vm_image

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**33 + 12345


def traffic(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "traffic" / f"{name}.json")
                      .read_text())


def small_vm(size=16 << 20):
    p = traffic("vm-1gib")["params"]
    p["size"] = size
    return p


def small_tar(size=8 << 20):
    p = traffic("kernel-tar")["params"]
    p["size"] = size
    return p


def small_silesia(div=64):
    p = traffic("silesia")["params"]
    for f in p["files"]:
        f["size"] //= div
    return p


@pytest.mark.parametrize("gen,params", [
    (vm_image, small_vm(4 << 20)), (kernel_tar, small_tar(2 << 20)),
    (silesia, small_silesia(256))])
def test_one_seed_gives_the_same_bytes(gen, params):
    a = gen.generate(params, SEED, 3, "cpu")
    b = gen.generate(params, SEED, 3, "cpu")
    c = gen.generate(params, SEED, 4, "cpu")
    d = gen.generate(params, SEED + 1, 3, "cpu")
    assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert not np.array_equal(a[:len(c)], c[:len(a)])
    assert not np.array_equal(a[:len(d)], d[:len(a)])


def test_vm_image_profile_matches_its_parameters():
    p = small_vm()
    data, info = vm_image.generate(p, SEED, 0, "cpu", with_info=True)
    assert len(data) == p["size"]
    blocks = data.reshape(-1, p["block"])
    classes = info["classes"]
    for c, name in enumerate(vm_image.CLASSES):
        assert abs((classes == c).mean() - p["shares"][name]) < 1e-3, name
    # zero blocks are zero, no other block is
    assert ((blocks == 0).all(1) == (classes == 0)).all()
    segs = info["repeats"]
    nonzero = int((classes != 0).sum())
    assert abs(segs[:, 2].sum() / nonzero - p["repeat_share"]) < 0.01
    dist = (segs[:, 0] - segs[:, 1]) * p["block"]
    lo, hi = p["repeat_dist"]
    assert dist.min() >= lo and dist.max() <= hi
    assert (dist >= segs[:, 2] * p["block"]).all()      # no self-overlap
    # log-uniform: about as many distances below the geometric middle of
    # what this image's positions allow as above it
    for dst, src, n in segs:
        assert np.array_equal(blocks[dst:dst + n], blocks[src:src + n])
        assert (classes[dst:dst + n] != 0).all()
        assert (classes[src:src + n] != 0).all()


def test_vm_image_repeat_distances_reach_the_far_range():
    p = small_vm()
    classes = np.ones(p["size"] // p["block"] * 64, np.int8)
    rng = np.random.default_rng(5)
    segs = vm_image.repeat_plan(dict(p, repeat_share=0.2), rng, classes)
    d = (segs[:, 0] - segs[:, 1]) * p["block"]
    assert d.min() >= p["repeat_dist"][0]
    assert d.max() > 256 << 20        # beyond one 256 MiB device chunk
    logd = np.log(d)
    mid = (np.log(p["repeat_dist"][0]) + np.log(d.max())) / 2
    assert 0.25 < (logd < mid).mean() < 0.85


def test_kernel_tar_is_a_tar_with_its_near_copies():
    p = small_tar()
    data, info = kernel_tar.generate(p, SEED, 0, "cpu", with_info=True)
    assert len(data) == p["size"]
    members = info["members"]
    with tarfile.open(fileobj=io.BytesIO(data.tobytes())) as tf:
        got = tf.getmembers()
    assert len(got) == len(members)
    assert [m.size for m in got] == [n for _, n, _ in members]
    copies = [m for m in members if m[2] >= 0]
    assert abs(len(copies) / len(members) - p["near_copy_share"]) < 0.08
    sizes = np.array([n for _, n, src in members if src < 0])
    assert 0.5 * p["file_median"] < np.median(sizes) < 2 * p["file_median"]
    for body, n, src in copies:
        s0 = members[src][0]
        assert body - s0 <= p["copy_window"]
        same = (data[body:body + n] == data[s0:s0 + n]).mean()
        assert same > 0.7


SILESIA_SIZES = {
    "dickens": 10_192_446, "mozilla": 51_220_480, "mr": 9_970_564,
    "nci": 33_553_445, "ooffice": 6_152_192, "osdb": 10_085_684,
    "reymont": 6_627_202, "samba": 21_606_400, "sao": 7_251_944,
    "webster": 41_458_703, "xml": 5_345_280, "x-ray": 8_474_240}


def test_silesia_declares_the_twelve_sizes():
    p = traffic("silesia")["params"]
    assert {f["name"]: f["size"] for f in p["files"]} == SILESIA_SIZES


def test_silesia_cycles_through_every_file_with_its_size():
    p = small_silesia(128)
    for cycle in range(3):
        names = [silesia.file_of(p, SEED, 12 * cycle + j)["name"]
                 for j in range(12)]
        assert sorted(names) == sorted(SILESIA_SIZES)
    assert [silesia.file_of(p, SEED, i)["name"] for i in range(12)] != \
        [silesia.file_of(p, SEED + 1, i)["name"] for i in range(12)]
    for i in silesia.warmup(p):
        data, info = silesia.generate(p, SEED, i, "cpu", with_info=True)
        assert len(data) == SILESIA_SIZES[info["name"]] // 128
