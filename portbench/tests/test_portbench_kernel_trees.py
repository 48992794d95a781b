"""The consecutive-trees generator (``corpus/kernel_trees.py``) of the
``-U`` cell: one seed gives the same bytes and exactly the declared
size, each tree keeps most of the members of the one before byte for
byte, and a kept member lies a tree after itself, give or take the
members added and dropped ahead of it."""

import io
import json
import tarfile
from pathlib import Path

import numpy as np

from portbench.corpus import kernel_trees

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**33 + 12345


def small_trees(tree_bytes):
    p = json.loads((ROOT / "portbench" / "traffic" / "kernel-trees.json")
                   .read_text())["params"]
    p.update(tree_bytes=tree_bytes, copy_window=tree_bytes)
    return p


def test_one_seed_gives_the_same_bytes():
    p = small_trees(256 << 10)
    a = kernel_trees.generate(p, SEED, 3, "cpu")
    b = kernel_trees.generate(p, SEED, 3, "cpu")
    c = kernel_trees.generate(p, SEED, 4, "cpu")
    d = kernel_trees.generate(p, SEED + 1, 3, "cpu")
    assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert len(a) == len(c) == len(d) == p["trees"] * p["tree_bytes"]
    assert not np.array_equal(a, c)
    assert not np.array_equal(a, d)


def test_layout_is_the_same_for_every_seed_and_each_tree_a_tar():
    p = small_trees(256 << 10)
    a, info_a = kernel_trees.generate(p, SEED, 0, "cpu", with_info=True)
    _, info_b = kernel_trees.generate(p, SEED + 1, 0, "cpu", with_info=True)
    assert info_a == info_b
    for k, t in enumerate(info_a["trees"]):
        tree = a[k * p["tree_bytes"]:(k + 1) * p["tree_bytes"]]
        with tarfile.open(fileobj=io.BytesIO(tree.tobytes())) as tf:
            got = tf.getmembers()
        assert [m.size for m in got] == [m["n"] for m in t["members"]]


def test_trees_share_their_members_with_the_tree_before():
    """Every member a tree keeps is its predecessor's byte for byte,
    header included; an edited one keeps its name and size, and differs
    in at most the edit spans' bytes; 1 - change_share - drop_share of
    the members of each tree come through unchanged, less three standard
    deviations of the draw (0.08 over the 300 members of a 4 MiB tree)."""
    p = small_trees(4 << 20)
    tb = p["tree_bytes"]
    data, info = kernel_trees.generate(p, SEED, 0, "cpu", with_info=True)
    trees = info["trees"]
    for k in range(1, p["trees"]):
        prev = {m["id"]: m for m in trees[k - 1]["members"]}
        kept = 0
        for m in trees[k]["members"]:
            if m["state"] == "added":
                assert m["id"] not in prev
                continue
            old = prev[m["id"]]
            assert old["n"] == m["n"]
            a = data[k * tb + m["body"] - 512:k * tb + m["body"] + m["n"]]
            b = data[(k - 1) * tb + old["body"] - 512:
                     (k - 1) * tb + old["body"] + old["n"]]
            if m["state"] == "kept":
                assert np.array_equal(a, b)
                kept += 1
            else:
                assert np.array_equal(a[:100], b[:100])     # the name
                assert (a[512:] != b[512:]).sum() <= \
                    p["edits"][1] * (m["n"] // 32 + 1)
        share = 1 - p["change_share"] - p["drop_share"]
        assert kept / len(prev) >= \
            share - 3 * (share * (1 - share) / len(prev)) ** 0.5


def test_members_lie_a_tree_after_their_predecessors():
    """A member lies ``tree_bytes`` after itself in the tree before, give
    or take the members added and dropped ahead of it: a few members."""
    p = small_trees(4 << 20)
    tb = p["tree_bytes"]
    _, info = kernel_trees.generate(p, SEED, 0, "cpu", with_info=True)
    trees = info["trees"]
    size = {m["id"]: 512 + (m["n"] + 511) // 512 * 512
            for t in trees for m in t["members"]}
    for k in range(1, p["trees"]):
        before = trees[k - 1]["members"]
        prev = {m["id"]: (k - 1) * tb + m["body"] for m in before}
        order = [m["id"] for m in before]
        shifts = []
        for m in trees[k]["members"]:
            if m["id"] not in prev:
                continue
            ahead = order[:order.index(m["id"])]
            added = sum(size[x["id"]] for x in trees[k]["members"]
                        if x["state"] == "added" and x["body"] < m["body"])
            dropped = sum(size[i] for i in ahead
                          if i in trees[k]["dropped"])
            shift = k * tb + m["body"] - prev[m["id"]] - tb
            assert shift == added - dropped
            shifts.append(abs(shift))
        assert max(shifts) <= 8 * p["file_max"]
