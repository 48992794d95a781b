"""Consecutive source-tree tarballs written end to end (six kernel
releases, say): ``trees`` ustar tarballs of exactly ``tree_bytes`` each.

Tree 0 is ``kernel_tar.build`` at ``tree_bytes`` with the traffic's
content parameters (``copy_window`` the tree). Tree k+1 is tree k with
its members edited as a release edits them:

- before each member, with probability ``add_share``, a fresh member
  (a log-normal size, as ``kernel_tar`` draws them) is inserted;
- each member is dropped with probability ``drop_share``, or edited in
  place with probability ``change_share``: ``kernel_tar``'s edit spans
  (``edits`` [lo, hi] spans of ``edit_len`` [lo, hi] bytes, at most a
  32nd of the member each) replaced by fresh text, and a new mtime in
  its header;
- every other member is copied byte for byte, header included.

Inserts and drops shift the offsets of what follows, as between
releases. The members are laid end to end; those that no longer fit
(with the two closing zero blocks) are cut at a member boundary, and
the rest of the tree is zero blocks. As in ``kernel_tar``, the layout
(tree 0's, and every insert, drop and edit) and the vocabulary are the
same for every seed, and the seed changes the text.
"""

from __future__ import annotations

import numpy as np

from . import common, kernel_tar

TAG = "kernel_trees"
HEADER = 512


def warmup(params) -> list:
    return [-1]


def _padded(n: int) -> int:
    return HEADER + (n + 511) // 512 * 512


def _next_tree(params, prev: np.ndarray, members: list, rng, gen, vocab,
               device, next_id: int, mtime: int):
    """(tree k+1, its members, the next fresh member id, the ids dropped):
    members are dicts of ``id``, ``body`` (the offset of the content in
    its tree), ``n`` and ``state`` ("kept", "changed" or "added")."""
    lo_e, hi_e = params["edits"]
    lo_l, hi_l = params["edit_len"]
    plan, dropped, need = [], [], 0
    for m in members:
        if rng.random() < params["add_share"]:
            n = int(min(params["file_max"], max(1, rng.lognormal(
                np.log(params["file_median"]), params["file_sigma"]))))
            plan.append((None, n, None))
            need += n
        u = rng.random()
        if u < params["drop_share"]:
            dropped.append(m["id"])
            continue
        spans = None
        if u < params["drop_share"] + params["change_share"]:
            n = m["n"]
            spans = []
            for _ in range(int(rng.integers(lo_e, hi_e + 1))):
                ln = min(n // 32 + 1, int(rng.integers(lo_l, hi_l + 1)))
                spans.append((int(rng.integers(0, n - ln + 1)), ln))
                need += ln
        plan.append((m, m["n"], spans))
    pool = common.to_host(vocab.text(gen, need, device))
    size = len(prev)
    out = np.zeros(size, np.uint8)
    placed, pos, cur = [], 0, 0
    for m, n, spans in plan:
        end = pos + _padded(n)
        if end + 1024 > size:
            if m is not None:
                dropped.append(m["id"])
            continue
        body = pos + HEADER
        if m is None:
            name = b"linux/new/file%05d.c" % next_id
            out[pos:body] = kernel_tar._header(name, n, mtime + next_id)
            out[body:body + n] = pool[cur:cur + n]
            cur += n
            placed.append({"id": next_id, "body": body, "n": n,
                           "state": "added"})
            next_id += 1
        else:
            src = m["body"]
            out[body:body + n] = prev[src:src + n]
            if spans is None:
                out[pos:body] = prev[src - HEADER:src]
            else:
                name = bytes(prev[src - HEADER:src - HEADER + 100]) \
                    .split(b"\0")[0]
                out[pos:body] = kernel_tar._header(name, n, mtime + m["id"])
                for at, ln in spans:
                    out[body + at:body + at + ln] = pool[cur:cur + ln]
                    cur += ln
            placed.append({"id": m["id"], "body": body, "n": n,
                           "state": "kept" if spans is None
                           else "changed"})
        pos = end
    return out, placed, next_id, dropped


def generate(params, seed: int, index: int, device, with_info: bool = False):
    """``trees`` x ``tree_bytes`` bytes; ``with_info`` adds, per tree,
    its members (``_next_tree``'s dicts) and the ids it dropped."""
    tb = params["tree_bytes"]
    tree, layout = kernel_tar.build(params, seed, 0, index, tb, device, TAG)
    vocab = kernel_tar.vocabulary(common.host_rng(0, TAG, "vocab"),
                                  params["vocab_words"], params["zipf_s"],
                                  device)
    members = [{"id": i, "body": body, "n": n, "state": "added"}
               for i, (body, n, _) in enumerate(layout)]
    trees, info = [tree], [{"members": members, "dropped": []}]
    next_id = len(members)
    for k in range(1, params["trees"]):
        rng = common.host_rng(0, TAG, "layout", index, k)
        gen = common.dev_gen(device, seed, TAG, "text", index, k)
        mtime = 1_700_000_000 + k * 10_000_000
        tree, members, next_id, dropped = _next_tree(
            params, tree, members, rng, gen, vocab, device, next_id, mtime)
        trees.append(tree)
        info.append({"members": members, "dropped": dropped})
    data = np.concatenate(trees)
    if not with_info:
        return data
    return data, {"trees": info}
