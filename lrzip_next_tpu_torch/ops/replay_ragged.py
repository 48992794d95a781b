"""Ragged replay: the rzip decode of one chunk as three copy kernels.

Port of ``lrzip_next_tpu/ops/replay_ragged.py``.  The native runtime
flattens the chunk's match chains at token granularity
(``runtime.flatten_replay`` / ``flatten_replay_layered``), after which the
decode is a list of *pieces* ``(dst, src, len)``: layer-0 pieces copy a
slice of the decoded literal plane, layer-k pieces copy a range of the
output that pass k-1 completed.  All sources of one pass are read-only
during it and all destinations are disjoint, so the pieces of a pass
run in any order.

The piece list (a few records a token) is uploaded once and cut on the
device, with no read-back, into (3, P) int64 tables of rows dst, src,
len in absolute byte offsets, ascending by ``dst``: a flat plan's long
and short pieces (``flat_tables``), a layered plan's layers
(``replay_pieces_layered``).  Three kernels (``csrc/replay_ragged.cu``)
take them:

- K8a ``ragged_concat``: the pieces longer than ``SHORT_LEN`` bytes into
  a zeroed buffer of 8 KiB cells, one block a cell; the block finds its
  own first piece by a search over the table and builds each 16-byte
  word of the cell in registers, so every output word is written once
  and the output needs no clearing pass.  Counterpart of
  ``_ragged_call``.
- K8c ``small_merge``: the pieces of at most ``SHORT_LEN`` bytes, in
  place into K8a's output, 32 pieces a warp, their 16-byte destination
  words spread over the lanes.  Counterpart of ``_small_call`` (whose
  output aliases its input).
- K8b ``layered_pass``: pass k of a layered plan, in place, on the
  layer's (3, P) piece table: it reads bytes that passes below k
  completed and writes bytes that none of them wrote.  Its blocks walk
  the layer's bytes in 16 KiB spans, find each span's pieces as K8a's
  blocks find theirs, and spread the span's 16-byte words over the
  threads as K8c spreads a warp's.  Counterpart of ``_layered_call``
  (which builds a new buffer each pass and copies untouched cells
  through; in place that copy is not needed).

The TPU kernels' int32-per-byte staging of the plane, the lead and trail
padding rows, the 16-row DMA windows at 8-aligned rows, the row and lane
rolls and the split of a plan into calls that fit the scalar-prefetch
memory are not carried over: a thread on the card loads any byte.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version beside it.  No kernel reads or writes outside its tensors
whatever the table holds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build

CELL = 8192                 # bytes per output cell of K8a
CELL_BITS = 13
SHORT_LEN = 512             # pieces up to this length go through K8c
_HUGE = 1 << 61             # K8a's and K8b's clamp of dst, len (kHuge)

ragged_launches = 0
layered_launches = 0
small_launches = 0


# ---------------------------------------------------------------------------
# planning


def merge_contiguous(plan_len: np.ndarray, plan_lit: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge pieces whose literal sources are adjacent (the token format
    chops long runs at 0xFFFF, ``format/tokens.split_long_runs``, so they
    arrive as thousands of adjacent pieces)."""
    plan_len = np.asarray(plan_len, np.int64)
    plan_lit = np.asarray(plan_lit, np.int64)
    if len(plan_len) <= 1:
        return plan_len, plan_lit
    keep = np.empty(len(plan_len), bool)
    keep[0] = True
    keep[1:] = plan_lit[1:] != plan_lit[:-1] + plan_len[:-1]
    if keep.all():
        return plan_len, plan_lit
    gs = np.nonzero(keep)[0]
    csum = np.concatenate([[0], np.cumsum(plan_len)])
    ge = np.concatenate([gs[1:], [len(plan_len)]])
    return csum[ge] - csum[gs], plan_lit[gs]


# ---------------------------------------------------------------------------
# the kernels' wrappers and plain versions


def _check_tensors(what: str, buf: torch.Tensor, table: torch.Tensor
                   ) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError(f"{what}: bytes must be 1-D uint8, got {buf.dtype} "
                        f"{tuple(buf.shape)}")
    if table.dtype != torch.int64 or table.dim() != 2 or \
            table.shape[0] != 3:
        raise TypeError(f"{what}: table must be (3, N) int64, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if table.device != buf.device:
        raise ValueError(f"{what}: tensors on different devices")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {buf.device}")
    if not (buf.is_contiguous() and table.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")


def _byte_maps(table: torch.Tensor):
    """Per-byte (dst, src) offsets of a (dst, src, len) table, in table
    order."""
    dst, src, length = table[0], table[1], table[2]
    rep = torch.repeat_interleave(
        torch.arange(table.shape[1], device=table.device), length)
    within = torch.arange(rep.shape[0], device=table.device) - \
        (torch.cumsum(length, 0) - length)[rep]
    return dst[rep] + within, src[rep] + within


def _copy_reference(out: torch.Tensor, src_buf: torch.Tensor,
                    table: torch.Tensor) -> None:
    """out[dst : dst+len] = src_buf[src : src+len] for every entry that
    lies inside both tensors (the others are skipped whole)."""
    dst, src, length = table[0], table[1], table[2]
    ok = (dst >= 0) & (src >= 0) & (length > 0) & \
        (length <= out.shape[0] - dst) & (length <= src_buf.shape[0] - src)
    d, s = _byte_maps(table[:, ok])
    out[d] = src_buf[s]


def check_order(pieces: torch.Tensor, what: str = "ragged_concat") -> None:
    """Raise ``ValueError`` unless a K8a or K8b table is in the order its
    kernel searches: the span ``[dst, dst + max(len, 0))`` of every
    entry, valid or not, ends at or before the next entry's ``dst`` (both
    clamped to +-2^61 as the kernels clamp them).  The replay's tables
    hold this by construction: ``dst`` is a running sum of positive
    lengths, and a subsequence of such a table (``split_pieces``, a
    layer's pieces) holds it too."""
    d = pieces[0].clamp(-_HUGE, _HUGE)
    end = d + pieces[2].clamp(0, _HUGE)
    if bool((end[:-1] > d[1:]).any()):
        raise ValueError(f"{what}: pieces not ascending and disjoint")


def ragged_concat_reference(lit: torch.Tensor, pieces: torch.Tensor,
                            ncells: int) -> torch.Tensor:
    """Plain PyTorch K8a; raises ``ValueError`` on a table that
    ``check_order`` refuses."""
    check_order(pieces)
    out = torch.zeros(ncells * CELL, dtype=torch.uint8, device=lit.device)
    dst, length = pieces[0], pieces[2]
    ok = (length > 0) & (dst >= 0) & (length <= out.shape[0] - dst)
    d, s = _byte_maps(pieces[:, ok])
    inside = (s >= 0) & (s < lit.shape[0])
    out[d[inside]] = lit[s[inside]]
    return out


def ragged_concat(lit: torch.Tensor, pieces: torch.Tensor, ncells: int
                  ) -> torch.Tensor:
    """K8a: (ncells * CELL,) uint8 with ``lit[src : src+len]`` at every
    piece's ``dst`` and 0 elsewhere.  ``pieces`` is the (3, P) int64
    table (dst, src, len), ascending by ``dst`` with disjoint
    destinations as ``check_order`` states it; a piece that does not lie
    inside the output is skipped, and a source byte outside ``lit`` reads
    as 0.  On the CPU a table out of order raises ``ValueError``; the
    kernel does not check it (that would read the table back), and on
    such a table it stays inside its tensors but which bytes land is not
    defined."""
    global ragged_launches
    _check_tensors("ragged_concat", lit, pieces)
    if ncells < 1:
        raise ValueError(f"ragged_concat: {ncells} cells")
    if lit.device.type == "cpu":
        return ragged_concat_reference(lit, pieces, ncells)
    out = torch.empty(ncells * CELL, dtype=torch.uint8, device=lit.device)
    lib = _build.library()
    _build.check(lib.lrzt_replay_ragged(
        lit.data_ptr(), lit.shape[0], pieces.data_ptr(), pieces.shape[1],
        ncells, out.data_ptr(), _build.stream_ptr(lit.device)),
        "replay_ragged")
    ragged_launches += 1
    return out


def small_merge_reference(out: torch.Tensor, lit: torch.Tensor,
                          pieces: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8c (in place)."""
    _copy_reference(out, lit, pieces)
    return out


def small_merge(out: torch.Tensor, lit: torch.Tensor, pieces: torch.Tensor
                ) -> torch.Tensor:
    """K8c: ``out[dst : dst+len] = lit[src : src+len]`` for every piece of
    the (3, P) int64 table (any order, disjoint destinations), in place;
    returns ``out``.  A piece outside either tensor is skipped whole.  An
    empty table launches nothing."""
    global small_launches
    _check_tensors("small_merge", out, pieces)
    _check_tensors("small_merge", lit, pieces)
    if out.device.type == "cpu":
        return small_merge_reference(out, lit, pieces)
    if pieces.shape[1] == 0:
        return out
    lib = _build.library()
    _build.check(lib.lrzt_replay_small(
        lit.data_ptr(), lit.shape[0], pieces.data_ptr(), pieces.shape[1],
        out.data_ptr(), out.shape[0], _build.stream_ptr(out.device)),
        "replay_small")
    small_launches += 1
    return out


def layered_pass_reference(buf: torch.Tensor, pieces: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch K8b (in place; the gather is complete before the
    scatter starts); raises ``ValueError`` on a table that
    ``check_order`` refuses."""
    check_order(pieces, "layered_pass")
    _copy_reference(buf, buf, pieces)
    return buf


def layered_pass(buf: torch.Tensor, pieces: torch.Tensor) -> torch.Tensor:
    """K8b: ``buf[dst : dst+len] = buf[src : src+len]`` for every piece of
    one layer's (3, P) int64 table, in place; returns ``buf``.  The table
    is ascending by ``dst`` with disjoint destinations, as
    ``check_order`` states it, and no piece's source overlaps any piece's
    destination (one layer of a layered plan).  A piece whose source or
    destination does not lie inside ``buf`` is skipped whole.  On the CPU
    a table out of order raises ``ValueError``; the kernel does not check
    it (that would read the table back), and on such a table it stays
    inside ``buf`` but which bytes land is not defined.  An empty table
    launches nothing."""
    global layered_launches
    _check_tensors("layered_pass", buf, pieces)
    if buf.device.type == "cpu":
        return layered_pass_reference(buf, pieces)
    if pieces.shape[1] == 0:
        return buf
    lib = _build.library()
    _build.check(lib.lrzt_replay_layered(
        buf.data_ptr(), buf.shape[0], pieces.data_ptr(), pieces.shape[1],
        _build.stream_ptr(buf.device)), "replay_layered")
    layered_launches += 1
    return buf


# ---------------------------------------------------------------------------
# the passes


def _rows(*columns: np.ndarray) -> np.ndarray:
    """The columns as the rows of one (k, P) int64 array (one copy each,
    for one upload)."""
    t = np.empty((len(columns), len(columns[0])), np.int64)
    for row, col in zip(t, columns):
        row[...] = col
    return t


def split_pieces(table: torch.Tensor, n_long: int):
    """The long and short pieces of a (3, P) int64 piece table on its
    device: two contiguous (3, n) tables, each in the order of ``table``.
    ``n_long``, the count of pieces longer than ``SHORT_LEN``, comes from
    the host, so nothing is read back."""
    order = torch.argsort((table[2] <= SHORT_LEN).to(torch.uint8),
                          stable=True)
    return (torch.index_select(table, 1, order[:n_long]),
            torch.index_select(table, 1, order[n_long:]))


def _literal_pass(long_t: torch.Tensor, short_t: torch.Tensor,
                  lit: torch.Tensor, out_len: int) -> torch.Tensor:
    """Pieces sourced from the literal plane (tables on its device) -> the
    (ncells * CELL,) uint8 buffer: K8a for the long ones, K8c for the
    short ones.  No read-back."""
    ncells = -(-max(out_len, 1) // CELL)
    out = ragged_concat(lit, long_t, ncells)
    return small_merge(out, lit, short_t)


def _check_sources(src: np.ndarray, length: np.ndarray, limit: int) -> None:
    if len(src) and (int((src + length).max()) > limit
                     or int(src.min()) < 0):
        # corrupt plan: sources past the literal plane would replay
        # zeros as silently wrong bytes
        raise ValueError("literal stream length mismatch")


def flat_tables(plan_len: np.ndarray, plan_lit: np.ndarray,
                lit: torch.Tensor):
    """The long and short piece tables of a flattened plan
    (``runtime.flatten_replay``: the output is the concatenation of
    ``lit[s : s+l]``), checked, merged and uploaded to ``lit``'s
    device."""
    pl_ = np.asarray(plan_len, np.int64)
    ps_ = np.asarray(plan_lit, np.int64)
    _check_sources(ps_, pl_, int(lit.shape[0]))
    pl_, ps_ = merge_contiguous(pl_, ps_)
    nz = pl_ > 0
    if not nz.all():
        pl_, ps_ = pl_[nz], ps_[nz]
    table = torch.from_numpy(_rows(np.cumsum(pl_) - pl_, ps_, pl_))
    return split_pieces(table.to(lit.device),
                        int(np.count_nonzero(pl_ > SHORT_LEN)))


def replay_pieces_ragged(plan_len: np.ndarray, plan_lit: np.ndarray,
                         lit: torch.Tensor, out_len: int) -> torch.Tensor:
    """Execute a flattened piece plan against the uint8 literal plane on
    its device.  Returns the (out_len,) uint8 chunk."""
    return _literal_pass(*flat_tables(plan_len, plan_lit, lit), lit,
                         out_len)[:out_len]


def replay_pieces_layered(plan_len: np.ndarray, plan_src: np.ndarray,
                          plan_layer: np.ndarray, n_layers: int,
                          lit: torch.Tensor, out_len: int) -> torch.Tensor:
    """Execute a layered plan (``runtime.flatten_replay_layered``): pass 0
    places the literal-sourced pieces (K8a, K8c; the deferred ranges stay
    0), pass k copies the layer-k pieces from the output that the passes
    below k completed (K8b, on the layer's columns of the one uploaded
    table).  Nothing is read back.  Returns the (out_len,) uint8
    chunk."""
    plan_len = np.asarray(plan_len, np.int64)
    plan_src = np.asarray(plan_src, np.int64)
    plan_layer = np.asarray(plan_layer, np.int32)
    dst = np.cumsum(plan_len) - plan_len
    nz = plan_len > 0
    l0 = nz & (plan_layer == 0)
    _check_sources(plan_src[l0], plan_len[l0], int(lit.shape[0]))
    deferred = nz & ~l0
    _check_sources(plan_src[deferred], plan_len[deferred], out_len)
    keep = nz & (plan_layer >= 0) & (plan_layer <= n_layers)
    layer = plan_layer[keep]
    counts = np.bincount(layer, minlength=n_layers + 1)
    # one upload; on the device the pieces in layer order, layer 0 first
    up = torch.from_numpy(_rows(dst[keep], plan_src[keep], plan_len[keep],
                                layer)).to(lit.device)
    order = torch.argsort(up[3], stable=True)
    table = torch.index_select(up[:3], 1, order)
    n_long = int(np.count_nonzero(plan_len[l0] > SHORT_LEN))
    out = _literal_pass(*split_pieces(table[:, :counts[0]], n_long), lit,
                        out_len)
    ends = np.cumsum(counts)
    for k in range(1, n_layers + 1):
        if counts[k]:
            layered_pass(out, table[:, ends[k - 1]:ends[k]].contiguous())
    return out[:out_len]
