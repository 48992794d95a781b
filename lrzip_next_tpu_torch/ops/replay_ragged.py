"""Ragged replay: the rzip decode of one chunk as three copy kernels.

Port of ``lrzip_next_tpu/ops/replay_ragged.py``.  The native runtime
flattens the chunk's match chains at token granularity
(``runtime.flatten_replay`` / ``flatten_replay_layered``), after which the
decode is a list of *pieces* ``(dst, src, len)``: layer-0 pieces copy a
slice of the decoded literal plane, layer-k pieces copy a range of the
output that pass k-1 completed.  All sources of one pass are read-only
during it and all destinations are disjoint, so the fragments of a pass
run in any order.

The piece list (a few records a token) is uploaded once; the planning
that the JAX package does in numpy on the host is plain tensor code on
the pieces' device here (``plan_frags``): pieces are cut at cell
boundaries into *fragments*, each inside one destination cell, in
destination order, with the per-cell fragment ranges ``lo`` (cell j owns
fragments ``lo[j] .. lo[j+1]``).  A fragment table is a (3, N) int64
tensor of rows dst, src, len in absolute byte offsets.  Three kernels
(``csrc/replay_ragged.cu``) take the tables:

- K8a ``ragged_concat``: pieces longer than ``SHORT_LEN`` bytes, 8 KiB
  cells, one block a cell: the cell is assembled in shared memory (zero
  where no fragment lands) and written once, so the output needs no
  clearing pass.  Counterpart of ``_ragged_call``.
- K8c ``small_merge``: pieces of at most ``SHORT_LEN`` bytes, 1 KiB
  cells, touched cells only, merged in place into K8a's output.
  Counterpart of ``_small_call`` (whose output aliases its input).
- K8b ``layered_pass``: pass k of a layered plan, 8 KiB cells, touched
  cells only, in place: it reads bytes that passes below k completed and
  writes bytes that none of them wrote.  Counterpart of ``_layered_call``
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

CELL = 8192                 # bytes per output cell of K8a and K8b
CELL_BITS = 13
SMALL_CELL_BITS = 10        # K8c: 1 KiB cells
SHORT_LEN = 512             # pieces up to this length go through K8c

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


def plan_frags(dst: torch.Tensor, src: torch.Tensor, length: torch.Tensor,
               ncells: int, cell_bits: int = CELL_BITS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cut (dst, src, len) pieces, int64 tensors ascending by ``dst`` with
    every length >= 1, at cell boundaries (2^cell_bits bytes), on their
    device.  Returns the (3, N) int64 fragment table and ``lo``
    (ncells + 1,) int64, the fragment range of every cell."""
    cb = cell_bits
    dev = dst.device
    ends = dst + length
    first = dst >> cb
    nf = ((ends - 1) >> cb) - first + 1
    idx = torch.repeat_interleave(
        torch.arange(dst.shape[0], device=dev), nf)
    k = torch.arange(idx.shape[0], device=dev) - \
        (torch.cumsum(nf, 0) - nf)[idx]
    cut = (first[idx] + k) << cb                # cell start of fragment k
    f_dst = torch.maximum(dst[idx], cut)
    f_end = torch.minimum(ends[idx], cut + (1 << cb))
    f_src = src[idx] + (f_dst - dst[idx])
    frags = torch.stack([f_dst, f_src, f_end - f_dst])
    lo = torch.searchsorted(f_dst >> cb,
                            torch.arange(ncells + 1, device=dev))
    return frags, lo


def touched_ranges(lo: torch.Tensor) -> torch.Tensor:
    """``lo`` with the empty cells dropped: (nt + 1,) int64, the fragment
    ranges of the cells that hold a fragment."""
    return torch.cat([lo[:-1][lo[1:] > lo[:-1]], lo[-1:]])


# ---------------------------------------------------------------------------
# the kernels' wrappers and plain versions


def _check_table(what: str, buf: torch.Tensor, frags: torch.Tensor,
                 lo: torch.Tensor) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError(f"{what}: bytes must be 1-D uint8, got {buf.dtype} "
                        f"{tuple(buf.shape)}")
    if frags.dtype != torch.int64 or frags.dim() != 2 or \
            frags.shape[0] != 3:
        raise TypeError(f"{what}: fragment table must be (3, N) int64, got "
                        f"{frags.dtype} {tuple(frags.shape)}")
    if lo.dtype != torch.int64 or lo.dim() != 1 or lo.shape[0] < 1:
        raise TypeError(f"{what}: ranges must be 1-D int64, got {lo.dtype} "
                        f"{tuple(lo.shape)}")
    if not (buf.device == frags.device == lo.device):
        raise ValueError(f"{what}: tensors on different devices")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {buf.device}")
    if not (buf.is_contiguous() and frags.is_contiguous()
            and lo.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")


def _byte_maps(frags: torch.Tensor):
    """Per-byte (dst, src) offsets of a fragment table, in table order."""
    dst, src, length = frags[0], frags[1], frags[2]
    rep = torch.repeat_interleave(
        torch.arange(frags.shape[1], device=frags.device), length)
    within = torch.arange(rep.shape[0], device=frags.device) - \
        (torch.cumsum(length, 0) - length)[rep]
    return dst[rep] + within, src[rep] + within


def _copy_reference(out: torch.Tensor, src_buf: torch.Tensor,
                    frags: torch.Tensor) -> None:
    """out[dst : dst+len] = src_buf[src : src+len] for every fragment
    that lies inside both tensors (the others are skipped whole)."""
    dst, src, length = frags[0], frags[1], frags[2]
    ok = (dst >= 0) & (src >= 0) & (length > 0) & \
        (length <= out.shape[0] - dst) & (length <= src_buf.shape[0] - src)
    d, s = _byte_maps(frags[:, ok])
    out[d] = src_buf[s]


def ragged_concat_reference(lit: torch.Tensor, frags: torch.Tensor,
                            lo: torch.Tensor, ncells: int) -> torch.Tensor:
    """Plain PyTorch K8a."""
    out = torch.zeros(ncells * CELL, dtype=torch.uint8, device=lit.device)
    dst, length = frags[0], frags[2]
    ok = (length > 0) & (length <= CELL) & \
        ((dst >> CELL_BITS) == ((dst + length - 1) >> CELL_BITS)) & \
        (dst >= 0) & (dst + length <= out.shape[0])
    d, s = _byte_maps(frags[:, ok])
    inside = (s >= 0) & (s < lit.shape[0])
    out[d[inside]] = lit[s[inside]]
    return out


def ragged_concat(lit: torch.Tensor, frags: torch.Tensor, lo: torch.Tensor,
                  ncells: int) -> torch.Tensor:
    """K8a: (ncells * CELL,) uint8 with ``lit[src : src+len]`` at every
    fragment's ``dst`` and 0 elsewhere.  Every fragment lies inside one
    8 KiB cell, ``lo`` is (ncells + 1,) and cell j owns fragments
    ``lo[j] .. lo[j+1]``; a source byte outside ``lit`` reads as 0."""
    global ragged_launches
    _check_table("ragged_concat", lit, frags, lo)
    if ncells < 1 or lo.shape[0] != ncells + 1:
        raise ValueError(f"ragged_concat: {lo.shape[0]} range bounds for "
                         f"{ncells} cells")
    if lit.device.type == "cpu":
        return ragged_concat_reference(lit, frags, lo, ncells)
    out = torch.empty(ncells * CELL, dtype=torch.uint8, device=lit.device)
    lib = _build.library()
    _build.check(lib.lrzt_replay_ragged(
        lit.data_ptr(), lit.shape[0], frags.data_ptr(), frags.shape[1],
        lo.data_ptr(), ncells, out.data_ptr(),
        _build.stream_ptr(lit.device)), "replay_ragged")
    ragged_launches += 1
    return out


def small_merge_reference(out: torch.Tensor, lit: torch.Tensor,
                          frags: torch.Tensor, lo: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch K8c (in place)."""
    _copy_reference(out, lit, frags)
    return out


def small_merge(out: torch.Tensor, lit: torch.Tensor, frags: torch.Tensor,
                lo: torch.Tensor) -> torch.Tensor:
    """K8c: ``out[dst : dst+len] = lit[src : src+len]`` for every
    fragment, in place; returns ``out``.  ``lo`` is (nt + 1,), the
    fragment ranges of the nt touched 1 KiB cells, one warp each."""
    global small_launches
    _check_table("small_merge", out, frags, lo)
    _check_table("small_merge", lit, frags, lo)
    if out.device.type == "cpu":
        return small_merge_reference(out, lit, frags, lo)
    if frags.shape[1] == 0 or lo.shape[0] < 2:
        return out
    lib = _build.library()
    _build.check(lib.lrzt_replay_small(
        lit.data_ptr(), lit.shape[0], frags.data_ptr(), frags.shape[1],
        lo.data_ptr(), lo.shape[0] - 1, out.data_ptr(), out.shape[0],
        _build.stream_ptr(out.device)), "replay_small")
    small_launches += 1
    return out


def layered_pass_reference(buf: torch.Tensor, frags: torch.Tensor,
                           lo: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8b (in place; the gather is complete before the
    scatter starts)."""
    _copy_reference(buf, buf, frags)
    return buf


def layered_pass(buf: torch.Tensor, frags: torch.Tensor, lo: torch.Tensor
                 ) -> torch.Tensor:
    """K8b: ``buf[dst : dst+len] = buf[src : src+len]`` for every
    fragment, in place; returns ``buf``.  The caller guarantees that no
    fragment's source overlaps any fragment's destination (one layer of a
    layered plan).  ``lo`` is (nt + 1,), the fragment ranges of the nt
    touched 8 KiB cells, one block each."""
    global layered_launches
    _check_table("layered_pass", buf, frags, lo)
    if buf.device.type == "cpu":
        return layered_pass_reference(buf, frags, lo)
    if frags.shape[1] == 0 or lo.shape[0] < 2:
        return buf
    lib = _build.library()
    _build.check(lib.lrzt_replay_layered(
        buf.data_ptr(), buf.shape[0], frags.data_ptr(), frags.shape[1],
        lo.data_ptr(), lo.shape[0] - 1, _build.stream_ptr(buf.device)),
        "replay_layered")
    layered_launches += 1
    return buf


# ---------------------------------------------------------------------------
# the passes


def _pieces(device, *arrays: np.ndarray):
    """The piece arrays as int64 tensors on ``device``, one upload."""
    both = torch.from_numpy(np.stack(arrays).astype(np.int64)).to(device)
    return tuple(both[i] for i in range(len(arrays)))


def _literal_pass(dst: torch.Tensor, src: torch.Tensor,
                  length: torch.Tensor, lit: torch.Tensor, out_len: int
                  ) -> torch.Tensor:
    """Pieces sourced from the literal plane (tensors on its device,
    ascending by ``dst``) -> the (ncells * CELL,) uint8 buffer: K8a for
    the long ones, K8c for the short ones."""
    ncells = -(-max(out_len, 1) // CELL)
    small = length <= SHORT_LEN
    long_m = ~small
    frags, lo = plan_frags(dst[long_m], src[long_m], length[long_m], ncells)
    out = ragged_concat(lit, frags, lo, ncells)
    if bool(small.any()):
        frags, lo = plan_frags(dst[small], src[small], length[small],
                               ncells * (CELL >> SMALL_CELL_BITS),
                               SMALL_CELL_BITS)
        small_merge(out, lit, frags, touched_ranges(lo))
    return out


def _check_sources(src: np.ndarray, length: np.ndarray, limit: int) -> None:
    if len(src) and (int((src + length).max()) > limit
                     or int(src.min()) < 0):
        # corrupt plan: sources past the literal plane would replay
        # zeros as silently wrong bytes
        raise ValueError("literal stream length mismatch")


def replay_pieces_ragged(plan_len: np.ndarray, plan_lit: np.ndarray,
                         lit: torch.Tensor, out_len: int) -> torch.Tensor:
    """Execute a flattened piece plan (``runtime.flatten_replay``: the
    output is the concatenation of ``lit[s : s+l]``) against the uint8
    literal plane on its device.  Returns the (out_len,) uint8 chunk."""
    pl_ = np.asarray(plan_len, np.int64)
    ps_ = np.asarray(plan_lit, np.int64)
    _check_sources(ps_, pl_, int(lit.shape[0]))
    pl_, ps_ = merge_contiguous(pl_, ps_)
    nz = pl_ > 0
    if not nz.all():
        pl_, ps_ = pl_[nz], ps_[nz]
    dst = np.cumsum(pl_) - pl_
    return _literal_pass(*_pieces(lit.device, dst, ps_, pl_), lit,
                         out_len)[:out_len]


def replay_pieces_layered(plan_len: np.ndarray, plan_src: np.ndarray,
                          plan_layer: np.ndarray, n_layers: int,
                          lit: torch.Tensor, out_len: int) -> torch.Tensor:
    """Execute a layered plan (``runtime.flatten_replay_layered``): pass 0
    places the literal-sourced pieces (K8a, K8c; the deferred ranges stay
    0), pass k copies the layer-k pieces from the output that the passes
    below k completed (K8b).  Returns the (out_len,) uint8 chunk."""
    plan_len = np.asarray(plan_len, np.int64)
    plan_src = np.asarray(plan_src, np.int64)
    plan_layer = np.asarray(plan_layer, np.int32)
    dst = np.cumsum(plan_len) - plan_len
    nz = plan_len > 0
    l0 = nz & (plan_layer == 0)
    _check_sources(plan_src[l0], plan_len[l0], int(lit.shape[0]))
    deferred = nz & ~l0
    _check_sources(plan_src[deferred], plan_len[deferred], out_len)
    t_dst, t_src, t_len, t_layer = _pieces(
        lit.device, dst[nz], plan_src[nz], plan_len[nz], plan_layer[nz])
    sel = t_layer == 0
    out = _literal_pass(t_dst[sel], t_src[sel], t_len[sel], lit, out_len)
    ncells = out.shape[0] // CELL
    for layer in range(1, n_layers + 1):
        if not ((plan_layer == layer) & nz).any():
            continue
        sel = t_layer == layer
        frags, lo = plan_frags(t_dst[sel], t_src[sel], t_len[sel], ncells)
        layered_pass(out, frags, touched_ranges(lo))
    return out[:out_len]
