"""K2, K9, K10: order-preserving compactions of int32 payloads at masks.

``compact_starts3(start, a, b, c)`` returns ``(a_c, b_c, c_c, n)``: the
payload values at the positions where ``start`` is set, in index order,
in the first ``n`` slots of k-sized int32 tensors (slots from ``n`` on
are unspecified), and ``n`` as a 0-dim int32 tensor on the same device.
A CUDA tensor runs the one-pass kernel of ``csrc/compact3.cu``: one
launch, after one ``cudaMemsetAsync`` of a small per-call workspace on
the same stream; each block finds its tile's output offset by a
decoupled look-back over the tiles before it, and the last one writes
the count, so the host steps between a count pass and a scatter pass are
gone.  A CPU tensor runs ``compact_starts3_reference``.

Counterpart of ``lrzip_next_tpu/ops/compact_pallas.py``
``compact_starts3_pallas``, without its ``cap``: the port reads ``n``
back once and runs every later stage on exactly ``n`` records.  The
port's matcher reaches the same chain records through K10 and no longer
calls K2.

``compact_starts(start, pos, cand)`` (K10) is the same kernel with two
payloads, ``(pos_c, cand_c, n)``; counterpart of
``compact_starts_pallas``.  The matcher's chain stage launches it
twice a chunk, on the chain starts and on the chain ends.

``compact_masked(start, is_end, pos, cand)`` (K9) returns ``(starts,
ends, srcs, n)``: ``pos`` at the set ``start`` flags, ``pos`` at the set
``is_end`` flags and ``cand`` at the set ``start`` flags, each in index
order, and the count of starts.  The masks are the caller's: for the run
masks of the dense matcher the k-th start pairs with the k-th end.  A
CUDA tensor runs ``csrc/compact_masked.cu``: one launch after one
``cudaMemsetAsync`` of its workspace, as for K2, whose look-back carries
the two masks' counts in one descriptor a tile and whose last tile writes
the count; counterpart of ``compact_masked_pallas``.

In all three, output slots from the count on are unspecified, a CUDA
tensor launches the kernel or raises, and only a CPU tensor runs the
plain version (``*_reference``).  All three take fewer than 2**31 flags,
and masks that are contiguous slices starting at any byte (K9's two at
different bytes).
"""

from __future__ import annotations

import torch

from . import _build

launches = 0          # K2
masked_launches = 0   # K9
starts_launches = 0   # K10


def _check(name: str, masks, payloads) -> None:
    first = masks[0]
    k = first.shape[0] if first.dim() == 1 else -1
    for x in masks:
        if x.dtype != torch.bool or x.dim() != 1 or x.shape[0] != k:
            raise TypeError(f"{name}: masks must be 1-D bool of one length, "
                            f"got {x.dtype} {tuple(x.shape)}")
    for x in payloads:
        if x.dtype != torch.int32 or tuple(x.shape) != (k,):
            raise TypeError(f"{name}: payloads must be int32 of "
                            f"shape ({k},), got {x.dtype} {tuple(x.shape)}")
    if any(x.device != first.device for x in (*masks, *payloads)):
        raise ValueError(f"{name}: tensors on different devices")
    if not all(x.is_contiguous() for x in (*masks, *payloads)):
        raise ValueError(f"{name} needs contiguous tensors")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")


def _gather_reference(mask: torch.Tensor, payloads):
    """``x[mask]`` in the first slots of a zeroed k-sized tensor for each
    payload, and the number of set flags."""
    idx = torch.nonzero(mask).flatten()
    n = idx.shape[0]
    outs = []
    for x in payloads:
        o = torch.zeros_like(x)
        o[:n] = x[idx]
        outs.append(o)
    return outs, n


def compact_starts3_reference(start: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor, c: torch.Tensor):
    """Plain PyTorch K2 with the kernel's output contract."""
    outs, n = _gather_reference(start, (a, b, c))
    return (*outs, torch.tensor(n, dtype=torch.int32, device=start.device))


def compact_starts_reference(start: torch.Tensor, pos: torch.Tensor,
                             cand: torch.Tensor):
    """Plain PyTorch K10 with the kernel's output contract."""
    outs, n = _gather_reference(start, (pos, cand))
    return (*outs, torch.tensor(n, dtype=torch.int32, device=start.device))


def compact_masked_reference(start: torch.Tensor, is_end: torch.Tensor,
                             pos: torch.Tensor, cand: torch.Tensor):
    """Plain PyTorch K9 with the kernel's output contract."""
    (starts, srcs), n = _gather_reference(start, (pos, cand))
    (ends,), _ = _gather_reference(is_end, (pos,))
    return (starts, ends, srcs,
            torch.tensor(n, dtype=torch.int32, device=start.device))


def compact_starts3(start: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor):
    """K2 on the tensors' own device (see the module docstring)."""
    global launches
    _check("compact_starts3", (start,), (a, b, c))
    if start.device.type == "cpu":
        return compact_starts3_reference(start, a, b, c)
    outs, n = _one_pass((start,), (a, b, c), 3, "lrzt_compact3",
                        "lrzt_compact_slots")
    if start.shape[0]:
        launches += 1
    return (*outs, n)


def compact_starts(start: torch.Tensor, pos: torch.Tensor,
                   cand: torch.Tensor):
    """K10 on the tensors' own device (see the module docstring)."""
    global starts_launches
    _check("compact_starts", (start,), (pos, cand))
    if start.device.type == "cpu":
        return compact_starts_reference(start, pos, cand)
    outs, n = _one_pass((start,), (pos, cand), 2, "lrzt_compact2",
                        "lrzt_compact_slots")
    if start.shape[0]:
        starts_launches += 1
    return (*outs, n)


def compact_masked(start: torch.Tensor, is_end: torch.Tensor,
                   pos: torch.Tensor, cand: torch.Tensor):
    """K9 on the tensors' own device (see the module docstring)."""
    global masked_launches
    _check("compact_masked", (start, is_end), (pos, cand))
    if start.device.type == "cpu":
        return compact_masked_reference(start, is_end, pos, cand)
    outs, n = _one_pass((start, is_end), (pos, cand), 3,
                        "lrzt_compact_masked", "lrzt_compact_masked_slots")
    if start.shape[0]:
        masked_launches += 1
    return (*outs, n)


def _one_pass(masks, payloads, n_outs: int, entry: str, slots: str):
    """The one-pass kernel ``entry`` (``csrc/compact3.cu``,
    ``csrc/compact_masked.cu``) on CUDA tensors: ``n_outs`` k-sized int32
    outputs and the 0-dim int32 count (nothing launched for k = 0).  Each
    output, the count and the workspace (``slots`` of the C library gives
    its size) are allocations of their own: on the host an allocation
    costs less than a view of a shared one."""
    dev = masks[0].device
    k = masks[0].shape[0]
    if k >= 1 << 31:
        raise ValueError(f"{entry}: {k} flags; the kernel takes fewer than "
                         "2**31")
    outs = [torch.empty(k, dtype=torch.int32, device=dev)
            for _ in range(n_outs)]
    if k == 0:
        return outs, torch.zeros((), dtype=torch.int32, device=dev)
    lib = _build.library()
    # freed on return, maybe before the kernel ends: the caching allocator
    # hands the block only to work queued after it on this stream
    ws = torch.empty(getattr(lib, slots)(k), dtype=torch.int64, device=dev)
    n = torch.empty((), dtype=torch.int32, device=dev)
    _build.check(getattr(lib, entry)(
        *(x.data_ptr() for x in (*masks, *payloads)), k, ws.data_ptr(),
        ws.shape[0], *(o.data_ptr() for o in outs), n.data_ptr(),
        _build.stream_ptr(dev)), entry)
    return outs, n
