"""K3 and K6: order-preserving stream compaction for the literal coder.

- ``pack_stream(vals, flags, cap)`` (K3): the uint8 ``vals`` at the set
  ``flags``, in index order - the chunk's literal bytes under the
  literal mask, the dense literal block.
- ``pack_plane(plane, cap)`` (K6): the low 16 bits of the int32 ``plane``
  elements whose bit 16 is set, in flat (step-major, lane-minor) order -
  the rANS wire stream out of K5's fused ``word | flag << 16`` plane;
  returned as int16 holding the uint16 words.

Both return ``(packed, count)``: a ``cap``-sized output with the kept
elements first and zeros past them (the padding reaches the rANS planes,
so it must be deterministic), and the number of set flags as a 0-dim
int32 tensor.  Elements ranked at or past ``cap`` are dropped; the count
still counts them.  A CUDA tensor runs ``csrc/streampack.cu``: for each
of K3 and K6 one launch, after one ``cudaMemsetAsync`` of a small
per-call workspace, of a one-pass compaction with a decoupled look-back
(``csrc/lookback.cuh``) that writes the kept elements with 16-byte
stores, the zero tail and the count, into an output from ``torch.empty``.
Bound: device memory (K6: the plane read once, the ``cap`` words and the
count written).  A CPU tensor runs the plain version.

Counterparts of ``lrzip_next_tpu/ops/streampack.py``
(``pack_stream_pallas``, ``pack_plane_pallas``) and of their XLA twin
``rans._pack_words_xla``.
"""

from __future__ import annotations

import torch

from . import _build

stream_launches = 0
plane_launches = 0


def _compact_reference(vals: torch.Tensor, flags: torch.Tensor, cap: int,
                       dtype: torch.dtype):
    idx = torch.nonzero(flags).flatten()
    n = idx.shape[0]
    out = torch.zeros(cap, dtype=dtype, device=vals.device)
    kept = min(n, cap)
    out[:kept] = vals[idx[:kept]].to(dtype)
    return out, torch.tensor(n, dtype=torch.int32, device=vals.device)


def pack_stream_reference(vals: torch.Tensor, flags: torch.Tensor,
                          cap: int):
    """Plain PyTorch K3."""
    return _compact_reference(vals, flags, cap, torch.uint8)


def pack_plane_reference(plane: torch.Tensor, cap: int):
    """Plain PyTorch K6."""
    flat = plane.reshape(-1)
    words = flat & 0xFFFF
    words = torch.where(words >= 1 << 15, words - (1 << 16), words)
    return _compact_reference(words, ((flat >> 16) & 1) != 0, cap,
                              torch.int16)


def _one_pass(ptrs, m: int, cap: int, dtype: torch.dtype, device,
              entry: str, what: str):
    """One one-pass compaction kernel (C entry ``entry``, its workspace
    sized by ``entry + "_slots"``) over the ``m`` elements at the device
    pointers ``ptrs``: the ``cap`` outputs of ``dtype`` (zeros past the
    count, written by the kernel) and the 0-dim int32 count; launches
    nothing for an empty input."""
    if m == 0:
        return (torch.zeros(cap, dtype=dtype, device=device),
                torch.zeros((), dtype=torch.int32, device=device))
    if m >= 1 << 31:
        raise ValueError(f"{what}: {m} elements; the kernel takes fewer "
                         "than 2**31")
    lib = _build.library()
    out = torch.empty(cap, dtype=dtype, device=device)
    # freed on return, maybe before the kernel ends: the caching allocator
    # hands the block only to work queued after it on this stream
    ws = torch.empty(getattr(lib, entry + "_slots")(m), dtype=torch.int64,
                     device=device)
    n = torch.empty((), dtype=torch.int32, device=device)
    _build.check(getattr(lib, entry)(
        *ptrs, m, out.data_ptr(), cap, ws.data_ptr(), ws.shape[0],
        n.data_ptr(), _build.stream_ptr(device)), entry)
    return out, n


def _check_device(t: torch.Tensor, what: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{what} needs contiguous tensors")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def pack_stream(vals: torch.Tensor, flags: torch.Tensor, cap: int):
    """K3 on the tensors' own device (see the module docstring)."""
    global stream_launches
    if vals.dtype != torch.uint8 or flags.dtype != torch.bool or \
            vals.dim() != 1 or vals.shape != flags.shape:
        raise TypeError(f"pack_stream: vals must be 1-D uint8 and flags bool "
                        f"of its shape, got {vals.dtype} {tuple(vals.shape)}"
                        f" and {flags.dtype} {tuple(flags.shape)}")
    if vals.device != flags.device:
        raise ValueError("pack_stream: tensors on different devices")
    for t in (vals, flags):
        _check_device(t, "pack_stream")
    if vals.device.type == "cpu":
        return pack_stream_reference(vals, flags, cap)
    res = _one_pass((vals.data_ptr(), flags.data_ptr()), vals.shape[0], cap,
                    torch.uint8, vals.device, "lrzt_pack_bytes",
                    "pack_stream")
    if vals.shape[0]:
        stream_launches += 1
    return res


def pack_plane(plane: torch.Tensor, cap: int):
    """K6 on the plane's own device (see the module docstring)."""
    global plane_launches
    if plane.dtype != torch.int32:
        raise TypeError(f"pack_plane: plane must be int32, got "
                        f"{plane.dtype}")
    _check_device(plane, "pack_plane")
    if plane.device.type == "cpu":
        return pack_plane_reference(plane, cap)
    res = _one_pass((plane.data_ptr(),), plane.numel(), cap, torch.int16,
                    plane.device, "lrzt_pack_plane", "pack_plane")
    if plane.numel():
        plane_launches += 1
    return res
