"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into an object, one process per
source, all started together, and links the objects into one shared
library with a plain C interface under ``build/lrzip_next_tpu_torch/``
at the checkout root, at first use, and again whenever a source is newer
than the library.  It is loaded with ``ctypes``; tensors pass as
``data_ptr()`` and the stream as
``torch.cuda.current_stream().cuda_stream``.  Every
entry point returns ``cudaGetLastError()`` after its launches, and
:func:`check` raises on a nonzero code.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "lrzip_next_tpu_torch"
_LIB = BUILD_DIR / "liblrzt_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_vp = ctypes.c_void_p
_i64 = ctypes.c_int64
_ci = ctypes.c_int
# C signatures of csrc/*.cu's extern "C" entry points
_SIGNATURES = {
    "lrzt_anchor_fps": [_vp, _i64, _i64, _ci, _vp, _vp, _vp],
    "lrzt_compact3": [_vp, _vp, _vp, _vp, _i64, _vp, _i64, _vp, _vp, _vp,
                      _vp, _vp],
    "lrzt_compact2": [_vp, _vp, _vp, _i64, _vp, _i64, _vp, _vp, _vp, _vp],
    "lrzt_compact_slots": [_i64],
    "lrzt_compact_masked": [_vp, _vp, _vp, _vp, _i64, _vp, _i64, _vp, _vp,
                            _vp, _vp, _vp],
    "lrzt_compact_masked_slots": [_i64],
    "lrzt_pack_bytes": [_vp, _vp, _i64, _vp, _i64, _vp, _i64, _vp, _vp],
    "lrzt_pack_bytes_slots": [_i64],
    "lrzt_pack_plane": [_vp, _i64, _vp, _i64, _vp, _i64, _vp, _vp],
    "lrzt_pack_plane_slots": [_i64],
    "lrzt_rans_hist": [_vp, _i64, _ci, _ci, _i64, _ci, _vp, _vp],
    "lrzt_rans_encode": [_vp, _i64, _ci, _i64, _ci, _vp, _vp, _vp, _vp,
                         _vp, _vp],
    "lrzt_rans_decode": [_vp, _i64, _vp, _vp, _i64, _ci, _i64, _ci, _ci,
                         _vp, _vp, _vp],
    "lrzt_rans_decode_cluster": [_ci, _ci, ctypes.POINTER(_ci)],
    "lrzt_replay_ragged": [_vp, _i64, _vp, _i64, _i64, _vp, _vp],
    "lrzt_replay_small": [_vp, _i64, _vp, _i64, _vp, _i64, _vp],
    "lrzt_replay_layered": [_vp, _i64, _vp, _i64, _vp],
    "lrzt_gear_anchors": [_vp, _i64, _ci, _vp, _vp, _i64, _vp, _vp, _vp,
                          _vp],
    "lrzt_gear_anchors_slots": [_i64],
}

_lib = None
_lock = threading.Lock()
build_log = ""
# Guards the wrappers' launch counters (module globals): the matcher's
# worker threads and the caller's thread launch kernels at once.
count_lock = threading.Lock()


def sources() -> list:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH): the "
                           "CUDA kernels cannot be built")
    return found


def _stale() -> bool:
    if not _LIB.exists():
        return True
    built = _LIB.stat().st_mtime
    deps = sources() + sorted(_CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise with the output of the first
    that fails.  Returns their joined output."""
    procs = []
    logs, failed = [], None
    try:
        for c in cmds:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=600)
            logs.append(out)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    return "".join(logs)


def build(force: bool = False) -> Path:
    """Compile the kernels if the library is missing or stale; returns
    its path.  Raises ``RuntimeError`` with nvcc's output on failure."""
    global build_log
    with _lock:
        if not force and not _stale():
            return _LIB
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = os.getpid()
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
        compiles = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                     "-o", str(obj)] for src, obj in zip(sources(), objs)]
        tmp = _LIB.with_name(f"{_LIB.name}.{tag}.tmp")
        try:
            build_log = _run_all(compiles)
            build_log += _run_all([[nvcc, *ARCH_FLAGS, "-shared",
                                    "-o", str(tmp), *map(str, objs)]])
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, _LIB)
        return _LIB


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first where needed."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """The raw handle of ``device``'s current CUDA stream (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object: a few microseconds less per launch)."""
    import torch
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
