"""lrzip_next_tpu_torch: the lrzip_next_tpu compressor on PyTorch and CUDA.

The rzip long-range matcher runs on an NVIDIA GPU: anchor fingerprints
(``ops/anchor.py``) and chain-start compaction (``ops/compact.py``) are
CUDA C++ kernels for ``sm_90a``, the sorts, scans and selection around
them are PyTorch (``ops/matcher.py``).  With ``method="rans"`` the
chunk's literals are rANS-encoded on the GPU too
(``models/device_path.py``): literal compaction and word compaction
(``ops/streampack.py``), the sampled histogram and the encode scan
(``ops/rans_kernels.py``) are CUDA C++ kernels.  Everything that holds
no JAX - the ``.lrz`` container, the backend codecs and the native host
runtime (``finalize_tokens``, ``greedy_cover``, ``rans_decode``) - is
imported from ``lrzip_next_tpu`` and shared, not copied.

The system has no learned parameters, and the port takes the very same
``Settings`` dataclass and the same input bytes as ``lrzip_next_tpu``, so
no state needs converting between the two packages.  For equal settings
the port writes the same archive bytes as
``lrzip_next_tpu.compress(data, Settings(..., use_tpu=True))``.

Quick API:

    import lrzip_next_tpu_torch as lrzt
    archive = lrzt.compress(data, lrzt.Settings(method="lzma"))  # on CUDA
    assert lrzt.decompress(archive) == data

``compress`` takes ``device="cuda"`` by default and raises where CUDA is
absent; ``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from .device import guard_zstandard

guard_zstandard()

from lrzip_next_tpu.models.pipeline import Settings, decompress  # noqa: E402

from .models.pipeline import (  # noqa: E402
    compress, compress_file, compress_stream)

__version__ = "0.1.0"

__all__ = [
    "Settings", "compress", "compress_file", "compress_stream",
    "decompress", "__version__",
]
