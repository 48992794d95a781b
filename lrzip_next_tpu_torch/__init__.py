"""lrzip_next_tpu_torch: the lrzip_next_tpu compressor on PyTorch and CUDA.

The rzip long-range matcher runs on an NVIDIA GPU: anchor fingerprints
(``ops/anchor.py``) and the compactions of chain starts, seed starts and
dense runs (``ops/compact.py``) are CUDA C++ kernels for ``sm_90a``, the
sorts, scans and selection around them are PyTorch (``ops/matcher.py``).
``Settings(anchor_stride=1)`` takes the dense matcher, where every
32-byte window is a seed.  With ``method="rans"`` the
chunk's literals are rANS-encoded on the GPU too
(``models/device_path.py``): literal compaction and word compaction
(``ops/streampack.py``), the sampled histogram and the encode scan
(``ops/rans_kernels.py``) are CUDA C++ kernels.  ``decompress`` decodes
such a chunk's literals on the GPU as well (the rANS decode scan, a CUDA
C++ kernel) and rebuilds the chunk there from the tokens (the ragged
replay kernels of ``ops/replay_ragged.py``) before one read-back.
``decompress_to_device`` leaves the chunks on the GPU as ``torch.uint8``
tensors; ``api.Lrzip`` is the handle-style API over files.

The package stands alone: the ``.lrz`` container (``format/``), the
backend codecs (``backends/``), the filters, the crypto layer and the
native host runtime (``runtime/``: ``finalize_tokens``, ``greedy_cover``,
``replay_tokens`` and the C++ codecs, built with g++ at first use) are
its own copies of the host layers of ``lrzip_next_tpu``, and it imports
nothing of that package.

The system has no learned parameters; what the two packages must agree
on is ``Settings``.  ``settings_from_reference`` turns the other
package's settings object into the port's.  For equal settings the port
writes the same archive bytes as
``lrzip_next_tpu.compress(data, Settings(..., use_tpu=True))``, and each
package decodes the other's archives.

Quick API:

    import lrzip_next_tpu_torch as lrzt
    archive = lrzt.compress(data, lrzt.Settings(method="lzma"))  # on CUDA
    assert lrzt.decompress(archive) == data                      # on CUDA

``compress``, ``decompress``, ``decompress_to_device`` and ``api.Lrzip``
take ``device="cuda"`` by default and raise where CUDA is absent; ``device="cpu"`` runs the kernels' plain
PyTorch versions.
"""

from .models.pipeline import (
    Settings, compress, compress_file, compress_stream, decompress,
    decompress_file, decompress_stream, decompress_stream_to,
    iter_decompress, settings_from_reference)
from .models.device_decode import decompress_to_device

__version__ = "0.1.0"

__all__ = [
    "Settings", "compress", "compress_file", "compress_stream",
    "decompress", "decompress_file", "decompress_to_device", "decompress_stream",
    "decompress_stream_to", "iter_decompress", "settings_from_reference",
    "__version__",
]
