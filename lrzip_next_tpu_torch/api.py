"""Handle-style library API.

Port of ``lrzip_next_tpu/api.py``.  Modeled on the reference's (archived)
liblrzip surface (src/libdemo/Lrzip.h:58-115): an opaque handle with
mode/flag setters, file attachment, callbacks, and a single run() entry -
familiar to users migrating from liblrzip, implemented over the port's
pipeline.  The handle runs on the device given at construction
(``"cuda"`` by default; ``"cpu"`` runs the kernels' plain versions).
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional

from .models import pipeline
from .models.info import format_fileinfo, get_fileinfo


class Mode(enum.Enum):
    NONE = 0
    INFO = 1
    TEST = 2
    DECOMPRESS = 3
    COMPRESS_NONE = 4
    COMPRESS_LZO = 5
    COMPRESS_ZLIB = 6
    COMPRESS_BZIP2 = 7
    COMPRESS_LZMA = 8
    COMPRESS_ZPAQ = 9
    COMPRESS_BZIP3 = 10
    COMPRESS_ZSTD = 11


_MODE_METHOD = {
    Mode.COMPRESS_NONE: "none",
    Mode.COMPRESS_LZO: "lzo",
    Mode.COMPRESS_ZLIB: "gzip",
    Mode.COMPRESS_BZIP2: "bzip2",
    Mode.COMPRESS_LZMA: "lzma",
    Mode.COMPRESS_ZPAQ: "zpaq",
    Mode.COMPRESS_BZIP3: "bzip3",
    Mode.COMPRESS_ZSTD: "zstd",
}


class Lrzip:
    """Opaque-handle API: lrzip_new/lrzip_run equivalent."""

    def __init__(self, mode: Mode = Mode.COMPRESS_LZMA, device="cuda"):
        self.mode = mode
        self.device = device
        self.settings = pipeline.Settings()
        self.files: List[str] = []
        self.outfile: Optional[str] = None
        self.info_cb: Optional[Callable[[str], None]] = None
        self.log_cb: Optional[Callable[[str], None]] = None
        self.last_info: Optional[str] = None

    # ------------------------------------------------- setters (Lrzip.h)

    def mode_set(self, mode: Mode) -> None:
        self.mode = mode

    def compression_level_set(self, level: int) -> None:
        if not 1 <= level <= 9:
            raise ValueError("level must be 1..9")
        self.settings.compression_level = level

    def flags_set(self, **kw) -> None:
        for k, v in kw.items():
            if not hasattr(self.settings, k):
                raise AttributeError(f"unknown setting {k}")
            setattr(self.settings, k, v)

    def file_add(self, path: str) -> None:
        self.files.append(path)

    def outfile_set(self, path: str) -> None:
        self.outfile = path

    def passphrase_set(self, passphrase: bytes) -> None:
        self.settings.passphrase = passphrase

    # --------------------------------------------------------------- run

    def run(self) -> bool:
        if not self.files:
            raise ValueError("no input files added")
        for path in self.files:
            if self.mode is Mode.INFO:
                with open(path, "rb") as fd:
                    report = format_fileinfo(get_fileinfo(fd), path)
                self.last_info = report
                if self.info_cb:
                    self.info_cb(report)
            elif self.mode in (Mode.TEST, Mode.DECOMPRESS):
                with open(path, "rb") as fd:
                    data = pipeline.decompress_stream(
                        fd, self.settings, device=self.device)
                if self.mode is Mode.DECOMPRESS:
                    out = self.outfile or _strip_suffix(path)
                    with open(out, "wb") as f:
                        f.write(data)
            else:
                self.settings.method = _MODE_METHOD[self.mode]
                out = self.outfile or path + ".lrz"
                with open(path, "rb") as f:
                    data = f.read()
                with open(out, "wb") as of:
                    pipeline.compress_stream(data, of, self.settings,
                                             device=self.device)
            if self.log_cb:
                self.log_cb(f"{self.mode.name}: {path} done")
        return True


def _strip_suffix(path: str) -> str:
    return path[:-4] if path.endswith(".lrz") else path + ".out"
