"""lrzip.conf parser.

Same search order and key set as the reference (src/util.c:206-468):
./lrzip.conf, $HOME/.lrzip/lrzip.conf, /etc/lrzip/lrzip.conf; '#' starts
a comment; KEY = VALUE pairs, keys case-insensitive.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

_KNOWN_KEYS = {
    "window", "unlimited", "compressionlevel", "rziplevel",
    "compressionmethod", "lzotest", "lz4test", "threshold",
    "processors", "hash", "hashcheck", "encrypt", "dictionarysize",
    "costfactor", "outputdirectory", "tmpdir", "nice", "showprogress",
    "verbosity", "deletefiles", "replacefile", "locale", "keepbroken",
}


def config_paths() -> list:
    paths = [os.path.join(os.getcwd(), "lrzip.conf")]
    home = os.environ.get("HOME")
    if home:
        paths.append(os.path.join(home, ".lrzip", "lrzip.conf"))
    paths.append("/etc/lrzip/lrzip.conf")
    return paths


def read_config(path: Optional[str] = None) -> Dict[str, str]:
    """Parse the first config file found; unknown keys are ignored with
    the reference's tolerance (it aborts; we warn-and-skip for
    resilience in library use)."""
    candidates = [path] if path else config_paths()
    for p in candidates:
        if p and os.path.isfile(p):
            return _parse(p)
    return {}


def _parse(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            key = key.strip().lower()
            val = val.strip()
            if key in ("deletefiles", "replacefile"):
                # these two are case-sensitive YES in the reference
                out[key] = val
            elif key in _KNOWN_KEYS:
                out[key] = val
    return out
