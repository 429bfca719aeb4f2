"""Idempotent checkpoint download — port of
``vision_toolbox_tpu/utils/download.py``: a file is fetched once into a
local cache directory and found there afterwards by the basename of its URL.
The cache is the JAX package's (``VTT_CACHE_DIR``, else
``~/.cache/vision_toolbox_tpu``), so a planted or downloaded file serves both
packages; a file placed there by name is used without any download."""

from __future__ import annotations

import os
import urllib.request


def cache_dir() -> str:
    root = os.environ.get("VTT_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "vision_toolbox_tpu"
    )
    os.makedirs(root, exist_ok=True)
    return root


def cached_download(url: str) -> str:
    path = os.path.join(cache_dir(), os.path.basename(url))
    if not os.path.exists(path):
        tmp = path + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, path)
    return path
