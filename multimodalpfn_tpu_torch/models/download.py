"""Where a published checkpoint is looked for: the resolution half of the JAX
package's `models/download.py` (`user_cache_dir`, `resolve_model_path` for
``"auto"``), which follows the reference
(`mmpfn/models/mmpfn/utils.py:193-241,300-351`), so a checkpoint the
reference cached is found as it is. The port has no downloader and opens no
connection: a checkpoint that is not on disk is placed there by the user.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

CLASSIFIER_CKPT = "tabpfn-v2-classifier.ckpt"
REGRESSOR_CKPT = "tabpfn-v2-regressor.ckpt"


def user_cache_dir() -> Path:
    """The platform's user cache dir for ``tabpfn``, as the reference picks it."""
    fallback = (Path.cwd() / ".tabpfn_models").resolve()
    if sys.platform == "win32":
        appdata = os.environ.get("APPDATA", "")
        return Path(appdata) / "tabpfn" if appdata.strip() else fallback
    if sys.platform == "darwin":
        return Path.home() / "Library" / "Caches" / "tabpfn"
    if sys.platform.startswith(("freebsd", "linux", "netbsd", "openbsd")):
        xdg = os.environ.get("XDG_CACHE_HOME", "")
        return Path(xdg) / "tabpfn" if xdg.strip() else Path.home() / ".cache" / "tabpfn"
    return fallback


def cached_checkpoint_path(name: str = CLASSIFIER_CKPT) -> Path:
    """A published checkpoint's path (``name``: `CLASSIFIER_CKPT` or
    `REGRESSOR_CKPT`) in ``$TABPFN_MODEL_CACHE_DIR``, or else in
    `user_cache_dir`."""
    env = os.environ.get("TABPFN_MODEL_CACHE_DIR", "")
    return (Path(env) if env.strip() else user_cache_dir()) / name
