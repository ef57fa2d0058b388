"""Checkpoint downloader chain: HF hub -> direct URL -> user cache dir. The
port of the JAX package's `models/download.py`, which follows the
reference's resolution and download semantics
(`mmpfn/models/mmpfn/model/loading.py:101-251` download chain;
`mmpfn/models/mmpfn/utils.py:193-241` platform cache dir;
`utils.py:300-351` model-path resolution):

  * ``model_path=None``/"auto" resolves to ``$TABPFN_MODEL_CACHE_DIR`` or the
    platform user-cache dir with appname "tabpfn" (so a checkpoint already
    downloaded by the reference is found as it is);
  * if the file is missing and ``download`` is enabled, try the HuggingFace Hub
    API first, then plain ``urllib`` against the resolve URL; accumulate errors
    and raise only after every source failed.

The transports are injectable (``hf_download=``, ``url_opener=``), so the
chain is testable without a network.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import urllib.error
import urllib.request
import warnings
from pathlib import Path
from typing import Callable, Literal

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ModelSource:
    """Published checkpoint registry (reference `loading.py:46-87`)."""

    repo_id: str
    default_filename: str
    filenames: tuple[str, ...]

    @classmethod
    def classifier_v2(cls) -> "ModelSource":
        return cls(
            repo_id="Prior-Labs/TabPFN-v2-clf",
            default_filename="tabpfn-v2-classifier.ckpt",
            filenames=(
                "tabpfn-v2-classifier.ckpt",
                "tabpfn-v2-classifier-gn2p4bpt.ckpt",
                "tabpfn-v2-classifier-llderlii.ckpt",
                "tabpfn-v2-classifier-od3j1g5m.ckpt",
                "tabpfn-v2-classifier-vutqq28w.ckpt",
                "tabpfn-v2-classifier-znskzxi4.ckpt",
            ),
        )

    @classmethod
    def regressor_v2(cls) -> "ModelSource":
        return cls(
            repo_id="Prior-Labs/TabPFN-v2-reg",
            default_filename="tabpfn-v2-regressor.ckpt",
            filenames=(
                "tabpfn-v2-regressor.ckpt",
                "tabpfn-v2-regressor-09gpqh39.ckpt",
                "tabpfn-v2-regressor-2noar4o2.ckpt",
                "tabpfn-v2-regressor-5wof9ojf.ckpt",
            ),
        )

    def url_for(self, filename: str) -> str:
        return f"https://huggingface.co/{self.repo_id}/resolve/main/{filename}?download=true"


def get_model_source(which: Literal["classifier", "regressor"]) -> ModelSource:
    if which == "classifier":
        return ModelSource.classifier_v2()
    if which == "regressor":
        return ModelSource.regressor_v2()
    raise ValueError(f"Unsupported model type: {which!r}")


def user_cache_dir(platform: str | None = None, appname: str = "tabpfn") -> Path:
    """The platform's user cache dir for ``appname``, as the reference picks
    it (`utils.py:193-241`), so checkpoints it cached are found without a
    download."""
    platform = sys.platform if platform is None else platform
    fallback = (Path.cwd() / f".{appname}_models").resolve()
    if platform == "win32":
        appdata = os.environ.get("APPDATA", "")
        return Path(appdata) / appname if appdata.strip() else fallback
    if platform == "darwin":
        return Path.home() / "Library" / "Caches" / appname
    if platform.startswith(("freebsd", "linux", "netbsd", "openbsd")):
        xdg = os.environ.get("XDG_CACHE_HOME", "")
        return Path(xdg) / appname if xdg.strip() else Path.home() / ".cache" / appname
    return fallback


def resolve_model_path(
    model_path: str | Path | None,
    which: Literal["classifier", "regressor"],
    version: str = "v2",
) -> tuple[Path, Path, str]:
    """(model_path, model_dir, model_name), reference `utils.py:307-323`."""
    if model_path is None or model_path == "auto":
        env = os.environ.get("TABPFN_MODEL_CACHE_DIR", "")
        model_dir = Path(env) if env.strip() else user_cache_dir()
        model_name = f"tabpfn-{version}-{which}.ckpt"
        return model_dir / model_name, model_dir, model_name
    model_path = Path(model_path)
    return model_path, model_path.parent, model_path.name


def _default_hf_download(repo_id: str, filename: str, local_dir: Path) -> Path:
    from huggingface_hub import hf_hub_download  # optional dependency

    return Path(hf_hub_download(repo_id=repo_id, filename=filename, local_dir=str(local_dir)))


def _default_url_opener(url: str) -> bytes:
    with urllib.request.urlopen(url) as response:  # noqa: S310
        if getattr(response, "status", 200) != 200:
            raise urllib.error.URLError(f"HTTP {response.status} for {url}")
        return response.read()


def download_model(
    to: Path,
    *,
    which: Literal["classifier", "regressor"],
    model_name: str | None = None,
    hf_download: Callable[..., Path] | None = None,
    url_opener: Callable[[str], bytes] | None = None,
) -> Literal["ok"] | list[Exception]:
    """Try every source in order; return "ok" or the accumulated exceptions
    (reference `loading.py:209-251`)."""
    source = get_model_source(which)
    filename = model_name or source.default_filename
    if model_name is not None and model_name not in source.filenames:
        return [ValueError(
            f"Model {model_name} not found in available models: {list(source.filenames)}"
        )]
    errors: list[Exception] = []
    to = Path(to)
    to.parent.mkdir(parents=True, exist_ok=True)

    hf = hf_download or _default_hf_download
    try:
        logger.info("Attempting HuggingFace download: %s", filename)
        local = hf(repo_id=source.repo_id, filename=filename, local_dir=to.parent)
        if Path(local) != to:
            Path(local).rename(to)
        return "ok"
    except Exception as e:  # noqa: BLE001 - any failure falls through to the next source
        logger.warning("HuggingFace download failed: %s", e)
        errors.append(e)

    opener = url_opener or _default_url_opener
    url = source.url_for(filename)
    try:
        logger.info("Attempting direct download from %s", url)
        to.write_bytes(opener(url))
        return "ok"
    except Exception as e:  # noqa: BLE001 - every source failed: the caller raises
        logger.warning("Direct URL download failed: %s", e)
        errors.append(e)
    return errors


def ensure_model(
    model_path: str | Path | None,
    which: Literal["classifier", "regressor"],
    *,
    download: bool = True,
    hf_download: Callable[..., Path] | None = None,
    url_opener: Callable[[str], bytes] | None = None,
) -> Path:
    """Resolve and, if needed, download a checkpoint; return its local path
    (reference `utils.py:300-351`)."""
    path, model_dir, model_name = resolve_model_path(model_path, which)
    model_dir.mkdir(parents=True, exist_ok=True)
    if path.exists():
        return path
    if not download:
        raise ValueError(
            f"Model path does not exist and downloading is disabled\nmodel path: {path}"
        )
    warnings.warn(f"Downloading model to {path}.", UserWarning, stacklevel=2)
    res = download_model(
        path, which=which, model_name=model_name, hf_download=hf_download, url_opener=url_opener
    )
    if res != "ok":
        raise RuntimeError(f"Failed to download model to {path}!") from res[0]
    return path
