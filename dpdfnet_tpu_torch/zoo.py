"""Model zoo (own copy of ``dpdfnet_tpu.zoo``): registry, cache
resolution, downloads, the converted-parameter cache.

A frozen registry, XDG cache directories, env overrides, atomic
staging-file + rename downloads, retry with backoff on retryable HTTP / OS
errors, inter-process file locks and writability probes.  The shipped
artifact is the PyTorch ``.pth`` checkpoint of the Hugging Face repo,
converted once into the parameter tree and cached as
``<model>.params.npz`` beside it.  The cache directories, env vars and
file names are the JAX package's, so a model cached by either package is
found by the other.

Env overrides:
  DPDFNET_TPU_CACHE_DIR, DPDFNET_TPU_MODEL_DIR, DPDFNET_TPU_HF_REPO,
  DPDFNET_TPU_HF_BASE_URL, DPDFNET_TPU_HF_SUBDIR, DPDFNET_TPU_DOWNLOAD_RETRIES
"""

from __future__ import annotations

import errno
import os
import shutil
import stat
import sys
import time
import uuid
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union
from urllib.error import HTTPError, URLError
from urllib.request import urlopen

from filelock import FileLock

from .config import ModelConfig, get_config
from .utils.device import DeviceLike


@dataclass(frozen=True)
class ModelInfo:
    name: str
    sample_rate: int
    frame_ms: float
    description: str
    checkpoint_filename: str


MODEL_REGISTRY: Dict[str, ModelInfo] = {
    "baseline": ModelInfo(
        "baseline", 16000, 20.0,
        "16 kHz, no DPRNN blocks: cheapest model, lowest latency budget.",
        "baseline.pth"),
    "dpdfnet2": ModelInfo(
        "dpdfnet2", 16000, 20.0,
        "16 kHz with 2 DPRNN blocks: the default speed/quality trade-off.",
        "dpdfnet2.pth"),
    "dpdfnet4": ModelInfo(
        "dpdfnet4", 16000, 20.0,
        "16 kHz with 4 DPRNN blocks: stronger denoising at moderate cost.",
        "dpdfnet4.pth"),
    "dpdfnet8": ModelInfo(
        "dpdfnet8", 16000, 20.0,
        "16 kHz with 8 DPRNN blocks: best quality in the 16 kHz family.",
        "dpdfnet8.pth"),
    "dpdfnet2_48khz_hr": ModelInfo(
        "dpdfnet2_48khz_hr", 48000, 20.0,
        "48 kHz high-resolution variant with 2 DPRNN blocks.",
        "dpdfnet2_48khz_hr.pth"),
    "dpdfnet8_48khz_hr": ModelInfo(
        "dpdfnet8_48khz_hr", 48000, 20.0,
        "48 kHz high-resolution flagship with 8 DPRNN blocks.",
        "dpdfnet8_48khz_hr.pth"),
}

DEFAULT_MODEL = "dpdfnet2"
DEFAULT_REVISION = "main"
DEFAULT_HF_REPO = "Ceva-IP/DPDFNet"
DEFAULT_HF_BASE = "https://huggingface.co"
DEFAULT_HF_SUBDIR = "checkpoints"
DEFAULT_DOWNLOAD_RETRIES = 3


@dataclass(frozen=True)
class ResolvedModel:
    info: ModelInfo
    cfg: ModelConfig
    params_path: Path          # .npz converted-params cache
    checkpoint_path: Optional[Path]


def get_model_info(model: str) -> ModelInfo:
    try:
        return MODEL_REGISTRY[model]
    except KeyError as exc:
        supported = ", ".join(supported_models())
        raise ValueError(f"Unsupported model '{model}'. Supported: {supported}") from exc


def supported_models() -> List[str]:
    return sorted(MODEL_REGISTRY)


# --------------------------------------------------------------------------- #
# Cache directories
# --------------------------------------------------------------------------- #

def _default_cache_root() -> Path:
    if os.name == "nt":
        local = os.environ.get("LOCALAPPDATA")
        if local:
            return Path(local) / "dpdfnet_tpu"
        return Path.home() / "AppData" / "Local" / "dpdfnet_tpu"
    if sys.platform == "darwin":
        return Path.home() / "Library" / "Caches" / "dpdfnet_tpu"
    xdg = os.environ.get("XDG_CACHE_HOME")
    if xdg:
        return Path(xdg) / "dpdfnet_tpu"
    return Path.home() / ".cache" / "dpdfnet_tpu"


def get_cache_dir() -> Path:
    override = os.environ.get("DPDFNET_TPU_CACHE_DIR")
    if override:
        return Path(override).expanduser().resolve()
    return _default_cache_root().resolve()


def get_cache_model_dir() -> Path:
    return get_cache_dir() / "models"


def _download_target_dir() -> Path:
    env_dir = os.environ.get("DPDFNET_TPU_MODEL_DIR")
    if env_dir:
        return Path(env_dir).expanduser().resolve()
    return get_cache_model_dir().resolve()


def _candidate_model_dirs() -> List[Path]:
    env_dir = os.environ.get("DPDFNET_TPU_MODEL_DIR")
    if env_dir:
        return [Path(env_dir).expanduser().resolve()]
    return [get_cache_model_dir().resolve()]


def _is_valid_file(path: Path) -> bool:
    """A usable artifact = a regular file with at least one byte in it."""
    try:
        st = path.stat()
    except OSError:
        return False
    return stat.S_ISREG(st.st_mode) and st.st_size > 0


def _emit(message: str, notifier: Optional[Callable[[str], None]]) -> None:
    (notifier or (lambda m: print(m, file=sys.stderr)))(message)


# --------------------------------------------------------------------------- #
# Download machinery
# --------------------------------------------------------------------------- #

def _hf_url(filename: str, revision: str) -> str:
    """Hugging Face resolve-endpoint URL for one checkpoint file.

    Shape: ``<base>/<repo>/resolve/<revision>/[<subdir>/]<filename>`` —
    every segment overridable through DPDFNET_TPU_HF_* env vars.
    """
    segments = [
        os.environ.get("DPDFNET_TPU_HF_BASE_URL", DEFAULT_HF_BASE),
        os.environ.get("DPDFNET_TPU_HF_REPO", DEFAULT_HF_REPO),
        "resolve",
        revision,
        os.environ.get("DPDFNET_TPU_HF_SUBDIR", DEFAULT_HF_SUBDIR),
        filename,
    ]
    return "/".join(seg.strip("/") for seg in segments if seg)


def _download_one(url: str, destination: Path) -> None:
    """Stream ``url`` into ``destination`` atomically.

    The body lands in a uniquely-named staging file in the destination
    directory (same filesystem, so the final rename is atomic) and is
    fsynced before the rename; a half-written staging file never shadows
    the real artifact, and the ``finally`` sweeps it on any failure.
    """
    destination.parent.mkdir(parents=True, exist_ok=True)
    staging = destination.parent / (
        f".{destination.name}.fetch-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    try:
        with urlopen(url, timeout=90.0) as response, open(staging, "wb") as sink:
            shutil.copyfileobj(response, sink, length=512 * 1024)
            sink.flush()
            os.fsync(sink.fileno())
        staging.replace(destination)
    finally:
        try:
            staging.unlink()
        except OSError:
            pass  # already renamed into place, or never created


def _assert_writable_dir(path: Path) -> None:
    """Fail fast, with an actionable hint, if ``path`` can't hold downloads."""
    hint = (
        "point DPDFNET_TPU_MODEL_DIR (or DPDFNET_TPU_CACHE_DIR) at a "
        "directory this process can write to"
    )
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as exc:
        raise RuntimeError(
            f"Could not create the model directory '{path}' — {hint}. [{exc}]"
        ) from exc
    probe = path / f".probe-writable-{uuid.uuid4().hex}"
    try:
        probe.touch()
    except OSError as exc:
        raise RuntimeError(
            f"The model directory '{path}' exists but is not writable — "
            f"{hint}. [{exc}]"
        ) from exc
    finally:
        try:
            probe.unlink()
        except OSError:
            pass


# Errno values that indicate a transient network condition (as opposed to a
# local filesystem/permission problem, which no amount of retrying fixes).
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name) for name in (
        "ECONNABORTED", "ECONNRESET", "ETIMEDOUT",
        "ENETRESET", "ENETUNREACH", "EHOSTUNREACH",
    )
)
# Permission-class errnos: always fail fast, even though OSError is broadly
# catchable, so the caller's actionable "set DPDFNET_TPU_MODEL_DIR" message
# surfaces immediately.
_PERMISSION_ERRNOS = frozenset((errno.EACCES, errno.EPERM, errno.EROFS))


def _max_download_attempts() -> int:
    raw = os.environ.get("DPDFNET_TPU_DOWNLOAD_RETRIES")
    if raw is None:
        return DEFAULT_DOWNLOAD_RETRIES
    try:
        return max(1, int(raw))
    except ValueError:
        return DEFAULT_DOWNLOAD_RETRIES


def _worth_retrying(exc: Exception) -> bool:
    """Classify a download failure as transient (retry) or permanent (raise).

    Order matters: HTTPError subclasses URLError subclasses OSError.
    """
    if isinstance(exc, HTTPError):
        # 408/425/429 explicitly ask the client to try again later; of the
        # 5xx family only 501 (Not Implemented) is permanent.
        return exc.code in (408, 425, 429) or (
            500 <= exc.code <= 504 and exc.code != 501)
    if isinstance(exc, URLError):
        return True     # connection-level failure (DNS, refused, reset)
    if isinstance(exc, OSError):
        if exc.errno in _PERMISSION_ERRNOS:
            return False
        if isinstance(exc, (TimeoutError, ConnectionError)):
            # socket read timeouts and mid-body disconnects
            # (http.client.RemoteDisconnected is a ConnectionResetError)
            # carry errno=None — still the most common transient failures
            return True
        return exc.errno in _TRANSIENT_ERRNOS
    return False


def _fetch_with_backoff(
    *, url: str, destination: Path, verbose: bool,
    notifier: Optional[Callable[[str], None]],
) -> None:
    """Run ``_download_one`` under an exponential-backoff retry policy."""
    attempts = _max_download_attempts()
    for attempt in range(attempts):
        try:
            _download_one(url, destination)
            return
        except (HTTPError, URLError, OSError) as exc:
            if attempt + 1 >= attempts or not _worth_retrying(exc):
                raise
        # 0.5 s, 1 s, 2 s, ... capped at 8 s between attempts.
        delay = min(8.0, 2.0 ** attempt / 2.0)
        if verbose:
            _emit(
                f"  transient error downloading {destination.name}; retrying "
                f"in {delay:.1f}s ({attempt + 1}/{attempts})", notifier,
            )
        time.sleep(delay)


def _ensure_downloaded(
    *, info: ModelInfo, destination_dir: Path, revision: str, force: bool,
    verbose: bool, notifier: Optional[Callable[[str], None]],
) -> None:
    destination_dir = destination_dir.expanduser().resolve()
    _assert_writable_dir(destination_dir)
    ckpt_path = destination_dir / info.checkpoint_filename

    lock = FileLock(str(destination_dir / f".{info.name}.download.lock"))
    with lock:
        if not force and _is_valid_file(ckpt_path):
            return
        action = "Refreshing" if force else "Downloading"
        _emit(f"{action} model '{info.name}' to {destination_dir}", notifier)
        url = _hf_url(info.checkpoint_filename, revision)
        if verbose:
            _emit(f"  {info.checkpoint_filename} <- {url}", notifier)
        try:
            _fetch_with_backoff(
                url=url, destination=ckpt_path, verbose=verbose, notifier=notifier)
        except HTTPError as exc:
            detail = f"HTTP {exc.code}" + (f" ({exc.reason})" if exc.reason else "")
            raise RuntimeError(
                f"Failed to download '{info.checkpoint_filename}' from '{url}'. "
                f"{detail}. Check that the Hugging Face host is reachable, then retry. "
                f"Pre-fetching with `dpdfnet-tpu download {info.name}` is an alternative."
            ) from exc
        except URLError as exc:
            raise RuntimeError(
                f"Failed to download '{info.checkpoint_filename}' from '{url}'. "
                f"Network error: {exc.reason}. Check network/proxy settings and "
                f"retry. You can also pre-download using: dpdfnet-tpu download "
                f"{info.name}"
            ) from exc
        except OSError as exc:
            if exc.errno in {errno.EACCES, errno.EPERM, errno.EROFS}:
                raise RuntimeError(
                    f"Failed to write '{info.checkpoint_filename}' to "
                    f"'{destination_dir}'. Set DPDFNET_TPU_CACHE_DIR or "
                    f"DPDFNET_TPU_MODEL_DIR to a writable location. ({exc})"
                ) from exc
            if isinstance(exc, (TimeoutError, ConnectionError)):
                raise RuntimeError(
                    f"Failed to download '{info.checkpoint_filename}' from "
                    f"'{url}'. Network error: {exc}. Check network/proxy "
                    f"settings and retry; `dpdfnet-tpu download {info.name}` "
                    f"pre-fetches."
                ) from exc
            raise RuntimeError(
                f"Failed to download '{info.checkpoint_filename}' from '{url}'. "
                f"Local filesystem error while writing '{ckpt_path}': {exc}."
            ) from exc
        if not _is_valid_file(ckpt_path):
            raise RuntimeError(
                f"Downloaded checkpoint for model '{info.name}' is invalid in "
                f"{destination_dir}. Remove the file and retry the download."
            )


def _find_first_existing(paths: List[Path], filename: str) -> Optional[Path]:
    for directory in paths:
        candidate = directory / filename
        if _is_valid_file(candidate):
            return candidate.resolve()
    return None


# --------------------------------------------------------------------------- #
# Resolution + conversion cache
# --------------------------------------------------------------------------- #

def _npz_name(info: ModelInfo) -> str:
    return f"{info.name}.params.npz"


def resolve_model(
    *, model: str,
    checkpoint_path: Optional[Union[str, Path]] = None,
    auto_download: bool = True,
    verbose: bool = False,
    notifier: Optional[Callable[[str], None]] = None,
) -> ResolvedModel:
    """Locate (or fetch) a model's weights; returns paths without loading."""
    info = get_model_info(model)
    cfg = get_config(model)
    search_dirs = _candidate_model_dirs()

    npz = _find_first_existing(search_dirs, _npz_name(info))
    ckpt: Optional[Path] = None
    if checkpoint_path is not None:
        ckpt = Path(checkpoint_path).expanduser().resolve()
        if not _is_valid_file(ckpt):
            raise FileNotFoundError(f"Checkpoint file not found or empty: {ckpt}")
        npz = None                                   # explicit ckpt wins
    elif npz is None:
        ckpt = _find_first_existing(search_dirs, info.checkpoint_filename)
        if ckpt is None and auto_download:
            target = _download_target_dir()
            _ensure_downloaded(
                info=info, destination_dir=target, revision=DEFAULT_REVISION,
                force=False, verbose=verbose, notifier=notifier,
            )
            ckpt = (target / info.checkpoint_filename).resolve()

    if npz is None and (ckpt is None or not _is_valid_file(ckpt)):
        searched = [str(p) for p in search_dirs]
        raise FileNotFoundError(
            f"Could not resolve weights for '{info.name}'. Searched: {searched}. "
            "Set DPDFNET_TPU_CACHE_DIR/DPDFNET_TPU_MODEL_DIR, or pass "
            "checkpoint_path."
        )

    if npz is not None:
        params_path = npz
    elif checkpoint_path is not None:
        # An explicit checkpoint gets its OWN conversion cache, next to
        # the checkpoint file.  Using the stock '<model>.params.npz' name
        # would (a) silently serve stock weights when that cache already
        # exists, and (b) poison the stock cache with custom weights when
        # it does not.
        params_path = ckpt.with_name(ckpt.stem + ".params.npz")
    else:
        params_path = _download_target_dir() / _npz_name(info)
    return ResolvedModel(info=info, cfg=cfg, params_path=params_path,
                         checkpoint_path=ckpt)


def load_model_params(resolved: ResolvedModel, device: DeviceLike = None):
    """Load the converted parameter tree onto ``device`` (``None``: cuda),
    converting a ``.pth`` checkpoint on ``device`` and caching its npz
    (``<model>.params.npz``, which the JAX package reads too) on first use.
    The cache is best-effort: an unwritable directory only skips it."""
    from .utils import serialization

    if _is_valid_file(resolved.params_path):
        return serialization.load_params(resolved.params_path, device)
    if resolved.checkpoint_path is None:
        raise FileNotFoundError(
            f"No cached params and no checkpoint for '{resolved.info.name}'.")
    from .models import convert

    params = convert.load_params(resolved.checkpoint_path, resolved.cfg, device)
    try:
        _assert_writable_dir(resolved.params_path.parent)
        lock = FileLock(str(
            resolved.params_path.parent / f".{resolved.info.name}.convert.lock"))
        with lock:
            if not _is_valid_file(resolved.params_path):
                tmp = resolved.params_path.with_suffix(".tmp.npz")
                serialization.save_params(tmp, params)
                os.replace(tmp, resolved.params_path)
    except (RuntimeError, OSError):
        pass                                           # cache is best-effort
    return params


def download_model(
    *, model: str, force: bool = False, verbose: bool = False,
    notifier: Optional[Callable[[str], None]] = None,
) -> ResolvedModel:
    info = get_model_info(model)
    target = _download_target_dir()
    _ensure_downloaded(
        info=info, destination_dir=target, revision=DEFAULT_REVISION,
        force=force, verbose=verbose, notifier=notifier,
    )
    return ResolvedModel(
        info=info, cfg=get_config(model),
        params_path=target / _npz_name(info),
        checkpoint_path=(target / info.checkpoint_filename).resolve(),
    )


def download_models(
    *, models: Optional[List[str]] = None, force: bool = False,
    verbose: bool = False, notifier: Optional[Callable[[str], None]] = None,
) -> List[ResolvedModel]:
    names = supported_models() if models is None else [
        get_model_info(m).name for m in models]
    return [
        download_model(model=m, force=force, verbose=verbose, notifier=notifier)
        for m in names
    ]


def available_model_entries() -> List[Dict[str, Any]]:
    search_dirs = _candidate_model_dirs()
    cache_dir = get_cache_model_dir().resolve()
    entries: List[Dict[str, Any]] = []
    for name in supported_models():
        info = MODEL_REGISTRY[name]
        ckpt = _find_first_existing(search_dirs, info.checkpoint_filename)
        npz = _find_first_existing(search_dirs, _npz_name(info))
        row = asdict(info)
        row["checkpoint_path"] = str(ckpt) if ckpt else None
        row["params_path"] = str(npz) if npz else None
        row["ready"] = ckpt is not None or npz is not None
        row["cache_dir"] = str(cache_dir)
        row["cached"] = (
            _is_valid_file(cache_dir / info.checkpoint_filename)
            or _is_valid_file(cache_dir / _npz_name(info))
        )
        entries.append(row)
    return entries
