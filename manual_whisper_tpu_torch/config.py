"""Layered env-var configuration (a copy of the JAX package's env layer).

Lookup order: process env -> .env.local -> .env, in the working directory
then its parent; ``KEY=KEY=val`` cleanup, quote stripping, boolean parsing
accepting 1/true/yes/on and 0/false/no/off.  The port keeps its own copy so
that it never imports the JAX package.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Dict, Mapping, Optional

_ENV_FILE_NAMES = (".env.local", ".env")

_cache_lock = threading.Lock()
_file_env_cache: Optional[Dict[str, str]] = None
_file_env_cache_key: Optional[str] = None


def _clean_value(key: str, raw: str) -> str:
    """Sanitise a dotenv value (reference: _localEnv.js:68-85).

    Handles accidental ``KEY=KEY=value`` duplication and strips matched
    single/double quotes.
    """
    value = raw.strip()
    dup_prefix = key + "="
    while value.startswith(dup_prefix):
        value = value[len(dup_prefix):].strip()
    if len(value) >= 2 and value[0] == value[-1] and value[0] in ("'", '"'):
        value = value[1:-1]
    return value.strip()


def parse_dotenv(text: str) -> Dict[str, str]:
    """Parse dotenv content (reference: _localEnv.js:35-60).

    Lines are ``KEY=VALUE``; ``#`` comment lines and blanks are skipped;
    ``export `` prefixes are tolerated; later keys win.
    """
    out: Dict[str, str] = {}
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith("export "):
            stripped = stripped[len("export "):].strip()
        eq = stripped.find("=")
        if eq <= 0:
            continue
        key = stripped[:eq].strip()
        if not key:
            continue
        out[key] = _clean_value(key, stripped[eq + 1:])
    return out


def _load_file_env(base_dir: Optional[Path] = None) -> Dict[str, str]:
    """Read `.env.local` / `.env` from base_dir and its parent, cached.

    Matches the reference's search order (cwd then parent, .env.local first;
    first file win per key) — _localEnv.js:19-33. Cache is invalidated when
    the base dir changes (tests chdir).
    """
    global _file_env_cache, _file_env_cache_key
    base = Path(base_dir) if base_dir is not None else Path.cwd()
    key = str(base.resolve())
    with _cache_lock:
        if _file_env_cache is not None and _file_env_cache_key == key:
            return _file_env_cache
        merged: Dict[str, str] = {}
        for directory in (base, base.parent):
            for name in _ENV_FILE_NAMES:
                path = directory / name
                try:
                    text = path.read_text(encoding="utf-8")
                except (OSError, UnicodeDecodeError):
                    continue
                for k, v in parse_dotenv(text).items():
                    merged.setdefault(k, v)
        _file_env_cache = merged
        _file_env_cache_key = key
        return merged


def clear_env_cache() -> None:
    global _file_env_cache, _file_env_cache_key
    with _cache_lock:
        _file_env_cache = None
        _file_env_cache_key = None


def get_env(name: str, default: Optional[str] = None,
            environ: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """process env first, then .env.local/.env fallback (_localEnv.js:6-15)."""
    env = environ if environ is not None else os.environ
    value = env.get(name)
    if value is not None and str(value).strip() != "":
        return str(value)
    file_value = _load_file_env().get(name)
    if file_value is not None and file_value != "":
        return file_value
    return default


def parse_boolean(raw, fallback: bool = False) -> bool:
    """Boolean env parsing (reference: processor.js:323-329)."""
    if not isinstance(raw, str):
        return fallback
    v = raw.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    return fallback


def get_bool(name: str, default: bool = False) -> bool:
    return parse_boolean(get_env(name), default)


def get_int(name: str, default: int) -> int:
    raw = get_env(name)
    if raw is None:
        return default
    try:
        return int(str(raw).strip())
    except ValueError:
        return default


def get_float(name: str, default: float) -> float:
    raw = get_env(name)
    if raw is None:
        return default
    try:
        return float(str(raw).strip())
    except ValueError:
        return default


def weights_dir() -> Optional[str]:
    """Checkpoint registry root: $MWX_WEIGHTS_DIR, else the repo-local
    `.weights/` directory when it exists (where the tools/train_synth_*
    trainers save — keeps evals/benches runnable with zero env setup)."""
    root = get_env("MWX_WEIGHTS_DIR")
    if root:
        return root
    local = Path(__file__).resolve().parent.parent / ".weights"
    return str(local) if local.is_dir() else None


SYNTH_MARKER_NAME = "SYNTH_TRAINED"


def warn_if_synth_checkpoint(checkpoint_dir, what: str) -> None:
    """RuntimeWarning when loading a checkpoint trained on synthetic data
    (a ``SYNTH_TRAINED`` marker beside its weights), unless the caller
    opted in via MWX_ALLOW_SYNTH_WEIGHTS."""
    if get_bool("MWX_ALLOW_SYNTH_WEIGHTS", False):
        return
    marker = Path(checkpoint_dir) / SYNTH_MARKER_NAME
    if marker.exists():
        import warnings
        warnings.warn(
            f"{what} checkpoint at {checkpoint_dir} is trained on synthetic "
            "tone-language data only and has never seen real speech; "
            "convert real weights or set MWX_ALLOW_SYNTH_WEIGHTS=1 to "
            "silence this warning", RuntimeWarning, stacklevel=3)


def parse_replacement_map_from_json(raw) -> Dict[str, str]:
    """TERM_REPLACEMENTS_JSON parsing (reference: processor.js:340-354)."""
    if not isinstance(raw, str) or not raw.strip():
        return {}
    try:
        parsed = json.loads(raw)
    except (ValueError, TypeError):
        return {}
    if not isinstance(parsed, dict):
        return {}
    out: Dict[str, str] = {}
    for k, v in parsed.items():
        if not isinstance(k, str) or not isinstance(v, str):
            continue
        src, dst = k.strip(), v.strip()
        if src and dst:
            out[src] = dst
    return out


def parse_replacement_map_from_pairs(raw) -> Dict[str, str]:
    """`k=v;k=v` TERM_REPLACEMENTS parsing (reference: processor.js:356-368)."""
    if not isinstance(raw, str) or not raw.strip():
        return {}
    out: Dict[str, str] = {}
    for pair in (p.strip() for p in raw.split(";")):
        if not pair:
            continue
        idx = pair.find("=")
        if idx <= 0:
            continue
        src, dst = pair[:idx].strip(), pair[idx + 1:].strip()
        if src and dst:
            out[src] = dst
    return out
