"""App-level configuration namespace (the ``MMLConfig`` analog) — the
port's own copy of ``mmlspark_tpu/core/config.py``.

Reference: core/env/src/main/scala/Configuration.scala:17-50 — a
typesafe-config namespace layering reference defaults under deployment
overrides. The tiers, as in the JAX package (one deployment configures
both packages):

1. built-in defaults (this module),
2. a JSON config file — ``$MMLSPARK_TPU_CONFIG`` if set, else
   ``~/.config/mmlspark_tpu.json`` when present,
3. environment variables ``MMLSPARK_TPU_<KEY>`` (highest precedence),

resolved once per process and exposed through typed getters. Stage params
(core/params.py) remain the per-stage tier; ``TrainConfig`` the per-run
tier — this module is for process-wide knobs only (the native build of
``ops/native_build.py`` reads ``native_cc`` and ``native_build``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

from mmlspark_tpu_torch.core.exceptions import FriendlyError

_ENV_PREFIX = "MMLSPARK_TPU_"

#: built-in defaults: key -> (value, doc)
_DEFAULTS: dict[str, tuple[Any, str]] = {
    "cache_dir": (
        os.path.join(os.path.expanduser("~"), ".mmlspark_tpu"),
        "root for downloaded models and other caches",
    ),
    "model_repo": (
        "",
        "default remote model repo (path or http[s] URL); empty = none",
    ),
    "native_cc": ("c++", "the C++ compiler that builds the native ops"),
    "native_build": (
        True,
        "build native ops on first use (False = Python fallbacks only)",
    ),
    "profile_dir": (
        "",
        "default torch.profiler trace directory; empty = profiling off",
    ),
    "log_level": ("INFO", "root level for the mmlspark_tpu_torch.* loggers"),
}

_lock = threading.Lock()
_resolved: dict[str, Any] | None = None


def _coerce(value: Any, like: Any) -> Any:
    if isinstance(like, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(value)
    if isinstance(like, float):
        return float(value)
    return value


def _load() -> dict[str, Any]:
    global _resolved
    with _lock:
        if _resolved is not None:
            return _resolved
        conf = {k: v for k, (v, _doc) in _DEFAULTS.items()}
        path = os.environ.get(
            _ENV_PREFIX + "CONFIG",
            os.path.join(
                os.path.expanduser("~"), ".config", "mmlspark_tpu.json"
            ),
        )
        if os.path.exists(path):
            try:
                with open(path) as f:
                    file_conf = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                raise FriendlyError(f"bad config file {path}: {e}") from e
            for k, v in file_conf.items():
                if k not in conf:
                    raise FriendlyError(
                        f"unknown config key '{k}' in {path}; known: "
                        f"{sorted(conf)}"
                    )
                conf[k] = _coerce(v, _DEFAULTS[k][0])
        for k in conf:
            env = os.environ.get(_ENV_PREFIX + k.upper())
            if env is not None:
                conf[k] = _coerce(env, _DEFAULTS[k][0])
        _resolved = conf
        return conf


def get(key: str) -> Any:
    """Resolved value for ``key`` (defaults < config file < env)."""
    conf = _load()
    if key not in conf:
        raise FriendlyError(
            f"unknown config key '{key}'; known: {sorted(conf)}"
        )
    return conf[key]


def explain() -> dict[str, dict[str, Any]]:
    """Every key with its resolved value and doc (MMLConfig's
    introspectable namespace)."""
    conf = _load()
    return {
        k: {"value": conf[k], "doc": _DEFAULTS[k][1]} for k in sorted(conf)
    }


def reset() -> None:
    """Drop the resolved snapshot (tests / after env changes)."""
    global _resolved
    with _lock:
        _resolved = None
