"""Versioned on-disk winner cache for the kernel autotuner (counterpart
of ``paddle_tpu/tuner/store.py``; the same layout, version and integrity
rules, so one cache directory can serve both packages).

Layout: one JSON file per platform under the tune-cache directory
(``PADDLE_TPU_TUNE_CACHE`` or ``~/.cache/paddle_tpu/tuning/``):

    winners-<platform>.json
    {"version": 1, "platform": "cuda-sm90",
     "entries": {"<key>": {"config": {...}, "us": 123.4}}}

The port's platform tags (``cuda-sm<major><minor>``, or ``cpu``) never
equal the JAX package's ``gpu``/``tpu``, so its CUDA winners live in
files of their own; keys are the canonical strings built by
:mod:`paddle_tpu_torch.tuner`.

Integrity rules: a corrupt or truncated file, a version-mismatched file,
or a malformed entry is ignored with a warning and treated as missing —
the caller retunes or keeps its rule; a bad cache can never crash a
launch or silently apply a stale config.

A committed defaults table (``default_winners.json`` next to this
module, the port's own: only winners measured on the H100) seeds cold
processes: disk entries win over defaults, and ``record()`` writes only
to disk, never to the package file. :func:`committed` reads that table
alone; it is the one tier B4's launch path reads.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Any, Dict, Optional

#: bump when the key grammar or entry schema changes: old caches are
#: ignored (with a warning), never reinterpreted
CACHE_VERSION = 1

_ENV_DIR = "PADDLE_TPU_TUNE_CACHE"
_DEFAULTS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "default_winners.json")


def cache_dir() -> str:
    d = os.environ.get(_ENV_DIR, "").strip()
    if d:
        return os.path.expanduser(d)
    return os.path.join(os.path.expanduser("~/.cache/paddle_tpu"), "tuning")


def _load_table(path: str, what: str) -> Dict[str, Dict[str, Any]]:
    """Load one winners table; any integrity problem -> warn + {}."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError, UnicodeDecodeError) as e:
        warnings.warn(
            f"paddle_tpu_torch.tuner: ignoring unreadable/corrupt {what} "
            f"({path}): {e}; affected shapes will be retuned or keep their "
            f"rules")
        return {}
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
        warnings.warn(
            f"paddle_tpu_torch.tuner: ignoring {what} ({path}) with version "
            f"{data.get('version') if isinstance(data, dict) else '?'} "
            f"(expected {CACHE_VERSION}); affected shapes will be retuned")
        return {}
    entries = data.get("entries")
    if not isinstance(entries, dict):
        warnings.warn(f"paddle_tpu_torch.tuner: {what} ({path}) has no "
                      f"valid 'entries' table; ignoring it")
        return {}
    good: Dict[str, Dict[str, Any]] = {}
    bad = 0
    for k, v in entries.items():
        if isinstance(k, str) and isinstance(v, dict) \
                and isinstance(v.get("config"), dict):
            good[k] = v
        else:
            bad += 1
    if bad:
        warnings.warn(f"paddle_tpu_torch.tuner: dropped {bad} malformed "
                      f"entr{'y' if bad == 1 else 'ies'} from {path}")
    return good


_COMMITTED: Optional[Dict[str, Dict[str, Any]]] = None


def _committed_table() -> Dict[str, Dict[str, Any]]:
    """The committed defaults table, loaded once a process."""
    global _COMMITTED
    if _COMMITTED is None:
        _COMMITTED = _load_table(_DEFAULTS_FILE, "default-winners table")
    return _COMMITTED


def committed(key: str) -> Optional[Dict[str, Any]]:
    """The committed defaults table's config for ``key``, or None; the
    disk cache is not read."""
    hit = _committed_table().get(key)
    return None if hit is None else dict(hit.get("config", {}))


class WinnerStore:
    """Per-platform winner table: disk entries over committed defaults,
    loaded once, then every lookup is a dict.get."""

    def __init__(self, platform: str, directory: Optional[str] = None):
        self.platform = platform
        self.directory = directory or cache_dir()
        self.path = os.path.join(self.directory,
                                 f"winners-{platform}.json")
        self._lock = threading.Lock()
        self._entries: Optional[Dict[str, Dict[str, Any]]] = None
        self._defaults: Optional[Dict[str, Dict[str, Any]]] = None

    def _ensure_loaded(self) -> None:
        if self._entries is not None:
            return
        with self._lock:
            if self._entries is None:
                self._defaults = _committed_table()
                self._entries = _load_table(self.path, "tuning cache")

    def lookup(self, key: str) -> Optional[Dict[str, Any]]:
        """The winning config dict for ``key``, or None. Disk entries
        shadow the committed defaults."""
        self._ensure_loaded()
        hit = self._entries.get(key)
        if hit is None:
            hit = self._defaults.get(key)
        return None if hit is None else dict(hit.get("config", {}))

    def entry(self, key: str) -> Optional[Dict[str, Any]]:
        """Full entry (config + timing metadata), disk tier only."""
        self._ensure_loaded()
        e = self._entries.get(key)
        return None if e is None else dict(e)

    def record(self, key: str, config: Dict[str, Any],
               us: Optional[float] = None) -> None:
        """Persist a winner: update memory, then atomically rewrite the
        platform file (tmp + rename). I/O failures warn, never raise —
        tuning results are an optimization, not state."""
        self._ensure_loaded()
        entry: Dict[str, Any] = {"config": dict(config)}
        if us is not None:
            entry["us"] = float(us)
        with self._lock:
            self._entries[key] = entry
            payload = {"version": CACHE_VERSION, "platform": self.platform,
                       "entries": self._entries}
            tmp = self.path + ".tmp"
            try:
                os.makedirs(self.directory, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError as e:
                warnings.warn(f"paddle_tpu_torch.tuner: could not persist "
                              f"winner cache to {self.path}: {e}")
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def keys(self):
        self._ensure_loaded()
        return sorted(set(self._entries) | set(self._defaults))


_STORES: Dict[str, WinnerStore] = {}
_STORES_LOCK = threading.Lock()


def store_for(platform: str) -> WinnerStore:
    with _STORES_LOCK:
        st = _STORES.get(platform)
        if st is None or st.directory != cache_dir():
            st = WinnerStore(platform)
            _STORES[platform] = st
        return st


def _reset_for_tests() -> None:
    global _COMMITTED
    with _STORES_LOCK:
        _STORES.clear()
        _COMMITTED = None
