"""Sharded checkpoint format: shard archives + JSON metadata
(counterpart of ``paddle_tpu/incubate/checkpoint/sharded.py``).

Layout of a checkpoint directory, the JAX package's, so each package
loads the other's checkpoints::

    ckpt/
      metadata_<proc>.json   # format 2 doc (below)
      shards_<proc>.npz      # "<key>|<i>" -> shard ndarray
      scalars.json           # non-array leaves (ints, floats, strings)
      health.json            # optional health stamp (the sentinel's)

``metadata_<proc>.json`` (format 2) is ``{"format": 2, "checksums":
{"shards_<proc>.npz": "<sha256>"}, "entries": {key: {shape, dtype,
spec, shards}}}``; format-1 checkpoints (a bare ``{key: entry}`` map, no
checksums) still load, and format 3 (``async_ckpt``'s atomic commit)
adds a ``"health"`` doc. The checksum is verified on load: a flipped bit
or a truncated archive raises :class:`CheckpointIntegrityError`.

The port is one process on one card: every tensor is written whole as
shard 0 with the slice index a single-device JAX array has (``[None]``
per axis) and ``spec`` null, under process index 0. A ``torch.distributed``
world larger than one, and ``load_sharded(mesh=...)``, raise naming
ROADMAP A10's second slice (mesh checkpoints and multi-process
commits). On load, a multi-shard
archive a JAX mesh wrote is reassembled from its slice indices, as the
JAX package does.

Two-byte types: NumPy has no bfloat16, and the JAX package's archives
hold each bfloat16 array as raw 2-byte blobs (``|V2``) with ``"dtype":
"bfloat16"`` in the metadata. The port writes bfloat16 the same way and
reads any 2-byte blob by the metadata's dtype as a bit view
(``torch.bfloat16``, ``torch.float16``), never by a numeric cast. (The
JAX package's own loader cannot read its bfloat16 archives back: it
assigns the blob into ``np.zeros(shape, "bfloat16")``, which NumPy
refuses; ROADMAP C11.)

A loaded tensor lands on ``device`` (by default the port's device, which
is CUDA unless the caller asks for the CPU); the restore walks
(``TrainEpochRange``, ``CheckpointRollback``) load onto the host and
copy into the live tensors in place, so a captured program reads the
restored state.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core.device import DeviceLike, resolve_device
from ...core.tensor import Tensor
from ...observability import tracer as _otrace
from ...utils.resilience import fault_injector


#: Suffix of the staging directory the atomic commit protocol
#: (``async_ckpt``) writes into before its single ``os.replace`` publish.
#: Every reader treats ``*.tmp`` paths as invisible (uncommitted).
STAGING_SUFFIX = ".tmp"

#: Suffix of the directory a publish parks the previous commit of the same
#: path under while it swaps the new one in; readers skip ``*.old`` dirs,
#: and ``cleanup_stale_staging`` renames one back after a crash in the
#: swap window.
OLD_SUFFIX = ".old"

#: the metadata's name of each torch type whose NumPy type has another
#: name, or none
_TORCH_NAMES = {torch.bfloat16: "bfloat16"}


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint directory is torn: checksum mismatch or a shard archive
    referenced by metadata is missing."""


def _sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _flatten(tree, prefix=""):
    """Nested dict/list -> {joined_key: leaf}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def _process_index() -> int:
    """0: the port commits from one process. A larger ``torch.distributed``
    world would need the JAX package's per-host files and barrier."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "checkpoints from a torch.distributed world of "
            f"{dist.get_world_size()} processes (per-process shard files, "
            "the cooperative commit) are ROADMAP A10's second slice; the "
            "port commits "
            "from one process")
    return 0


def _raw(val):
    return val._data if isinstance(val, Tensor) else val


def _is_scalar(raw) -> bool:
    return isinstance(raw, (int, float, str, bool, type(None)))


def _dtype_name(t: torch.Tensor) -> str:
    return _TORCH_NAMES.get(t.dtype) or str(t.dtype).split(".", 1)[1]


def _host_blob(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the array the JAX package's archive holds: its
    NumPy array, or for bfloat16 raw 2-byte blobs (``|V2``)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def _entry(key: str, shape, dtype_name: str) -> Dict[str, Any]:
    """Metadata entry of a whole (one-shard) array: the slice index a
    single-device JAX array has (null for a 0-d one, as for the JAX
    package's NumPy scalars), no spec."""
    index = [None] * len(shape) if len(shape) else None
    return {"shape": list(shape), "dtype": dtype_name, "spec": None,
            "shards": [{"blob": f"{key}|0", "index": index}]}


def _materialize_host(flat: Dict[str, Any]):
    """flat {key: leaf} with every tensor on the host -> (metadata
    entries, shard blobs, scalars)."""
    meta: Dict[str, Any] = {}
    blobs: Dict[str, np.ndarray] = {}
    scalars: Dict[str, Any] = {}
    for key, raw in flat.items():
        raw = _raw(raw)
        if _is_scalar(raw):
            scalars[key] = raw
            continue
        if isinstance(raw, torch.Tensor):
            t = raw.detach()
            if t.device.type != "cpu":
                t = t.cpu()
            arr, name = _host_blob(t), _dtype_name(t)
        else:
            arr = np.asarray(raw)
            name = str(arr.dtype)
        meta[key] = _entry(key, arr.shape, name)
        blobs[f"{key}|0"] = arr
    return meta, blobs, scalars


def save_sharded(state, path: str, overwrite: bool = True):
    """Write ``state`` (nested dict/list of tensors, Tensors, arrays and
    scalars) as a checkpoint directory. Device tensors are copied to the
    host here, on the caller's thread (``AsyncSaver`` and
    ``AsyncCheckpointer`` move that off the step path)."""
    with _otrace.span("checkpoint/save", {"path": path}):
        return _save_sharded_impl(state, path, overwrite)


def _save_sharded_impl(state, path: str, overwrite: bool):
    os.makedirs(path, exist_ok=True)
    proc = _process_index()
    meta, shard_blobs, scalars = _materialize_host(_flatten(state))
    tmp = os.path.join(path, f".tmp_shards_{proc}.npz")
    np.savez(tmp, **shard_blobs)
    shards_name = f"shards_{proc}.npz"
    os.replace(tmp, os.path.join(path, shards_name))
    # fault site "save": a crash here leaves shard archives without
    # metadata, the torn-checkpoint shape a restore must survive
    fault_injector().fire("save")
    doc = {"format": 2,
           "checksums": {shards_name: _sha256_of(
               os.path.join(path, shards_name))},
           "entries": meta}
    mtmp = os.path.join(path, f".tmp_metadata_{proc}.json")
    with open(mtmp, "w") as f:
        json.dump(doc, f)
    os.replace(mtmp, os.path.join(path, f"metadata_{proc}.json"))
    if proc == 0:
        stmp = os.path.join(path, f".tmp_scalars_{os.getpid()}.json")
        with open(stmp, "w") as f:
            json.dump(scalars, f)
        os.replace(stmp, os.path.join(path, "scalars.json"))


def _corrupt_first_shard_file(path: str):
    """FaultInjector ``load:N:corrupt`` action: flip one byte near the end
    of the first shard archive (a deterministic torn checkpoint)."""
    for fn in sorted(os.listdir(path)):
        if fn.startswith("shards_") and fn.endswith(".npz"):
            full = os.path.join(path, fn)
            with open(full, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                byte = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([byte[0] ^ 0xFF]))
            return


def verify_checkpoint(path: str):
    """Checksum-verify a checkpoint directory without loading it.

    Raises :class:`CheckpointIntegrityError` when a shard archive referenced
    by a format-2/3 metadata file is missing or fails its sha256 (format 1,
    without checksums, gets the existence check only), when the directory
    has shard archives but no metadata (a save that died between the two
    writes), when a host's shard archive lacks its ``metadata_<proc>.json``
    (its slices would restore as zeros), and when a metadata file is not
    parsable JSON."""
    if not os.path.isdir(path):
        raise CheckpointIntegrityError(f"{path} is not a directory")
    names = os.listdir(path)
    meta_files = [n for n in names if n.startswith("metadata_")
                  and n.endswith(".json")]
    shard_files = [n for n in names if n.startswith("shards_")
                   and n.endswith(".npz")]
    if not meta_files:
        raise CheckpointIntegrityError(
            f"{path}: no metadata_*.json "
            f"({'shards present — torn save' if shard_files else 'empty'})")
    meta_procs = {n[len("metadata_"):-len(".json")] for n in meta_files}
    orphan_shards = sorted(
        n for n in shard_files
        if n[len("shards_"):-len(".npz")] not in meta_procs)
    if orphan_shards:
        raise CheckpointIntegrityError(
            f"{path}: shard archive(s) without a committing manifest: "
            f"{', '.join(orphan_shards)} (a host died between its shard "
            f"write and its metadata commit — slices owned by that host "
            f"would restore as zeros)")
    for fn in sorted(meta_files):
        try:
            with open(os.path.join(path, fn)) as f:
                m = json.load(f)
        except ValueError as e:
            raise CheckpointIntegrityError(
                f"{path}: {fn} is not parsable JSON ({e})") from e
        proc = fn[len("metadata_"):-len(".json")]
        expect = (m.get("checksums", {}) if m.get("format") in (2, 3)
                  else {f"shards_{proc}.npz": None})
        for shards_name, digest in expect.items():
            full = os.path.join(path, shards_name)
            if not os.path.exists(full):
                raise CheckpointIntegrityError(
                    f"{path}: {fn} references missing {shards_name}")
            if digest is not None and _sha256_of(full) != digest:
                raise CheckpointIntegrityError(
                    f"{path}: checksum mismatch for {shards_name} "
                    f"(expected {digest[:12]}…)")


#: Health-stamp sidecar the numerical-anomaly sentinel writes beside the
#: shard and metadata files. Checksums say the bytes are intact; the stamp
#: says the state was numerically sane when saved. No stamp reads healthy.
HEALTH_STAMP_FILE = "health.json"


def write_health_stamp(path: str, healthy: bool, step: Optional[int] = None,
                       reason: Optional[str] = None):
    """Write (or overwrite) the health stamp of checkpoint dir ``path``,
    through a per-process ``.tmp_`` file and ``os.replace``, so a crash
    mid-write leaves the previous stamp and its debris is swept by
    ``cleanup_stale_staging``."""
    stamp = {"healthy": bool(healthy), "time": time.time()}
    if step is not None:
        stamp["step"] = int(step)
    if reason is not None:
        stamp["reason"] = str(reason)
    final = os.path.join(path, HEALTH_STAMP_FILE)
    tmp = os.path.join(path, f".tmp_health_{os.getpid()}.json")
    with open(tmp, "w") as f:
        json.dump(stamp, f)
    os.replace(tmp, final)


def read_health_stamp(path: str) -> Dict[str, Any]:
    """The health stamp of checkpoint dir ``path``: the ``health.json``
    sidecar (rewritable, so a later ``mark_unhealthy`` wins), else the
    ``health`` doc of format-3 metadata, else ``{"healthy": True}``."""
    full = os.path.join(path, HEALTH_STAMP_FILE)
    try:
        with open(full) as f:
            stamp = json.load(f)
    except (OSError, ValueError):
        stamp = _manifest_health(path)
    if not isinstance(stamp, dict):
        return {"healthy": True}
    stamp.setdefault("healthy", True)
    return stamp


def _manifest_health(path: str) -> Dict[str, Any]:
    """Health doc embedded in a format-3 metadata file, else healthy."""
    try:
        names = os.listdir(path)
    except OSError:
        return {"healthy": True}
    for fn in sorted(names):
        if not (fn.startswith("metadata_") and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(path, fn)) as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(m, dict) and isinstance(m.get("health"), dict):
            return dict(m["health"])
    return {"healthy": True}


def _is_checkpoint_dir(path: str) -> bool:
    # *.tmp staging and *.old parked dirs are never restorable
    stripped = path.rstrip(os.sep)
    if stripped.endswith(STAGING_SUFFIX) or stripped.endswith(OLD_SUFFIX):
        return False
    try:
        names = os.listdir(path)
    except OSError:
        return False
    return any(n.startswith("metadata_") and n.endswith(".json")
               for n in names)


def swap_eligible(path: str, verify: bool = True):
    """May ``path`` be rolled onto live serving replicas? ``(ok, reason)``,
    never raises: a committed checkpoint dir (not staging or parked), a
    healthy stamp and, with ``verify``, intact checksums."""
    if not _is_checkpoint_dir(path):
        return False, (
            f"{path} is not a committed checkpoint directory (staging/"
            f"parked dirs and metadata-less paths are never eligible)")
    stamp = read_health_stamp(path)
    if not stamp.get("healthy", True):
        return False, (
            f"{path} is stamped unhealthy"
            + (f" ({stamp['reason']})" if stamp.get("reason") else ""))
    if verify:
        try:
            verify_checkpoint(path)
        except CheckpointIntegrityError as e:
            return False, f"{path} failed checksum verification: {e}"
    return True, "eligible"


def newest_healthy_checkpoint(root: str,
                              verify: bool = True) -> Optional[str]:
    """The newest checkpoint under ``root`` (itself a checkpoint dir, or a
    dir of them) that is stamped healthy and, with ``verify``, passes the
    checksum sweep; ordered by the number at the end of the name, then
    mtime. Skipped candidates warn. None when nothing survives."""
    import re
    import warnings
    if _is_checkpoint_dir(root):
        cands = [root]
    else:
        try:
            names = sorted(os.listdir(root))
        except OSError:
            return None
        cands = [os.path.join(root, n) for n in names
                 if _is_checkpoint_dir(os.path.join(root, n))]

    def _order(p):
        m = re.search(r"(\d+)$", os.path.basename(p.rstrip(os.sep)))
        step = int(m.group(1)) if m else -1
        try:
            mtime = os.path.getmtime(p)
        except OSError:
            mtime = 0.0
        return (step, mtime)

    for cand in sorted(cands, key=_order, reverse=True):
        stamp = read_health_stamp(cand)
        if not stamp.get("healthy", True):
            warnings.warn(
                f"skipping checkpoint {cand}: health stamp says unhealthy"
                f" ({stamp.get('reason', 'no reason recorded')})")
            continue
        if verify:
            try:
                verify_checkpoint(cand)
            except CheckpointIntegrityError as e:
                warnings.warn(f"skipping checkpoint {cand}: {e}")
                continue
        return cand
    return None


def _meta_entries(m):
    """Entries map from a format-2/3 doc or a legacy format-1 bare map."""
    if isinstance(m, dict) and m.get("format") in (2, 3):
        return m["entries"]
    return m


def _container(dtype_name: str) -> np.dtype:
    """The NumPy type that holds an array of ``dtype_name``'s bits."""
    return np.dtype(np.int16) if dtype_name == "bfloat16" \
        else np.dtype(dtype_name)


def _bits(data: np.ndarray, container: np.dtype) -> np.ndarray:
    """A blob in ``container``'s type: a raw 2-byte blob by bit view."""
    if data.dtype.kind == "V":
        return data.view(container)
    return data


def _to_torch(full: np.ndarray, dtype_name: str) -> torch.Tensor:
    if not full.flags.c_contiguous or not full.flags.writeable:
        full = full.copy()
    t = torch.from_numpy(full)
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def load_sharded(path: str, mesh=None, return_tensor: bool = True,
                 verify: bool = True, *, device: DeviceLike = None):
    """Load a checkpoint directory, reassembling each array from every
    archive's shards by its slice index, onto ``device``: ``Tensor``s
    (``return_tensor``) or torch tensors, in the saved nesting, scalars
    as saved. ``verify=True`` checksum-verifies every shard archive first
    and raises :class:`CheckpointIntegrityError` on a torn checkpoint.
    ``mesh`` (re-sharding onto a mesh) is ROADMAP A10's second slice."""
    if mesh is not None:
        raise NotImplementedError(
            "load_sharded(mesh=...): re-sharding onto a device mesh is "
            "ROADMAP A10's second slice; the port loads whole tensors "
            "onto one device")
    dev = resolve_device(device)
    with _otrace.span("checkpoint/load", {"path": path}):
        return _load_sharded_impl(path, dev, return_tensor, verify)


def _load_sharded_impl(path: str, dev, return_tensor: bool, verify: bool):
    if fault_injector().fire("load") == "corrupt":
        _corrupt_first_shard_file(path)
    if verify:
        verify_checkpoint(path)

    metas = {}
    for fn in sorted(os.listdir(path)):
        if fn.startswith("metadata_"):
            with open(os.path.join(path, fn)) as f:
                m = json.load(f)
            proc = fn[len("metadata_"):-len(".json")]
            for k, v in _meta_entries(m).items():
                metas.setdefault(k, []).append((proc, v))
    blobs = {}
    for fn in sorted(os.listdir(path)):
        if fn.startswith("shards_") and fn.endswith(".npz"):
            proc = fn[len("shards_"):-len(".npz")]
            with np.load(os.path.join(path, fn)) as z:
                for k in z.files:
                    blobs[(proc, k)] = z[k]

    flat: Dict[str, Any] = {}
    for key, entries in metas.items():
        shape = tuple(entries[0][1]["shape"])
        dtype_name = entries[0][1]["dtype"]
        container = _container(dtype_name)
        full = np.zeros(shape, dtype=container) if shape else None
        for proc, e in entries:
            for sh in e["shards"]:
                data = _bits(blobs[(proc, sh["blob"])], container)
                if sh["index"] is None or not shape:
                    full = data
                    continue
                sl = tuple(slice(None) if s is None else slice(s[0], s[1])
                           for s in sh["index"])
                full[sl] = data
        t = _to_torch(np.asarray(full).reshape(shape), dtype_name).to(dev)
        flat[key] = Tensor(t) if return_tensor else t

    scalars_path = os.path.join(path, "scalars.json")
    if os.path.exists(scalars_path):
        with open(scalars_path) as f:
            flat.update(json.load(f))
    return _unflatten(flat)


class AsyncSaver:
    """Asynchronous checkpointing: ``save`` takes an owned snapshot of the
    state (``async_ckpt.snapshot``: device copies on the current stream,
    no host sync) and the host copy and file write run on a background
    thread, so the training loop keeps stepping while a later in-place
    update cannot reach what is written."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error = None

    def save(self, state, path: str, on_done=None):
        from .async_ckpt import _host_flat, snapshot
        self.wait()
        snap = snapshot(state)

        def run():
            try:
                save_sharded(_unflatten(_host_flat(snap)), path)
                if on_done is not None:
                    on_done()
            except Exception as e:  # surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
