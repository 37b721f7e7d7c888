"""ctypes binding for the port's shared-memory ring
(``paddle_tpu_torch/csrc/shm_ring.cpp``), the ``DataLoader``'s transport
from its worker processes (counterpart of ``paddle_tpu/core/shm_ring.py``).

The library is built at first use with the system ``g++`` into
``build/paddle_tpu_torch/`` beside the package (a directory
``.gitignore`` lists), under a name carrying a hash of the source, so an
edited source rebuilds. Without a toolchain :func:`available` is False
and the ``DataLoader`` sends every batch through its queue, as the
reference's does. A ring reserves its memory when it is made
(``posix_fallocate``), so a ``/dev/shm`` too small for it fails there,
not in a worker's later write.

:meth:`ShmRing.pop_object` pops into one fresh NumPy byte array and
unpickles the arrays as views of it: one copy out of the ring.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "shm_ring.cpp"
_LIB = None
_BUILD_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return (_SRC.parent.parent.parent / "build" / "paddle_tpu_torch"
            / f"libshm_ring-{digest}.so")


def _build(so: Path):
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(tmp), str(_SRC), "-lrt", "-lpthread"], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.shm_ring_create.restype = ctypes.c_void_p
        lib.shm_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.shm_ring_open.restype = ctypes.c_void_p
        lib.shm_ring_open.argtypes = [ctypes.c_char_p]
        lib.shm_ring_push.restype = ctypes.c_int
        lib.shm_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int64]
        lib.shm_ring_pop.restype = ctypes.c_int
        lib.shm_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int64]
        lib.shm_ring_capacity.restype = ctypes.c_int64
        lib.shm_ring_capacity.argtypes = [ctypes.c_void_p]
        lib.shm_ring_used.restype = ctypes.c_int64
        lib.shm_ring_used.argtypes = [ctypes.c_void_p]
        lib.shm_ring_close.argtypes = [ctypes.c_void_p]
        lib.shm_ring_unlink.argtypes = [ctypes.c_char_p]
        _LIB = lib
        return lib


def available() -> bool:
    """True when the ring's library builds and loads (POSIX, g++)."""
    if os.name != "posix":
        return False
    try:
        _load()
        return True
    except Exception:
        return False


class ShmRing:
    """Single-producer single-consumer byte ring in POSIX shared memory."""

    def __init__(self, name: str, capacity: int = 64 << 20,
                 create: bool = True):
        self._lib = _load()
        self.name = name.encode()
        if create:
            self._base = self._lib.shm_ring_create(self.name, capacity)
        else:
            self._base = self._lib.shm_ring_open(self.name)
        if not self._base:
            raise OSError(f"shm_ring {'create' if create else 'open'} "
                          f"failed for {name} (capacity {capacity} B)")
        self._creator = create

    @property
    def capacity(self) -> int:
        return self._lib.shm_ring_capacity(self._base)

    def push_bytes(self, data, timeout_ms: int = 120_000):
        """Push a bytes-like object (copied straight from its buffer)."""
        arr = np.frombuffer(data, np.uint8)
        self._push(arr.ctypes.data, arr.size, arr.size, timeout_ms)

    def _push(self, ptr, n, total, timeout_ms):
        if total > self.capacity:
            raise ValueError(f"payload of {total}B exceeds ring "
                             f"capacity; raise DataLoader shm capacity")
        rc = self._lib.shm_ring_push(self._base, ptr, n, timeout_ms)
        if rc != 0:
            raise TimeoutError("shm_ring push timed out (consumer stalled)")

    def pop_bytes(self, n: int, timeout_ms: int = 120_000) -> bytes:
        return self._pop(n, timeout_ms).tobytes()

    def _pop(self, n: int, timeout_ms: int) -> np.ndarray:
        buf = np.empty(n, np.uint8)
        rc = self._lib.shm_ring_pop(self._base, buf.ctypes.data, n,
                                    timeout_ms)
        if rc != 0:
            raise TimeoutError("shm_ring pop timed out (producer stalled)")
        return buf

    # -- pickled-object transport (protocol-5 out-of-band buffers) ---------
    def push_object(self, obj, timeout_ms: int = 120_000) -> int:
        """Push ``obj`` and return the bytes pushed; the caller sends that
        count through its queue so the consumer knows how much to pop.
        The arrays' bytes are copied into the ring straight from their
        buffers, part after part (the consumer pops the whole message
        once every part is in)."""
        buffers = []
        payload = pickle.dumps(obj, protocol=5,
                               buffer_callback=buffers.append)
        parts = [np.frombuffer(payload, np.uint8)] + [
            np.frombuffer(b.raw(), np.uint8) for b in buffers]
        header = np.frombuffer(struct.pack(
            f"<{len(parts) + 1}q", len(parts), *(p.size for p in parts)),
            np.uint8)
        parts.insert(0, header)
        total = sum(p.size for p in parts)
        for p in parts:
            self._push(p.ctypes.data, p.size, total, timeout_ms)
        return total

    def pop_object(self, total: int, timeout_ms: int = 120_000):
        blob = self._pop(total, timeout_ms)
        mv = memoryview(blob)
        (n_parts,) = struct.unpack_from("<q", mv, 0)
        sizes = struct.unpack_from(f"<{n_parts}q", mv, 8)
        off = 8 + 8 * n_parts
        parts = []
        for s in sizes:
            parts.append(mv[off:off + s])
            off += s
        return pickle.loads(parts[0], buffers=parts[1:])

    def close(self):
        if self._base:
            self._lib.shm_ring_close(self._base)
            self._base = None
        if self._creator:
            self._lib.shm_ring_unlink(self.name)
            self._creator = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
