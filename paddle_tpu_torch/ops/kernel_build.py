"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own with ``nvcc`` for ``sm_90a`` into ``build/paddle_tpu_torch/`` beside
the package (a directory ``.gitignore`` lists). The output name carries a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import: the first wrapper
that launches a kernel calls :func:`load`, which builds every missing
library in parallel (one ``nvcc`` per source, all started together) and
then loads the one it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

#: the kernels of the port, by source name under ``csrc/``
KERNEL_SOURCES = ("flash_attention_fwd", "paged_attention")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_PKG_DIR = Path(__file__).resolve().parent.parent
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: the compiler output (``-Xptxas -v`` register and shared-memory report)
#: of each library built by this process
BUILD_LOGS: Dict[str, str] = {}


def csrc_path(name: str) -> Path:
    return _PKG_DIR / "csrc" / f"{name}.cu"


def build_dir() -> Path:
    return _PKG_DIR.parent / "build" / "paddle_tpu_torch"


def library_path(name: str) -> Path:
    h = hashlib.sha256(csrc_path(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """``nvcc`` from PyTorch's CUDA_HOME, else from ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither under torch's CUDA_HOME nor on PATH); "
            "the CUDA kernels of paddle_tpu_torch cannot be built")
    return found


def build_all(names=KERNEL_SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once; returns the wall seconds spent. Raises
    with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    try:
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc_path(name))]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building the kernels
    first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err_fn: str, code: int, what: str):
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        fn = getattr(lib, err_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        msg: Optional[bytes] = fn(code)
        raise RuntimeError(
            f"{what}: CUDA error {code} ({(msg or b'?').decode()})")
