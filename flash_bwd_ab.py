#!/usr/bin/env python3
"""Time variants of the flash-attention backward kernels (B2 and B3)
against the repository's own, on one CUDA card.

    python3 flash_bwd_ab.py DIR [DIR ...]     # from the repository root

Each DIR holds a variant of ``paddle_tpu_torch/csrc``'s
``flash_attention_bwd_dq.cu``, ``flash_attention_bwd_dkv.cu`` and
``flash_bwd_mma.cuh`` (same C entry points). Every variant is built with
the repository's nvcc flags into DIR and run on the same inputs as the
repository's kernels: B=4, S=1024, H=16, D=128, causal, fp32 and bf16.
The script prints each variant's registers and spills, its largest
difference from the repository's result, its fp32 error against the same
formulas in float64 (max |err| / max |ref| for dQ, dK, dV, beside the
plain version's), and B2's and B3's device times taken in turns
(repository, variants, variants in reverse, repository), and the card's
name and power limit. It needs one card and exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

NAMES = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def build(kb, vdir: Path):
    """Compile the variant in vdir; returns its two libraries."""
    procs = []
    for name in NAMES:
        out = vdir / f"lib{name}.so"
        procs.append((name, out, subprocess.Popen(
            [kb.find_nvcc(), *kb.NVCC_FLAGS, "-o", str(out),
             str(vdir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{vdir}/{name}.cu failed to build:\n{log}")
        report(vdir.name, name, log)
        libs[name] = ctypes.CDLL(str(out))
    return libs


def report(tag, name, log):
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(tag, name, line.strip())


def entries(libs):
    dq = libs["flash_attention_bwd_dq"].pt_flash_attention_bwd_dq
    dkv = libs["flash_attention_bwd_dkv"].pt_flash_attention_bwd_dkv
    for fn, n_ptr, n_tail in ((dq, 7, 2), (dkv, 8, 3)):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_int] * n_tail + [ctypes.c_void_p])
    return dq, dkv


def runners(torch, fa, dq_fn, dkv_fn, q, k, v, do, lse, delta):
    """Closures launching one variant's B2 and B3 (causal) into its own
    outputs, and those outputs."""
    b, sq, h, d = q.shape
    code = fa._DTYPES[q.dtype]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    st_dq = fa._strides(q, k, v, do, dq)
    st_dkv = fa._strides(q, k, v, do, dk, dv)
    scale = 1.0 / d ** 0.5
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]

    def run_dq():
        if dq_fn(*ptrs, dq.data_ptr(), b, h, sq, k.shape[1], d, st_dq, scale,
                 1, code, code, stream):
            raise RuntimeError("B2 launch failed")

    def run_dkv():
        if dkv_fn(*ptrs, dk.data_ptr(), dv.data_ptr(), b, h, sq, k.shape[1],
                  d, st_dkv, scale, 1, code, code, code, stream):
            raise RuntimeError("B3 launch failed")

    return run_dq, run_dkv, (dq, dk, dv)


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import kernel_build as kb
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    kb.build_all(NAMES)
    for name in NAMES:
        report("repo", name, kb.BUILD_LOGS.get(name, ""))
    variants = {"repo": entries({n: kb.load(n) for n in NAMES})}
    for arg in sys.argv[1:]:
        variants[Path(arg).name] = entries(build(kb, Path(arg)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(4, 1024, 16, 128, generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = fa.attention_delta(out, do)
        runs = {n: runners(torch, fa, *f, q, k, v, do, lse, delta)
                for n, f in variants.items()}
        for run_dq, run_dkv, _ in runs.values():
            run_dq()
            run_dkv()
        torch.cuda.synchronize()
        ref = runs["repo"][2]
        for n, (_, _, outs) in runs.items():
            diff = [float((a.float() - r.float()).abs().max())
                    for a, r in zip(outs, ref)]
            print(f"{dt} {n} max |diff| vs repo (dq, dk, dv) {diff}")
        if dt == torch.float32:
            f64 = [x.double() for x in (q, k, v, do)]
            o64, l64 = fa.flash_attention_fwd_plain(*f64[:3], True)
            r64 = fa.flash_attention_bwd_plain(*f64[:3], o64, l64, f64[3],
                                               True)
            plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                                 delta=delta)

            def rel(got):
                return [f"{float((g.double() - r).abs().max() / r.abs().max()):.3e}"
                        for g, r in zip(got, r64)]
            print(f"fp32 plain vs float64 (dq, dk, dv) {rel(plain)}")
            for n, (_, _, outs) in runs.items():
                print(f"fp32 {n} vs float64 (dq, dk, dv) {rel(outs)}")
            del f64, o64, l64, r64, plain
        names = list(runs)
        times = {n: [] for n in names}
        for n in names + names[::-1]:
            run_dq, run_dkv, _ = runs[n]
            times[n].append((time_ms(torch, run_dq), time_ms(torch, run_dkv)))
        for n, t in times.items():
            print(f"{dt} {n} B2 ms {[round(x[0], 4) for x in t]} "
                  f"B3 ms {[round(x[1], 4) for x in t]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
