#!/usr/bin/env python3
"""Time variants of the kernels (flash forward B1, backward B2 and B3,
paged decode B4, greedy NMS B5) against the repository's own, on one CUDA
card.

    python3 flash_bwd_ab.py [--only flash|paged|nms ...] DIR [DIR ...]
                                              # from the repository root

Each DIR holds either a variant of some of ``paddle_tpu_torch/csrc``'s
``flash_attention_fwd.cu``, ``flash_attention_bwd_dq.cu`` and
``flash_attention_bwd_dkv.cu`` (same C entry points), with its own copy of
``flash_mma.cuh`` beside them, and/or of ``greedy_nms.cu`` (an edited
copy, e.g. another tile width), or a whole tree of another version of
the repository (a DIR holding ``paddle_tpu_torch/``, e.g. an older commit
unpacked with ``git archive``).

Flash kernels: every source a variant holds is built with the
repository's nvcc flags into DIR and run on the same inputs as the
repository's kernel: B=4, S=1024, H=16, D=128, causal, fp32 and bf16. The
script prints each variant's registers and spills, its largest difference
from the repository's result, its fp32 error against the same formulas in
float64 (max |err| / max |ref| for O and LSE, or dQ, dK and dV), and
each kernel's device times taken in turns
(repository, variants, variants in reverse, repository).

Paged decode B4, at ``chip_smoke.py``'s two B4 cases: the repository's
wrapper with its chunk rule at several ``BLOCKS_PER_SM``, and each tree's
own wrapper and kernel (imported from the tree under another name, built
there), each held to the plain version at 1e-4 and timed in alternating
rounds on the device's clock (median round), and the wrappers' host time a
call, also in alternating rounds.

Greedy NMS B5, at ``chip_smoke.py``'s main size (P=640 problems of
k=400 random boxes) in the cases of NMS_AB_CASES: eta 1; eta 0.9 at
threshold 0.45, which never adapts (the bitmask scan, as eta 1); eta 0.9
and 0.995 at thresholds in [0.55, 0.75], which take the per-candidate
votes of the adaptive path until the threshold falls to 0.5. The
repository's wrapper, each variant DIR's ``greedy_nms.cu`` and each
tree's own wrapper and kernel, each held to the plain version bit for
bit and timed in alternating rounds on the device's clock (median
round), beside the bound.

``--only`` runs the named sections alone (default: all three).

Every time is taken as ``chip_smoke.py`` takes it (``time_ms(spin=True)``:
CUDA events around calls queued behind a spin kernel). The script prints
the card's name and power limit, needs one card and exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

#: BLOCKS_PER_SM values of B4's chunk rule timed against each other
BLOCKS_PER_SM = (2, 4, 8, 16, 32)
#: host time rounds of B4's wrappers, and calls a round
HOST_ROUNDS = 5
HOST_CALLS = 100

#: B5's A/B cases at P=640, k=400: (name, kind of chip_smoke._nms_case,
#: eta)
NMS_AB_CASES = (("eta 1", "boxes", 1.0),
                ("eta 0.9 thr 0.45 (non-adaptive)", "boxes", 0.9),
                ("eta 0.9 thr 0.55-0.75 (adaptive)", "eta_cross", 0.9),
                ("eta 0.995 thr 0.55-0.75 (adaptive)", "eta_cross", 0.995))

#: each kernel's source name, pointer count and trailing dtype codes
KERNELS = {"flash_attention_fwd": ("pt_flash_attention_fwd", 5, 1),
           "flash_attention_bwd_dq": ("pt_flash_attention_bwd_dq", 7, 2),
           "flash_attention_bwd_dkv": ("pt_flash_attention_bwd_dkv", 8, 3)}
LABELS = {"flash_attention_fwd": "B1", "flash_attention_bwd_dq": "B2",
          "flash_attention_bwd_dkv": "B3"}


def build(kb, vdir: Path):
    """Compile the sources the variant in vdir holds; returns their
    libraries by name."""
    procs = []
    for name in (*KERNELS, "greedy_nms"):
        src = vdir / f"{name}.cu"
        if not src.is_file():
            continue
        out = vdir / f"lib{name}.so"
        procs.append((name, out, subprocess.Popen(
            [kb.find_nvcc(), *kb.NVCC_FLAGS, "-o", str(out), str(src)],
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
    """Each library's C entry point with its argtypes set."""
    out = {}
    for name, lib in libs.items():
        if name not in KERNELS:
            continue
        fn_name, n_ptr, n_tail = KERNELS[name]
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_int] * n_tail + [ctypes.c_void_p])
        out[name] = fn
    return out


def runners(torch, fa, fns, q, k, v, do, lse, delta):
    """{kernel name: (closure launching one variant's kernel (causal)
    into its own outputs, those outputs)}."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    code = fa._DTYPES[q.dtype]
    scale = 1.0 / d ** 0.5
    stream = torch.cuda.current_stream().cuda_stream
    ins = [x.data_ptr() for x in (q, k, v)]
    grads = [x.data_ptr() for x in (do, lse, delta)]
    out = {}
    for name, fn in fns.items():
        if name == "flash_attention_fwd":
            res = (torch.empty_like(q),
                   torch.empty(b, h, sq, device=q.device))
            st = fa._strides(q, k, v, res[0])
            args = (*ins, *(x.data_ptr() for x in res), b, h, sq, skv, d,
                    st, scale, 1, code, stream)
        elif name == "flash_attention_bwd_dq":
            res = (torch.empty_like(q),)
            st = fa._strides(q, k, v, do, res[0])
            args = (*ins, *grads, res[0].data_ptr(), b, h, sq, skv, d, st,
                    scale, 1, code, code, stream)
        else:
            res = (torch.empty_like(k), torch.empty_like(v))
            st = fa._strides(q, k, v, do, *res)
            args = (*ins, *grads, *(x.data_ptr() for x in res), b, h, sq,
                    skv, d, st, scale, 1, code, code, code, stream)

        def run(fn=fn, args=args, st=st, name=name):  # st: kept alive
            if fn(*args):
                raise RuntimeError(f"{LABELS[name]} launch failed")
        out[name] = (run, res)
    return out


def tree_module(root: Path, alias: str, name: str):
    """Module ``name`` (e.g. ``ops.custom``) of the tree at root, its
    package imported once as ``alias`` (its kernels build under root)."""
    import importlib
    import importlib.util
    if alias not in sys.modules:
        pkg = root / "paddle_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            alias, pkg / "__init__.py",
            submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[alias] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.{name}")


def nms_runner(torch, lib, name):
    """A variant's B5 library as a function of (iou, valid, thr, eta)
    like the wrapper."""
    fn = lib.pt_greedy_nms
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_void_p])

    def run(iou, valid, thr, eta):
        kept = torch.empty(valid.shape, dtype=torch.int32, device="cuda")
        code = fn(iou.data_ptr(), valid.data_ptr(), thr.data_ptr(),
                  kept.data_ptr(), valid.shape[0], valid.shape[1], eta,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"B5 {name}: CUDA error {code}")
        return kept
    return run


def nms_design_bytes(torch, valid, kept, tile):
    """Bytes B5 reads at tile width ``tile`` for this data: every kept
    row's columns after its tile, every valid row's upper triangle of its
    tile's diagonal block, valid and thr in, kept out."""
    p_n, k = valid.shape
    idx = torch.arange(k, device=valid.device)
    tile_end = torch.clamp((idx // tile + 1) * tile, max=k)
    folds = int(((kept != 0) * (k - tile_end)).sum())
    diag = int(((valid != 0) * (tile_end - idx - 1)).sum())
    return 4 * folds, 4 * diag, 2 * p_n * k * 4 + p_n * 4


def nms_ab(torch, cs, variants, trees):
    """B5: the repository's wrapper against each variant's (name: function
    of (iou, valid, thr, eta)) and each tree's wrapper, at chip_smoke's
    main size in each case of NMS_AB_CASES."""
    from paddle_tpu_torch.ops import custom
    from paddle_tpu_torch.ops import detection as det_mod
    fns = {"repo": custom.greedy_nms, **variants}
    for i, (name, root) in enumerate(trees.items()):
        fns[name] = tree_module(root, f"ab_tree_{i}", "ops.custom").greedy_nms
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    for case, kind, eta in NMS_AB_CASES:
        iou, valid, thr = cs._nms_case(torch, det_mod, gen, 640, 400, kind)
        ref = custom.greedy_nms_plain(iou, valid, thr, eta)
        runs = {}
        for n, fn in fns.items():
            try:
                kept = fn(iou, valid, thr, eta)
                torch.cuda.synchronize()
            except RuntimeError as e:     # e.g. shared memory refused
                print(f"B5 {case} {n}: does not run: {e}")
                continue
            mism = int((kept != ref).sum())
            print(f"B5 {case} {n}: {mism} mismatches against the plain "
                  f"version")
            if mism:
                raise RuntimeError(f"B5 {n} disagrees with the plain "
                                   f"version")
            runs[n] = (lambda fn=fn, eta=eta, x=(iou, valid, thr):
                       fn(*x, eta))
        med, per = cs.time_rounds(torch, runs)
        bms, full = cs.nms_bound(torch, valid, ref)
        for n in runs:
            print(f"B5 {case} {n} device ms median {med[n]:.4f} rounds "
                  f"{[round(x, 4) for x in per[n]]} (bound {bms:.4f} ms; "
                  f"every matrix whole {full:.4f} ms; "
                  f"{int(ref.sum()) / ref.shape[0]:.1f} kept a problem)")
        for tile in (32, 64, 128):
            folds, diag, io = nms_design_bytes(torch, valid, ref, tile)
            print(f"B5 {case} reads at T={tile}: {folds / 1e6:.1f} MB of "
                  f"kept rows after their tile + {diag / 1e6:.1f} MB of "
                  f"diagonal triangles + {io / 1e6:.1f} MB in/out = "
                  f"{(folds + diag + io) / cs.PEAK_BYTES * 1e3:.4f} ms at "
                  f"{cs.PEAK_BYTES / 1e12:.2f} TB/s")
        idx = torch.arange(valid.shape[1], device=valid.device)
        strips = 4 * int(((valid != 0) * (valid.shape[1] - idx - 1)).sum())
        print(f"B5 {case} reads prefetching whole upper strips: "
              f"{strips / 1e6:.1f} MB of valid rows after the row = "
              f"{strips / cs.PEAK_BYTES * 1e3:.4f} ms")
        if kind == "boxes" and eta == 1.0:
            one = [x[:torch.cuda.get_device_properties(0)
                     .multi_processor_count].contiguous()
                   for x in (iou, valid, thr)]
        del iou, valid, thr, ref, runs
    # one problem an SM: the chain of one problem, without the others'
    # loads on its SM
    ms = cs.time_ms(lambda: custom.greedy_nms(*one), spin=True)
    print(f"B5 eta 1 repo at P={one[1].shape[0]} (one problem an SM) "
          f"device ms {ms:.4f}")


def paged_ab(torch, cs, trees):
    """B4: the repository's chunk rule at each of BLOCKS_PER_SM and each
    tree's wrapper, against each other at chip_smoke's B4 cases."""
    from paddle_tpu_torch.ops import paged_attention as pa
    mods = {"repo": pa}
    for i, (name, root) in enumerate(trees.items()):
        mods[name] = tree_module(root, f"ab_tree_{i}",
                                 "ops.paged_attention")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    q, kb, vb, bt = cs.paged_case(torch, gen)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    default = pa.BLOCKS_PER_SM
    for n in BLOCKS_PER_SM:
        pa.BLOCKS_PER_SM = n
        chunk = pa.chunk_pages_for(bt.shape[1], q.shape[0] * q.shape[1],
                                   n_sms)
        print(f"B4 repo {n} blocks/SM: {chunk} pages a chunk of "
              f"{bt.shape[1]}, {n_sms} SMs")
    pa.BLOCKS_PER_SM = default

    def at(bps, positions):
        def run():
            pa.BLOCKS_PER_SM = bps
            try:
                return pa.paged_attention(q, kb, vb, bt, positions)
            finally:
                pa.BLOCKS_PER_SM = default
        return run

    for case, pos in cs.PAGED_CASES:
        positions = torch.tensor(pos, dtype=torch.int32, device="cuda")
        fns = {f"repo {n} blocks/SM": at(n, positions)
               for n in BLOCKS_PER_SM}
        wrappers = {}       # each tree's wrapper as a user calls it
        for name, mod in mods.items():
            wrappers[name] = (lambda mod=mod: mod.paged_attention(
                q, kb, vb, bt, positions))
            if name != "repo":
                fns[name] = wrappers[name]
        ref = pa.paged_attention_plain(q, kb, vb, bt, positions)
        for n, fn in fns.items():
            out, again = fn(), fn()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            print(f"B4 {case} {n}: max_abs_err {err:.3e}, two launches "
                  f"bitwise equal {torch.equal(out, again)}")
            if err > cs.TOL["fp32"]:
                raise RuntimeError(f"B4 {case} {n} disagrees with the plain "
                                   f"version")
        med, per = cs.time_rounds(torch, fns)
        bms, by, rows = cs.paged_bound(torch, q, kb, bt, positions)
        for n in fns:
            print(f"B4 {case} {n} device ms median {med[n]:.4f} rounds "
                  f"{[round(x, 4) for x in per[n]]} (bound {bms:.4f} ms, "
                  f"{by}, {rows} rows)")
        host = {n: [] for n in wrappers}
        for r in range(HOST_ROUNDS):
            for n in (list(wrappers) if r % 2 == 0 else list(wrappers)[::-1]):
                host[n].append(cs.host_time_ms(wrappers[n], HOST_CALLS))
        for n, t in host.items():
            print(f"B4 {case} {n} wrapper host ms a call median "
                  f"{statistics.median(t):.4f} rounds "
                  f"{[round(x, 4) for x in t]}")


def float64_refs(fa, q, k, v, do):
    """The forward's (O, LSE) and the backward's (dQ, dK, dV) in float64."""
    f64 = [x.double() for x in (q, k, v, do)]
    o64, l64 = fa.flash_attention_fwd_plain(*f64[:3], True)
    grads = fa.flash_attention_bwd_plain(*f64[:3], o64, l64, f64[3], True)
    return {"flash_attention_fwd": (o64, l64),
            "flash_attention_bwd_dq": grads[:1],
            "flash_attention_bwd_dkv": grads[1:]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import kernel_build as kb
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append",
                    choices=("flash", "paged", "nms"))
    ap.add_argument("dirs", nargs="*")
    args = ap.parse_args()
    wanted = (lambda section: not args.only or section in args.only)
    kb.build_all()
    for name in KERNELS:
        report("repo", name, kb.BUILD_LOGS.get(name, ""))
    report("repo", "greedy_nms", kb.BUILD_LOGS.get("greedy_nms", ""))
    variants = {"repo": entries({n: kb.load(n) for n in KERNELS})}
    nms_variants = {}
    trees = {}
    for arg in args.dirs:
        name = Path(arg).name
        if (Path(arg) / "paddle_tpu_torch").is_dir():
            trees[name] = Path(arg)
            continue
        libs = build(kb, Path(arg))
        variants[name] = entries(libs)
        if "greedy_nms" in libs:
            nms_variants[name] = nms_runner(torch, libs["greedy_nms"], name)
    if wanted("nms"):
        nms_ab(torch, cs, nms_variants, trees)
    if wanted("paged"):
        paged_ab(torch, cs, trees)
    if not wanted("flash"):
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(4, 1024, 16, 128, generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = fa.attention_delta(out, do)
        runs = {n: runners(torch, fa, f, q, k, v, do, lse, delta)
                for n, f in variants.items()}
        for rs in runs.values():
            for run, _ in rs.values():
                run()
        torch.cuda.synchronize()
        refs64 = float64_refs(fa, q, k, v, do) if dt == torch.float32 \
            else None
        for name in KERNELS:
            ref = runs["repo"][name][1]
            for n, rs in runs.items():
                if name not in rs:
                    continue
                outs = rs[name][1]
                diff = [float((a.float() - r.float()).abs().max())
                        for a, r in zip(outs, ref)]
                line = f"{dt} {LABELS[name]} {n} max |diff| vs repo {diff}"
                if refs64 is not None:
                    rel = [float((g.double() - r).abs().max()
                                 / r.abs().max())
                           for g, r in zip(outs, refs64[name])]
                    line += f" vs float64 {[f'{x:.3e}' for x in rel]}"
                print(line)
        for name in KERNELS:
            names = [n for n, rs in runs.items() if name in rs]
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                times[n].append(cs.time_ms(runs[n][name][0], spin=True))
            for n, t in times.items():
                print(f"{dt} {LABELS[name]} {n} ms "
                      f"{[round(x, 4) for x in t]}")
        del runs, refs64
    return 0


if __name__ == "__main__":
    sys.exit(main())
