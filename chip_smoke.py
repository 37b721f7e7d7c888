#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and time kernel, plain version and,
   where one exists, the single PyTorch call computing the same function;
3. the main path, part one: GPT-3 1.3B (``GPTForCausalLM``, full width,
   random weights from a seed) forward on a [4, 1024] batch through the
   flash kernel, held against the same model's dense attention;
4. the main path, part two: the paged ``LLMEngine`` serving 8 greedy
   requests of 32 new tokens;
5. checks and timings off the main path: the forward's device time with
   flash and with dense attention, one decode step's logits, kernel lane
   against gather lane, on one cache state, and torch.profiler breakdowns
   of a forward and of a decode step (device busy share, time by kernel).

Every launch count is set to 0 just before phase 3 and read after phase
4. The last two lines are a ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# GPT-3 1.3B (the repository's flagship serving and training config)
CFG_13B = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
               num_heads=16, intermediate_size=4 * 2048,
               max_position_embeddings=1024, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)

# H100 SXM published peaks (dense): fp32 without tensor cores, bf16 tensor
# cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

#: prompt lengths of the 8 serving requests
PROMPT_LENS = [17, 64, 129, 255, 400, 513, 777, 900]

TOL = {"fp32": 1e-4, "bf16": 2e-2}     # max abs error, kernel vs plain
LOGIT_TOL = 2e-3                       # flash vs dense, and kernel vs gather


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
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


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def bound(flops, nbytes, peak_flops):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash(torch, fa_mod, gen):
    """B1 against its plain version at B=4, S=1024, H=16, D=128, plus the
    odd length and Sq != Skv cases. Returns the summary row for the main
    path's case (fp32, causal, S=1024)."""
    fa = fa_mod.flash_attention_fwd
    plain = fa_mod.flash_attention_fwd_plain
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, d = 4, 16, 128
    cases = [("fp32", torch.float32, 1024, 1024, True),
             ("fp32", torch.float32, 1024, 1024, False),
             ("bf16", torch.bfloat16, 1024, 1024, True),
             ("bf16", torch.bfloat16, 1024, 1024, False),
             ("fp32", torch.float32, 1000, 1000, True),
             ("fp32", torch.float32, 512, 1024, True),
             ("fp32", torch.float32, 1024, 640, False)]
    row = None
    for name, dt, sq, skv, causal in cases:
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, skv, h, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, skv, h, d, generator=gen, device="cuda").to(dt)
        out, lse = fa(q, k, v, causal=causal)
        ref, ref_lse = plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = err <= TOL[name] and lse_err <= TOL["fp32"] \
            and bool(torch.isfinite(out.float()).all())
        ms = time_ms(lambda: fa(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: plain(q, k, v, causal=causal), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # SDPA's causal mask is top-left aligned, as the kernel's
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
        if causal:
            pairs = sum(min(i + 1, skv) for i in range(sq))
        else:
            pairs = sq * skv
        flops = 4.0 * d * pairs * b * h
        elem = q.element_size()
        nbytes = (2 * sq + 2 * skv) * b * h * d * elem + 4 * b * h * sq
        bms, by = bound(flops, nbytes,
                        PEAK_FP32 if dt == torch.float32 else PEAK_BF16)
        log(f"B1 flash {name} Sq={sq} Skv={skv} causal={causal}: "
            f"max_abs_err O {err:.3e} LSE {lse_err:.3e} "
            f"(tol {TOL[name]:.0e}/{TOL['fp32']:.0e}) kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
            f"bound {bms:.4f} ms ({by})")
        if not ok:
            raise RuntimeError(f"flash kernel disagrees with its plain "
                               f"version ({name}, Sq={sq}, Skv={skv})")
        if row is None:
            row = {"max_abs_err": max(err, lse_err), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "library_ms": lib_ms, "tolerance": TOL[name],
                   "shape": f"B={b} S={sq} H={h} D={d} fp32 causal"}
        del q, k, v, out, lse, ref, ref_lse
    return row


def check_paged(torch, pa_mod, gen):
    """B4 against its plain version: 8 sequences, H=16, D=128, page 16,
    64 pages per sequence, block tables with trash entries, positions at
    page edges and at 0, through a strided layer view of a 2-layer
    arena."""
    s_n, h, d, page, pps = 8, 16, 128, 16, 64
    n_pages = s_n * pps
    arena_k = torch.randn(n_pages + 1, 2, page, h, d, generator=gen,
                          device="cuda")
    arena_v = torch.randn(n_pages + 1, 2, page, h, d, generator=gen,
                          device="cuda")
    kb, vb = arena_k[:, 1], arena_v[:, 1]          # strided layer views
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    bt = perm.reshape(s_n, pps).to(torch.int32)
    trash = torch.rand(s_n, pps, generator=gen, device="cuda") < 0.1
    bt = torch.where(trash, torch.full_like(bt, n_pages), bt)
    positions = torch.tensor([0, 15, 16, 255, 512, 1023, 640, 1000],
                             dtype=torch.int32, device="cuda")
    q = torch.randn(s_n, h, d, generator=gen, device="cuda")
    out = pa_mod.paged_attention(q, kb, vb, bt, positions)
    ref = pa_mod.paged_attention_plain(q, kb, vb, bt, positions)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    ms = time_ms(lambda: pa_mod.paged_attention(q, kb, vb, bt, positions))
    plain_ms = time_ms(
        lambda: pa_mod.paged_attention_plain(q, kb, vb, bt, positions),
        iters=5)
    rows = int((positions.long() + 1).clamp(max=pps * page).sum().item())
    flops = 4.0 * rows * h * d
    nbytes = (2 * rows * h * d * 4 + 2 * s_n * h * d * 4
              + bt.numel() * 4 + s_n * 4)
    bms, by = bound(flops, nbytes, PEAK_FP32)
    log(f"B4 paged S={s_n} H={h} D={d} page={page} pages/seq={pps} fp32: "
        f"max_abs_err {err:.3e} (tol {TOL['fp32']:.0e}) kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms bound {bms:.4f} ms ({by}), "
        f"{rows} visible rows")
    if not (err <= TOL["fp32"] and bool(torch.isfinite(out).all())):
        raise RuntimeError("paged attention kernel disagrees with its "
                           "plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "tolerance": TOL["fp32"],
            "shape": f"S={s_n} H={h} D={d} page={page} pages/seq={pps} fp32"}


def run_forward(torch, model, fa_mod, rng, cfg, dev):
    """Phase 3: the 1.3B forward through the flash kernel, against dense."""
    ids = torch.from_numpy(rng.integers(0, cfg["vocab_size"],
                                        (4, cfg["max_position_embeddings"]))
                           ).to(dev)
    before = fa_mod.flash_attention_fwd.launches
    model.set_attn_impl("flash")
    sync(torch, dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(ids)
    sync(torch, dev)
    t_flash = time.perf_counter() - t0
    launched = fa_mod.flash_attention_fwd.launches - before
    model.set_attn_impl("dense")
    with torch.no_grad():
        dense = model(ids)
    sync(torch, dev)
    model.set_attn_impl("flash")
    err = (logits - dense).abs().max().item()
    finite = bool(torch.isfinite(logits).all())
    log(f"forward GPT {tuple(ids.shape)} flash: logits {tuple(logits.shape)} "
        f"finite={finite} max_abs_err vs dense {err:.3e} (tol {LOGIT_TOL}) "
        f"B1 launches {launched} wall {t_flash * 1e3:.1f} ms")
    if not finite or err > LOGIT_TOL or \
            tuple(logits.shape) != (*ids.shape, cfg["vocab_size"]):
        raise RuntimeError("1.3B flash forward disagrees with dense")
    if launched != cfg["num_layers"]:
        raise RuntimeError(f"expected {cfg['num_layers']} flash "
                           f"launches per forward, saw {launched}")


def run_serving(torch, model, pa_mod, rng, card, cfg, lens):
    """Phase 4: the paged LLMEngine on 8 greedy requests."""
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    before = pa_mod.paged_attention.launches
    t0 = time.perf_counter()
    eng = LLMEngine(model, LLMEngineConfig(
        num_slots=8, max_seq=cfg["max_position_embeddings"],
        kv_layout="paged", page_size=16,
        paged_attn_impl="kernel", seed=0))
    t_warm = time.perf_counter() - t0
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist()
               for n in lens]
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    results = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    stats = eng.stats()
    eng.drain(timeout=60)
    ticks = int(stats["stats"].get("serving.llm.decode_ticks", 0))
    warm_steps = int(stats["stats"].get("serving.llm.warmup_decode_steps",
                                        0))
    launched = pa_mod.paged_attention.launches - before
    n_tok = sum(len(r["tokens"]) for r in results)
    hist = stats["histograms"]
    tick = hist["serving.llm.decode_tick_ms"]
    ttft = hist["serving.llm.ttft_ms"]
    log(f"serving GPT paged (8 slots, max_seq "
        f"{cfg['max_position_embeddings']}, page 16) on "
        f"{card}: {len(results)} requests, {n_tok} tokens in {wall:.3f} s "
        f"= {n_tok / wall:.1f} tokens/s; decode tick mean "
        f"{tick['mean']:.3f} ms p50 {tick['p50']:.3f} ms over "
        f"{tick['count']} ticks; TTFT p50 {ttft['p50']:.1f} ms max "
        f"{ttft['max']:.1f} ms; warmup {t_warm:.1f} s; B4 launches "
        f"{launched} ({ticks} ticks + {warm_steps} warmup step)")
    for r in results:
        if len(r["tokens"]) != 32:
            raise RuntimeError(f"request {r['req_id']} returned "
                               f"{len(r['tokens'])} tokens, not 32")
    if launched != cfg["num_layers"] * (ticks + warm_steps):
        raise RuntimeError(f"B4 launched {launched} times for {ticks} "
                           f"ticks (+{warm_steps} warmup)")
    return {"tokens_per_s": n_tok / wall, "tick_ms_mean": tick["mean"],
            "tick_ms_p50": tick["p50"], "ticks": ticks,
            "ttft_ms_p50": ttft["p50"]}


def compare_lanes(torch, model, rng, cfg, lens, dev):
    """One decode step's logits, kernel lane against gather lane, on the
    same cache state (8 prefilled slots)."""
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder
    dec = GPTPagedDecoder(model, page_size=16, attn_impl="kernel")
    kv = dec.new_kv(8, cfg["max_position_embeddings"])
    params = dec.params()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fin = torch.zeros(8, dtype=torch.bool, device=dev)
    samp = pack_sampling([SamplingParams()], dev)
    last = torch.zeros(8, dtype=torch.int32, device=dev)
    for slot, n in enumerate(lens):
        kv.alloc()
        kv.ensure_pages(slot, n + 1)
        lp = 1 << (n - 1).bit_length()
        toks = torch.zeros(1, lp, dtype=torch.int32, device=dev)
        toks[0, :n] = torch.from_numpy(rng.integers(0, cfg["vocab_size"], n))
        nxt, fin = dec.prefill(
            kv, params, toks,
            torch.tensor([n], dtype=torch.int32, device=dev),
            torch.tensor([slot], dtype=torch.int32, device=dev), fin,
            samp, gen)
        last[slot] = nxt[0]
    lk = dec.decode_logits(kv, params, last, "kernel")
    lg = dec.decode_logits(kv, params, last, "gather")
    err = (lk - lg).abs().max().item()
    same = bool((lk.argmax(-1) == lg.argmax(-1)).all())
    log(f"decode logits kernel lane vs gather lane (8 slots): max_abs_err "
        f"{err:.3e} (tol {LOGIT_TOL}), argmax equal {same}")
    if err > LOGIT_TOL or not torch.isfinite(lk).all():
        raise RuntimeError("paged kernel lane disagrees with gather lane")
    return dec, kv, params, last


def time_forward(torch, model, rng, cfg, dev):
    """Device time of one [4, 1024] forward, flash against dense."""
    ids = torch.from_numpy(rng.integers(0, cfg["vocab_size"],
                                        (4, cfg["max_position_embeddings"]))
                           ).to(dev)
    out = {}
    with torch.no_grad():
        for impl in ("flash", "dense"):
            model.set_attn_impl(impl)
            out[impl] = time_ms(lambda: model(ids), iters=3, warmup=1)
    model.set_attn_impl("flash")
    log(f"forward [4, {ids.shape[1]}] device time: flash "
        f"{out['flash']:.2f} ms, dense {out['dense']:.2f} ms")
    return out


def profile_steps(torch, label, step, steps):
    """Where one step's time goes: host wall per step without the
    profiler (each step ends in a host fetch or a synchronize), then
    device time per step and by kernel from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = e.self_cuda_time_total
        if dt > 0:
            rows.append((dt / 1e3 / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    log(f"{label}: host wall {wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
        f"({100 * dev_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * dev_ms / wall_ms:.1f}% idle), "
        f"{sum(r[1] for r in rows):.0f} kernels")
    for ms, cnt, key in rows[:10]:
        log(f"  {ms:.3f} ms/step  {cnt:.0f}/step  {key[:100]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms}


def profile_decode(torch, dec, kv, params, last, dev, steps=10):
    """Where a decode step's time goes, at the engine's 8 slots."""
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    n = kv.num_slots
    samp = pack_sampling([SamplingParams()] * n, dev)
    state = {"last": last,
             "fin": torch.zeros(n, dtype=torch.bool, device=dev)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def step():
        state["last"], state["fin"] = dec.decode_step(
            kv, params, state["fin"], state["last"], samp, gen)
        state["last"].cpu()          # the engine's one fetch per tick

    return profile_steps(torch, f"decode step, {n} slots", step, steps)


def profile_forward(torch, model, rng, cfg, dev):
    """Where a [4, 1024] flash forward's time goes."""
    ids = torch.from_numpy(rng.integers(0, cfg["vocab_size"],
                                        (4, cfg["max_position_embeddings"]))
                           ).to(dev)

    def step():
        with torch.no_grad():
            model(ids)
        torch.cuda.synchronize()

    return profile_steps(torch, f"forward {tuple(ids.shape)} flash", step, 2)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        from paddle_tpu_torch.ops import kernel_build
        from paddle_tpu_torch.ops import flash_attention as fa_mod
        from paddle_tpu_torch.ops import paged_attention as pa_mod
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    import numpy as np

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = paddle_tpu_torch.resolve_device()
    card = torch.cuda.get_device_name(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # -- phase 1: build -----------------------------------------------------
    t_build = kernel_build.build_all()
    log(f"build: {len(kernel_build.KERNEL_SOURCES)} kernels in "
        f"{t_build:.1f} s")
    for name, text in kernel_build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # -- phase 2: kernels against their plain versions -----------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    b1 = check_flash(torch, fa_mod, gen)
    b4 = check_paged(torch, pa_mod, gen)
    torch.cuda.empty_cache()

    # -- phases 3 and 4: the main path ---------------------------------------
    rng = np.random.default_rng(0)
    model = GPTForCausalLM(GPTConfig(**CFG_13B, attn_impl="flash"),
                           device=dev, seed=0).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: GPT-3 1.3B, {n_params} parameters, fp32, random weights "
        f"(seed 0)")
    fa_mod.flash_attention_fwd.launches = 0
    pa_mod.paged_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    run_forward(torch, model, fa_mod, rng, CFG_13B, dev)
    serve = run_serving(torch, model, pa_mod, rng, card, CFG_13B,
                        PROMPT_LENS)
    launches = {"flash_attention_fwd": fa_mod.flash_attention_fwd.launches,
                "paged_attention": pa_mod.paged_attention.launches}
    log(f"main path launches: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in launches.items():
        if n < 1:
            raise RuntimeError(f"kernel {name} was not launched on the "
                               f"main path")
    torch.cuda.empty_cache()
    time_forward(torch, model, rng, CFG_13B, dev)
    profile_forward(torch, model, rng, CFG_13B, dev)
    dec, kv, params, last = compare_lanes(torch, model, rng, CFG_13B,
                                          PROMPT_LENS, dev)
    profile_decode(torch, dec, kv, params, last, dev)

    # -- phase 6: summary ----------------------------------------------------
    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="paddle_tpu/ops/pallas_attention.py:67",
             launches=launches["flash_attention_fwd"], status="ok", **b1),
        dict(name="paged_attention", route="cuda",
             source="paddle_tpu_torch/csrc/paged_attention.cu",
             replaces="paddle_tpu/ops/paged_attention.py:76",
             launches=launches["paged_attention"], status="ok", **b4),
    ]
    log(f"serving: {json.dumps(serve)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
