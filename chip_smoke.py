#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` with nvcc, log
   each kernel's registers, shared memory and spills (``-Xptxas -v``),
   and count the tensor-core instructions (HMMA/HGMMA) in the SASS of the
   flash-attention kernels B1, B2 and B3 (``cuobjdump -sass``; an
   instantiation without any fails the run);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (B1, B2 and B3 in fp32 also against
   float64 formulas; B1-B4 two launches against each other, bit for
   bit; B1 also at generate's short causal lengths, B=2, S 64 to 96;
   B4 also captured in a CUDA graph and replayed 20 times on new queries
   and positions, each replay within 1e-4 of its plain version, and at
   head dims 16 to 1024 in fp32, bf16 and fp16, rows of one element a
   lane included),
   and time kernel, plain version and, where one exists, the single
   PyTorch call computing the same function: for B1 the forward of
   ``scaled_dot_product_attention``, for B2 and B3 together its backward
   (timed without its forward), each SDPA backend that accepts the case
   timed on its own and the fastest kept under its name, kernel and
   library timed in alternating rounds and reported as the median round;
   kernels and library calls are timed on the device's clock, behind a
   spin kernel that lets the host queue every call first;
   bounds of B1-B3 on the tensor cores (fp32 as 3xTF32), with the
   fp32-FMA bound beside; B1-B3 in fp32, bf16 and fp16; B1-B3 also at
   BERT-base's attention (B=256, S=128, H=12, D=64, non-causal) in fp32
   (and against float64) and bf16, and at the long-context GPT's
   (S=4096, D=64, causal: B=1, H=2 in fp32, against float64 too, and
   bf16; timed at its B=4, H=12), the same checks and timings;
3. the serving path, part one: GPT-3 1.3B (``GPTForCausalLM``, full
   width, random weights from a seed) forward on a [4, 1024] batch
   through the flash kernel, held against the same model's dense
   attention;
4. the serving path, part two: the paged ``LLMEngine`` serving 8 greedy
   requests of 32 new tokens, its decode step and prefill buckets
   captured as CUDA graphs at warm-up and replayed (``core/graphs.py``:
   one decode capture, every tick a replay, B4's 24 launches inside it;
   capture ms per signature and the graph pool's bytes printed);
5. checks and timings off the main paths: the same engine config on the
   eager lane (``disable_graphs``), whose tokens must equal the graphed
   lane's and whose tick is printed beside it; the forward's device time
   with flash and with dense attention, one decode step's logits, kernel
   lane against gather lane, on one cache state, the graphed kernel
   lane's logits bitwise against the eager one's, and torch.profiler
   breakdowns of a forward and of a decode step in both lanes (device
   busy share, time by kernel, the SM clock, power and temperature
   sampled in the window), with the replay's host ms a step and its
   device ms on the device's clock;
6. the static-slot decode plane and ``generate`` on the same model: (a)
   the default ``LLMEngine`` layout (``kv_layout="slot"``) serving phase
   4's 8 prompts, 32 greedy new tokens each (tokens/s, tick, TTFT,
   ``kv_bytes``, peak memory, and how many token lists equal the paged
   lane's, printed only), graphed as phase 4, then on the eager lane
   (tokens equal, tick beside); (b) one decode step's logits, slot lane against
   the paged gather lane, on the same 8 prefilled prompts, and a
   torch.profiler breakdown of a slot decode step in both lanes (host
   wall, device busy share, kernels by time, copy kernels, bytes the
   step allocates and must read), and one layer's attention timed in its block-diagonal form
   over the slot-major buffers and as plain matmuls over a layer-major
   copy; (c) ``model.generate`` on a [2, 64] prompt, 32 new tokens,
   in its three cache modes (static slot, concat, recompute), timed in ms
   per generated token, the recompute lane launching B1 once a layer a
   step, the static lane replaying its captured prefill and decode step
   (a second call captures nothing; its eager lane's tokens equal, its
   ms per token and both lanes' device ms a token printed beside);
   held against the dense forward (no B1): the recompute lane's
   last flash forward gives its logits within 2e-3, every generated
   token of each mode is its argmax over that mode's sequence, and two
   modes part only there (a mismatch passes only at a near-tie, top-2
   gap under 2e-3, and is counted);
7. the training path: the same 1.3B model trained 5 steps through
   ``Model.train_batch`` (AdamW, weight decay 0.01, global-norm clip 1.0,
   linear warmup over cosine decay, ``GPTPretrainingCriterion``) on one
   fixed [4, 1024] batch, attention forward on B1 and backward on B2 and
   B3; the step is the compiled program of ``hapi/model.py`` (forward,
   gradients, clip and the in-place AdamW update): the first call runs
   it eagerly and captures it as a CUDA graph, the other four replay it
   (exactly one capture; capture ms and the graph pool's bytes printed);
   the loss must be finite and fall, and each step must launch each of
   the three kernels once per layer, counted through the replays;
8. checks and timings off the training path: a torch.profiler breakdown
   of a graphed train step (wall, device busy and idle share, kernels a
   step, tokens/s, peak memory), the optimizer's update alone replayed
   from its own graph (device ms and kernels against its byte bound);
   then the eager lane (``disable_graphs``) on fresh weights from the
   same seed: 5 steps whose losses must equal the graphed lane's (bitwise,
   or within 1e-5 relative, the first differing step named), its profile
   and its update timed the same way; and one step's gradients through
   flash against dense attention on fresh weights, on the eager lane;
9. the mixed-precision training paths, each on a fresh 1.3B model from
   seed 0: 5 graphed ``train_batch`` steps under ``amp.auto_cast()`` (O1,
   bfloat16) with phase 7's optimizer and batch, each step launching the
   bfloat16 lanes of B1, B2 and B3 once per layer, the loss falling and
   its first value within 2e-2 of phase 7's first, one capture; both
   lanes profiled as in phase 8 (the eager one also by part: GEMMs,
   B1-B3, casts, optimizer), the eager lane's losses equal the graphed
   lane's; ``train_loop`` over the batch stacked 5 times (parameters,
   gradients and AdamW state in flat buffers, one captured program),
   whose losses must equal 5 graphed ``train_batch`` calls with the lr
   held, as a call holds it (bitwise or within 1e-5 relative), and its
   flat update timed alone; 3 graphed O2 steps (``amp.decorate`` and
   AdamW with float32 masters); 3 eager float16 steps with
   ``amp.GradScaler`` (``auto_cast(dtype="float16")``, scale, backward,
   step, update), B1-B3 in float16;
10. the detection path: YOLOv3-DarkNet53 (80 classes, width 1.0, COCO
   anchors, random weights from seed 0, fp32, eval) serving 16 single
   608x608 images submitted at once through the dynamic-batching
   ``Engine`` (buckets 1/2/4/8, 50 ms batching delay), then 3 windows
   of 64 more through the warm engine, timed for images/s; each batch is one
   forward and one ``decode`` whose greedy NMS runs on B5;
11. checks and timings off the detection path: the forward's device time
   at batch 8, decode's time split into yolo_box, top-k, IoU and B5, the
   kernel lane's detections against the plain lane's on the same IoU
   (bitwise), and a torch.profiler breakdown of one served batch;
12. ResNet-50 training at bench.py's TPU shape: ``resnet50(num_classes=
   1000)`` from seed 0, Momentum(0.1, 0.9, weight decay 1e-4) and
   ``CrossEntropyLoss`` through ``Model.train_batch`` on bench.py's batch
   (256 images of 224x224 and their labels from ``RandomState(0)``): 5
   graphed fp32 steps (one capture, four replays) and 5 on the eager lane
   on fresh weights, the same in O1 bf16 (``auto_cast``); losses and BN
   running statistics graphed against eager (bitwise, or within 1e-5
   relative: cuDNN's weight-gradient algorithms may sum with atomics);
   each lane's imgs/s, step wall, device ms, idle share, kernels a step,
   capture ms, graph-pool bytes, peak memory, device time by part (the
   graphed lanes by kernel name, the eager lanes by the host op that
   launched each kernel: convolutions forward and backward, BN forward
   and backward, ReLU, residual adds, pooling, casts, the update, the
   rest) and train TFLOP/s by bench.py's count (3 x 4.09 GFLOP an
   image), the Momentum update timed alone against its byte bound; then
   an O1 ``train_loop`` over the batch stacked 5 times, its losses equal
   to the graphed O1 ones (the lr is constant); no kernel of the port
   runs on this path;
13. BERT-base training at bench.py's TPU shape: ``BertConfig()`` (both
   dropouts 0.1) under bench.py's MLM head and flat cross entropy,
   AdamW(1e-4, weight decay 0.01), ids [256, 128] from ``RandomState(0)``;
   the lanes, checks and prints of phase 12 with tokens/s and bench.py's
   6·N·tokens TFLOP/s (attention dense while dropout trains, as in the
   JAX package: no kernel on this path); then two kernel checks on the
   same model: (a) ``BertModel`` in eval with no mask takes B1 once a
   layer (12), held against the dense lane in fp32 (1e-4) and, in O1
   bf16, by its distance from the dense fp32 output (at most 1.2 times
   the dense bf16 lane's), as max |diff| over max |dense|; (b) one eager
   step with both dropouts 0 runs B1-B3 once a layer, its gradients held
   against the dense lane's within 1e-3 of each tensor's largest entry,
   or, for a tensor over it, no farther from a float64 step than 1.2
   times the flash formula run in fp32 without the kernels;
14. C6: the default paged engine (``paged_attn_impl="auto"``) serves a
   float16 GPT and a bfloat16 GPT of head dim 100 through B4, an
   explicit ``"kernel"`` is the same lane, and the kernel lane's and an
   explicit gather engine's greedy tokens each lie within twice the
   model's own rounding of a float32 copy's argmax;
15. YOLOv3-DarkNet53 training at bench.py's TPU shape (:197-217):
   ``YOLOv3(80 classes, width 1.0)`` from seed 0, Momentum(1e-3, 0.9,
   weight decay 5e-4) and ``YOLOv3Loss`` through ``Model.train_batch``
   on bench.py's batch (32 images of 416x416, 1 to 7 gt boxes each in 50
   slots, from ``RandomState(0)``): the lanes, checks and prints of
   phase 12 (fp32 and O1, graphed and eager under cuDNN's deterministic
   algorithms, a graphed lane with its default ones, an O1
   ``train_loop``), with losses and BN statistics held bitwise between
   the lanes, bench.py's count (3 x 65.86 GFLOP x (416/608)^2 an image)
   and the eager lanes' time by op: convolutions, BN and the loss, each
   forward and backward, the update; no kernel of the port runs on this
   path (B5 is detection inference's);
16. the GPT at S = 4096 (bench.py:264-319): ``GPTConfig(50304, 768, 12
   layers, 12 heads, 4096 positions, dropouts 0, attn_impl "auto")``
   from seed 0, every ``layers.{i}`` forward through
   ``distributed.fleet.utils.recompute``, AdamW(1e-4, weight decay
   0.01), [4, 4096] ids from ``RandomState(0)``: 5 steps each of O1
   graphed, O1 eager, fp32 graphed and O1 graphed without recompute,
   every step launching B1 twice a layer (forward and re-run; once
   without recompute) and B2 and B3 once; tokens/s, step wall and
   device, idle share, B1-B3's share of device time, peak memory; the
   O1 lanes' losses graphed against eager (bitwise or 1e-5) and with
   recompute against without (bitwise), and one eager O1 step's loss and
   gradients with and without recompute bitwise, with the memory the
   step takes above the weights and optimizer state in each.

Each model, its programs and its cache are released between phases
(``release_memory``): GPT-3 1.3B, ResNet-50, BERT-base, YOLOv3 and the
S = 4096 GPT are never resident at once.

A replay of a captured graph adds to each kernel's count the launches
the graph captured. Every launch count (and B1-B3's counts by input
type) is set to 0 just
before phase 3 and read after phase 4 (the paged serving path), set to 0
just before phase 6a and read after it (the slot serving path, which
runs no kernel: its attention is dense, as the JAX package's), just
before phase 6c's three ``generate`` calls and read after them (the
generate path), just before phase 7 and read after it, just before each
of phase 9's four paths (O1 ``train_batch``, O1 ``train_loop``, O2,
fp16) and read after it, just before phase 10 and read after it, just
before phases 12 and 13's training paths and read after each (no kernel
of the port runs on either), just before phase 13's kernel checks and
read after them, just before phase 14 and read after it, just before
phase 15 and read after it, and just before each of phase 16's four
lanes and read after it. The last two lines are a
``{"kernels": [...]}`` summary and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np

# GPT-3 1.3B (the repository's flagship serving and training config)
CFG_13B = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
               num_heads=16, intermediate_size=4 * 2048,
               max_position_embeddings=1024, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)

# H100 SXM published peaks (dense): fp32 without tensor cores, TF32 and
# bf16 (and fp16, the same rate) tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

#: prompt lengths of the 8 serving requests
PROMPT_LENS = [17, 64, 129, 255, 400, 513, 777, 900]

#: YOLOv3-DarkNet53 at PaddleDetection's eval size, and decode's defaults
DET_CLASSES = 80
DET_SIZE = 608
DET_REQUESTS = 16
DET_WINDOW = 64     # requests of each timed window after the burst
DET_WINDOWS = 3
DET_DECODE = dict(conf_thresh=0.01, nms_thresh=0.45, nms_top_k=400,
                  keep_top_k=100)

TOL = {"fp32": 1e-4, "bf16": 2e-2, "fp16": 2e-2}  # kernel vs plain
F64_TOL = 2e-5      # B1-B3 fp32 (3xTF32) vs float64 formulas, of max |ref|
LOGIT_TOL = 2e-3                       # flash vs dense, and kernel vs gather
GRAD_TOL = 1e-3     # flash vs dense train gradients, per tensor, of its max
TRAIN_STEPS = 5
AMP_STEPS = 5       # O1 bf16 train steps; O2 and fp16 take AMP_SHORT
AMP_SHORT = 3
AMP_LOSS_TOL = 2e-2  # O1 bf16 first loss vs fp32 first loss, relative
#: graphed against eager lane, and train_loop against graphed
#: train_batch: the losses bitwise equal or within this, relative
LANE_TOL = 1e-5
LOOP_STEPS = 5      # O1 bf16 steps of one train_loop call

#: the library yardstick of B1-B3: each SDPA backend on its own, timed in
#: ROUNDS alternating rounds of ROUND_ITERS calls against the kernels, on
#: the device's clock behind a spin of SPIN_CYCLES (~25 ms)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
ROUNDS = 5
ROUND_ITERS = 20
SPIN_CYCLES = 50_000_000


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3, spin=False):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls. With ``spin``, a spin
    kernel of SPIN_CYCLES runs first, so that the host has queued every
    call before the device reaches them and the events time the device
    alone, whatever each call costs the host (a call shorter on the
    device than on the host is otherwise timed on the host's clock); a
    spin that the host does not outrun is taken again, four times
    longer, and if the host does not outrun that either the time would be
    the host's, so it raises."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for cycles in ((SPIN_CYCLES, 4 * SPIN_CYCLES) if spin else (0,)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()      # the spin still ran: all queued
        end.synchronize()
        if ahead:
            break
    else:
        if spin:
            raise RuntimeError(
                f"time_ms: the host did not queue {iters} calls within a "
                f"spin of {4 * SPIN_CYCLES} cycles; the reading would be "
                f"host time")
    return start.elapsed_time(end) / iters


def host_time_ms(fn, calls=20):
    """Mean host time of ``fn`` in ms over ``calls`` back-to-back calls
    (what a call costs the host: the device runs behind), then waits for
    the device."""
    import torch
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def time_rounds(torch, fns, rounds=ROUNDS, iters=ROUND_ITERS):
    """Device times of several functions of the same inputs, taken in
    alternating rounds (each round times every function in turn, the
    order reversed every other round): {name: median round ms}, and
    every round's ms by name."""
    per = {n: [] for n in fns}
    for r in range(rounds):
        for n in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            per[n].append(time_ms(fns[n], iters=iters, warmup=1, spin=True))
    return {n: float(np.median(v)) for n, v in per.items()}, per


def sdpa_backends(torch, make):
    """{backend name: callable} for each SDPA backend that accepts the
    case: ``make()`` builds the call under the backend (and returns the
    function to time), and a backend that refuses it raises and is
    skipped."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            # a backend that refuses the case warns why, then raises
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                fn = make()
                fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def run(fn=fn, backend=backend):
            with sdpa_kernel(backend):
                return fn()
        out[name] = run
    return out


def fastest(ms_by_name, names):
    """(name, ms) of the fastest of ``names`` in ``ms_by_name``, or (None,
    None) when there is none."""
    got = [(ms_by_name[n], n) for n in names if n in ms_by_name]
    if not got:
        return None, None
    ms, name = min(got)
    return name, ms


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def bound(flops, nbytes, peak_flops):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_bound(flops, nbytes, dt):
    """An attention kernel's bound on the tensor cores: bf16 and fp16 at
    their rate; fp32 to fp32 accuracy as 3xTF32, three TF32 operations per
    operation. Also the bound on fp32 FMA outside the tensor cores (None
    for bf16 and fp16),
    the definition used before the backward kernels moved to tensor
    cores."""
    import torch
    if dt == torch.float32:
        return (*bound(3.0 * flops, nbytes, PEAK_TF32),
                bound(flops, nbytes, PEAK_FP32)[0])
    return (*bound(flops, nbytes, PEAK_BF16), None)


def sass_tensor_counts(kernel_build, names):
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of each kernel
    function of the built libraries ``names``, from ``cuobjdump -sass``:
    {library: {function: count}}, or None where the tool is absent."""
    import re
    import shutil
    from pathlib import Path
    tool = Path(kernel_build.find_nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.is_file() else shutil.which("cuobjdump")
    if tool is None:
        return None
    out = {}
    for name in names:
        sass = subprocess.run([tool, "-sass",
                               str(kernel_build.library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                # the instantiation: element type and head dim
                t = re.search(r"kernelI(f|13__nv_bfloat16|6__half)Li(\d+)E",
                              m.group(1))
                kind = {"f": "fp32", "6__half": "fp16"}.get(
                    t.group(1), "bf16") if t else None
                fn = f"{kind} D={t.group(2)}" if t else m.group(1)
                counts[fn] = 0
            elif fn is not None and re.search(r"\bHG?MMA\b", line):
                counts[fn] += 1
        out[name] = counts
    return out


#: B1 at the shapes of generate's recompute lane: B=2, S from 64 to 95
#: causal fp32, one partial key tile or one whole one
GEN_FLASH_LENS = (64, 65, 95, 96)


#: B1-B3 at BERT-base's attention: B=256, S=128, H=12, D=64, non-causal
BERT_ATTN = (256, 128, 12, 64)

#: B1-B3 at the long-context GPT's attention (bench.py:264-319): S=4096,
#: H=12, D=64, causal, timed at its batch of 4 ("s4096") and checked,
#: against float64 too, on two heads of one sequence ("s4096_check")
LONG_ATTN = (4, 4096, 12, 64)
LONG_CHECK = (1, 4096, 2, 64)
#: cases timed only: the float64 formulas at LONG_ATTN would hold tens of
#: GB of score matrices; LONG_CHECK holds the same kernels to them
NO_F64_TAGS = ("s4096",)


def _flash_cases(torch, with_gen):
    """Phase 2's B1-B3 cases, (type name, dtype, B, Sq, Skv, H, D, causal,
    summary tag): the training path's B=4, S=1024, H=16, D=128, the odd
    length and Sq != Skv cases, BERT-base's shape (BERT_ATTN, tag
    "bert"), the long-context GPT's (LONG_ATTN, tag "s4096", and
    LONG_CHECK, tag "s4096_check"), and for B1 the short causal lengths
    of generate's recompute lane (GEN_FLASH_LENS)."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    b, s, h, d = BERT_ATTN
    lb, ls, lh, ld = LONG_ATTN
    cb, cs, ch, cd = LONG_CHECK
    cases = [("fp32", f32, 4, 1024, 1024, 16, 128, True, None),
             ("fp32", f32, 4, 1024, 1024, 16, 128, False, None),
             ("bf16", bf16, 4, 1024, 1024, 16, 128, True, None),
             ("bf16", bf16, 4, 1024, 1024, 16, 128, False, None),
             ("fp16", f16, 4, 1024, 1024, 16, 128, True, None),
             ("fp16", f16, 4, 1024, 1024, 16, 128, False, None),
             ("fp32", f32, 4, 1000, 1000, 16, 128, True, None),
             ("fp32", f32, 4, 512, 1024, 16, 128, True, None),
             ("fp32", f32, 4, 1024, 640, 16, 128, False, None),
             ("fp32", f32, b, s, s, h, d, False, "bert"),
             ("bf16", bf16, b, s, s, h, d, False, "bert"),
             ("fp32", f32, cb, cs, cs, ch, cd, True, "s4096_check"),
             ("bf16", bf16, cb, cs, cs, ch, cd, True, "s4096_check"),
             ("fp32", f32, lb, ls, ls, lh, ld, True, "s4096"),
             ("bf16", bf16, lb, ls, ls, lh, ld, True, "s4096")]
    if with_gen:
        cases += [("fp32", f32, 2, n, n, 16, 128, True, None)
                  for n in GEN_FLASH_LENS]
    return cases


def check_flash(torch, fa_mod, gen):
    """B1 against its plain version on :func:`_flash_cases`; every case
    launches the kernel twice and requires bitwise equal results, and
    every fp32 case is also held to F64_TOL of the same attention in
    float64 (O and LSE, max |err| / max |ref|). Returns the summary row
    for the main path's case (fp32, causal, S=1024), with the bf16 and
    fp16 causal cases' times beside and the BERT-shape cases' under
    ``bert_<type>_*`` keys."""
    fa = fa_mod.flash_attention_fwd
    plain = fa_mod.flash_attention_fwd_plain
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row, low, tagged = None, {}, {}
    for name, dt, b, sq, skv, h, d, causal, tag in _flash_cases(torch,
                                                                True):
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, skv, h, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, skv, h, d, generator=gen, device="cuda").to(dt)
        out, lse = fa(q, k, v, causal=causal)
        again = fa(q, k, v, causal=causal)
        ref, ref_lse = plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        del again
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = same and err <= TOL[name] and lse_err <= TOL["fp32"] \
            and bool(torch.isfinite(out.float()).all())
        e64, extra = None, ""
        if dt == torch.float32 and tag not in NO_F64_TAGS:
            o64, l64 = plain(*(x.double() for x in (q, k, v)), causal)
            e64 = max(((out.double() - o64).abs().max()
                       / o64.abs().max()).item(),
                      ((lse.double() - l64).abs().max()
                       / l64.abs().max()).item())
            extra = f" vs float64 {e64:.3e} (tol {F64_TOL:.0e})"
            ok = ok and e64 <= F64_TOL
            del o64, l64
        plain_ms = time_ms(lambda: plain(q, k, v, causal=causal), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # SDPA's causal mask is top-left aligned, as the kernel's
        libs = sdpa_backends(torch, lambda: (
            lambda: sdpa(qt, kt, vt, is_causal=causal)))
        med, rounds = time_rounds(
            torch, {"kernel": lambda: fa(q, k, v, causal=causal), **libs})
        ms = med["kernel"]
        lib_name, lib_ms = fastest(med, libs)
        if causal:
            pairs = sum(min(i + 1, skv) for i in range(sq))
        else:
            pairs = sq * skv
        flops = 4.0 * d * pairs * b * h
        elem = q.element_size()
        nbytes = (2 * sq + 2 * skv) * b * h * d * elem + 4 * b * h * sq
        bms, by, fma_ms = attn_bound(flops, nbytes, dt)
        lib_txt = ", ".join(f"{n} {med[n]:.4f}" for n in libs)
        log(f"B1 flash {name} B={b} Sq={sq} Skv={skv} H={h} D={d} "
            f"causal={causal}: "
            f"max_abs_err O {err:.3e} LSE {lse_err:.3e} "
            f"(tol {TOL[name]:.0e}/{TOL['fp32']:.0e}){extra}, two launches "
            f"bitwise equal {same}; kernel {ms:.4f} ms (rounds "
            f"{[round(x, 4) for x in rounds['kernel']]}) plain "
            f"{plain_ms:.4f} ms sdpa {{{lib_txt}}} ms, fastest {lib_name}; "
            f"bound {bms:.4f} ms ({by}"
            + (f"; on fp32 FMA {fma_ms:.4f} ms)" if fma_ms else ")"))
        if not ok:
            raise RuntimeError(f"flash kernel disagrees with its plain "
                               f"version, the float64 formulas or itself "
                               f"({name}, B={b}, Sq={sq}, Skv={skv}, H={h}, "
                               f"D={d})")
        if row is None:
            row = {"max_abs_err": max(err, lse_err), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "bound_fp32_fma_ms": fma_ms,
                   "library_ms": lib_ms,
                   "library": f"sdpa forward, {lib_name} backend",
                   "library_ms_by_backend": {n: med[n] for n in libs},
                   "tolerance": TOL[name], "max_err_vs_float64": e64,
                   "float64_tolerance": F64_TOL,
                   "bitwise_repeatable": same,
                   "shape": f"B={b} S={sq} H={h} D={d} fp32 causal"}
        elif tag is not None:
            t = f"{tag}_{name}"
            tagged.update({
                f"{t}_ms": ms, f"{t}_plain_ms": plain_ms,
                f"{t}_bound_ms": bms, f"{t}_bound_by": by,
                f"{t}_max_abs_err": max(err, lse_err),
                f"{t}_library_ms": lib_ms,
                f"{t}_library": f"sdpa forward, {lib_name} backend",
                f"{t}_shape": f"B={b} S={sq} H={h} D={d} "
                              + ("causal" if causal else "non-causal"),
                f"{t}_bitwise_repeatable": same})
            if e64 is not None:
                tagged[f"{t}_max_err_vs_float64"] = e64
        elif name != "fp32" and causal and name not in low:
            low[name] = {f"{name}_ms": ms, f"{name}_bound_ms": bms,
                         f"{name}_library_ms": lib_ms,
                         f"{name}_library": f"sdpa forward, {lib_name} "
                                            f"backend",
                         f"{name}_max_abs_err": max(err, lse_err),
                         f"{name}_bitwise_repeatable": same}
        del q, k, v, out, lse, ref, ref_lse
        torch.cuda.empty_cache()
    for extra in low.values():
        row.update(extra)
    row.update(tagged)
    return row


def check_flash_bwd(torch, fa_mod, gen):
    """B2 and B3 against their plain versions on :func:`_flash_cases`
    (all but generate's short ones) with a random dO. Error is max
    |kernel - plain| over max |plain|, per output. Every case launches
    the kernels twice and requires the two results to be bitwise equal
    (no atomics). The main case (fp32, causal, S=1024) and the BERT-shape
    fp32 case are also held to F64_TOL of the same formulas in float64:
    the kernels run fp32 as 3xTF32, and a single TF32 product would miss
    that bar (tests/test_torch_flash_tf32_split.py). Returns the summary
    rows of B2 and B3 for the main case, with the bf16 and fp16 causal
    cases' times beside and the BERT-shape cases' under ``bert_<type>_*``
    keys."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, low, tagged = None, {}, ({}, {})
    for name, dt, b, sq, skv, h, d, causal, tag in _flash_cases(torch,
                                                                False):
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, skv, h, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, skv, h, d, generator=gen, device="cuda").to(dt)
        do = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
        out, lse = fa_mod.flash_attention_fwd(q, k, v, causal=causal)
        delta = fa_mod.attention_delta(out, do)
        args = (q, k, v, do, lse, delta, causal)
        dq = fa_mod.flash_attention_bwd_dq(*args)
        dk, dv = fa_mod.flash_attention_bwd_dkv(*args)
        again = (fa_mod.flash_attention_bwd_dq(*args),
                 *fa_mod.flash_attention_bwd_dkv(*args))
        rq = fa_mod.flash_attention_bwd_dq_plain(*args)
        rk, rv = fa_mod.flash_attention_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
        del again
        errs, abs_errs = {}, {}
        for g, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            if not bool(torch.isfinite(got.float()).all()):
                raise RuntimeError(f"flash backward {g} is not finite")
            abs_errs[g] = (got.float() - ref.float()).abs().max().item()
            errs[g] = abs_errs[g] / ref.float().abs().max().item()
        ok = same and all(e <= TOL[name] for e in errs.values())
        extra, e64 = "", None
        if rows is None or (tag not in (None, *NO_F64_TAGS)
                            and dt == torch.float32):
            # independent of the plain version: the same formulas in f64
            f64 = [x.double() for x in (q, k, v, do)]
            o64, l64 = fa_mod.flash_attention_fwd_plain(*f64[:3], causal)
            r64 = fa_mod.flash_attention_bwd_plain(*f64[:3], o64, l64,
                                                   f64[3], causal)
            e64 = max(((got.double() - ref).abs().max()
                       / ref.abs().max()).item()
                      for got, ref in zip((dq, dk, dv), r64))
            extra = f" (vs float64 formulas {e64:.3e}, tol {F64_TOL:.0e})"
            ok = ok and e64 <= F64_TOL
            del f64, o64, l64, r64
        plain_dq = time_ms(lambda: fa_mod.flash_attention_bwd_dq_plain(*args),
                           iters=3)
        plain_dkv = time_ms(
            lambda: fa_mod.flash_attention_bwd_dkv_plain(*args), iters=3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        do_t = do.transpose(1, 2)

        def make():
            # the backward of the forward this backend ran
            o_lib = sdpa(qt, kt, vt, is_causal=causal)
            return lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                               retain_graph=True)
        libs = sdpa_backends(torch, make)
        med, _ = time_rounds(torch, {
            "B2": lambda: fa_mod.flash_attention_bwd_dq(*args),
            "B3": lambda: fa_mod.flash_attention_bwd_dkv(*args), **libs})
        ms_dq, ms_dkv = med["B2"], med["B3"]
        lib_name, lib_ms = fastest(med, libs)
        lib_txt = ", ".join(f"{n} {med[n]:.4f}" for n in libs)
        if causal:
            pairs = sum(min(i + 1, skv) for i in range(sq))
        else:
            pairs = sq * skv
        elem = q.element_size()
        bhd = b * h * d
        in_bytes = (2 * sq + 2 * skv) * bhd * elem + 2 * 4 * b * h * sq
        b_dq = attn_bound(6.0 * bhd * pairs, in_bytes + sq * bhd * elem, dt)
        b_dkv = attn_bound(8.0 * bhd * pairs,
                           in_bytes + 2 * skv * bhd * elem, dt)
        fma = (f"; on fp32 FMA {b_dq[2]:.4f} / {b_dkv[2]:.4f} ms"
               if b_dq[2] else "")
        log(f"B2/B3 flash bwd {name} B={b} Sq={sq} Skv={skv} H={h} D={d} "
            f"causal={causal}: "
            f"max err/max dq {errs['dq']:.3e} dk {errs['dk']:.3e} "
            f"dv {errs['dv']:.3e}{extra} (tol {TOL[name]:.0e}), two launches "
            f"bitwise equal {same}; B2 {ms_dq:.4f} ms (plain {plain_dq:.4f}, "
            f"bound {b_dq[0]:.4f} {b_dq[1]}); B3 {ms_dkv:.4f} ms (plain "
            f"{plain_dkv:.4f}, bound {b_dkv[0]:.4f} {b_dkv[1]}){fma}; "
            f"B2+B3 {ms_dq + ms_dkv:.4f} ms vs sdpa backward {{{lib_txt}}} "
            f"ms, fastest {lib_name}")
        if not ok:
            raise RuntimeError(f"flash backward kernels disagree with their "
                               f"plain versions, the float64 formulas or "
                               f"themselves ({name}, B={b}, Sq={sq}, "
                               f"Skv={skv}, H={h}, D={d})")
        if rows is None:
            shape = f"B={b} S={sq} H={h} D={d} fp32 causal"
            common = {"tolerance": TOL[name],
                      "tolerance_of": "max |err| / max |plain|",
                      "max_err_vs_float64": e64, "float64_tolerance": F64_TOL,
                      "bitwise_repeatable": same,
                      "library_ms": lib_ms,
                      "library": f"sdpa backward, {lib_name} backend, for "
                                 f"B2+B3 together",
                      "library_ms_by_backend": {n: med[n] for n in libs},
                      "shape": shape}
            rows = ({"max_abs_err": abs_errs["dq"],
                     "max_err_over_max_ref": errs["dq"], "ms": ms_dq,
                     "plain_ms": plain_dq, "bound_ms": b_dq[0],
                     "bound_by": b_dq[1], "bound_fp32_fma_ms": b_dq[2],
                     **common},
                    {"max_abs_err": max(abs_errs["dk"], abs_errs["dv"]),
                     "max_err_over_max_ref": max(errs["dk"], errs["dv"]),
                     "ms": ms_dkv, "plain_ms": plain_dkv,
                     "bound_ms": b_dkv[0], "bound_by": b_dkv[1],
                     "bound_fp32_fma_ms": b_dkv[2], **common})
        elif tag is not None:
            t = f"{tag}_{name}"
            common = {f"{t}_library_ms": lib_ms,
                      f"{t}_library": f"sdpa backward, {lib_name} backend, "
                                      f"for B2+B3 together",
                      f"{t}_shape": f"B={b} S={sq} H={h} D={d} "
                                    + ("causal" if causal else "non-causal"),
                      f"{t}_bitwise_repeatable": same}
            if e64 is not None:
                common[f"{t}_max_err_vs_float64"] = e64
            for out_row, ms, pms, bd, e in (
                    (tagged[0], ms_dq, plain_dq, b_dq, errs["dq"]),
                    (tagged[1], ms_dkv, plain_dkv, b_dkv,
                     max(errs["dk"], errs["dv"]))):
                out_row.update({f"{t}_ms": ms, f"{t}_plain_ms": pms,
                                f"{t}_bound_ms": bd[0],
                                f"{t}_bound_by": bd[1],
                                f"{t}_max_err_over_max_ref": e, **common})
        elif name != "fp32" and causal and name not in low:
            lib = {f"{name}_library_ms": lib_ms,
                   f"{name}_library": f"sdpa backward, {lib_name} backend, "
                                      f"for B2+B3 together",
                   f"{name}_bitwise_repeatable": same}
            low[name] = (
                {f"{name}_ms": ms_dq, f"{name}_bound_ms": b_dq[0],
                 f"{name}_max_err_over_max_ref": errs["dq"], **lib},
                {f"{name}_ms": ms_dkv, f"{name}_bound_ms": b_dkv[0],
                 f"{name}_max_err_over_max_ref": max(errs["dk"], errs["dv"]),
                 **lib})
        del q, k, v, do, out, lse, delta, dq, dk, dv, rq, rk, rv, libs
        torch.cuda.empty_cache()
    for dq_row, dkv_row in low.values():
        rows[0].update(dq_row)
        rows[1].update(dkv_row)
    rows[0].update(tagged[0])
    rows[1].update(tagged[1])
    return rows


#: B4's cases: the positions of the 8 sequences
PAGED_CASES = (("main", [0, 15, 16, 255, 512, 1023, 640, 1000]),
               ("all at 1023", [1023] * 8))
#: B4's other head dims (D, dtype name), at the main case's positions:
#: GPT-3 2.7B's 80, 96, 256 (two vectors a lane in f32), the narrowest
#: fp32 one that fills a warp with rows (16), float16, rows that are not
#: whole 16-byte vectors (100 in the half types, 130 in f32: one element
#: a lane) and the widest (1024)
PAGED_HEAD_DIMS = ((80, "float32"), (80, "bfloat16"), (96, "float32"),
                   (96, "bfloat16"), (256, "float32"), (16, "float32"),
                   (128, "float16"), (100, "float16"), (100, "bfloat16"),
                   (130, "float32"), (1024, "float32"))
#: the tolerance of each type, kernel against plain
TYPE_TOL = {"float32": TOL["fp32"], "bfloat16": TOL["bf16"],
            "float16": TOL["fp16"]}


def paged_case(torch, gen, d=128, dtype="float32"):
    """B4's inputs: 8 sequences, H=16, head dim d (128), page 16, 64 pages
    per sequence, block tables with trash entries, K and V as strided
    layer views of 2-layer arenas; (q, k view, v view, block tables)."""
    s_n, h, page, pps = 8, 16, 16, 64
    dt = getattr(torch, dtype)
    n_pages = s_n * pps
    arena_k = torch.randn(n_pages + 1, 2, page, h, d, generator=gen,
                          device="cuda").to(dt)
    arena_v = torch.randn(n_pages + 1, 2, page, h, d, generator=gen,
                          device="cuda").to(dt)
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    bt = perm.reshape(s_n, pps).to(torch.int32)
    trash = torch.rand(s_n, pps, generator=gen, device="cuda") < 0.1
    bt = torch.where(trash, torch.full_like(bt, n_pages), bt)
    q = torch.randn(s_n, h, d, generator=gen, device="cuda").to(dt)
    return q, arena_k[:, 1], arena_v[:, 1], bt


def paged_bound(torch, q, kb, bt, positions):
    """B4's bound: (ms, "bytes" or "operations", visible rows)."""
    s_n, h, d = q.shape
    es = kb.element_size()
    rows = int((positions.long() + 1).clamp(
        max=bt.shape[1] * kb.shape[1]).sum().item())
    nbytes = (2 * rows * h * d * es + 2 * s_n * h * d * es
              + bt.numel() * 4 + s_n * 4)
    return (*bound(4.0 * rows * h * d, nbytes, PEAK_FP32), rows)


def check_paged(torch, pa_mod, gen):
    """B4 against its plain version on :func:`paged_case`'s inputs at
    positions at page edges and at 0, then with all 8 sequences at 1023
    (PAGED_CASES), then at the first case's positions with the head dims
    of PAGED_HEAD_DIMS. Each case launches the kernel twice and requires
    bitwise equal results. Returns the summary row of the first case,
    the second's times beside."""
    q, kb, vb, bt = paged_case(torch, gen)
    s_n, h, d = q.shape
    page, pps = kb.shape[1], bt.shape[1]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk = pa_mod.chunk_pages_for(pps, s_n * h, n_sms)
    row = None
    for name, pos in PAGED_CASES:
        positions = torch.tensor(pos, dtype=torch.int32, device="cuda")
        out = pa_mod.paged_attention(q, kb, vb, bt, positions)
        again = pa_mod.paged_attention(q, kb, vb, bt, positions)
        ref = pa_mod.paged_attention_plain(q, kb, vb, bt, positions)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        err = (out - ref).abs().max().item()
        def run():
            return pa_mod.paged_attention(q, kb, vb, bt, positions)
        ms = time_ms(run, spin=True)
        host_ms = host_time_ms(run)
        plain_ms = time_ms(
            lambda: pa_mod.paged_attention_plain(q, kb, vb, bt, positions),
            iters=5)
        bms, by, rows = paged_bound(torch, q, kb, bt, positions)
        log(f"B4 paged {name} S={s_n} H={h} D={d} page={page} "
            f"pages/seq={pps} fp32 ({chunk} pages a chunk, {n_sms} SMs): "
            f"max_abs_err {err:.3e} (tol {TOL['fp32']:.0e}), two launches "
            f"bitwise equal {same}; kernel {ms:.4f} ms (the wrapper's host "
            f"time a call {host_ms:.4f} ms) plain {plain_ms:.4f} ms bound "
            f"{bms:.4f} ms ({by}), {rows} visible rows")
        if not (same and err <= TOL["fp32"]
                and bool(torch.isfinite(out).all())):
            raise RuntimeError(f"paged attention kernel disagrees with its "
                               f"plain version or itself ({name})")
        if row is None:
            row = {"max_abs_err": err, "ms": ms, "host_ms": host_ms,
                   "plain_ms": plain_ms,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "tolerance": TOL["fp32"], "bitwise_repeatable": same,
                   "chunk_pages": chunk,
                   "shape": f"S={s_n} H={h} D={d} page={page} "
                            f"pages/seq={pps} fp32"}
        else:
            row.update(full_ms=ms, full_bound_ms=bms, full_max_abs_err=err,
                       full_shape="all 8 sequences at position 1023")
    row.update(check_paged_replay(torch, pa_mod, gen, q, kb, vb, bt))
    positions = torch.tensor(PAGED_CASES[0][1], dtype=torch.int32,
                             device="cuda")
    others = {}
    for d, dtype in PAGED_HEAD_DIMS:
        q, kb, vb, bt = paged_case(torch, gen, d, dtype)
        out = pa_mod.paged_attention(q, kb, vb, bt, positions)
        again = pa_mod.paged_attention(q, kb, vb, bt, positions)
        ref = pa_mod.paged_attention_plain(q, kb, vb, bt, positions)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TYPE_TOL[dtype]
        ms = time_ms(lambda: pa_mod.paged_attention(q, kb, vb, bt,
                                                    positions), spin=True)
        bms, by, _ = paged_bound(torch, q, kb, bt, positions)
        log(f"B4 paged main positions D={d} {dtype}: max_abs_err {err:.3e} "
            f"(tol {tol:.0e}), two launches bitwise equal {same}; kernel "
            f"{ms:.4f} ms bound {bms:.4f} ms ({by})")
        if not (same and err <= tol and bool(torch.isfinite(out).all())):
            raise RuntimeError(f"paged attention kernel disagrees with its "
                               f"plain version or itself (D={d} {dtype})")
        others[f"D{d}_{dtype}"] = {"max_abs_err": err, "ms": ms,
                                   "bound_ms": bms, "bound_by": by}
    row["head_dims"] = others
    # the main case's inputs shifted one element off 16 bytes: the same
    # kernel, one element a lane
    q, kb, vb, bt = paged_case(torch, gen)
    qs = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    qs.copy_(q)
    out = pa_mod.paged_attention(qs, kb, vb, bt, positions)
    ref = pa_mod.paged_attention_plain(q, kb, vb, bt, positions)
    err = (out - ref).abs().max().item()
    ms = time_ms(lambda: pa_mod.paged_attention(qs, kb, vb, bt, positions),
                 spin=True)
    log(f"B4 paged main positions, q shifted off 16 bytes: max_abs_err "
        f"{err:.3e} (tol {TOL['fp32']:.0e}); kernel {ms:.4f} ms")
    if err > TOL["fp32"] or not bool(torch.isfinite(out).all()):
        raise RuntimeError("paged attention kernel disagrees with its plain "
                           "version on a view off 16 bytes")
    row["shifted_q"] = {"max_abs_err": err, "ms": ms}
    return row


class _GraphState:
    """A captured program's state for a lone kernel: its graph pool."""

    def __init__(self, graphs, device):
        self.graph_pool = graphs.GraphPool(device)


PAGED_REPLAYS = 20


def check_paged_replay(torch, pa_mod, gen, q, kb, vb, bt):
    """B4 captured once in a CUDA graph at the main case's shapes, then
    replayed PAGED_REPLAYS times on new queries and positions (copied
    into the graph's inputs; positions anywhere up to past the table):
    each replay within TOL of the plain version, so every launch leaves
    its tickets zero, and each replay counts one launch."""
    from paddle_tpu_torch.core import graphs
    prog = graphs.Program(lambda params, state, q, positions:
                          pa_mod.paged_attention(q, kb, vb, bt, positions))
    limit = bt.shape[1] * kb.shape[1] + 3
    before = pa_mod.paged_attention.launches
    state = _GraphState(graphs, q.device)
    prog(None, state, q.clone(),
         torch.randint(0, limit, (q.shape[0],), generator=gen,
                       device="cuda", dtype=torch.int32))
    err = 0.0
    for _ in range(PAGED_REPLAYS):
        qi = torch.randn(q.shape, generator=gen, device="cuda")
        pi = torch.randint(0, limit, (q.shape[0],), generator=gen,
                           device="cuda", dtype=torch.int32)
        out = prog(None, state, qi, pi)
        ref = pa_mod.paged_attention_plain(qi, kb, vb, bt, pi)
        err = max(err, (out - ref).abs().max().item())
    launched = pa_mod.paged_attention.launches - before
    log(f"B4 captured once, replayed {prog.replays} times on new inputs: "
        f"max_abs_err {err:.3e} (tol {TOL['fp32']:.0e}); launches counted "
        f"{launched} (1 warm-up + {prog.replays} replays)")
    if err > TOL["fp32"] or prog.replays != PAGED_REPLAYS or \
            launched != PAGED_REPLAYS + 1:
        raise RuntimeError("paged attention kernel replayed from a CUDA "
                           "graph disagrees with its plain version")
    return {"replay_max_abs_err": err, "replays_checked": PAGED_REPLAYS}


def release_memory(torch):
    """Collect engines gone out of scope (their KV caches, and with them
    the graphs bound to those caches) and return the cached blocks."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _nms_case(torch, det_mod, gen, p_n, k, kind="boxes", side=608.0):
    """iou [P, k, k], valid [P, k] int32, thr [P] on the card: the IoU of
    random boxes at the detection path's density (a 608 px image, box
    sides 10 to 300 px) with ~15% invalid rows, or (``kind``) a random
    asymmetric matrix; boxes on a grid that never overlap, or one box
    repeated, every row valid (every candidate kept: the longest fold;
    one kept); random boxes with every overlap NaN in the rows and columns
    on either side of each 32-candidate boundary and 5% NaN elsewhere;
    random boxes with a threshold per problem in [0.55, 0.75], which an
    eta of 0.995 takes under 0.5 at a different candidate in each
    problem (an eta of 0.9999 never does within 200 candidates). Problem
    0 has no valid row."""
    thr = torch.full((p_n,), 0.45, device="cuda")
    if kind == "asymmetric":
        iou = torch.rand(p_n, k, k, generator=gen, device="cuda")
    elif kind in ("disjoint", "identical"):
        side_n = math.ceil(math.sqrt(k))
        cell = torch.arange(k, dtype=torch.float32, device="cuda")
        c = torch.stack([cell % side_n, cell // side_n], -1) * 20.0
        if kind == "identical":
            c = torch.zeros_like(c)
        boxes = torch.cat([c, c + 10.0], dim=-1).expand(p_n, k, 4)
        iou = det_mod._pairwise_iou(boxes, boxes)
    else:
        c = torch.rand(p_n, k, 2, generator=gen, device="cuda") * side
        wh = 10 + torch.rand(p_n, k, 2, generator=gen, device="cuda") * 290
        boxes = torch.cat([c - wh / 2, c + wh / 2], dim=-1)
        iou = det_mod._pairwise_iou(boxes, boxes)
    if kind == "nan_edges":
        iou[torch.rand(iou.shape, generator=gen, device="cuda") < 0.05] = \
            float("nan")
        edges = [e for b in range(32, k, 32) for e in (b - 1, b)]
        iou[:, edges, :] = float("nan")
        iou[:, :, edges] = float("nan")
    valid = (torch.rand(p_n, k, generator=gen, device="cuda") < 0.85
             ).to(torch.int32)
    if kind in ("disjoint", "identical"):
        valid.fill_(1)
    if kind == "eta_cross":
        thr = 0.55 + 0.2 * torch.rand(p_n, generator=gen, device="cuda")
    valid[0] = 0
    return iou.contiguous(), valid, thr


def nms_bound(torch, valid, kept):
    """B5's byte bound for this data: the fewest overlaps any greedy NMS
    must read. A kept candidate is proven kept only by reading its
    overlap with every earlier kept one (K * (K - 1) / 2 reads for K
    kept); a suppressed one needs one overlap above the threshold; an
    invalid one needs none. Plus valid and thr in and kept out. The
    operations (one compare per overlap read) are far below the byte
    time. Also the bound of reading every matrix whole, P * k * k * 4
    bytes."""
    p_n, k = valid.shape
    n_kept = (kept != 0).sum(1).to(torch.int64)
    n_valid = (valid != 0).sum(1).to(torch.int64)
    reads = int((n_kept * (n_kept - 1) // 2 + n_valid - n_kept).sum().item())
    io = 2 * p_n * k * 4 + p_n * 4
    return ((reads * 4 + io) / PEAK_BYTES * 1e3,
            (p_n * k * k * 4 + io) / PEAK_BYTES * 1e3)


#: B5's cases in check_nms: (name, P, k, kind, eta); the first is the
#: main case (a batch of 8 images x 80 classes at nms_top_k 400), timed
#: with the next two: eta 0.9 at threshold 0.45, which never adapts (the
#: bitmask scan of eta 1), and eta 0.9 at thresholds in [0.55, 0.75],
#: which takes the adaptive path's per-candidate votes until it falls
#: to 0.5
NMS_CASES = ([("main", 640, 400, "boxes", 1.0),
              ("eta0.9_nonadaptive", 640, 400, "boxes", 0.9),
              ("eta0.9_adaptive", 640, 400, "eta_cross", 0.9),
              ("k1", 64, 1, "boxes", 1.0),
              ("k45", 64, 45, "boxes", 1.0),
              ("asymmetric", 64, 77, "asymmetric", 1.0),
              ("asymmetric_eta0.7", 64, 77, "asymmetric", 0.7)]
             + [(f"edge_k{k}_eta{eta}", 64, k, "boxes", eta)
                for k in (31, 32, 33, 63, 64, 65, 127, 128, 129)
                for eta in (1.0, 0.9)]
             + [("disjoint", 64, 400, "disjoint", 1.0),
                ("disjoint_eta0.9", 64, 400, "disjoint", 0.9),
                ("identical", 64, 400, "identical", 1.0),
                ("eta_cross_in_tile", 64, 300, "eta_cross", 0.995),
                ("eta_never_crosses", 64, 200, "eta_cross", 0.9999),
                ("nan_edges", 64, 200, "nan_edges", 1.0),
                ("nan_edges_eta0.9", 64, 200, "nan_edges", 0.9),
                ("k12500_smem_over_48k", 2, 12500, "asymmetric", 1.0)])


def check_nms(torch, nms_mod, det_mod, gen):
    """B5 against its plain version, bit for bit (integer masks), in every
    case of NMS_CASES, rows with valid 0 in each; the main case and its
    two eta 0.9 twins timed. Returns the summary row of the main case."""
    row = None
    for name, p_n, k, kind, eta in NMS_CASES:
        iou, valid, thr = _nms_case(torch, det_mod, gen, p_n, k, kind)
        kept = nms_mod.greedy_nms(iou, valid, thr, eta)
        ref = nms_mod.greedy_nms_plain(iou, valid, thr, eta)
        torch.cuda.synchronize()
        mism = int((kept != ref).sum().item())
        err = (kept - ref).abs().max().item()
        n_kept = int(kept.sum().item())
        ok = mism == 0 and int(kept[0].sum().item()) == 0
        if kind == "disjoint":
            ok = ok and torch.equal(kept[1:], valid[1:])
        if kind == "identical":
            ok = ok and n_kept == p_n - 1
        log(f"B5 greedy NMS {name} P={p_n} k={k} eta={eta}: {mism} "
            f"mismatches (bit-exact required), {n_kept} kept of "
            f"{int(valid.sum().item())} valid")
        if not ok:
            raise RuntimeError(f"greedy NMS kernel disagrees with its plain "
                               f"version ({name})")
        if name == "main":
            ms = time_ms(lambda: nms_mod.greedy_nms(iou, valid, thr, eta),
                         spin=True)
            plain_ms = time_ms(
                lambda: nms_mod.greedy_nms_plain(iou, valid, thr, eta),
                iters=3)
            bms, full_ms = nms_bound(torch, valid, kept)
            log(f"B5 main case: kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"bound {bms:.4f} ms (bytes this data needs; reading every "
                f"matrix whole: {full_ms:.4f} ms), {n_kept / p_n:.1f} kept "
                f"per problem; no single PyTorch call computes greedy NMS "
                f"(torchvision is not installed): library null")
            row = {"max_abs_err": err, "mismatches": mism, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": "bytes",
                   "bound_ms_full_iou": full_ms, "library_ms": None,
                   "tolerance": 0, "kept_per_problem": n_kept / p_n,
                   "shape": f"P={p_n} k={k} eta={eta} random boxes"}
        elif name.startswith("eta0.9_"):
            ms = time_ms(lambda: nms_mod.greedy_nms(iou, valid, thr, eta),
                         spin=True)
            bms, _ = nms_bound(torch, valid, kept)
            path = name.split("_")[1]
            log(f"B5 eta 0.9 {path}: kernel {ms:.4f} ms bound {bms:.4f} ms")
            row.update({f"eta09_{path}_ms": ms,
                        f"eta09_{path}_bound_ms": bms})
        del iou, valid, thr, kept, ref
    return row


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
    graph = graph_report(eng, ticks, "paged")
    return ({"tokens_per_s": n_tok / wall, "tick_ms_mean": tick["mean"],
             "tick_ms_p50": tick["p50"], "ticks": ticks,
             "ttft_ms_p50": ttft["p50"], "warmup_s": t_warm, **graph},
            prompts, [r["tokens"] for r in results])


def graph_report(eng, ticks, label):
    """The engine's compiled programs after its run: one decode capture
    replayed once a tick, one capture per prefill bucket, capture ms per
    signature, and the graph pool's bytes beside ``kv_bytes``. Raises if
    the ticks did not all replay the one captured decode step."""
    dec, cfg = eng.decoder, eng.config
    fn = dec.decode_fn(cfg.num_slots, cfg.max_seq)
    caps = {f"decode_{cfg.num_slots}x{cfg.max_seq}": fn.capture_ms}
    for b in cfg.prefill_buckets:
        caps[f"prefill_1x{b}"] = dec.prefill_fn(1, b).capture_ms
    stats = eng.stats()
    out = {"capture_ms": caps, "decode_traces": fn.trace_counter["traces"],
           "decode_replays": fn.replays,
           "graph_pool_bytes": stats["graph_pool_bytes"],
           "kv_bytes": stats["kv_bytes"],
           "executable_cache": stats["executable_cache"]}
    log(f"{label} engine graphs: decode traces {out['decode_traces']}, "
        f"replays {fn.replays} ({ticks} ticks); capture ms "
        + ", ".join(f"{k} {'/'.join(f'{x:.1f}' for x in v)}"
                    for k, v in caps.items())
        + f"; graph pool {out['graph_pool_bytes']} bytes beside kv_bytes "
        f"{out['kv_bytes']}; executable cache {out['executable_cache']}")
    if out["decode_traces"] != 1 or fn.replays != ticks or \
            any(len(v) != 1 for v in caps.values()):
        raise RuntimeError(f"{label} engine: the decode step was not "
                           f"captured once and replayed every tick")
    return out


def run_eager_lane(torch, model, cfg, prompts, graphed, tokens, layout):
    """The same engine config and requests on the eager lane
    (``disable_graphs``: every program runs as its plain function): its
    tick beside the graphed lane's; the token lists must be equal."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    extra = (dict(kv_layout="paged", page_size=16, paged_attn_impl="kernel")
             if layout == "paged" else dict(kv_layout="slot"))
    with graphs.disable_graphs():
        eng = LLMEngine(model, LLMEngineConfig(
            num_slots=8, max_seq=cfg["max_position_embeddings"], seed=0,
            **extra))
        t0 = time.perf_counter()
        try:
            reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
            results = [r.result(timeout=600) for r in reqs]
            wall = time.perf_counter() - t0
            stats = eng.stats()
        finally:
            eng.drain(timeout=60)
    tick = stats["histograms"]["serving.llm.decode_tick_ms"]
    n_tok = sum(len(r["tokens"]) for r in results)
    same = [r["tokens"] for r in results] == tokens
    log(f"{layout} engine tick: graphed mean {graphed['tick_ms_mean']:.3f} "
        f"ms p50 {graphed['tick_ms_p50']:.3f} ms ({graphed['tokens_per_s']:.1f} "
        f"tokens/s); eager lane mean {tick['mean']:.3f} ms p50 "
        f"{tick['p50']:.3f} ms ({n_tok / wall:.1f} tokens/s); token lists "
        f"equal: {same}")
    if not same:
        raise RuntimeError(f"{layout} engine: the graphed lane's tokens "
                           f"differ from the eager lane's")
    return {"eager_tick_ms_mean": tick["mean"], "eager_tick_ms_p50":
            tick["p50"], "eager_tokens_per_s": n_tok / wall,
            "eager_tokens_equal": same}


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
    graphed = graphed_logits(torch, dec, kv, params, last, "kernel")
    bitwise = torch.equal(graphed, lk)
    log(f"decode logits kernel lane replayed from a CUDA graph (B4 inside) "
        f"vs eager: bitwise equal {bitwise}, max_abs_err "
        f"{(graphed - lk).abs().max().item():.3e}")
    if not bitwise:
        raise RuntimeError("the replayed kernel lane's logits differ from "
                           "the eager lane's")
    return dec, kv, params, last


def graphed_logits(torch, dec, kv, params, last, attn_impl):
    """One paged decode step's logits on the cache's current state from a
    captured CUDA graph: its first call (warm-up and capture), then the
    replay's output."""
    import functools
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving.llm.paged import paged_decode_logits
    prog = graphs.Program(functools.partial(
        paged_decode_logits, dec.spec, attn_impl=attn_impl))
    kv.refresh_block_tables()
    with torch.no_grad():
        prog(params, kv, last)
        out = prog(params, kv, last).clone()
    if prog.replays != 1:
        raise RuntimeError("graphed_logits did not replay")
    return out


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


def smi_sample():
    """Start one ``nvidia-smi`` query of the SM clock, power draw and
    temperature; returns a function that waits for it and gives its
    line (the sample lands in the window that follows, or just after)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)

    def read():
        out, _ = proc.communicate(timeout=60)
        return out.strip().splitlines()[0] if out.strip() else "?"
    return read


def profile_steps(torch, label, step, steps, ranges=(), memory=False):
    """Where one step's time goes: host wall per step without the
    profiler (each step ends in a host fetch or a synchronize), then
    device time per step and by kernel from torch.profiler, with the SM
    clock, power and temperature sampled in that window. ``ranges``
    names record_function ranges the step opens: their rows on the
    device's timeline are spans, not kernels, and are left out. With
    ``memory``, also the device bytes the step's operators allocate
    (``profile_memory``): a copy of a strided view shows there."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    sample = smi_sample()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 profile_memory=memory) as prof:
        for _ in range(steps):
            step()
    smi = sample()
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or e.key in ranges:
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
        f"{sum(r[1] for r in rows):.0f} kernels; SM clock, power, "
        f"temperature {smi}")
    for ms, cnt, key in rows[:10]:
        log(f"  {ms:.3f} ms/step  {cnt:.0f}/step  {key[:100]}")
    out = {"wall_ms": wall_ms, "device_ms": dev_ms, "kernels": rows,
           "events": prof.events(), "smi": smi}
    if memory:
        # operator-level rows (CPU side) carry the device allocations
        alloc = 0
        for e in prof.key_averages():
            b = getattr(e, "self_device_memory_usage", None)
            if b is None:
                b = e.self_cuda_memory_usage
            if not str(e.device_type).endswith("CUDA") and b > 0:
                alloc += b
        out["alloc_bytes"] = alloc / steps
        log(f"  device bytes allocated by the step's operators: "
            f"{alloc / steps / 2**20:.1f} MiB/step")
    return out


def profile_decode(torch, dec, kv, params, last, dev, steps=10,
                   label="decode step", memory=False):
    """Where a decode step's time goes, at the engine's 8 slots, in the
    lane the caller is in (graphed, or eager inside ``disable_graphs``);
    also the host ms of one step call without the tick's fetch (for a
    graph: the replay's host cost) and, graphed, the step's device ms on
    the device's clock (20 replays behind a spin kernel)."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    n = kv.num_slots
    samp = pack_sampling([SamplingParams()] * n, dev)
    state = {"last": last,
             "fin": torch.zeros(n, dtype=torch.bool, device=dev)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def launch():
        state["last"], state["fin"] = dec.decode_step(
            kv, params, state["fin"], state["last"], samp, gen)

    def step():
        launch()
        state["last"].cpu()          # the engine's one fetch per tick

    lane = "graphed" if graphs.graphs_enabled() else "eager lane"
    out = profile_steps(torch, f"{label}, {n} slots, {lane}", step, steps,
                        memory=memory)
    out["call_host_ms"] = host_time_ms(launch)
    line = f"  one step call: host {out['call_host_ms']:.4f} ms"
    if graphs.graphs_enabled():
        out["call_device_ms"] = time_ms(launch, spin=True)
        line += f", device {out['call_device_ms']:.4f} ms (events)"
    log(line)
    return out


def profile_decode_lanes(torch, dec, kv, params, last, dev, label,
                         memory=False):
    """:func:`profile_decode` graphed, then on the eager lane on the same
    cache (each step advances it: the lanes see rows a few dozen apart)."""
    from paddle_tpu_torch.core import graphs
    graphed = profile_decode(torch, dec, kv, params, last, dev,
                             label=label, memory=memory)
    with graphs.disable_graphs():
        eager = profile_decode(torch, dec, kv, params, last, dev,
                               label=label, memory=memory)
    log(f"{label}: host wall a tick graphed {graphed['wall_ms']:.3f} ms vs "
        f"eager {eager['wall_ms']:.3f} ms; device {graphed['device_ms']:.3f}"
        f" vs {eager['device_ms']:.3f} ms (profiler); step call host "
        f"{graphed['call_host_ms']:.4f} vs {eager['call_host_ms']:.4f} ms")
    return graphed, eager


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


def run_slot_serving(torch, model, card, cfg, prompts, paged_tokens):
    """Phase 6a: the static-slot LLMEngine (the default layout) on phase
    4's 8 greedy requests, 32 new tokens each; how many token lists equal
    the paged lane's is printed, not gated (near-ties may flip)."""
    from paddle_tpu_torch.serving.llm import (GPTStaticDecoder, LLMEngine,
                                              LLMEngineConfig)
    t0 = time.perf_counter()
    eng = LLMEngine(model, LLMEngineConfig(
        num_slots=8, max_seq=cfg["max_position_embeddings"],
        kv_layout="slot", seed=0))
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    results = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    stats = eng.stats()
    eng.drain(timeout=60)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not isinstance(eng.decoder, GPTStaticDecoder) or \
            stats["kv_layout"] != "slot":
        raise RuntimeError("kv_layout='slot' did not serve through "
                           "GPTStaticDecoder")
    n_tok = sum(len(r["tokens"]) for r in results)
    hist = stats["histograms"]
    tick = hist["serving.llm.decode_tick_ms"]
    ttft = hist["serving.llm.ttft_ms"]
    same = sum(r["tokens"] == t for r, t in zip(results, paged_tokens))
    log(f"serving GPT slot (8 slots, max_seq "
        f"{cfg['max_position_embeddings']}) on {card}: {len(results)} "
        f"requests, {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
        f"tokens/s; decode tick mean {tick['mean']:.3f} ms p50 "
        f"{tick['p50']:.3f} ms over {tick['count']} ticks; TTFT p50 "
        f"{ttft['p50']:.1f} ms max {ttft['max']:.1f} ms; warmup "
        f"{t_warm:.1f} s; kv_bytes {stats['kv_bytes']}; peak device memory "
        f"{peak:.2f} GiB; token lists equal to the paged lane's: {same} "
        f"of {len(results)}")
    for r in results:
        if len(r["tokens"]) != 32:
            raise RuntimeError(f"request {r['req_id']} returned "
                               f"{len(r['tokens'])} tokens, not 32")
    graph = graph_report(eng, tick["count"], "slot")
    return {"tokens_per_s": n_tok / wall, "tick_ms_mean": tick["mean"],
            "tick_ms_p50": tick["p50"], "ticks": tick["count"],
            "ttft_ms_p50": ttft["p50"], "ttft_ms_max": ttft["max"],
            "warmup_s": t_warm, "peak_gib": peak, "equal_to_paged": same,
            **graph}, [r["tokens"] for r in results]


def compare_slot_lanes(torch, model, cfg, prompts, dev):
    """Phase 6b: one decode step's logits, slot lane against the paged
    gather lane, on the same 8 prefilled prompts."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder
    sd = GPTStaticDecoder(model)
    pd = GPTPagedDecoder(model, page_size=16, attn_impl="gather")
    n, max_seq = len(prompts), cfg["max_position_embeddings"]
    skv, pkv = sd.new_kv(n, max_seq), pd.new_kv(n, max_seq)
    params = sd.params()
    fin = torch.zeros(n, dtype=torch.bool, device=dev)
    samp = pack_sampling([SamplingParams()], dev)
    last = torch.zeros(n, dtype=torch.int32, device=dev)
    for slot, p in enumerate(prompts):
        lp = 1 << (len(p) - 1).bit_length()
        toks = torch.zeros(1, lp, dtype=torch.int32, device=dev)
        toks[0, :len(p)] = torch.tensor(p, dtype=torch.int32, device=dev)
        args = (toks, torch.tensor([len(p)], dtype=torch.int32, device=dev),
                torch.tensor([slot], dtype=torch.int32, device=dev), fin,
                samp, None)
        skv.alloc()
        pkv.alloc()
        pkv.ensure_pages(slot, len(p) + 1)
        nxt, _ = sd.prefill(skv, params, *args)
        pd.prefill(pkv, params, *args)
        last[slot] = nxt[0]
    ls = sd.decode_logits(skv, params, last)
    lg = pd.decode_logits(pkv, params, last, "gather")
    err = (ls - lg).abs().max().item()
    same = bool((ls.argmax(-1) == lg.argmax(-1)).all())
    log(f"decode logits slot lane vs paged gather lane ({n} slots): "
        f"max_abs_err {err:.3e} (tol {LOGIT_TOL}), argmax equal {same}")
    if err > LOGIT_TOL or not torch.isfinite(ls).all():
        raise RuntimeError("slot lane disagrees with the paged gather lane")
    return sd, skv, params, last


def profile_slot_decode(torch, dec, kv, params, last, dev):
    """Phase 6b: where a slot decode step's time goes, the bytes the dense
    step must read (all weights and every slot's max_seq K/V rows), and
    the copy kernels and allocations that a copied layer view would add
    (64 MiB per K or V buffer per layer at 1.3B)."""
    prof, eager = profile_decode_lanes(torch, dec, kv, params, last, dev,
                                       "slot decode step", memory=True)
    weights = sum(t.numel() * t.element_size()
                  for t in [params["tok"], params["pos"], params["fnw"],
                            params["fnb"]]
                  + [t for lp in params["layers"] for t in lp.values()])
    need = weights + kv.kv_bytes()
    copies = [r for r in prof["kernels"] if "opy" in r[2]]
    copy_ms = sum(r[0] for r in copies)
    log(f"slot decode step: device {prof['device_ms']:.3f} ms, reads at "
        f"least {need / 1e9:.3f} GB (weights {weights / 1e9:.3f}, K/V "
        f"{kv.kv_bytes() / 1e9:.3f}) = {need / prof['device_ms'] / 1e9:.3f} "
        f"TB/s; copy kernels {sum(r[1] for r in copies):.0f}/step taking "
        f"{copy_ms:.3f} ms/step")
    return {"step_wall_ms": prof["wall_ms"],
            "step_device_ms": prof["device_ms"],
            "step_kernels": sum(r[1] for r in prof["kernels"]),
            "step_bytes_needed": need, "step_copy_ms": copy_ms,
            "step_alloc_bytes": prof["alloc_bytes"],
            "step_call_host_ms": prof["call_host_ms"],
            "step_call_device_ms": prof["call_device_ms"],
            "eager_step_wall_ms": eager["wall_ms"],
            "eager_step_device_ms": eager["device_ms"],
            "eager_step_kernels": sum(r[1] for r in eager["kernels"]),
            "eager_step_call_host_ms": eager["call_host_ms"],
            "eager_step_alloc_bytes": eager["alloc_bytes"],
            "step_smi": prof["smi"], "eager_step_smi": eager["smi"],
            **time_slot_attention(torch, kv, dev)}


def time_slot_attention(torch, kv, dev):
    """Phase 6b: one layer's slot attention (scores and weights . V, the
    softmax left out) on the device's clock, two ways at the engine's
    shapes: the block-diagonal form of ``_block_decode`` over the
    slot-major layer view ``kv.k[:, 0]`` (``[S, max_seq, H, D]``,
    strided), and two plain batched matmuls over a layer-major
    ``[S, H, max_seq, D]`` copy of it, the layout that would need no such
    form; each against the time to read that layer's K and V once."""
    s, nh, hd, n = kv.num_slots, kv.num_heads, kv.head_dim, kv.max_seq
    kb, vb = kv.k[:, 0], kv.v[:, 0]
    kl, vl = (x.permute(0, 2, 1, 3).contiguous() for x in (kb, vb))
    q = torch.randn(s, nh, hd, device=dev)
    w = torch.softmax(torch.randn(s, nh, n, device=dev), dim=-1)
    eye = torch.eye(nh, device=dev)

    def block_diagonal():
        qbd = (q[:, :, :, None] * eye[:, None, :]).reshape(s, nh * hd, nh)
        torch.bmm(kb.flatten(2), qbd)
        blocks = torch.bmm(w, vb.flatten(2))
        blocks.view(s, nh, nh, hd).diagonal(dim1=1, dim2=2).transpose(
            1, 2).reshape(s, nh * hd)

    def layer_major():
        torch.matmul(kl, q[..., None])
        torch.matmul(w[:, :, None], vl).reshape(s, nh * hd)

    bd_ms = time_ms(block_diagonal, spin=True)
    lm_ms = time_ms(layer_major, spin=True)
    read_ms = 2 * kb.numel() * kb.element_size() / PEAK_BYTES * 1e3
    nl = kv.num_layers
    log(f"slot attention, one layer ({s} slots, {n} rows): block-diagonal "
        f"over the slot-major view {bd_ms:.4f} ms, plain matmuls over a "
        f"layer-major copy {lm_ms:.4f} ms, reading its K and V once "
        f"{read_ms:.4f} ms; x{nl} layers: {bd_ms * nl:.3f} / "
        f"{lm_ms * nl:.3f} / {read_ms * nl:.3f} ms")
    return {"attn_layer_block_diagonal_ms": bd_ms,
            "attn_layer_layer_major_ms": lm_ms,
            "attn_layer_kv_read_bound_ms": read_ms}


#: phase 6c: generate's prompt batch and its new tokens
GEN_BATCH = (2, 64)
GEN_NEW = 32
GEN_MODES = (("static", True), ("concat", "concat"), ("recompute", False))


def run_generate(torch, model, fa_mod, ids, cfg):
    """Phase 6c: ``model.generate`` on a [2, 64] prompt in its three cache
    modes, GEN_NEW greedy tokens each: the static slot, the concat cache
    and the recompute lane, whose full flash forward at every step
    launches B1 once a layer (and the other two never)."""
    outs, ms = {}, {}
    for name, use_cache in GEN_MODES:
        before = fa_mod.flash_attention_fwd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = model.generate(ids, max_length=GEN_NEW,
                                    use_cache=use_cache)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / GEN_NEW
        launched = fa_mod.flash_attention_fwd.launches - before
        want = cfg["num_layers"] * GEN_NEW if use_cache is False else 0
        if launched != want:
            raise RuntimeError(f"generate({name}) launched B1 {launched} "
                               f"times, not {want}")
        if tuple(outs[name].shape) != (ids.shape[0],
                                       ids.shape[1] + GEN_NEW):
            raise RuntimeError(f"generate({name}) returned "
                               f"{tuple(outs[name].shape)}")
    return outs, ms


def _first_differences(a, b):
    """``(row, column)`` of each row's first differing token of two
    equal-shaped token tensors."""
    diff = (a != b).cpu()
    return [(r, int(diff[r].nonzero()[0])) for r in range(diff.shape[0])
            if diff[r].any()]


def check_generate(torch, model, ids, outs, first_ms, runs=2):
    """Phase 6c, off the path: ms per generated token of each mode (the
    median of the path's call and ``runs`` more), then the holds against
    the dense forward (``attn_impl="dense"``, no B1):

    - the recompute lane's last step, a flash forward over its returned
      sequence (B1 at [2, 95]), gives the dense forward's logits within
      LOGIT_TOL;
    - in every mode each generated token is the argmax of the dense
      forward's logits over that mode's sequence, unless that position's
      top-2 gap is under LOGIT_TOL (counted as a near-tie);
    - where two modes' tokens part, they part first at a near-tie of the
      dense forward over their common prefix.

    Any other mismatch fails."""
    res = {}
    lin = ids.shape[1]
    for name, use_cache in GEN_MODES:
        times = [first_ms[name]]
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate(ids, max_length=GEN_NEW, use_cache=use_cache)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / GEN_NEW)
        res[name] = {"ms_per_token": float(np.median(times)),
                     "ms_per_token_runs": times}
    with torch.no_grad():
        seq = outs["recompute"][:, :-1].long()
        flash = model(seq)[:, lin - 1:].float()
        model.set_attn_impl("dense")
        dense = {n: model(outs[n][:, :-1].long())[:, lin - 1:].float()
                 for n, _ in GEN_MODES}
        model.set_attn_impl("flash")
    err = (flash - dense["recompute"]).abs().max().item()
    log(f"generate recompute lane: flash forward over its [{seq.shape[0]}, "
        f"{seq.shape[1]}] sequence vs dense forward: max_abs_err logits "
        f"{err:.3e} (tol {LOGIT_TOL})")
    if err > LOGIT_TOL or not torch.isfinite(flash).all():
        raise RuntimeError("generate's recompute lane: the flash forward "
                           "disagrees with the dense forward")
    res["recompute_flash_vs_dense_max_abs_err"] = err
    near = {}
    for name, _ in GEN_MODES:
        top2 = dense[name].topk(2, dim=-1)
        near[name] = (top2.values[..., 0] - top2.values[..., 1]) < LOGIT_TOL
        miss = top2.indices[..., 0] != outs[name][:, lin:].long()
        bad = int((miss & ~near[name]).sum())
        res[name].update(near_ties=int(near[name].sum()),
                         near_tie_flips=int((miss & near[name]).sum()))
        log(f"generate {name} [{ids.shape[0]}, {lin}] + {GEN_NEW}: "
            f"{res[name]['ms_per_token']:.2f} ms per token (runs "
            f"{', '.join(f'{t:.2f}' for t in res[name]['ms_per_token_runs'])}"
            f"); against the dense forward: near-ties "
            f"{res[name]['near_ties']}, flipped "
            f"{res[name]['near_tie_flips']}, other mismatches {bad}")
        if bad:
            raise RuntimeError(f"generate({name}) disagrees with the dense "
                               f"forward at {bad} positions")
    res["static"].update(generate_lanes(torch, model, ids, outs["static"],
                                        res["static"]["ms_per_token"]))
    parts = {n: _first_differences(outs["static"], outs[n])
             for n in ("concat", "recompute")}
    off_tie = [(n, r, c) for n, p in parts.items() for r, c in p
               if c < lin or not near["static"][r, c - lin]]
    same = not any(parts.values())
    log(f"generate: the three modes' tokens equal: {same}; first "
        f"differences from the static lane {parts}, not at a near-tie "
        f"{off_tie}")
    if off_tie:
        raise RuntimeError(f"generate's modes part away from a near-tie: "
                           f"{off_tie}")
    res["modes_equal"] = same
    return res


def generate_lanes(torch, model, ids, graphed_out, graphed_ms, runs=3):
    """Phase 6c: the static lane of ``generate`` replays its captured
    prefill and decode step (a call captures nothing once the path's
    call has); on the eager lane (``disable_graphs``) it must give the
    same tokens; ms per token of each lane (median of ``runs`` eager
    calls beside the graphed median) and each lane's device ms a token
    from a torch.profiler breakdown of one call."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    b, lin = ids.shape
    max_seq = 1 << (lin + GEN_NEW - 1).bit_length()
    dec = GPTStaticDecoder(model, max_top_k=0)
    fns = (dec.decode_fn(b, max_seq),
           dec.prefill_fn(b, 1 << (lin - 1).bit_length()))
    traces = [f.trace_counter["traces"] for f in fns]
    replays = fns[0].replays

    def call():
        return model.generate(ids, max_length=GEN_NEW, use_cache=True)

    graphed = profile_steps(torch, f"generate static {tuple(ids.shape)} + "
                            f"{GEN_NEW}, graphed", call, 1)
    with graphs.disable_graphs():
        eager = profile_steps(torch, f"generate static {tuple(ids.shape)} + "
                              f"{GEN_NEW}, eager lane", call, 1)
        times, out = [], None
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / GEN_NEW)
    same = torch.equal(out, graphed_out)
    new_traces = [f.trace_counter["traces"] - t for f, t in zip(fns, traces)]
    res = {"eager_ms_per_token": float(np.median(times)),
           "eager_ms_per_token_runs": times,
           "device_ms_per_token": graphed["device_ms"] / GEN_NEW,
           "eager_device_ms_per_token": eager["device_ms"] / GEN_NEW,
           "decode_replays_per_call": (fns[0].replays - replays) / 3,
           "decode_capture_ms": fns[0].capture_ms,
           "prefill_capture_ms": fns[1].capture_ms,
           "eager_tokens_equal": same, "smi": graphed["smi"],
           "eager_smi": eager["smi"]}
    log(f"generate static lane: graphed {graphed_ms:.2f} ms per token vs "
        f"eager {res['eager_ms_per_token']:.2f} (runs "
        f"{', '.join(f'{t:.2f}' for t in times)}); device "
        f"{res['device_ms_per_token']:.3f} vs "
        f"{res['eager_device_ms_per_token']:.3f} ms a token; decode "
        f"replays a call {res['decode_replays_per_call']:.0f}, new captures "
        f"{new_traces}; capture ms decode {fns[0].capture_ms} prefill "
        f"{fns[1].capture_ms}; eager lane's tokens equal: {same}")
    if not same or any(new_traces) or \
            res["decode_replays_per_call"] != GEN_NEW - 1:
        raise RuntimeError("generate's static lane did not replay its "
                           "graphs, or its eager lane's tokens differ")
    return res


def _counters(fa_mod):
    return (fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd_dq,
            fa_mod.flash_attention_bwd_dkv)


def _train_model(torch, cfg, dev, impl, with_optimizer=True, o2=False):
    """GPT-3 1.3B wrapped in ``Model``, weights from seed 0, with AdamW
    (weight decay 0.01, global-norm clip 1.0, linear warmup over cosine
    decay) and the GPT criterion. With ``o2``, ``amp.decorate`` casts the
    model to bfloat16 first and AdamW keeps float32 masters
    (``multi_precision``)."""
    from paddle_tpu_torch import Model, amp
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    net = GPTForCausalLM(GPTConfig(**cfg, attn_impl=impl), device=dev,
                         seed=0)
    if o2:
        amp.decorate(net, level="O2")
    opt = sched = None
    if with_optimizer:
        # GPT-3 1.3B's published peak lr, a short warmup for a 5-step run
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(2e-4, T_max=1000),
                                warmup_steps=2, start_lr=2e-5, end_lr=2e-4)
        opt = AdamW(learning_rate=sched, parameters=net.parameters(),
                    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0),
                    multi_precision=o2, device=dev)
    model = Model(net, device=dev)
    model.prepare(opt, GPTPretrainingCriterion())
    return model, sched


def run_train(torch, fa_mod, ids, cfg, dev):
    """Phase 7: TRAIN_STEPS train_batch calls of the 1.3B model on one
    fixed batch, attention through B1, B2 and B3."""
    model, sched = _train_model(torch, cfg, dev, "flash")
    losses, walls = [], []
    for step in range(TRAIN_STEPS):
        before = [c.launches for c in _counters(fa_mod)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.train_batch([ids], [ids])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        sched.step()
        launched = [c.launches - b for c, b in zip(_counters(fa_mod), before)]
        losses.append(loss)
        log(f"train step {step + 1}: loss {loss:.6f} wall "
            f"{walls[-1] * 1e3:.1f} ms, launches B1/B2/B3 {launched}")
        if launched != [cfg["num_layers"]] * 3:
            raise RuntimeError(f"train step {step + 1} launched B1/B2/B3 "
                               f"{launched} times, not "
                               f"{cfg['num_layers']} each")
        if not math.isfinite(loss):
            raise RuntimeError(f"train step {step + 1}: loss {loss}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall over {TRAIN_STEPS} "
                           f"steps: {losses}")
    return model, {"losses": losses, "step_wall_ms": [w * 1e3
                                                      for w in walls],
                   **program_report(model, "fp32 train step", TRAIN_STEPS)}


def program_report(model, label, steps):
    """The compiled train step's program after ``steps`` train_batch
    calls: exactly one capture, then replays; capture ms and the graph
    pool's bytes."""
    prog = model._train_step_fn["fn"]
    out = {"traces": prog.trace_counter["traces"], "replays": prog.replays,
           "capture_ms": list(prog.capture_ms),
           "graph_pool_bytes": model._train_state.graph_pool.nbytes()}
    log(f"{label}: {out['traces']} capture ({', '.join(f'{c:.1f}' for c in out['capture_ms'])} ms), "
        f"{out['replays']} replays, graph pool {out['graph_pool_bytes']} B")
    if out["traces"] != 1 or out["replays"] != steps - 1:
        raise RuntimeError(f"{label}: {out['traces']} captures and "
                           f"{out['replays']} replays over {steps} calls, "
                           f"not 1 and {steps - 1}")
    return out


def check_lane_losses(got, ref, what, tol=LANE_TOL):
    """``got`` equal to ``ref`` step by step, bitwise or within ``tol``
    relative; the first differing step is named."""
    diffs = [(i + 1, abs(a - b) / abs(b))
             for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    worst = max((r for _, r in diffs), default=0.0)
    first = diffs[0][0] if diffs else None
    log(f"{what}: " + (f"bitwise equal over {len(got)} steps" if not diffs
                       else f"first differing step {first}, worst relative "
                            f"difference {worst:.3e} (tol {tol})"))
    if len(got) != len(ref) or worst > tol:
        raise RuntimeError(f"{what}: {got} vs {ref}")
    return {"bitwise": not diffs, "first_differing_step": first,
            "worst_rel": worst}


def profile_update(torch, model, label, fused=False, passes=10):
    """The optimizer's update alone (global-norm clip and AdamW, in place)
    on the model's parameters and state: from stand-in gradients through
    ``Optimizer._apply_update``, or, ``fused``, ``train_loop``'s flat
    update from the flat gradients its last step left. Eagerly inside
    ``disable_graphs``, else one replay of its own CUDA graph. Host wall
    (to a synchronize), device ms and kernels per update, against its
    byte bound, ``passes`` times the parameters' bytes: AdamW reads p, g,
    m, v and writes p, m, v; the clip reads g for the norm and reads and
    writes it scaled (10; AdamW alone 7; Momentum reads p, g, v and
    writes p, v: 5). It moves the weights: call it last on a model."""
    from paddle_tpu_torch.core import graphs
    opt = model._optimizer
    if fused:
        run = model._fused_loop["update"]
    else:
        trainable = model._train_step_fn["trainable"]
        held = {id(p): i for i, p in enumerate(opt._parameter_list)}
        idx = [held[id(p)] for p in trainable]
        grads = [torch.full_like(p, 1e-4) for p in trainable]

        def run():
            opt._apply_update(idx, grads)
    n_bytes = sum(p.numel() * p.element_size()
                  for p in model._train_step_fn["trainable"])
    opt._fill_scalars()
    graph = None
    if graphs.graphs_enabled():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
    call = graph.replay if graph is not None else run

    def step():
        call()
        torch.cuda.synchronize()

    prof = profile_steps(torch, label, step, 2)
    kernels = sum(r[1] for r in prof["kernels"])
    bound_bytes = passes * n_bytes
    bound_ms = bound_bytes / PEAK_BYTES * 1e3
    log(f"{label}: device {prof['device_ms']:.3f} ms, {kernels:.0f} "
        f"kernels, bound {bound_ms:.3f} ms ({bound_bytes / 1e9:.2f} GB), "
        f"{prof['device_ms'] / bound_ms:.2f}x it")
    del graph
    return {"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
            "kernels": kernels, "bound_ms": bound_ms,
            "bound_bytes": bound_bytes}


def eager_train_lane(torch, ids, cfg, dev, o1, steps, ref_losses):
    """The eager lane (``disable_graphs``) beside a graphed run: a fresh
    1.3B model from seed 0, phase 7's optimizer and batch, ``steps``
    train_batch calls (under ``auto_cast`` when ``o1``), the scheduler
    stepped as in the graphed run; its losses equal the graphed lane's
    (:func:`check_lane_losses`); then its step profiled, and its update
    timed (:func:`profile_update`). Releases the model."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    cast = amp.auto_cast if o1 else contextlib.nullcontext
    what = "O1 bf16" if o1 else "fp32"
    torch.cuda.reset_peak_memory_stats()
    model, sched = _train_model(torch, cfg, dev, "flash")
    losses, walls = [], []

    def one():
        with cast():
            return model.train_batch([ids], [ids])[0]

    with graphs.disable_graphs():
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(one())
            walls.append((time.perf_counter() - t0) * 1e3)
            sched.step()
        peak = torch.cuda.max_memory_allocated() / 2**30
        cmp = check_lane_losses(ref_losses, losses,
                                f"{what} train_batch, graphed vs eager lane")
        prof = profile_train_step(torch, model, ids, o1, "eager lane")
        update = profile_update(torch, model,
                                f"{what} optimizer update, eager lane")
    out = {"losses": losses, "step_wall_ms": walls, **cmp,
           **lane_summary(f"{what} eager lane", prof, update, peak)}
    del model
    release_memory(torch)
    return out


def compare_train_grads(torch, ids, cfg, dev):
    """One step's gradients through flash against dense attention, on
    fresh weights from the same seed. k_proj.bias has a gradient that is
    zero but for rounding (softmax ignores a score shift shared by all
    keys), so it is held to that instead of to a relative error."""
    model, _ = _train_model(torch, cfg, dev, "flash", with_optimizer=False)
    net = model.network
    model.train_batch([ids], [ids], update=False)
    flash = {n: p.grad for n, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    net.set_attn_impl("dense")
    model.train_batch([ids], [ids], update=False)
    top = max(float(g.abs().max()) for g in flash.values())
    worst, worst_name, kbias = 0.0, None, 0.0
    for n, p in net.named_parameters():
        g_f, g_d = flash[n], p.grad
        if n.endswith("k_proj.bias"):
            kbias = max(kbias, float(g_f.abs().max()), float(g_d.abs().max()))
            continue
        rel = float((g_f - g_d).abs().max()) / float(g_d.abs().max())
        if rel > worst:
            worst, worst_name = rel, n
    log(f"train gradients flash vs dense (1.3B, one step): worst max|diff|/"
        f"max|dense| {worst:.3e} at {worst_name} (tol {GRAD_TOL}); "
        f"k_proj.bias max |grad| {kbias:.3e} against the largest gradient "
        f"{top:.3e}")
    # rounding noise: far below what GRAD_TOL allows any other tensor
    if worst > GRAD_TOL or kbias > 1e-4 * top:
        raise RuntimeError("1.3B flash gradients disagree with dense")
    del flash
    return {"worst_rel": worst, "worst_param": worst_name,
            "k_bias_max": kbias, "grad_max": top}


def _by_dtype(fa_mod, dtype):
    """B1, B2 and B3's launches on ``dtype`` inputs so far."""
    return [c.launches_by_dtype.get(dtype, 0) for c in _counters(fa_mod)]


def _check_amp_step(fa_mod, cfg, what, step, dtype, before):
    """One mixed-precision step must launch each of B1, B2 and B3 once per
    layer on ``dtype`` inputs."""
    launched = [a - b for a, b in zip(_by_dtype(fa_mod, dtype), before)]
    if launched != [cfg["num_layers"]] * 3:
        raise RuntimeError(f"{what} step {step + 1} launched B1/B2/B3 "
                           f"{launched} times in {dtype}, not "
                           f"{cfg['num_layers']} each")
    return launched


def run_amp_train(torch, fa_mod, ids, cfg, dev, fp32_first):
    """Phase 9, O1: AMP_STEPS train_batch calls of the 1.3B model under
    amp.auto_cast() (bfloat16), phase 7's optimizer and batch; B1-B3 on
    bfloat16 inputs once per layer a step; float32 weights; the loss
    finite, falling, and at first within AMP_LOSS_TOL of fp32's."""
    from paddle_tpu_torch import amp
    model, sched = _train_model(torch, cfg, dev, "flash")
    losses, walls = [], []
    for step in range(AMP_STEPS):
        before = _by_dtype(fa_mod, "bfloat16")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with amp.auto_cast():
            loss, _ = model.train_batch([ids], [ids])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        sched.step()
        launched = _check_amp_step(fa_mod, cfg, "O1 bf16", step, "bfloat16",
                                   before)
        losses.append(loss)
        log(f"O1 bf16 train step {step + 1}: loss {loss:.6f} wall "
            f"{walls[-1] * 1e3:.1f} ms, bf16 launches B1/B2/B3 {launched}")
        if not math.isfinite(loss):
            raise RuntimeError(f"O1 bf16 step {step + 1}: loss {loss}")
    rel = abs(losses[0] - fp32_first) / abs(fp32_first)
    log(f"O1 bf16 first loss {losses[0]:.6f} vs fp32 first {fp32_first:.6f}:"
        f" relative difference {rel:.3e} (tol {AMP_LOSS_TOL})")
    if not losses[-1] < losses[0] or rel > AMP_LOSS_TOL:
        raise RuntimeError(f"O1 bf16 losses {losses} (fp32 first "
                           f"{fp32_first})")
    if any(p.dtype != torch.float32 for p in model.network.parameters()):
        raise RuntimeError("O1 changed the weights' type")
    return model, {"losses": losses, "first_vs_fp32_rel": rel,
                   "step_wall_ms": [w * 1e3 for w in walls],
                   **program_report(model, "O1 bf16 train step", AMP_STEPS)}


def run_train_loop(torch, fa_mod, ids, cfg, dev):
    """Phase 9's train_loop path: a fresh O1 bf16 1.3B model from seed 0
    trained LOOP_STEPS steps by one ``train_loop`` call on the batch
    stacked LOOP_STEPS times (parameters, gradients and AdamW state in
    flat buffers, one captured program replayed), B1-B3 in bfloat16 once
    per layer a step, the scheduler held (the lr is fixed for a call).
    Then a second call of LOOP_STEPS, timed, and the flat update alone
    (:func:`profile_update`)."""
    from paddle_tpu_torch import amp
    model, _ = _train_model(torch, cfg, dev, "flash")
    stack = np.stack([ids] * LOOP_STEPS)
    before = _by_dtype(fa_mod, "bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with amp.auto_cast():
        losses = model.train_loop([stack], [stack])
    first_ms = (time.perf_counter() - t0) * 1e3
    launched = [a - b for a, b in zip(_by_dtype(fa_mod, "bfloat16"), before)]
    fused = model._fused_loop
    if fused is None:
        raise RuntimeError("train_loop fell back to train_batch on O1")
    prog = fused["fn"]
    log(f"O1 train_loop x{LOOP_STEPS}: losses "
        f"{[round(x, 6) for x in losses]}, first call {first_ms:.1f} ms, "
        f"bf16 launches B1/B2/B3 {launched}, {prog.trace_counter['traces']}"
        f" capture ({', '.join(f'{c:.1f}' for c in prog.capture_ms)} ms), "
        f"{prog.replays} replays, {len(fused['pieces'])} update pieces, "
        f"graph pool {model._train_state.graph_pool.nbytes()} B")
    if launched != [cfg["num_layers"] * LOOP_STEPS] * 3 \
            or prog.trace_counter["traces"] != 1 \
            or prog.replays != LOOP_STEPS - 1:
        raise RuntimeError(f"train_loop: launches {launched}, "
                           f"{prog.trace_counter} traces, {prog.replays} "
                           "replays")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with amp.auto_cast():
        again = model.train_loop([stack], [stack])
    step_ms = (time.perf_counter() - t0) * 1e3 / LOOP_STEPS
    log(f"O1 train_loop, second call: {step_ms:.1f} ms a step (wall, "
        f"{LOOP_STEPS} replays and one read), losses "
        f"{[round(x, 6) for x in again]}")
    update = profile_update(torch, model, "O1 flat update (train_loop), "
                            "one replay", fused=True)
    return model, {"losses": losses, "first_call_ms": first_ms,
                   "step_ms": step_ms, "capture_ms": list(prog.capture_ms),
                   "graph_pool_bytes": model._train_state.graph_pool.nbytes(),
                   "update_pieces": len(fused["pieces"]), "update": update,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def held_lr_train_batch(torch, ids, cfg, dev, steps):
    """The reference of the train_loop path: a fresh O1 bf16 1.3B model
    from seed 0, ``steps`` graphed train_batch calls with the scheduler
    held, as one train_loop call holds it. Returns the losses; releases
    the model."""
    from paddle_tpu_torch import amp
    model, _ = _train_model(torch, cfg, dev, "flash")
    with amp.auto_cast():
        losses = [model.train_batch([ids], [ids])[0] for _ in range(steps)]
    program_report(model, "O1 train_batch, lr held", steps)
    del model
    release_memory(torch)
    return losses


def _labelled(torch, fn, label):
    """``fn`` inside a torch.profiler range named ``label``."""
    def run(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return run


def _kernel_ms(torch, events, name):
    """Device ms of the kernels launched inside the host events ``name``
    (their own and their children's)."""
    total = 0.0
    for e in events:
        if e.name == name and e.device_type == torch.autograd.DeviceType.CPU:
            t = getattr(e, "device_time_total", None)
            total += (e.cuda_time_total if t is None else t) / 1e3
    return total


def _chain(e):
    """A host event and its enclosing host events, innermost first."""
    while e is not None:
        yield e
        e = e.cpu_parent


def op_attribution(torch, events, parts, steps):
    """Device ms a step by part, each kernel counted once, from the host
    ops that launched it: a kernel goes to the first part of ``parts``
    ((name, pattern)) that matches the op it was launched under or an
    op or range enclosing it. A pattern is a regex on the event's name,
    or ``"link:<range>"``: the backward of the ops run inside the
    forward range ``<range>``, found by the sequence number each forward
    op gives its autograd node and the engine's
    ``evaluate_function`` event carries."""
    import re
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    linked = {}
    for name, pat in parts:
        if pat.startswith("link:"):
            label = pat[5:]
            linked[name] = {
                e.sequence_nr for e in cpu if e.sequence_nr >= 0
                and not e.name.startswith("autograd::")
                and any(c.name == label for c in _chain(e))}
    out = {name: 0.0 for name, _ in parts}
    for e in cpu:
        t = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if t is None else t
        if us <= 0:
            continue
        up = [(c.name, c.sequence_nr) for c in _chain(e)]
        for name, pat in parts:
            if pat.startswith("link:"):
                hit = any(n.startswith("autograd::engine::evaluate_function")
                          and sq in linked[name] for n, sq in up)
            else:
                hit = any(re.search(pat, n) for n, _ in up)
            if hit:
                out[name] += us / 1e3 / steps
                break
    return out


#: device time by part of a GPT train step: kernels by name, first match
GPT_PARTS = (("flash_B1_B3", r"flash_(fwd|bwd_dq|bwd_dkv)_kernel<"),
             ("gemm", r"gemm|xmma|nvjet|cutlass|gemv|splitk"))


def profile_train_step(torch, model, ids, o1, lane, batch=None,
                       count=None, unit="tokens", parts=GPT_PARTS,
                       op_parts=(), labels=()):
    """Where one train step's time goes (fp32, or O1 bf16 under
    ``auto_cast``), in the lane the caller is in: wall, device busy and
    idle share, kernels a step, ``unit``/s (``count`` of them a step,
    by default ``ids.size``; a ``batch`` of (inputs, labels) replaces
    ``[ids], [ids]``), and device
    time by part: kernels by name into ``parts`` ((name, regex), first
    match; by default the GEMMs and B1-B3) and the rest; on the eager lane
    also the casts (kernels under ``aten::_to_copy``: the weights to bf16
    each call, the gradients back) and the optimizer (clip and update:
    the kernels launched inside ``Optimizer._apply_update``), which a
    graph's replay does not attribute (its update is timed alone by
    :func:`profile_update`). With ``op_parts``, the eager lane's parts
    are instead :func:`op_attribution`'s, each kernel once by the op that
    launched it (cuDNN names some convolution kernels with no word a
    pattern could rely on), and ``labels`` ((module, attribute, label))
    wraps those functions in ranges named ``label`` for the profile."""
    import re
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    eager = not graphs.graphs_enabled()
    opt = model._optimizer
    what = "O1 bf16" if o1 else "fp32"
    opt._apply_update = _labelled(torch, opt._apply_update,
                                  "optimizer.update")
    cast = amp.auto_cast if o1 else contextlib.nullcontext
    xs, ys = batch if batch is not None else ([ids], [ids])
    count = ids.size if count is None else count

    def step():
        with cast():
            model.train_batch(xs, ys)

    wrapped = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in labels]
    for (mod, attr, fn), (_, _, label) in zip(wrapped, labels):
        setattr(mod, attr, _labelled(torch, fn, label))
    try:
        prof = profile_steps(torch, f"{what} train step "
                             f"{tuple(xs[0].shape)}, {lane}", step, 2,
                             ranges=("optimizer.update",
                                     *(lb for _, _, lb in labels)))
    finally:
        del opt._apply_update
        for mod, attr, fn in wrapped:
            setattr(mod, attr, fn)
    out = {name: 0.0 for name, _ in parts}
    for ms, _, key in prof["kernels"]:
        for name, pattern in parts:
            if re.search(pattern, key, re.I):
                out[name] += ms
                break
    if eager and op_parts:
        out = op_attribution(torch, prof["events"], op_parts, 2)
    elif eager:       # the profile's two steps' events
        if "casts" not in out:
            out["casts"] = _kernel_ms(torch, prof["events"],
                                      "aten::_to_copy") / 2
        out["optimizer"] = _kernel_ms(torch, prof["events"],
                                      "optimizer.update") / 2
    out["other"] = prof["device_ms"] - sum(out.values())
    wall, busy = prof["wall_ms"], prof["device_ms"]
    kernels = sum(r[1] for r in prof["kernels"])
    log(f"{what} train step, {lane}: wall {wall:.1f} ms, "
        f"{count / wall * 1e3:.1f} {unit}/s, device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%), "
        f"{kernels:.0f} kernels; by part (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return {"step_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall, "kernels_per_step": kernels,
            f"{unit}_per_s": count / wall * 1e3, "device_ms_by_part": out,
            "smi": prof["smi"]}


def lane_summary(label, prof, update, peak_gib):
    """One lane's line: step wall, device ms, idle share, kernels a step,
    the optimizer's device ms and the lane's peak memory."""
    out = dict(prof, update=update, peak_gib=peak_gib)
    log(f"{label}: step wall {out['step_ms']:.1f} ms, device "
        f"{out['device_busy_ms']:.1f} ms, idle {100 * out['idle_share']:.1f}"
        f"%, {out['kernels_per_step']:.0f} kernels a step, optimizer update "
        f"{update['device_ms']:.3f} ms ({update['kernels']:.0f} kernels, "
        f"bound {update['bound_ms']:.3f}), peak {out['peak_gib']:.2f} GiB")
    return out


def run_amp_o2(torch, fa_mod, ids, cfg, dev):
    """Phase 9, O2: AMP_SHORT steps of the model cast to bfloat16 by
    ``amp.decorate(level="O2")``, AdamW with float32 masters, under
    ``auto_cast(level="O2")``; B1-B3 in bfloat16; losses finite and
    falling; the parameters stay bfloat16."""
    from paddle_tpu_torch import amp
    model, sched = _train_model(torch, cfg, dev, "flash", o2=True)
    losses = []
    for step in range(AMP_SHORT):
        before = _by_dtype(fa_mod, "bfloat16")
        with amp.auto_cast(level="O2"):
            loss, _ = model.train_batch([ids], [ids])
        sched.step()
        _check_amp_step(fa_mod, cfg, "O2", step, "bfloat16", before)
        losses.append(loss)
    types = {str(p.dtype) for p in model.network.parameters()}
    log(f"O2 bf16 (decorate, AdamW multi_precision): losses "
        f"{[round(x, 6) for x in losses]}, parameter types {types}")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0] or types != {"torch.bfloat16"}:
        raise RuntimeError(f"O2 losses {losses}, parameter types {types}")
    return {"losses": losses}


def run_amp_fp16(torch, fa_mod, ids, cfg, dev):
    """Phase 9, fp16: AMP_SHORT eager steps with ``amp.GradScaler``: the
    forward and loss under ``auto_cast(dtype="float16")``, then
    ``scale(loss).backward()``, ``step``, ``update``; B1-B3 in float16 once
    per layer a step; the losses of the steps not skipped finite."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    model, sched = _train_model(torch, cfg, dev, "flash")
    net, opt = model.network, model._optimizer
    crit = GPTPretrainingCriterion()
    scaler = amp.GradScaler()
    x = torch.from_numpy(ids).to(dev)
    net.train()
    out = []
    for step in range(AMP_SHORT):
        before = _by_dtype(fa_mod, "float16")
        with amp.auto_cast(dtype="float16"):
            loss = crit(net(x), x)
        scaler.scale(loss).backward()
        scaler.step(opt)
        skipped = scaler._found_inf
        scaler.update()
        opt.clear_grad()
        sched.step()
        _check_amp_step(fa_mod, cfg, "fp16", step, "float16", before)
        out.append((float(loss.detach()), skipped, scaler.loss_scale))
        log(f"fp16 GradScaler step {step + 1}: loss {out[-1][0]:.6f}, "
            f"skipped {skipped}, scale after update {scaler.loss_scale}")
    kept = [l for l, skipped, _ in out if not skipped]
    if not all(math.isfinite(x) for x in kept):
        raise RuntimeError(f"fp16 losses of steps not skipped: {kept}")
    return {"losses": [l for l, _, _ in out],
            "skipped": [s_ for _, s_, _ in out],
            "scales": [c for _, _, c in out],
            "found_inf_steps": scaler.found_inf_steps}


def _det_batch(torch, rng, n, dev):
    """n random 608x608 images in [0, 1) and their sizes, on the card."""
    img = torch.from_numpy(rng.random((n, 3, DET_SIZE, DET_SIZE),
                                      dtype=np.float32)).to(dev)
    hw = torch.full((n, 2), DET_SIZE, dtype=torch.int32, device=dev)
    return img, hw


def _det_serve_fn(torch, model):
    def serve(img, hw):
        with torch.inference_mode():
            return model.decode(model(img), hw, **DET_DECODE)
    return serve


def run_detection(torch, model, rng, card, dev, reset_counters):
    """Phase 10: 16 single-image requests, submitted at once, through the
    Engine, then DET_WINDOWS windows of DET_WINDOW more, timed for a
    rate (the median window's); every
    future resolves with dets [1, 100, 6] and a count <= 100. One warm-up
    batch of 8 goes first through the same engine: PyTorch keeps cuDNN's
    execution plans per thread, so the worker's first batch builds them
    (its time is logged as the cold batch). ``reset_counters`` runs after
    it, just before the 16 requests."""
    from paddle_tpu_torch.serving import Engine, EngineConfig
    eng = Engine(_det_serve_fn(torch, model),
                 EngineConfig(batch_buckets=(1, 2, 4, 8), max_batch=8,
                              max_batch_delay=0.05), device=dev)
    eng.submit([rng.random((8, 3, DET_SIZE, DET_SIZE), dtype=np.float32),
                np.full((8, 2), DET_SIZE, np.int32)]).result(timeout=600)
    cold = eng.stats()["histograms"]["serving.batch_exec_ms"]["sum"]
    reqs = [[rng.random((1, 3, DET_SIZE, DET_SIZE), dtype=np.float32),
             np.full((1, 2), DET_SIZE, np.int32)]
            for _ in range(DET_REQUESTS)]
    window = rng.random((DET_WINDOW, 3, DET_SIZE, DET_SIZE), dtype=np.float32)
    reset_counters()
    done = []
    t0 = time.perf_counter()
    futs = eng.submit_many(reqs)
    for f in futs:
        f.add_done_callback(lambda _f: done.append(time.perf_counter()))
    results = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    st = eng.stats()
    lat = (np.array(done) - t0) * 1e3
    bex, fill = (st["histograms"][f"serving.{k}"]
                 for k in ("batch_exec_ms", "batch_fill"))
    batches = st["stats"]["serving.batches"] - 1
    bex_mean = (bex["sum"] - cold) / batches
    fill_mean = (fill["sum"] - 1.0) / batches
    counts = [int(c[0]) for _, c in results]
    log(f"serving YOLOv3-DarkNet53 {DET_SIZE}x{DET_SIZE} ({model.num_classes}"
        f" classes) on {card}: burst of {len(results)} requests (a smoke "
        f"figure from {batches} batches, not a rate) in {wall:.3f} s; "
        f"latency p50 {np.median(lat):.1f} ms max {lat.max():.1f} ms; "
        f"batch_exec_ms mean {bex_mean:.1f} (cold first batch {cold:.1f}),"
        f" batch_fill mean {fill_mean:.3f}; detections per image {counts}")
    # a rate: DET_WINDOWS windows of DET_WINDOW more requests at once
    # through the warm engine, each from its first submit to its last
    # result; the host's clock varies between windows, so all are kept
    rates, win_results, done_sum = [], [], bex["sum"]
    n_batches = batches + 1
    for w in range(DET_WINDOWS):
        win_done = []
        t0 = time.perf_counter()
        futs = eng.submit_many([[window[i:i + 1],
                                 np.full((1, 2), DET_SIZE, np.int32)]
                                for i in range(DET_WINDOW)])
        for f in futs:
            f.add_done_callback(
                lambda _f: win_done.append(time.perf_counter()))
        win_results += [f.result(timeout=600) for f in futs]
        win_wall = time.perf_counter() - t0
        st2 = eng.stats()
        w_batches = st2["stats"]["serving.batches"] - n_batches
        bex_sum = st2["histograms"]["serving.batch_exec_ms"]["sum"]
        w_bex = (bex_sum - done_sum) / w_batches
        n_batches, done_sum = n_batches + w_batches, bex_sum
        rates.append(DET_WINDOW / win_wall)
        # batch completion times: where the window's wall goes
        ends = sorted(round((t - t0) * 1e3) for t in win_done)
        ends = [e for i, e in enumerate(ends) if i == 0 or e - ends[i - 1] > 5]
        log(f"window {w + 1} of {DET_WINDOW} requests: {win_wall:.3f} s = "
            f"{rates[-1]:.2f} images/s over {w_batches} batches, "
            f"batch_exec_ms mean {w_bex:.1f}; batches done at (ms) {ends}")
    eng.drain(timeout=60)
    for dets, cnt in results + win_results:
        if dets.shape != (1, DET_DECODE["keep_top_k"], 6) \
                or cnt.shape != (1,) or cnt.dtype != np.int32 \
                or not 0 <= int(cnt[0]) <= DET_DECODE["keep_top_k"] \
                or not np.isfinite(dets).all():
            raise RuntimeError(f"bad detection result {dets.shape} {cnt}")
        if (dets[0, int(cnt[0]):, 0] != -1).any():
            raise RuntimeError("padding rows must carry label -1")
    return {"burst_s": wall, "burst_latency_ms_p50": float(np.median(lat)),
            "burst_latency_ms_max": float(lat.max()), "burst_batches": batches,
            "batch_exec_ms_mean": bex_mean, "cold_batch_ms": cold,
            "batch_fill": fill_mean, "detections": counts,
            "images_per_s": float(np.median(rates)),
            "images_per_s_by_window": rates}


def detection_checks(torch, model, nms_mod, det_mod, rng, dev):
    """Phase 11, on one batch of 8: the forward's device time, decode's
    time split, the kernel lane against the plain lane on the same IoU,
    and a profile of one served batch."""
    img, hw = _det_batch(torch, rng, 8, dev)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(img), iters=3, warmup=1)
        outs = model(img)
        dec_ms = time_ms(lambda: model.decode(outs, hw, **DET_DECODE),
                         iters=3, warmup=1)
        boxes, scores = [], []

        def heads():
            boxes.clear()
            scores.clear()
            for out, mask, ds in zip(outs, model.anchor_masks,
                                     model.downsamples):
                anchors = []
                for i in mask:
                    anchors += model.anchors[2 * i:2 * i + 2]
                b, s_ = det_mod.yolo_box(
                    out, hw, anchors=anchors, class_num=model.num_classes,
                    conf_thresh=DET_DECODE["conf_thresh"],
                    downsample_ratio=ds)
                boxes.append(b)
                scores.append(s_.transpose(1, 2))
            return torch.cat(boxes, 1), torch.cat(scores, 2)

        yb_ms = time_ms(heads, iters=3, warmup=1)
        bb, sc = heads()
        k = DET_DECODE["nms_top_k"]
        topk_ms = time_ms(lambda: det_mod._top_k(sc, k), iters=3, warmup=1)
        top_s, order = det_mod._top_k(sc, k)
        cand = torch.gather(bb[:, None].expand(*sc.shape, 4), -2,
                            order[..., None].expand(*order.shape, 4))
        iou_ms = time_ms(lambda: det_mod._pairwise_iou(cand, cand), iters=3,
                         warmup=1)
        t_s, labels, cand, iou = det_mod._class_candidates(
            bb, sc, k, True, -1)
        n, c_n = t_s.shape[:2]
        p_n = n * c_n
        valid = (t_s > DET_DECODE["conf_thresh"]).reshape(p_n, k).to(
            torch.int32).contiguous()
        iou_f = iou.reshape(p_n, k, k)
        thr = torch.full((p_n,), DET_DECODE["nms_thresh"], device=dev)
        b5_ms = time_ms(lambda: nms_mod.greedy_nms(iou_f, valid, thr),
                        spin=True)
        kept_k = nms_mod.greedy_nms(iou_f, valid, thr).reshape(n, c_n, k)
        kept_p = nms_mod.greedy_nms_plain(iou_f, valid, thr).reshape(
            n, c_n, k)
        sel_ms = time_ms(lambda: det_mod._select_detections(
            t_s, labels, cand, kept_k != 0, DET_DECODE["keep_top_k"]),
            iters=3, warmup=1)
        dk, ck = det_mod._select_detections(t_s, labels, cand, kept_k != 0,
                                            DET_DECODE["keep_top_k"])
        dp, cp = det_mod._select_detections(t_s, labels, cand, kept_p != 0,
                                            DET_DECODE["keep_top_k"])
        dm, cm = model.decode(outs, hw, **DET_DECODE)
        torch.cuda.synchronize()
    same = (torch.equal(kept_k, kept_p) and torch.equal(dk, dp)
            and torch.equal(ck, cp) and torch.equal(dk, dm)
            and torch.equal(ck, cm))
    n_valid = int(valid.sum().item())
    n_kept = int(kept_k.sum().item())
    b5_bound, _ = nms_bound(torch, valid, kept_k.reshape(p_n, k))
    iou_mb = iou_f.numel() * 4 / 1e6
    log(f"YOLOv3 batch 8: forward {fwd_ms:.2f} ms device; decode "
        f"{dec_ms:.2f} ms = yolo_box x3 {yb_ms:.2f} + candidate top-k "
        f"{topk_ms:.2f} + IoU {iou_ms:.2f} ({iou_mb:.0f} MB) + B5 "
        f"{b5_ms:.3f} (P={p_n}, k={k}, {n_valid} valid, {n_kept} kept, "
        f"bound {b5_bound:.4f} ms) + final top-k/select {sel_ms:.2f} ms "
        f"(parts timed apart; the rest is gathers and reshapes)")
    log(f"kernel lane vs plain lane on the same IoU: masks, dets and counts "
        f"equal {same}; counts {ck.tolist()}")
    if not same:
        raise RuntimeError("B5 lane detections differ from the plain lane")
    serve = _det_serve_fn(torch, model)

    def step():
        serve(img, hw)
        torch.cuda.synchronize()

    prof = profile_steps(torch, "served detection batch of 8", step, 2)
    return {"forward_ms": fwd_ms, "decode_ms": dec_ms, "yolo_box_ms": yb_ms,
            "topk_ms": topk_ms, "iou_ms": iou_ms, "b5_ms": b5_ms,
            "b5_bound_ms": b5_bound, "select_ms": sel_ms, "batch_wall_ms": prof["wall_ms"],
            "batch_device_ms": prof["device_ms"], "kept": n_kept,
            "valid": n_valid}


# -- phases 12 and 13: ResNet-50 and BERT-base training (bench.py) ------------

#: bench.py's TPU shapes: ResNet-50 (:96-112), BERT-base (:131-170)
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 256, 224, 1000
RESNET_FWD_GFLOP = 4.09      # bench.py's forward count an image at 224
BERT_BATCH, BERT_SEQ = 256, 128
MODEL_STEPS = 5              # train_batch steps of each lane

#: device time by part of a ResNet step on the graphed lane: kernels by
#: name, first match (a replay has no host ops; some cuDNN convolution
#: kernels match no pattern and fall into "other")
VISION_PARTS = (
    ("pooling", r"pool"),
    ("conv_and_gemm", r"conv|cudnn|xmma|gemm|implicit|winograd|fft|"
                      r"nchwToNhwc|nhwcToNchw|sm90|sm80|cutlass|nvjet"),
    ("relu", r"clamp|threshold"),
    ("bn_statistics", r"reduce_kernel|welford"),
    ("casts", r"copy"))
#: and on the eager lane, by the host op that launched each kernel
#: (:func:`op_attribution`): BN is the port's F.batch_norm, wrapped in a
#: range for the profile, and the backward of the ops it ran
VISION_OP_PARTS = (
    ("optimizer", r"^optimizer\.update$"),
    ("bn_fwd", r"^F\.batch_norm$"),
    ("bn_bwd", "link:F.batch_norm"),
    ("conv_fwd", r"^aten::convolution$"),
    ("conv_bwd", r"^aten::convolution_backward$"),
    ("pooling", r"pool"),
    ("relu", r"^aten::(relu|threshold_backward|clamp_min)"),
    ("loss", r"cross_entropy|log_softmax|nll_loss"),
    ("linear", r"^aten::(addmm|mm|linear)$"),
    ("residual_add", r"^aten::add_?$"),
    ("casts", r"^aten::_to_copy$"))
#: and of a BERT step
BERT_PARTS = (
    ("gemm", r"gemm|xmma|nvjet|cutlass|gemv|splitk"),
    ("softmax", r"softmax"),
    ("dropout_draws", r"distribution|uniform|philox|bernoulli"),
    ("gelu", r"gelu"),
    ("reductions", r"reduce_kernel|welford"),
    ("embedding", r"index|embedding|gather|scatter|radix|sort"),
    ("casts", r"copy"))


def _resnet_model(torch, dev):
    """bench.py's ResNet-50 run (:100-105): weights from seed 0,
    Momentum(0.1, 0.9, weight decay 1e-4), CrossEntropyLoss."""
    from paddle_tpu_torch import Model, nn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=RESNET_CLASSES, device=dev, seed=0)
    model = Model(net, device=dev)
    model.prepare(Momentum(learning_rate=0.1, momentum=0.9,
                           parameters=net.parameters(), weight_decay=1e-4,
                           device=dev), nn.CrossEntropyLoss())
    return model


def _bert_model(torch, dev, cfg):
    """bench.py's BERT-base run (:143-165): the BERT of ``cfg``
    (``BertConfig()`` there) under its MLM head (a vocabulary linear over
    the sequence output) and its flat cross entropy, AdamW(1e-4, weight
    decay 0.01); weights from seeds 0 and 1."""
    from paddle_tpu_torch import Model, nn
    from paddle_tpu_torch.models import BertModel
    from paddle_tpu_torch.nn.layers_common import reset_parameters
    from paddle_tpu_torch.optimizer import AdamW

    class MLMHead(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bert = BertModel(cfg, device=dev, seed=0)
            self.head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  device=dev)
            reset_parameters(self.head,
                             torch.Generator(device=dev).manual_seed(1))

        def forward(self, ids):
            seq_out, _ = self.bert(ids)
            return self.head(seq_out)

    class FlatCE(torch.nn.Module):
        def forward(self, logits, labels):
            v = logits.shape[-1]
            return nn.functional.cross_entropy(logits.reshape(-1, v),
                                               labels.reshape(-1))

    net = MLMHead()
    model = Model(net, device=dev)
    model.prepare(AdamW(learning_rate=1e-4, parameters=net.parameters(),
                        weight_decay=0.01, device=dev), FlatCE())
    return model


def _state_diff(torch, got, ref):
    """(bitwise equal, worst max |a - b| / max |b| over the tensors)."""
    worst = 0.0
    for k, b in ref.items():
        if not torch.equal(got[k], b):
            scale = float(b.abs().max()) or 1.0
            worst = max(worst, float((got[k] - b).abs().max()) / scale)
    return worst == 0.0, worst


@contextlib.contextmanager
def cudnn_deterministic(torch, on=True):
    """cuDNN held to its deterministic algorithms inside (when ``on``):
    its default weight-gradient algorithms may sum with atomics, so two
    runs of one step part by rounding, which training amplifies."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = was or on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def _listed(batch):
    """A spec's batch as (inputs, labels) lists: one array each, or
    lists (YOLOv3's box and label tensors)."""
    return tuple(list(b) if isinstance(b, (list, tuple)) else [b]
                 for b in batch)


def _train_lane(torch, spec, prec, lane, label):
    """One lane of :func:`model_lanes`: a fresh model (the generator
    re-seeded), MODEL_STEPS train_batch calls (graphed, or eager inside
    ``disable_graphs``), then its profile and its update timed alone.
    Returns (results, buffers after the steps); releases the model."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    xs, ys = _listed(spec["batch"])
    cast = amp.auto_cast if prec == "o1" else contextlib.nullcontext
    torch.cuda.reset_peak_memory_stats()
    P.seed(0)
    model = spec["build"]()
    ctx = graphs.disable_graphs() if lane == "eager" \
        else contextlib.nullcontext()
    losses, walls = [], []
    with ctx:
        for _ in range(MODEL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cast():
                losses.append(model.train_batch(xs, ys)[0])
            walls.append((time.perf_counter() - t0) * 1e3)
        buffers = {k: b.detach().clone()
                   for k, b in model.network.named_buffers()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"{label}: losses {[round(x, 6) for x in losses]}, step walls "
            f"{[round(w, 1) for w in walls]} ms, peak {peak:.2f} GiB")
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{label}: losses {losses}")
        res = {"losses": losses, "step_wall_ms": walls}
        if lane != "eager":
            res.update(program_report(model, label, MODEL_STEPS))
        prof = profile_train_step(
            torch, model, None, prec == "o1", label, batch=(xs, ys),
            count=spec["count"], unit=spec["unit"], parts=spec["parts"],
            op_parts=spec.get("op_parts", ()),
            labels=spec.get("labels", ()))
        update = profile_update(
            torch, model, f"{label}, optimizer update"
            + (" (eager)" if lane == "eager" else " (one replay)"),
            passes=spec["passes"])
        flops = spec["flops"](model.network)
    res.update(lane_summary(label, prof, update, peak))
    per_s = prof[f"{spec['unit']}_per_s"]
    res["train_tflops"] = per_s * flops / 1e12
    log(f"{label}: {per_s:.1f} {spec['unit']}/s, {res['train_tflops']:.2f} "
        f"train TFLOP/s by bench.py's count ({flops / 1e9:.3f} GFLOP per "
        f"{spec['unit'][:-1]})")
    del model
    release_memory(torch)
    return res, buffers


def model_lanes(torch, spec):
    """Phase 12 or 13 on ``spec`` (name, build, batch, count and unit of
    a step, train FLOPs a unit as a function of the model, parts, update
    passes, ``deterministic``): for fp32 and O1 bf16, MODEL_STEPS graphed
    train_batch steps (one capture, then replays) and the same on the
    eager lane on fresh weights, each lane's dropout generator
    re-seeded; the losses and the buffers (BN running statistics) equal
    between the lanes, bitwise or within LANE_TOL relative; each lane
    profiled (wall, device, idle, kernels a step, time by part) and its
    optimizer update timed alone (:func:`_train_lane`). With
    ``deterministic`` (convolutions) both lanes run with cuDNN's
    deterministic algorithms (:func:`cudnn_deterministic`; its default
    ones sum weight gradients with atomics, and steps at lr 0.1 amplify
    what that rounding parts), and the graphed lane runs once more with
    the default algorithms, profiled: the speed a caller gets by default.
    Then an O1 train_loop over the batch stacked MODEL_STEPS times, held
    to the graphed O1 losses (the lr is constant). Returns the results;
    releases every model."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    name = spec["name"]
    xs, ys = _listed(spec["batch"])
    det = spec.get("deterministic", False)
    tol = spec.get("lane_tol", LANE_TOL)
    out = {}
    for prec in ("fp32", "o1"):
        lanes = {}
        with cudnn_deterministic(torch, det):
            for lane in ("graphed", "eager"):
                lanes[lane] = _train_lane(
                    torch, spec, prec, lane, f"{name} {prec} {lane} lane"
                    + (" (cuDNN deterministic)" if det else ""))
        (g, gbuf), (e, ebuf) = lanes["graphed"], lanes["eager"]
        g.update(check_lane_losses(g["losses"], e["losses"],
                                   f"{name} {prec} train_batch, graphed vs "
                                   f"eager lane", tol))
        same, worst = _state_diff(torch, gbuf, ebuf)
        log(f"{name} {prec} buffers ({len(gbuf)}: BN running statistics), "
            f"graphed vs eager: " + ("bitwise equal" if same else
                                     f"worst relative {worst:.3e} (tol "
                                     f"{tol})"))
        if worst > tol:
            raise RuntimeError(f"{name} {prec}: graphed buffers differ from "
                               f"the eager lane's by {worst}")
        g["buffers_bitwise"], g["buffers_worst_rel"] = same, worst
        out[prec] = {"graphed": g, "eager": e}
        if det:
            # the speed a caller gets by default: the graphed lane again
            # with cuDNN free to choose its algorithms
            d, _ = _train_lane(torch, spec, prec, "graphed",
                               f"{name} {prec} graphed lane, default cuDNN "
                               f"algorithms")
            rel = [abs(a - b) / abs(b) for a, b in zip(d["losses"],
                                                       g["losses"])]
            log(f"{name} {prec}: losses with cuDNN's default algorithms "
                f"against the deterministic lane's, relative by step: "
                f"{[float(f'{r:.3e}') for r in rel]}")
            d["losses_rel_to_deterministic"] = rel
            out[prec]["graphed_default_cudnn"] = d
    # the O1 train_loop over the batch stacked MODEL_STEPS times
    torch.cuda.reset_peak_memory_stats()
    P.seed(0)
    model = spec["build"]()
    stack_x = [np.stack([x] * MODEL_STEPS) for x in xs]
    stack_y = [np.stack([y] * MODEL_STEPS) for y in ys]
    with cudnn_deterministic(torch, det):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with amp.auto_cast():
            losses = model.train_loop(stack_x, stack_y)
        first_ms = (time.perf_counter() - t0) * 1e3
        fused = model._fused_loop
        if fused is None:
            raise RuntimeError(f"{name}: train_loop fell back to "
                               f"train_batch")
        prog = fused["fn"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with amp.auto_cast():
            model.train_loop(stack_x, stack_y)
        step_ms = (time.perf_counter() - t0) * 1e3 / MODEL_STEPS
    loop = {"losses": losses, "first_call_ms": first_ms, "step_ms": step_ms,
            "capture_ms": list(prog.capture_ms),
            "graph_pool_bytes": model._train_state.graph_pool.nbytes(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"{name} O1 train_loop x{MODEL_STEPS}: losses "
        f"{[round(x, 6) for x in losses]}, first call {first_ms:.1f} ms, "
        f"second {step_ms:.1f} ms a step, capture "
        f"{[round(c, 1) for c in prog.capture_ms]} ms, graph pool "
        f"{loop['graph_pool_bytes']} B, peak {loop['peak_gib']:.2f} GiB")
    loop.update(check_lane_losses(
        losses, out["o1"]["graphed"]["losses"],
        f"{name} O1 train_loop x{MODEL_STEPS} vs {MODEL_STEPS} graphed "
        f"train_batch", tol))
    out["o1_train_loop"] = loop
    # the loop's program holds the model, and the model its graph pool
    del model, fused, prog, stack_x, stack_y
    release_memory(torch)
    return out


# -- phase 15: YOLOv3-DarkNet53 training (bench.py:185-262) -------------------

#: bench.py's TPU shape (:197): batch 32 at 416x416, width 1.0, 80
#: classes, 50 gt slots
YOLO_BATCH, YOLO_SIZE, YOLO_CLASSES, YOLO_BOXES = 32, 416, 80, 50
#: bench.py's forward count an image at 608 (:255-256), scaled by area
YOLO_FWD_GFLOP_608 = 65.86
#: device time by part of a YOLOv3 step: the graphed lanes by kernel
#: name, the eager lanes by the op that launched each kernel (the loss is
#: yolov3_loss wrapped in a range, its backward linked as BN's is)
YOLO_PARTS = (("leaky_relu", r"leaky"), *VISION_PARTS)
YOLO_OP_PARTS = (
    ("optimizer", r"^optimizer\.update$"),
    ("loss_fwd", r"^yolov3_loss$"),
    ("loss_bwd", "link:yolov3_loss"),
    ("bn_fwd", r"^F\.batch_norm$"),
    ("bn_bwd", "link:F.batch_norm"),
    ("conv_fwd", r"^aten::convolution$"),
    ("conv_bwd", r"^aten::convolution_backward$"),
    ("leaky_relu", r"leaky_relu|LeakyReluBackward"),
    ("upsample_concat", r"^aten::(index_select|cat)$|IndexSelectBackward"),
    ("residual_add", r"^aten::add_?$"),
    ("casts", r"^aten::_to_copy$"))


def _yolo_batch():
    """bench.py:205-217: images and gt boxes from RandomState(0), 1 to 7
    boxes an image in the 50 slots."""
    rng = np.random.RandomState(0)
    x = rng.rand(YOLO_BATCH, 3, YOLO_SIZE, YOLO_SIZE).astype(np.float32)
    gt_box = np.zeros((YOLO_BATCH, YOLO_BOXES, 4), np.float32)
    gt_label = np.zeros((YOLO_BATCH, YOLO_BOXES), np.int64)
    for i in range(YOLO_BATCH):
        for b in range(rng.randint(1, 8)):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            w, h = rng.uniform(0.05, 0.4, 2)
            gt_box[i, b] = [cx, cy, w, h]
            gt_label[i, b] = rng.randint(0, YOLO_CLASSES)
    return x, gt_box, gt_label


def _yolo_model(torch, dev, width=1.0):
    """bench.py's YOLOv3 run (:198-203): the detector from seed 0,
    Momentum(1e-3, 0.9, weight decay 5e-4), YOLOv3Loss."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import YOLOv3, YOLOv3Loss
    net = YOLOv3(num_classes=YOLO_CLASSES, width_mult=width,
                 num_max_boxes=YOLO_BOXES, device=dev, seed=0)
    model = Model(net, device=dev)
    model.prepare(Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=net.parameters(), weight_decay=5e-4,
                           device=dev), YOLOv3Loss(net))
    return model


def yolo_spec(torch, dev, batch, width=1.0):
    """Phase 15's :func:`model_lanes` spec: bench.py's model (at
    ``width``) and ``batch``, images/s, bench.py's FLOP count (3 x 65.86
    GFLOP x (size/608)^2 an image), parts by kernel name and by op (the
    loss, BN and convolutions each forward and backward), cuDNN
    deterministic and the lanes held bitwise."""
    from paddle_tpu_torch.nn import functional as port_functional
    from paddle_tpu_torch.vision.models import yolov3 as yolo_mod
    x, gt_box, gt_label = batch
    size = x.shape[-1]
    return dict(
        name="YOLOv3-DarkNet53",
        build=lambda: _yolo_model(torch, dev, width),
        batch=([x], [gt_box, gt_label]), count=x.shape[0], unit="imgs",
        flops=lambda net: 3 * YOLO_FWD_GFLOP_608 * 1e9 * (size / 608) ** 2,
        parts=YOLO_PARTS, op_parts=YOLO_OP_PARTS,
        labels=((port_functional, "batch_norm", "F.batch_norm"),
                (yolo_mod, "yolov3_loss", "yolov3_loss")),
        passes=5, deterministic=True, lane_tol=0.0)


# -- phase 16: the GPT at S = 4096 under recompute (bench.py:264-319) ---------

#: bench.py's TPU config (:282-287) and batch
LONG_CFG = dict(vocab_size=50304, hidden_size=768, num_layers=12,
                num_heads=12, max_position_embeddings=4096,
                hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LONG_BATCH = (4, 4096)
#: the lanes: (precision, lane, every block recomputed)
LONG_LANES = (("o1", "graphed", True), ("o1", "eager", True),
              ("fp32", "graphed", True), ("o1", "graphed", False))


def _long_gpt_model(torch, dev, cfg, recompute):
    """bench.py's GPT at S = 4096 (:282-304): weights from seed 0, every
    ``layers.{i}`` forward through ``fleet.utils.recompute`` (when
    ``recompute``), AdamW(1e-4, weight decay 0.01), the GPT criterion."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.distributed.fleet import utils as fleet_utils
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    net = GPTForCausalLM(GPTConfig(**cfg, attn_impl="auto"), device=dev,
                         seed=0)
    if recompute:
        blocks = tuple(f"layers.{i}" for i in range(cfg["num_layers"]))
        for name, sub in net.named_modules():
            if name.endswith(blocks):
                orig = sub.forward
                sub.forward = (lambda *a, __f=orig, **k:
                               fleet_utils.recompute(__f, *a, **k))
    model = Model(net, device=dev)
    model.prepare(AdamW(learning_rate=1e-4, parameters=net.parameters(),
                        weight_decay=0.01, device=dev),
                  GPTPretrainingCriterion())
    return model


def _long_lane(torch, fa_mod, dev, cfg, ids, prec, lane, recompute):
    """One lane of phase 16: a fresh model, MODEL_STEPS train_batch calls
    (B1 launching twice a layer a step with recompute, once without; B2
    and B3 once), then its profile. Returns the lane's results."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    label = (f"GPT S={ids.shape[1]} {prec} {lane} lane, "
             + ("recompute" if recompute else "no recompute"))
    cast = amp.auto_cast if prec == "o1" else contextlib.nullcontext
    ctx = graphs.disable_graphs() if lane == "eager" \
        else contextlib.nullcontext()
    torch.cuda.reset_peak_memory_stats()
    P.seed(0)
    model = _long_gpt_model(torch, dev, cfg, recompute)
    want = [cfg["num_layers"] * (2 if recompute else 1),
            cfg["num_layers"], cfg["num_layers"]]
    losses, walls = [], []
    with ctx:
        for step in range(MODEL_STEPS):
            before = [c.launches for c in _counters(fa_mod)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cast():
                losses.append(model.train_batch([ids], [ids])[0])
            walls.append((time.perf_counter() - t0) * 1e3)
            launched = [c.launches - b
                        for c, b in zip(_counters(fa_mod), before)]
            if launched != want:
                raise RuntimeError(f"{label}: step {step + 1} launched "
                                   f"B1/B2/B3 {launched}, not {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"{label}: losses {[round(x, 6) for x in losses]}, step walls "
            f"{[round(w, 1) for w in walls]} ms, B1/B2/B3 {want} a step, "
            f"peak {peak:.2f} GiB")
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{label}: losses {losses}")
        res = {"losses": losses, "step_wall_ms": walls, "peak_gib": peak,
               "launches_per_step": want}
        if lane != "eager":
            res.update(program_report(model, label, MODEL_STEPS))
        prof = profile_train_step(torch, model, ids, prec == "o1", label)
    res.update(prof)
    flash = prof["device_ms_by_part"]["flash_B1_B3"]
    res["flash_share"] = flash / max(prof["device_busy_ms"], 1e-9)
    log(f"{label}: {prof['tokens_per_s']:.1f} tokens/s, B1-B3 "
        f"{flash:.2f} ms of {prof['device_busy_ms']:.2f} device "
        f"({100 * res['flash_share']:.1f}%)")
    del model
    release_memory(torch)
    return res


def _long_grads(torch, dev, cfg, ids, recompute):
    """One eager O1 step's loss and gradients (``train_batch(update=
    False)``) on fresh weights, and the step's peak memory."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    P.seed(0)
    model = _long_gpt_model(torch, dev, cfg, recompute)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with graphs.disable_graphs(), amp.auto_cast():
        loss = model.train_batch([ids], [ids], update=False)[0]
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    grads = {n: p.grad for n, p in model.network.named_parameters()}
    del model
    return loss, grads, peak


def run_long_gpt(torch, fa_mod, dev, cfg, ids, reset_counters,
                 read_counters):
    """Phase 16 on ``cfg`` and ``ids``: the lanes of LONG_LANES, each
    with its launches read (counts set to 0 before it); the O1 graphed
    lane's losses against the eager lane's (bitwise or LANE_TOL) and
    against the graphed lane without recompute (bitwise); one eager O1
    step's loss and gradients with and without recompute, bitwise, with
    the step's peak memory beside (what recompute saves)."""
    out, paths, dtypes = {}, {}, {}
    for prec, lane, rc in LONG_LANES:
        key = f"{prec}_{lane}" + ("" if rc else "_no_recompute")
        reset_counters()
        out[key] = _long_lane(torch, fa_mod, dev, cfg, ids, prec, lane, rc)
        paths[key] = read_counters()
        dtypes[key] = {c.__name__: dict(c.launches_by_dtype)
                       for c in _counters(fa_mod)}
    g = out["o1_graphed"]
    g.update(eager=check_lane_losses(
        g["losses"], out["o1_eager"]["losses"],
        f"GPT S={ids.shape[1]} O1 recompute, graphed vs eager lane"))
    g.update(no_recompute=check_lane_losses(
        g["losses"], out["o1_graphed_no_recompute"]["losses"],
        f"GPT S={ids.shape[1]} O1 graphed, recompute vs none", tol=0.0))
    rl, rg, rpeak = _long_grads(torch, dev, cfg, ids, True)
    pl, pg, ppeak = _long_grads(torch, dev, cfg, ids, False)
    differ = [n for n, v in rg.items() if not torch.equal(v, pg[n])]
    log(f"GPT S={ids.shape[1]} O1 eager step, recompute vs none: loss "
        f"{rl!r} vs "
        f"{pl!r}, gradients bitwise equal in {len(rg) - len(differ)} of "
        f"{len(rg)} tensors; the step's peak above its weights and state "
        f"{rpeak:.2f} GiB with recompute, {ppeak:.2f} GiB without "
        f"({ppeak - rpeak:.2f} GiB saved)")
    if rl != pl or differ:
        raise RuntimeError(f"GPT S={ids.shape[1]}: recompute changes the "
                           f"loss or the "
                           f"gradients of {differ[:5]}")
    out["recompute_vs_none"] = {
        "loss": rl, "grads_bitwise": True, "step_peak_gib": rpeak,
        "step_peak_gib_no_recompute": ppeak}
    del rg, pg
    release_memory(torch)
    return out, paths, dtypes


#: a lane's distance from float64 may exceed its yardstick's by this factor
WITNESS_RATIO = 1.2
#: micro-batches of the float64 witness step (its memory at the full batch
#: would not fit beside the fp32 model); the loss is a mean over equal
#: micro-batches, so their mean gradient is the full batch's
F64_MICRO = 4


def _bert_grads(torch, net, ids, labels, micro=1):
    """d(flat cross entropy of ``net(ids)``)/d(parameter) for every
    parameter, over ``micro`` equal micro-batches averaged (zeros where
    the loss does not reach)."""
    from paddle_tpu_torch import nn
    params = dict(net.named_parameters())
    total = {n: torch.zeros_like(p) for n, p in params.items()}
    for x, y in zip(ids.chunk(micro), labels.chunk(micro)):
        logits = net(x)
        loss = nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.reshape(-1)) / micro
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        for n, g in zip(params, grads):
            if g is not None:
                total[n] += g
        del logits, loss, grads
    return total


@contextlib.contextmanager
def plain_flash(fa_mod):
    """B1-B3's wrappers swapped for their plain versions inside: the flash
    formula (O and LSE saved, delta = rowsum(dO O), P recomputed from the
    LSE, as the JAX package's ``_fa_core``) in PyTorch float32 on the
    card, with no kernel."""
    saved = (fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd_dq,
             fa_mod.flash_attention_bwd_dkv)
    fa_mod.flash_attention_fwd = (
        lambda q, k, v, causal=False, scale=None:
        fa_mod.flash_attention_fwd_plain(q, k, v, causal, scale))
    fa_mod.flash_attention_bwd_dq = fa_mod.flash_attention_bwd_dq_plain
    fa_mod.flash_attention_bwd_dkv = fa_mod.flash_attention_bwd_dkv_plain
    try:
        yield
    finally:
        (fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd_dq,
         fa_mod.flash_attention_bwd_dkv) = saved


def bert_flash_checks(torch, fa_mod, dev, ids, cfg):
    """Phase 13's kernel checks on the BERT of ``cfg`` (BERT-base): (a)
    ``BertModel`` in eval with no mask at ``ids``' [256, 128] takes B1
    (non-causal, D = 64) once a layer, held against the dense lane (max
    |diff| over max |dense| of the sequence and pooled outputs): fp32
    within TOL; in O1 bf16 the flash lane's distance from the dense fp32
    output may be at most WITNESS_RATIO times the dense bf16 lane's (the
    fp32 output is the reference both lanes round away from). (b) one
    eager train step with both dropouts 0 runs B1-B3 once a layer; each
    gradient, flash against dense, within GRAD_TOL of its tensor's
    largest entry (phase 8's rule), or, where it is not, the kernel lane
    no farther from the same step in float64 (dense, F64_MICRO
    micro-batches) than WITNESS_RATIO times the flash formula computed in
    float32 without the kernels (:func:`plain_flash`) is: the formula
    (delta from the stored O) itself lies farther from float64 than a
    dense float32 step where the gradients cancel, and the kernel is held
    to the formula's own accuracy (the distances of all three lanes are
    printed); k_proj.bias, zero but for rounding, held to 1e-4 of the
    largest gradient; the pooler, which the MLM loss does not reach, zero
    in both."""
    import copy
    import dataclasses
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.models import BertModel
    n_layers = cfg.num_layers
    net = BertModel(cfg, device=dev, seed=0).eval()
    x = torch.from_numpy(ids).to(dev)

    def diff(got, ref):
        return max(float((a.float() - b.float()).abs().max())
                   / float(b.float().abs().max()) for a, b in zip(got, ref))

    def set_impl(layers, impl):
        for layer in layers:
            layer.self_attn.attn_impl = impl

    res, outs = {}, {}
    for prec, cast in (("fp32", contextlib.nullcontext),
                       ("bf16", amp.auto_cast)):
        before = fa_mod.flash_attention_fwd.launches
        with torch.no_grad(), cast():
            outs[f"flash_{prec}"] = net(x)
            launched = fa_mod.flash_attention_fwd.launches - before
            set_impl(net.encoder.layers, "dense")
            outs[f"dense_{prec}"] = net(x)
            set_impl(net.encoder.layers, "auto")
        if launched != n_layers:
            raise RuntimeError(f"BERT eval forward {prec}: {launched} B1 "
                               f"launches, {n_layers} expected")
    ref = outs["dense_fp32"]
    err32 = diff(outs["flash_fp32"], ref)
    w_flash, w_dense = diff(outs["flash_bf16"], ref), diff(outs["dense_bf16"],
                                                           ref)
    err16 = diff(outs["flash_bf16"], outs["dense_bf16"])
    log(f"BERT-base eval forward {list(ids.shape)}: B1 launched {n_layers} "
        f"times a precision; fp32 flash vs dense max |diff| / max |dense| "
        f"{err32:.3e} (tol {TOL['fp32']:.0e}); O1 bf16 from the dense fp32 "
        f"output: flash {w_flash:.3e}, dense {w_dense:.3e} (flash at most "
        f"{WITNESS_RATIO} x dense); flash bf16 vs dense bf16 {err16:.3e}")
    if err32 > TOL["fp32"] or w_flash > WITNESS_RATIO * w_dense:
        raise RuntimeError(f"BERT eval forward: fp32 error {err32}, bf16 "
                           f"flash {w_flash} vs dense {w_dense} from fp32")
    res.update(eval_fp32_max_diff_over_max=err32,
               eval_bf16_max_diff_over_max=err16,
               eval_bf16_flash_vs_fp32=w_flash,
               eval_bf16_dense_vs_fp32=w_dense)
    del net, outs, ref
    release_memory(torch)
    model = _bert_model(torch, dev, dataclasses.replace(
        cfg, hidden_dropout_prob=0.0, attention_dropout_prob=0.0))
    net = model.network
    layers = net.bert.encoder.layers
    with graphs.disable_graphs():
        before = [c.launches for c in _counters(fa_mod)]
        model.train_batch([ids], [ids.astype(np.int64)], update=False)
        launched = [c.launches - b for c, b in zip(_counters(fa_mod), before)]
        flash = {n: p.grad.detach().clone()
                 for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        with plain_flash(fa_mod):
            model.train_batch([ids], [ids.astype(np.int64)], update=False)
        formula = {n: p.grad.detach().clone()
                   for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        set_impl(layers, "dense")
        model.train_batch([ids], [ids.astype(np.int64)], update=False)
        dense = {n: p.grad.detach().clone()
                 for n, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    net64 = copy.deepcopy(net).double()
    del model, net
    release_memory(torch)
    lab = torch.from_numpy(ids.astype(np.int64)).to(dev)
    g64 = _bert_grads(torch, net64, lab, lab, micro=F64_MICRO)
    del net64
    release_memory(torch)

    def rel(a, b):
        return float((a.double() - b).abs().max()) / (
            float(b.abs().max()) or 1.0)

    top = max(float(g.abs().max()) for g in flash.values())
    kbias, zero, rows = 0.0, [], []
    for n, g_d in dense.items():
        g_f = flash[n]
        if n.endswith("k_proj.bias"):
            kbias = max(kbias, float(g_f.abs().max()), float(g_d.abs().max()))
            continue
        m = float(g_d.abs().max())
        if m == 0.0:
            zero.append(n)
            if float(g_f.abs().max()) != 0.0:
                raise RuntimeError(f"{n}: zero dense gradient, flash "
                                   f"{float(g_f.abs().max())}")
            continue
        e = float((g_f - g_d).abs().max()) / m
        rows.append((e, n, rel(g_f, g64[n]), rel(formula[n], g64[n]),
                     rel(g_d, g64[n])))
    rows.sort(reverse=True)
    over = [r for r in rows if r[0] > GRAD_TOL]
    bad = [r for r in over if r[2] > WITNESS_RATIO * r[3]]
    far = max(rows, key=lambda r: r[2])
    log(f"BERT-base one step, dropout 0 {list(ids.shape)}: B1/B2/B3 "
        f"launched {launched}; gradients flash vs dense, per tensor max "
        f"|diff| / max |dense|: worst {rows[0][0]:.3e} at {rows[0][1]} (tol "
        f"{GRAD_TOL}); {len(over)} tensors over it, each held to the "
        f"float64 step ({F64_MICRO} micro-batches), distance from it of "
        f"kernel / formula in fp32 / dense fp32 (kernel at most "
        f"{WITNESS_RATIO} x formula): "
        + ("; ".join(f"{n} {f:.3e} / {p_:.3e} / {d_:.3e}"
                     for _, n, f, p_, d_ in over[:8]) or "none")
        + f"; kernel farthest from float64 at {far[1]}: {far[2]:.3e} / "
        f"{far[3]:.3e} / {far[4]:.3e}; k_proj.bias max |grad| {kbias:.3e} "
        f"of the largest {top:.3e}; zero in both: {zero}")
    if launched != [n_layers] * 3 or bad or kbias > 1e-4 * top:
        raise RuntimeError(f"BERT-base flash gradients disagree with dense "
                           f"and float64: {bad[:4]}")
    res.update(grad_worst_rel=rows[0][0], grad_worst_param=rows[0][1],
               grad_over_tol={n: {"flash_vs_dense": e, "flash_vs_f64": f,
                                  "formula_vs_f64": p_,
                                  "dense_vs_f64": d_}
                              for e, n, f, p_, d_ in over},
               grad_farthest_from_f64={
                   "param": far[1], "flash_vs_f64": far[2],
                   "formula_vs_f64": far[3], "dense_vs_f64": far[4]},
               k_bias_max=kbias, grad_max=top, zero_grads=zero,
               step_launches=launched)
    del flash, formula, dense, g64
    release_memory(torch)
    return res


def _greedy_holds(torch, model, ref, prompts, tokens, near):
    """Per request, the logits of ``model`` and of ``ref`` (its float32
    copy, dense attention) at each position that chose one of ``tokens``
    (teacher-forced over the prompt and the tokens before); returns
    (max |model - ref| over them, [(request, step, token, ref argmax,
    ref gap)] where the token is not within ``near`` of the reference's
    best logit). ``near=None`` measures only."""
    worst, off = 0.0, []
    with torch.no_grad():
        for r, (p, toks) in enumerate(zip(prompts, tokens)):
            seq = torch.tensor([p + list(toks[:-1])], device=ref.device)
            sl = slice(len(p) - 1, None)
            want = ref(seq)[0, sl].float()
            got = model(seq)[0, sl].float()
            worst = max(worst, float((got - want).abs().max()))
            if near is None:
                continue
            top = want.max(dim=-1).values
            chosen = want.gather(1, torch.tensor(toks, device=ref.device)[
                :, None])[:, 0]
            for t in (top - chosen > near).nonzero()[:, 0].tolist():
                off.append((r, t, toks[t], int(want[t].argmax()),
                            float(top[t] - chosen[t])))
    return worst, off


def check_c6(torch, dev):
    """Phase 14: the default paged engine ("auto") serves a float16 GPT
    and a bfloat16 GPT of head dim 100 through the paged kernel (B4
    launched), and an explicit "kernel" is the same lane. Each lane's
    greedy tokens, the kernel's and an explicit gather engine's, are
    held to the model's float32 copy with dense attention, teacher-forced
    over each lane's own tokens: every token is that reference's argmax,
    or within twice the model's own distance from it (the dense forward
    in the model's type against the float32 copy, measured over the same
    sequences) of its best logit: a near-tie, which a lane in a 16-bit
    type may break either way. Where the two lanes' tokens part, they
    part at such a near-tie (counted)."""
    import copy
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import paged_attention as pa_mod
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder
    base = dict(vocab_size=1024, num_layers=4, max_position_embeddings=256,
                hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    cases = (("float16, head_dim 128", torch.float16,
              dict(base, hidden_size=512, num_heads=4,
                   intermediate_size=2048)),
             ("bfloat16, head_dim 100", torch.bfloat16,
              dict(base, hidden_size=400, num_heads=4,
                   intermediate_size=1600)))
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, base["vocab_size"], n).tolist()
               for n in (9, 40, 100, 130)]
    out = {}
    for what, dt, cfg in cases:
        model = GPTForCausalLM(GPTConfig(**cfg), device=dev,
                               seed=0).eval().to(dt)
        tokens, lanes, launched = {}, {}, {}
        for lane in ("auto", "gather"):
            before = pa_mod.paged_attention.launches
            eng = LLMEngine(model, LLMEngineConfig(
                num_slots=4, max_seq=256, kv_layout="paged", page_size=16,
                paged_attn_impl=lane))
            lanes[lane] = eng.decoder.attn_impl
            try:
                reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
                tokens[lane] = [r.result(timeout=300)["tokens"]
                                for r in reqs]
            finally:
                eng.drain(timeout=120)
            launched[lane] = pa_mod.paged_attention.launches - before
        explicit = GPTPagedDecoder(model, page_size=16,
                                   attn_impl="kernel").attn_impl
        ref = copy.deepcopy(model).float()
        ref.set_attn_impl("dense")
        model.set_attn_impl("dense")
        noise = max(_greedy_holds(torch, model, ref, prompts, tokens[n],
                                  None)[0] for n in tokens)
        off = {n: _greedy_holds(torch, model, ref, prompts, tokens[n],
                                2 * noise)[1] for n in tokens}
        parts = [(r, next(t for t, (a, b) in enumerate(zip(ta, tb))
                          if a != b))
                 for r, (ta, tb) in enumerate(zip(tokens["auto"],
                                                  tokens["gather"]))
                 if ta != tb]
        log(f"C6 {what}: default engine lane {lanes['auto']} (B4 launched "
            f"{launched['auto']} times, the gather engine "
            f"{launched['gather']}), explicit kernel lane {explicit}; "
            f"tokens equal the gather engine's "
            f"{tokens['auto'] == tokens['gather']} (first differences "
            f"(request, step) {parts}); against the float32 copy, the "
            f"model's own logit distance {noise:.3e}, tokens off its argmax "
            f"by more than twice that: {off}")
        if lanes != {"auto": "kernel", "gather": "gather"} \
                or explicit != "kernel" or launched["auto"] < 1 \
                or launched["gather"] != 0 or any(off.values()) \
                or not all(len(t) == 16 for t in tokens["auto"]):
            raise RuntimeError(f"C6 {what}: lanes {lanes}, launches "
                               f"{launched}, explicit {explicit}, off the "
                               f"float32 reference {off}")
        out[what] = {"lane": lanes["auto"], "launches": launched["auto"],
                     "tokens_equal": tokens["auto"] == tokens["gather"],
                     "first_differences": parts, "logit_noise": noise}
        del model, ref
        release_memory(torch)
    return out


def training_phases(torch, fa_mod, cfg, dev, ids, reset_counters,
                    read_counters, stamp):
    """Phases 7 to 9 on the model config ``cfg`` and the batch ``ids``;
    returns their results by name."""
    # -- phase 7: the training path ------------------------------------------
    stamp("7 training path")
    reset_counters()
    train_model, train = run_train(torch, fa_mod, ids, cfg, dev)
    train_launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"training path launches: {train_launches}; losses "
        f"{[round(x, 6) for x in train['losses']]}; peak device memory "
        f"{peak:.2f} GiB")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if train_launches[name] < 1:
            raise RuntimeError(f"kernel {name} was not launched on the "
                               f"training path")

    # -- phase 8: off the training path --------------------------------------
    stamp("8 training checks")
    from paddle_tpu_torch.core import graphs
    prof = profile_train_step(torch, train_model, ids, False, "graphed")
    update = profile_update(torch, train_model,
                            "fp32 optimizer update, one replay")
    train["graphed"] = lane_summary("fp32 graphed lane", prof, update, peak)
    del train_model
    release_memory(torch)
    train["eager"] = eager_train_lane(torch, ids, cfg, dev, False,
                                      TRAIN_STEPS, train["losses"])
    with graphs.disable_graphs():
        grads = compare_train_grads(torch, ids, cfg, dev)
    release_memory(torch)

    # -- phase 9: the mixed-precision training paths --------------------------
    stamp("9 mixed-precision training paths")
    flash_names = [c.__name__ for c in _counters(fa_mod)]
    amp_launches, amp_dtypes, amp_peak = {}, {}, {}

    def amp_path(name, dtype, run):
        """Phase 9's path ``name``: B1-B3 launched, in ``dtype`` only."""
        reset_counters()
        out = run()
        amp_launches[name] = read_counters()
        amp_dtypes[name] = {c.__name__: dict(c.launches_by_dtype)
                            for c in _counters(fa_mod)}
        amp_peak[name] = torch.cuda.max_memory_allocated() / 2**30
        log(f"{name} path launches: {amp_launches[name]}, B1-B3 by type "
            f"{amp_dtypes[name]}; peak device memory {amp_peak[name]:.2f} "
            f"GiB")
        for n in flash_names:
            got = amp_dtypes[name][n]
            if amp_launches[name][n] < 1 or set(got) != {dtype}:
                raise RuntimeError(f"kernel {n} was launched {got} on the "
                                   f"{name} path, not in {dtype} only")
        return out

    amp_model, amp_o1 = amp_path(
        "training_amp_bf16", "bfloat16",
        lambda: run_amp_train(torch, fa_mod, ids, cfg, dev,
                              train["losses"][0]))
    prof = profile_train_step(torch, amp_model, ids, True, "graphed")
    update = profile_update(torch, amp_model,
                            "O1 bf16 optimizer update, one replay")
    amp_o1["graphed"] = lane_summary("O1 bf16 graphed lane", prof, update,
                                     amp_peak["training_amp_bf16"])
    del amp_model
    release_memory(torch)
    amp_o1["eager"] = eager_train_lane(torch, ids, cfg, dev, True,
                                       AMP_STEPS, amp_o1["losses"])
    loop_ref = held_lr_train_batch(torch, ids, cfg, dev, LOOP_STEPS)
    loop_model, amp_loop = amp_path(
        "training_loop_bf16", "bfloat16",
        lambda: run_train_loop(torch, fa_mod, ids, cfg, dev))
    amp_loop["train_batch_losses"] = loop_ref
    amp_loop.update(check_lane_losses(
        amp_loop["losses"], loop_ref,
        f"O1 train_loop x{LOOP_STEPS} vs {LOOP_STEPS} graphed train_batch"))
    del loop_model
    release_memory(torch)
    amp_o2 = amp_path("training_amp_o2", "bfloat16",
                      lambda: run_amp_o2(torch, fa_mod, ids, cfg, dev))
    release_memory(torch)
    amp_fp16 = amp_path("training_amp_fp16", "float16",
                        lambda: run_amp_fp16(torch, fa_mod, ids, cfg,
                                             dev))
    release_memory(torch)

    return dict(train=train, train_launches=train_launches, peak=peak,
                grads=grads, flash_names=flash_names,
                amp_launches=amp_launches, amp_dtypes=amp_dtypes,
                amp_peak=amp_peak, amp_o1=amp_o1, amp_loop=amp_loop,
                amp_o2=amp_o2, amp_fp16=amp_fp16)


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
        from paddle_tpu_torch.ops import custom as nms_mod
        from paddle_tpu_torch.ops import detection as det_mod
        from paddle_tpu_torch.ops import paged_attention as pa_mod
        from paddle_tpu_torch.vision.models import yolov3_darknet53
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2

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

    def stamp(phase):
        log(f"-- phase {phase} at {time.perf_counter() - t_start:.1f} s")

    # -- phase 1: build -----------------------------------------------------
    stamp("1 build")
    t_build = kernel_build.build_all()
    log(f"build: {len(kernel_build.KERNEL_SOURCES)} kernels in "
        f"{t_build:.1f} s")
    for name, text in kernel_build.BUILD_LOGS.items():
        for line in text.splitlines():
            # the entry line names the instantiation (type, head dim)
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "error")):
                log(f"  {name}: {line.strip()}")
    tc_libs = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
    tc = sass_tensor_counts(kernel_build, tc_libs)
    if tc is None:
        log("cuobjdump not found: the tensor-core instruction counts of "
            f"{', '.join(tc_libs)} are not checked")
    else:
        # fp32, bf16 and fp16 at each supported head dim
        n_inst = 3 * len(fa_mod.SUPPORTED_HEAD_DIMS)
        for name, counts in tc.items():
            log(f"SASS tensor-core instructions (HMMA/HGMMA) in {name}: "
                f"{counts}")
            if len(counts) != n_inst or min(counts.values()) == 0:
                raise RuntimeError(f"{name}: {n_inst} instantiations with "
                                   f"tensor-core instructions expected, "
                                   f"got {counts}")

    # -- phase 2: kernels against their plain versions -----------------------
    stamp("2 kernels")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    b1 = check_flash(torch, fa_mod, gen)
    b2, b3 = check_flash_bwd(torch, fa_mod, gen)
    if tc is not None:
        b1["sass_tensor_core_instructions"] = tc["flash_attention_fwd"]
        b2["sass_tensor_core_instructions"] = tc["flash_attention_bwd_dq"]
        b3["sass_tensor_core_instructions"] = tc["flash_attention_bwd_dkv"]
    b4 = check_paged(torch, pa_mod, gen)
    b5 = check_nms(torch, nms_mod, det_mod, gen)
    torch.cuda.empty_cache()

    # -- phases 3 and 4: the serving path ------------------------------------
    stamp("3-4 serving path")
    rng = np.random.default_rng(0)
    model = GPTForCausalLM(GPTConfig(**CFG_13B, attn_impl="flash"),
                           device=dev, seed=0).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: GPT-3 1.3B, {n_params} parameters, fp32, random weights "
        f"(seed 0)")
    all_counters = (*_counters(fa_mod), pa_mod.paged_attention,
                    nms_mod.greedy_nms)

    def reset_counters():
        for c in all_counters:
            c.launches = 0
        for c in _counters(fa_mod):
            c.launches_by_dtype = {}
        torch.cuda.reset_peak_memory_stats()

    def read_counters():
        return {c.__name__: c.launches for c in all_counters}

    reset_counters()
    run_forward(torch, model, fa_mod, rng, CFG_13B, dev)
    serve, prompts, paged_tokens = run_serving(torch, model, pa_mod, rng,
                                               card, CFG_13B, PROMPT_LENS)
    serve_launches = read_counters()
    log(f"serving path launches: {serve_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("flash_attention_fwd", "paged_attention"):
        if serve_launches[name] < 1:
            raise RuntimeError(f"kernel {name} was not launched on the "
                               f"serving path")
    release_memory(torch)
    stamp("5 serving checks")
    serve.update(run_eager_lane(torch, model, CFG_13B, prompts, serve,
                                paged_tokens, "paged"))
    release_memory(torch)
    time_forward(torch, model, rng, CFG_13B, dev)
    profile_forward(torch, model, rng, CFG_13B, dev)
    dec, kv, params, last = compare_lanes(torch, model, rng, CFG_13B,
                                          PROMPT_LENS, dev)
    graphed_step, eager_step = profile_decode_lanes(
        torch, dec, kv, params, last, dev, "paged decode step")
    serve.update(step_wall_ms=graphed_step["wall_ms"],
                 step_device_ms=graphed_step["device_ms"],
                 step_call_host_ms=graphed_step["call_host_ms"],
                 step_call_device_ms=graphed_step["call_device_ms"],
                 eager_step_wall_ms=eager_step["wall_ms"],
                 eager_step_device_ms=eager_step["device_ms"],
                 eager_step_call_host_ms=eager_step["call_host_ms"],
                 step_smi=graphed_step["smi"], eager_step_smi=eager_step["smi"])
    del dec, kv, params, last
    release_memory(torch)

    # -- phase 6: static-slot serving and generate ----------------------------
    stamp("6 slot serving and generate")
    reset_counters()
    slot, slot_tokens = run_slot_serving(torch, model, card, CFG_13B,
                                         prompts, paged_tokens)
    slot_launches = read_counters()
    log(f"slot serving path launches: {slot_launches}")
    release_memory(torch)
    slot.update(run_eager_lane(torch, model, CFG_13B, prompts, slot,
                               slot_tokens, "slot"))
    release_memory(torch)
    sdec, skv, sparams, slast = compare_slot_lanes(torch, model, CFG_13B,
                                                   prompts, dev)
    slot.update(profile_slot_decode(torch, sdec, skv, sparams, slast, dev))
    del sdec, skv, sparams, slast
    release_memory(torch)
    # a generator of its own keeps the later phases' batches as they were
    gen_ids = torch.from_numpy(np.random.default_rng(8).integers(
        0, CFG_13B["vocab_size"], GEN_BATCH)).to(dev)
    reset_counters()
    gen_outs, gen_ms = run_generate(torch, model, fa_mod, gen_ids, CFG_13B)
    gen_launches = read_counters()
    log(f"generate path launches: {gen_launches}")
    if gen_launches["flash_attention_fwd"] < 1:
        raise RuntimeError("kernel flash_attention_fwd was not launched on "
                           "the generate path")
    gen = check_generate(torch, model, gen_ids, gen_outs, gen_ms)
    del model, gen_outs
    release_memory(torch)

    # -- phases 7 to 9: the training paths -----------------------------------
    ids = rng.integers(0, CFG_13B["vocab_size"],
                       (4, CFG_13B["max_position_embeddings"]))
    tr = training_phases(torch, fa_mod, CFG_13B, dev, ids, reset_counters,
                         read_counters, stamp)
    train, train_launches, peak, grads = (tr["train"], tr["train_launches"],
                                          tr["peak"], tr["grads"])
    flash_names, amp_launches, amp_dtypes, amp_peak = (
        tr["flash_names"], tr["amp_launches"], tr["amp_dtypes"],
        tr["amp_peak"])
    amp_o1, amp_loop, amp_o2, amp_fp16 = (tr["amp_o1"], tr["amp_loop"],
                                          tr["amp_o2"], tr["amp_fp16"])

    # -- phase 10: the detection path ----------------------------------------
    stamp("10 detection path")
    det_model = yolov3_darknet53(num_classes=DET_CLASSES, device=dev,
                                 seed=0).eval()
    n_params = sum(p.numel() for p in det_model.parameters())
    log(f"model: YOLOv3-DarkNet53, {DET_CLASSES} classes, {n_params} "
        f"parameters, fp32, eval, random weights (seed 0)")
    det = run_detection(torch, det_model, rng, card, dev, reset_counters)
    det_launches = read_counters()
    det["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"detection path launches: {det_launches}; peak device memory "
        f"{det['peak_gib']:.2f} GiB")
    if det_launches["greedy_nms"] < 1:
        raise RuntimeError("kernel greedy_nms was not launched on the "
                           "detection path")

    # -- phase 11: off the detection path ------------------------------------
    stamp("11 detection checks")
    det.update(detection_checks(torch, det_model, nms_mod, det_mod, rng,
                                dev))
    del det_model
    release_memory(torch)

    # -- phase 12: ResNet-50 training at bench.py's TPU shape -----------------
    stamp("12 ResNet-50 training")
    from paddle_tpu_torch.nn import functional as port_functional
    brng = np.random.RandomState(0)         # bench.py:106-108
    vx = brng.rand(RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE).astype(
        np.float32)
    vy = brng.randint(0, RESNET_CLASSES, (RESNET_BATCH,)).astype(np.int64)
    log(f"model: ResNet-50, {RESNET_CLASSES} classes, batch {RESNET_BATCH} "
        f"at {RESNET_SIZE}x{RESNET_SIZE}, Momentum(0.1, 0.9, weight decay "
        f"1e-4), random weights (seed 0); {smi}")
    reset_counters()
    resnet = model_lanes(torch, dict(
        name="ResNet-50", build=lambda: _resnet_model(torch, dev),
        batch=(vx, vy), count=RESNET_BATCH, unit="imgs",
        flops=lambda net: 3 * RESNET_FWD_GFLOP * 1e9, parts=VISION_PARTS,
        op_parts=VISION_OP_PARTS,
        labels=((port_functional, "batch_norm", "F.batch_norm"),),
        passes=5, deterministic=True))
    resnet_launches = read_counters()
    log(f"ResNet-50 training path launches: {resnet_launches} (no kernel "
        f"of the port is on it: cuDNN convolutions, BN as a composition)")
    if any(resnet_launches.values()):
        raise RuntimeError("a port kernel launched on the ResNet-50 path")
    del vx, vy

    # -- phase 13: BERT-base training at bench.py's TPU shape -----------------
    stamp("13 BERT-base training")
    from paddle_tpu_torch.models import BertConfig
    bcfg = BertConfig()
    bert_ids = np.random.RandomState(0).randint(
        0, bcfg.vocab_size, (BERT_BATCH, BERT_SEQ)).astype(np.int32)
    log(f"model: BERT-base ({bcfg}) under bench.py's MLM head, "
        f"[{BERT_BATCH}, {BERT_SEQ}], AdamW(1e-4, weight decay 0.01), "
        f"random weights (seeds 0 and 1); {smi}")
    reset_counters()
    bert = model_lanes(torch, dict(
        name="BERT-base", build=lambda: _bert_model(torch, dev, bcfg),
        batch=(bert_ids, bert_ids.astype(np.int64)),
        count=BERT_BATCH * BERT_SEQ, unit="tokens",
        flops=lambda net: 6 * sum(p.numel() for p in net.parameters()),
        parts=BERT_PARTS, passes=7))
    bert_launches = read_counters()
    log(f"BERT-base training path launches: {bert_launches} (attention "
        f"dense while dropout trains, as in the JAX package)")
    if any(bert_launches.values()):
        raise RuntimeError("a port kernel launched on the BERT training "
                           "path, whose attention drops probabilities")
    reset_counters()
    bert["flash_checks"] = bert_flash_checks(torch, fa_mod, dev, bert_ids,
                                             bcfg)
    bert_flash_launches = read_counters()
    bert_dtypes = {c.__name__: dict(c.launches_by_dtype)
                   for c in _counters(fa_mod)}
    log(f"BERT-base kernel checks launches: {bert_flash_launches}, B1-B3 "
        f"by type {bert_dtypes}")
    for n in flash_names:
        if bert_flash_launches[n] < 1:
            raise RuntimeError(f"kernel {n} was not launched by the BERT "
                               f"kernel checks")

    # -- phase 14: C6, the paged engine's "auto" lane -------------------------
    stamp("14 C6")
    reset_counters()
    c6 = check_c6(torch, dev)
    c6_launches = read_counters()
    log(f"C6 serving path launches: {c6_launches}")
    if c6_launches["paged_attention"] < 1:
        raise RuntimeError("kernel paged_attention was not launched on the "
                           "C6 serving path")

    # -- phase 15: YOLOv3-DarkNet53 training at bench.py's TPU shape ---------
    stamp("15 YOLOv3-DarkNet53 training")
    log(f"model: YOLOv3-DarkNet53, {YOLO_CLASSES} classes, width 1.0, "
        f"batch {YOLO_BATCH} at {YOLO_SIZE}x{YOLO_SIZE}, {YOLO_BOXES} gt "
        f"slots, Momentum(1e-3, 0.9, weight decay 5e-4), random weights "
        f"(seed 0); {smi}")
    reset_counters()
    yolo = model_lanes(torch, yolo_spec(torch, dev, _yolo_batch()))
    yolo_launches = read_counters()
    log(f"YOLOv3 training path launches: {yolo_launches} (no kernel of the "
        f"port is on it: B5 runs in detection inference only)")
    if any(yolo_launches.values()):
        raise RuntimeError("a port kernel launched on the YOLOv3 training "
                           "path")

    # -- phase 16: the GPT at S = 4096, every block recomputed ----------------
    stamp("16 GPT S=4096 training")
    long_ids = np.random.RandomState(0).randint(
        0, LONG_CFG["vocab_size"], LONG_BATCH).astype(np.int32)
    log(f"model: GPT ({LONG_CFG}), attn_impl auto, {list(LONG_BATCH)}, "
        f"AdamW(1e-4, weight decay 0.01), every decoder block through "
        f"fleet.utils.recompute, random weights (seed 0); {smi}")
    long_gpt, long_paths, long_dtypes = run_long_gpt(
        torch, fa_mod, dev, LONG_CFG, long_ids, reset_counters,
        read_counters)
    log(f"GPT S=4096 training paths launches: {long_paths}, B1-B3 by type "
        f"{long_dtypes}")
    for n in flash_names:
        if long_paths["o1_graphed"][n] < 1:
            raise RuntimeError(f"kernel {n} was not launched on the GPT "
                               f"S=4096 training path")

    # -- summary --------------------------------------------------------------
    paths = {"serving": serve_launches, "serving_slot": slot_launches,
             "generate": gen_launches, "training": train_launches,
             **amp_launches, "detection": det_launches,
             "training_resnet50": resnet_launches,
             "training_bert": bert_launches,
             "bert_flash_checks": bert_flash_launches,
             "serving_c6": c6_launches, "training_yolov3": yolo_launches,
             **{f"training_gpt_s4096_{k}": v for k, v in long_paths.items()}}
    amp_dtypes["bert_flash_checks"] = bert_dtypes
    amp_dtypes.update({f"training_gpt_s4096_{k}": v
                       for k, v in long_dtypes.items()})

    def launches(name):
        by_path = {k: v[name] for k, v in paths.items()}
        out = {"launches": sum(by_path.values()),
               "launches_by_path": by_path}
        if name in flash_names:
            out["launches_by_dtype_by_path"] = {
                k: v[name] for k, v in amp_dtypes.items()}
        return out

    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="paddle_tpu/ops/pallas_attention.py:67",
             **launches("flash_attention_fwd"), status="ok", **b1),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_bwd_dq.cu",
             replaces="paddle_tpu/ops/pallas_attention.py:189",
             **launches("flash_attention_bwd_dq"), status="ok", **b2),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_bwd_dkv.cu",
             replaces="paddle_tpu/ops/pallas_attention.py:227",
             **launches("flash_attention_bwd_dkv"), status="ok", **b3),
        dict(name="paged_attention", route="cuda",
             source="paddle_tpu_torch/csrc/paged_attention.cu",
             replaces="paddle_tpu/ops/paged_attention.py:76",
             **launches("paged_attention"), status="ok", **b4),
        dict(name="greedy_nms", route="cuda",
             source="paddle_tpu_torch/csrc/greedy_nms.cu",
             replaces="paddle_tpu/ops/custom.py:109",
             **launches("greedy_nms"), status="ok", **b5),
    ]
    log(f"serving: {json.dumps(serve)}")
    log(f"serving, slot: {json.dumps(slot)}")
    log(f"generate: {json.dumps(gen)}")
    log("training: " + json.dumps(dict(train, **grads, peak_gib=peak)))
    log("training, mixed precision: " + json.dumps(
        {"o1_bf16": amp_o1, "o1_bf16_train_loop": amp_loop,
         "o2_bf16": amp_o2, "fp16_grad_scaler": amp_fp16,
         "peak_gib": amp_peak}))
    log(f"detection: {json.dumps(det)}")
    log(f"training, ResNet-50: {json.dumps(resnet)}")
    log(f"training, BERT-base: {json.dumps(bert)}")
    log(f"C6: {json.dumps(c6)}")
    log(f"training, YOLOv3-DarkNet53: {json.dumps(yolo)}")
    log(f"training, GPT S=4096: {json.dumps(long_gpt)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
