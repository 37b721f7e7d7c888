#!/usr/bin/env python3
"""Time the eager lanes of GPT-3 1.3B for several trees of the
repository on one CUDA card, in turns.

    python3 eager_ab.py DIR [DIR ...]          # from the repository root

Each DIR is a tree of a version of the repository: ``.`` for this one, or
an older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists (``build/``, say). Rounds run the DIRs in order and
then in reverse (A B B A), each round in a process of its own that
imports that tree's package and ``chip_smoke.py`` and measures with that
tree's own functions, so every tree is timed as its smoke test times it:

- the host time of one ``torch.add`` on two 16-element CUDA tensors and
  of one funnel call (``funnel_host_us``): how fast the host is in that
  round;
- the paged decode step (B4's kernel lane) and the static-slot decode
  step, 8 slots of 1024, on the eager lane (``profile_decode`` inside
  ``disable_graphs``, as phases 5 and 6 take it): host wall a tick and
  host ms of one step call;
- an O1 bfloat16 ``Model.train_batch`` step at ``[4, 1024]`` on the eager
  lane (phase 9's model, optimizer and batch shape): the median wall of
  steps 2 to 4 (CUDA-synchronised ``perf_counter``).

Each round's lines go to ``chiprun_out/eager_ab_<round>.log``. The script
prints the card's name and power limit, each round's numbers, each
number's median over a tree's rounds, and those medians as one JSON line.
It needs one card and exits non-zero without one.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

#: what a round reports, in the order printed
KEYS = ("torch_add_us", "funnel_torch_us", "paged_eager_wall_ms",
        "paged_eager_call_host_ms", "slot_eager_wall_ms",
        "slot_eager_call_host_ms", "o1_train_eager_step_ms")
TRAIN_STEPS = 4


def one_round(tree: str) -> dict:
    """The numbers of one round of ``tree``, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_tree", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import paddle_tpu_torch as P
    if not P.__file__.startswith(tree):
        raise RuntimeError(f"imported {P.__file__}, not {tree}'s package")
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import kernel_build
    kernel_build.build_all()
    dev = P.resolve_device()
    cfg = cs.CFG_13B
    out = {"tree": tree}
    f = cs.funnel_host_us(torch, dev)
    out["torch_add_us"] = f["torch_us"]
    out["funnel_torch_us"] = f["funnel_torch_us"]

    model = GPTForCausalLM(GPTConfig(**cfg, attn_impl="flash"), device=dev,
                           seed=0).eval()
    rng = np.random.default_rng(0)
    dec, kv, params, last = cs.compare_lanes(torch, model, rng, cfg,
                                             cs.PROMPT_LENS, dev)
    with graphs.disable_graphs():
        e = cs.profile_decode(torch, dec, kv, params, last, dev,
                              label="paged decode step")
    out["paged_eager_wall_ms"] = e["wall_ms"]
    out["paged_eager_call_host_ms"] = e["call_host_ms"]
    del dec, kv, params, last
    cs.release_memory(torch)
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist()
               for n in cs.PROMPT_LENS]
    dec, kv, params, last = cs.compare_slot_lanes(torch, model, cfg,
                                                  prompts, dev)
    with graphs.disable_graphs():
        e = cs.profile_decode(torch, dec, kv, params, last, dev,
                              label="slot decode step")
    out["slot_eager_wall_ms"] = e["wall_ms"]
    out["slot_eager_call_host_ms"] = e["call_host_ms"]
    del dec, kv, params, last, model
    cs.release_memory(torch)

    model, _ = cs._train_model(torch, cfg, dev, "flash")
    ids = rng.integers(0, cfg["vocab_size"],
                       (4, cfg["max_position_embeddings"]))
    walls = []
    with graphs.disable_graphs():
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp.auto_cast():
                model.train_batch([ids], [ids])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    out["o1_train_eager_step_ms"] = statistics.median(walls[1:])
    out["o1_train_eager_step_walls_ms"] = walls
    return out


def main() -> int:
    if sys.argv[1:2] == ["--round"]:
        print("EAGER_AB " + json.dumps(one_round(sys.argv[2])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("eager_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    order = trees + trees[::-1]
    rounds = {t: [] for t in trees}
    for i, tree in enumerate(order):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--round", tree],
            capture_output=True, text=True, timeout=900)
        with open(os.path.join("chiprun_out", f"eager_ab_{i}.log"),
                  "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("EAGER_AB ")]
        if proc.returncode != 0 or not lines:
            print(f"round {i} ({tree}) failed, rc {proc.returncode}:\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        r = json.loads(lines[-1][len("EAGER_AB "):])
        rounds[tree].append(r)
        print(f"round {i} {tree}: " + ", ".join(
            f"{k} {r[k]:.4f}" for k in KEYS), flush=True)
    medians = {t: {k: statistics.median(r[k] for r in rs) for k in KEYS}
               for t, rs in rounds.items()}
    for t, m in medians.items():
        print(f"median {t}: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in m.items()))
    print(json.dumps({"card": smi, "medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
