"""Worlds of gloo ranks for the port's distributed tests.

JAX-free: every rank imports this module (and torch, numpy and the port)
only, never ``jax`` or ``paddle_tpu``; each rank records which of the two
it finds in ``sys.modules``. :func:`run_world` starts ``nprocs`` ranks
through the port's own ``distributed.spawn`` (the spawn start method,
never a fork of the JAX-holding test process); each rank brings up a
gloo process group on the CPU, runs one world function of this module
and pickles its results into the world's directory, which the parent
reads back. Inputs the parent wants the ranks to use go in
``inputs.pkl`` there.

Run as a script (``python tests/torch_dist_worlds.py NAME OUT``), a rank
started by ``distributed.launch`` runs world function ``NAME``.
"""
from __future__ import annotations

import os
import pickle
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the join's bound, seconds
WORLD_TIMEOUT = 150


def run_world(name, out_dir, nprocs=4, inputs=None, timeout=WORLD_TIMEOUT):
    """Run world function ``name`` on ``nprocs`` gloo ranks; returns each
    rank's results (a list of dicts)."""
    import paddle_tpu_torch.distributed as dist
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs or {}, f)
    dist.spawn(_entry, args=(name, str(out)), nprocs=nprocs,
               backend="gloo", timeout=timeout,
               env={"OMP_NUM_THREADS": "1"})
    results = []
    for r in range(nprocs):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(name, out_dir):
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(device="cpu")
    with open(Path(out_dir) / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    try:
        res = WORLDS[name](inputs)
    finally:
        dist.set_mesh(None)
    res["_imported"] = sorted(m for m in ("jax", "jaxlib", "paddle_tpu")
                              if m in sys.modules)
    res["_rank"] = dist.get_rank()
    with open(Path(out_dir) / f"rank{dist.get_rank()}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.env.destroy_process_group()


def _np(t):
    from paddle_tpu_torch.distributed import mesh
    t = mesh.full(t)
    t = t._data if hasattr(t, "_data") and not hasattr(t, "numpy") else t
    return t.detach().float().cpu().numpy() if t.is_floating_point() else \
        t.detach().cpu().numpy()


# -- collectives ----------------------------------------------------------------

def collectives(inp):
    """Every collective at world 4 (global group, a rank subgroup, mesh
    axis groups), all_reduce's gradient, the compressed all-reduce and
    its codes, the compressed train step, the topology's groups, the
    strategy's JSON and the env contract."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    r = dist.get_rank()
    x = torch.as_tensor(inp["x"][r])           # rank r's row block
    out = {}

    def cl():
        return x.clone()
    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                     ("min", C.ReduceOp.MIN), ("prod", C.ReduceOp.PROD),
                     ("avg", C.ReduceOp.AVG)):
        t = cl()
        dist.all_reduce(t, op=op)
        out[f"all_reduce_{name}"] = t.numpy()
    sub = dist.new_group([0, 2])
    t = cl()
    dist.all_reduce(t, group=sub)
    out["all_reduce_subgroup"] = t.numpy()
    t = cl()
    dist.broadcast(t, src=2)
    out["broadcast"] = t.numpy()
    t = cl()
    dist.broadcast(t, src=2, group=sub)
    out["broadcast_subgroup"] = t.numpy()
    t = cl()
    dist.reduce(t, dst=1)
    out["reduce"] = t.numpy()
    lst = []
    out["all_gather"] = dist.all_gather(lst, x).numpy()
    out["all_gather_list"] = [a.numpy() for a in lst]
    if r in (0, 2):
        out["all_gather_subgroup"] = dist.all_gather(None, x,
                                                     group=sub).numpy()
    out["reduce_scatter"] = dist.reduce_scatter(None, x).numpy()
    out["alltoall"] = dist.alltoall(x).numpy()
    out["p2p_exchange"] = dist.p2p_exchange(cl(), src=1, dst=3).numpy()
    t = cl()
    if r == 0:
        dist.send(t * 10, dst=3)
    elif r == 3:
        dist.recv(t, src=0)
    out["send_recv"] = t.numpy()
    t = torch.zeros_like(x)
    parts = [torch.full_like(x, float(i + 1)) for i in range(4)] \
        if r == 1 else None
    dist.scatter(t, parts, src=1)
    out["scatter"] = t.numpy()
    objs = []
    dist.all_gather_object(objs, {"rank": r, "tag": "x" * r})
    out["all_gather_object"] = objs
    dist.barrier()
    dist.wait(x)
    # all_reduce's gradient: the JAX package's pmean(sum(all_reduce(v)^2))
    # over the world, seeded 1/n on each rank (the replicated objective)
    v = x[:1].clone().requires_grad_(True)
    loss = dist.all_reduce((dist.all_reduce(v) ** 2).sum(),
                           op=C.ReduceOp.AVG)
    (loss / dist.get_world_size()).backward()
    out["all_reduce_grad"] = v.grad.numpy()
    # a permute's gradient is the reverse move
    v = x.clone().requires_grad_(True)
    (dist.p2p_exchange(v, src=1, dst=3) * torch.as_tensor(
        inp["w_p2p"][r])).sum().backward()
    out["p2p_grad"] = v.grad.numpy()
    # mesh-axis groups of the hybrid topology
    hcg = dist.HybridCommunicateGroup(dp_degree=2, mp_degree=2)
    mesh = dist.get_mesh()
    out["mesh"] = (tuple(mesh.mesh_dim_names), mesh.mesh.tolist())
    out["groups"] = {n: C._get_group(g)._members() for n, g in (
        ("dp", hcg.get_data_parallel_group()),
        ("mp", hcg.get_model_parallel_group()))}
    out["coords"] = (hcg.get_data_parallel_rank(),
                     hcg.get_model_parallel_rank())
    t = cl()
    dist.all_reduce(t, group=hcg.get_model_parallel_group())
    out["all_reduce_mp"] = t.numpy()
    t = cl()
    dist.all_reduce(t, group=hcg.get_data_parallel_group())
    out["all_reduce_dp"] = t.numpy()
    # the compressed all-reduce over a 4-rank dp mesh
    dist.set_mesh(dist.build_mesh({"dp": 4}))
    g = torch.as_tensor(inp["grad"][r])
    q, s = C._block_quantize_int8(g.reshape(-1, 64))
    out["codes"], out["scales"] = q.numpy(), s.numpy()
    for wire in ("int8", "bf16"):
        t = g.clone()
        dist.compressed_all_reduce(t, op=C.ReduceOp.AVG, group=C.Group(
            axis="dp"), wire_dtype=wire, block=64)
        out[f"compressed_{wire}"] = t.numpy()
    step = C.build_compressed_train_step(dist.get_mesh(), block=64)
    w, b = torch.as_tensor(inp["w"]), torch.zeros(4)
    losses = []
    for _ in range(3):
        w, b, loss = step(w, b, torch.as_tensor(inp["xs"]),
                          torch.as_tensor(inp["ys"]))
        losses.append(float(loss))
    out["train_step"] = (w.numpy(), b.numpy(), losses)
    st = DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    st.compressed_allreduce = True
    out["strategy_json"] = st.to_json()
    env = dist.ParallelEnv()
    out["env"] = (env.rank, env.world_size, env.current_endpoint,
                  env.trainer_endpoints, env.device_id)
    # the staged functional collectives a gloo world of CUDA ranks takes
    # (here on CPU tensors: the same host path)
    name = torch.distributed.distributed_c10d._get_default_group().group_name
    staged = {}
    for op, args in (("all_reduce", ("sum", name)),
                     ("all_gather_into_tensor", (4, name)),
                     ("reduce_scatter_tensor", ("sum", 4, name)),
                     ("all_to_all_single", ([2] * 4, [2] * 4, name)),
                     ("broadcast", (2, name))):
        staged[op] = C._staged_functional(op)(cl(), *args).numpy()
    out["staged_functional"] = staged
    return out


# -- data, tensor and ZeRO parallelism ------------------------------------------

def _gpt(inp, device="cpu", weights=True):
    import torch
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**inp["gpt_cfg"])
    net = GPTForCausalLM(cfg, device=device, seed=0)
    if weights:
        net.set_state_dict({k: torch.as_tensor(v)
                            for k, v in inp["gpt_w"].items()})
    return net


def _gpt_train(net, ids, eps, device="cpu"):
    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    opt = P.optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                            weight_decay=0.01, epsilon=eps, device=device)
    m = P.Model(net, device=device)
    m.prepare(opt, GPTPretrainingCriterion())
    return [m.train_batch([ids], [ids])[0] for _ in range(3)], m


def parallel(inp):
    """The dryrun's dp2 x mp2 GPT through shard_tensor, shard_batch and
    Model.train_batch; the same through fleet; the mp layers; ZeRO levels
    against replicated AdamW; DataParallel (and its bf16 and compressed
    exchanges) against one process; LocalSGD."""
    import torch
    import paddle_tpu_torch as P
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt as gpt_mod
    r = dist.get_rank()
    out = {}
    ids = torch.as_tensor(inp["ids"])
    # 1. the dryrun's path
    mesh = dist.build_mesh({"dp": 2, "mp": 2})
    dist.set_mesh(mesh)
    net = _gpt(inp, weights=False)
    specs = gpt_mod.tp_partition_specs(net)
    for name, p in list(net.named_parameters()):
        dist.shard_tensor(p, specs[name], mesh)
    # the JAX package's global arrays, carried into the laid-out model
    net.set_state_dict({k: torch.as_tensor(v)
                        for k, v in inp["gpt_w"].items()})
    x = dist.shard_batch(P.to_tensor(ids, place="cpu"), mesh)
    losses, m = _gpt_train(net, x, inp["eps"])
    out["dryrun_losses"] = losses
    out["dryrun_params"] = {k: v.numpy() for k, v in net.state_dict().items()}
    out["dryrun_lane"] = m.lane
    try:
        m.train_loop([ids[None]], [ids[None]])
    except NotImplementedError as e:
        out["train_loop_refusal"] = str(e)
    out["placements"] = {k: str(p.placements)
                         for k, p in net.named_parameters()}
    # 2. the same model through fleet (dp2 x mp2, model mode)
    dist.set_mesh(None)
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=st, device="cpu")
    net = _gpt(inp)
    opt = P.optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                            weight_decay=0.01, epsilon=inp["eps"],
                            device="cpu")
    specs = gpt_mod.tp_partition_specs(net)
    for name, p in list(net.named_parameters()):
        dist.shard_tensor(p, specs[name])
    net = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(opt)
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    m = P.Model(net, device="cpu")
    m.prepare(opt, GPTPretrainingCriterion())
    xb = dist.shard_batch(ids)
    out["fleet_losses"] = [m.train_batch([xb], [xb])[0] for _ in range(3)]
    out["fleet_mode"] = fleet.get_hybrid_communicate_group_() \
        .get_parallel_mode()
    # 3. the mp layers on the dp2 x mp2 mesh, weights from the parent
    lw = inp["layers"]
    col = fleet.ColumnParallelLinear(16, 8, gather_output=False)
    row = fleet.RowParallelLinear(8, 16, input_is_parallel=True)
    emb = fleet.VocabParallelEmbedding(32, 16)
    for layer, key in ((col, "col"), (row, "row"), (emb, "emb")):
        layer.set_state_dict({k: torch.as_tensor(v)
                              for k, v in lw[key].items()})
    xin = dist.replicate_tensor(torch.as_tensor(lw["x"])).detach() \
        .requires_grad_(True)
    h = emb(torch.as_tensor(lw["ids"]))
    y = row(col(xin + h))
    ce = fleet.ParallelCrossEntropy()(y, torch.as_tensor(lw["labels"]))
    gs = torch.autograd.grad(ce, [xin] + list(col.parameters())
                             + list(row.parameters())
                             + list(emb.parameters()))
    out["mp_out"] = _np(y)
    out["mp_loss"] = float(_np(ce))
    out["mp_grads"] = [_np(g) for g in gs]
    out["mp_col_out_placements"] = str(col(xin).placements)
    # 4. ZeRO levels against replicated AdamW (a 2-layer MLP, dp4)
    dist.set_mesh(dist.build_mesh({"dp": 4}))
    zw = inp["zero"]
    for level in ("none", "os", "os_g", "p_g_os"):
        net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                              P.nn.Linear(16, 4))
        net.set_state_dict({k: torch.as_tensor(v) for k, v in zw.items()})
        opt = P.optimizer.AdamW(learning_rate=1e-2,
                                parameters=net.parameters(), device="cpu")
        if level == "none":
            net = dist.DataParallel(net)
            from paddle_tpu_torch.distributed.sharding import \
                _rebind_optimizer
            _rebind_optimizer(opt)
        else:
            net, opt, _ = dist.group_sharded_parallel(net, opt, level=level)
        m = P.Model(net, device="cpu")
        m.prepare(opt, P.nn.MSELoss())
        xs = dist.shard_batch(torch.as_tensor(inp["zx"]))
        ys = dist.shard_batch(torch.as_tensor(inp["zy"]))
        out[f"zero_{level}_losses"] = [m.train_batch([xs], [ys])[0]
                                       for _ in range(3)]
        out[f"zero_{level}_params"] = {
            k: v.numpy() for k, v in net.state_dict().items()}
        st0 = opt._state[0]["moment1"]
        out[f"zero_{level}_state_placements"] = str(st0.placements)
    # 5. DataParallel against one process, and its wires
    for wire in ("dense", "bf16", "int8"):
        net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                              P.nn.Linear(16, 4))
        net.set_state_dict({k: torch.as_tensor(v) for k, v in zw.items()})
        dp = dist.DataParallel(net, bf16_allreduce=wire == "bf16",
                               compressed_allreduce=wire == "int8")
        loss = P.nn.MSELoss()(dp(torch.as_tensor(inp["zx"])),
                              dist.shard_batch(torch.as_tensor(inp["zy"])))
        loss.backward()
        dp.apply_collective_grads()
        out[f"dp_{wire}_grads"] = [_np(p.grad) for p in dp.parameters()]
        out[f"dp_{wire}_loss"] = float(_np(loss))
    try:
        dp(torch.as_tensor(inp["zx"][:3]))
    except ValueError as e:
        out["dp_odd_batch"] = str(e)
    # 6. LocalSGD: plain replicas, local batches, an average every 2 steps
    dist.set_mesh(None)
    dist.set_hybrid_communicate_group(None)
    net = P.nn.Linear(8, 4)
    net.set_state_dict({"weight": torch.as_tensor(zw["0.weight"][:, :4]),
                        "bias": torch.zeros(4)})
    from paddle_tpu_torch.distributed.fleet.utils import LocalSGDOptimizer
    opt = LocalSGDOptimizer(P.optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters(), device="cpu"),
        k_steps=2)
    seen = []
    for step in range(4):
        xl = torch.as_tensor(inp["zx"][r * 2:(r + 1) * 2])
        loss = (net(xl) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        seen.append(net.weight.detach().clone().numpy())
    out["localsgd"] = seen
    return out


# -- sequence parallelism ---------------------------------------------------------

def ring(inp):
    """ring_attention and ring_flash_attention at sp4 and dp2 x sp2,
    causal and not, outputs and gradients of sum(out * do); a ring of one
    against plain flash; B1-B3 launches per rank."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import sequence_parallel as sp
    from paddle_tpu_torch.ops import flash_attention as fa_op  # noqa: F401
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    out = {}
    for layout, axes, batch in (("sp4", {"sp": 4}, None),
                                ("dp2sp2", {"dp": 2, "sp": 2}, "dp")):
        mesh = dist.build_mesh(axes)
        for causal in (False, True):
            for kind, fn in (("dense", sp.ring_attention),
                             ("flash", sp.ring_flash_attention)):
                q, k, v, do = (torch.as_tensor(a).requires_grad_(i < 3)
                               for i, a in enumerate(inp["qkvd"]))
                fa.flash_attention_fwd.launches = 0
                o = fn(q, k, v, mesh=mesh, axis="sp", causal=causal,
                       batch_axes=batch)
                loss = (o * dist.constrain(do, o_spec(o), mesh)).sum()
                gq, gk, gv = torch.autograd.grad(loss, (q, k, v))
                key = f"{layout}_{kind}_{'causal' if causal else 'full'}"
                out[key] = [_np(o)] + [g.numpy() for g in (gq, gk, gv)]
    # a ring of one (sp axis of size 1) is plain flash attention
    mesh = dist.build_mesh({"dp": 4, "sp": 1})
    q, k, v, _ = (torch.as_tensor(a) for a in inp["qkvd"])
    o = sp.ring_flash_attention(q, k, v, mesh=mesh, axis="sp",
                                causal=True)
    plain, _ = fa.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), True)
    out["sp1"] = (_np(o), plain.transpose(1, 2).numpy())
    return out


def o_spec(o):
    """The layout tuple of a ``[B, H, T, D]`` ring output (for pinning
    the cotangent the same way)."""
    from torch.distributed.tensor import Shard
    names = o.device_mesh.mesh_dim_names
    spec = [None] * 4
    for n, p in zip(names, o.placements):
        if isinstance(p, Shard):
            spec[p.dim] = n if spec[p.dim] is None else (spec[p.dim], n)
    return tuple(spec)


WORLDS = {"collectives": collectives, "parallel": parallel, "ring": ring}


# -- as a launched script ---------------------------------------------------------

def launched(argv):
    """A rank started by ``distributed.launch``: ``env OUT`` records the
    contract as ``init_parallel_env`` reads it and a world all-reduce;
    ``preempt OUT`` exits with the preemption code at its first start
    and records its restart number at the second."""
    import torch
    torch.set_num_threads(1)
    name, out = argv[0], Path(argv[1])
    import paddle_tpu_torch.distributed as dist
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    if name == "preempt":
        restart = int(os.environ.get("PADDLE_TPU_RESTART_NUM", "0"))
        if rank == 1 and restart == 0:
            sys.exit(dist.PREEMPTION_EXIT_CODE)
        (out / f"preempt{rank}.txt").write_text(
            f"{restart} {os.environ.get('PADDLE_TPU_ELASTIC', '')}")
        return
    env = dist.init_parallel_env(device="cpu")
    t = torch.ones(2) * (rank + 1)
    dist.all_reduce(t)
    rec = {"rank": env.rank, "world": env.world_size,
           "endpoint": env.current_endpoint,
           "endpoints": env.trainer_endpoints,
           "device_id": env.device_id, "backend": dist.env.backend(),
           "sum": t.tolist(),
           "imported": sorted(m for m in ("jax", "paddle_tpu")
                              if m in sys.modules)}
    with open(out / f"env{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    dist.env.destroy_process_group()


def fail_on(rank_to_fail):
    """A spawned rank's body: the named rank raises."""
    if int(os.environ["PADDLE_TRAINER_ID"]) == rank_to_fail:
        raise ValueError(f"rank {rank_to_fail} fails on purpose")


def sleep_for(seconds):
    """A spawned rank's body: sleep (a join's timeout runs out first)."""
    import time
    time.sleep(seconds)


def record_env(out_dir):
    """A spawned rank's body: record the contract spawn set."""
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
            "FLAGS_selected_gpus", "PADDLE_DISTRI_BACKEND")
    rank = os.environ["PADDLE_TRAINER_ID"]
    with open(Path(out_dir) / f"spawn{rank}.pkl", "wb") as f:
        pickle.dump({k: os.environ.get(k) for k in keys}, f)


if __name__ == "__main__":
    launched(sys.argv[1:])
