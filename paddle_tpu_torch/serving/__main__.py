"""``python -m paddle_tpu_torch.serving`` — stand up the HTTP front door
(counterpart of ``paddle_tpu/serving/__main__.py``; the same subcommands,
flags, stdout lines and exit behaviour, plus ``--device``).

* ``serve-llm`` builds a ``GPTForCausalLM`` from the flags (its weights
  from ``--state-dict``, a ``paddle.save`` file either package wrote, or
  random from seed 0) and serves continuous-batching generation through
  one slot-layout :class:`~paddle_tpu_torch.serving.llm.LLMEngine`, or,
  with ``--replicas``/``--roles``, through a
  :class:`~paddle_tpu_torch.serving.router.Router` of them, under the
  SLO :class:`~paddle_tpu_torch.serving.fleet.Autoscaler` with
  ``--autoscale``.
* ``serve --model <prefix>`` serves a ``jit.save`` artifact; loading one
  is ROADMAP.md queue A11, so it exits non-zero with that message, as
  ``--model-parallel > 1`` does with A10's.

``--device`` picks the card (default: the port's rule, CUDA, raising
where there is none; ``--device cpu`` serves on the CPU). With ``--port
0`` the bound port is printed as ``PADDLE_TPU_SERVING_PORT=<port>``.
SIGTERM/SIGINT begin a graceful drain (chained with any PreemptionGuard):
admission stops, queued requests finish, ``/healthz`` flips to 503, and
the process prints ``drained, bye`` and exits 0.
"""
from __future__ import annotations

import argparse
import sys

_NAME = "paddle_tpu_torch.serving"


def _parse_int_list(raw: str):
    return [int(x) for x in raw.split(",") if x.strip()]


def _add_device(p):
    p.add_argument("--device", default=None,
                   help="device to serve on ('cuda', 'cuda:1', 'cpu'; "
                        "default: CUDA, raising where there is none)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=f"python -m {_NAME}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("serve", help="serve a jit.save artifact over HTTP")
    sv.add_argument("--model", required=True,
                    help="artifact path prefix (the X of X.pdmodel)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8500,
                    help="0 binds an ephemeral port (printed on stdout as "
                         "PADDLE_TPU_SERVING_PORT=<port>)")
    sv.add_argument("--replicas", type=int, default=1,
                    help=">1 serves through a health-aware replica router")
    sv.add_argument("--model-parallel", type=int, default=1,
                    help="devices per replica ('model' mesh axis size; "
                         "ROADMAP.md queue A10)")
    sv.add_argument("--buckets", default="",
                    help="comma-separated batch buckets (default: powers "
                         "of two up to --max-batch)")
    sv.add_argument("--seq-buckets", default="",
                    help="optional comma-separated sequence buckets "
                         "(requires a padding-masked model)")
    sv.add_argument("--max-batch", type=int, default=64)
    sv.add_argument("--max-queue", type=int, default=256)
    sv.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="batcher coalescing window")
    sv.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline")
    sv.add_argument("--oversize", choices=("split", "reject"),
                    default="split")
    _add_device(sv)

    lv = sub.add_parser(
        "serve-llm",
        help="serve GPT generation (continuous batching) over HTTP")
    lv.add_argument("--state-dict", default=None,
                    help="framework_io.save'd GPTForCausalLM state dict "
                         "(omit for a randomly initialized model — smoke "
                         "tests only)")
    lv.add_argument("--vocab-size", type=int, default=50304)
    lv.add_argument("--hidden-size", type=int, default=768)
    lv.add_argument("--num-layers", type=int, default=12)
    lv.add_argument("--num-heads", type=int, default=12)
    lv.add_argument("--max-positions", type=int, default=1024)
    lv.add_argument("--host", default="127.0.0.1")
    lv.add_argument("--port", type=int, default=8500,
                    help="0 binds an ephemeral port (printed on stdout as "
                         "PADDLE_TPU_SERVING_PORT=<port>)")
    lv.add_argument("--replicas", type=int, default=1,
                    help=">1 serves through a health-aware replica router")
    lv.add_argument("--model-parallel", type=int, default=1,
                    help="devices per replica ('model' mesh axis size; "
                         "ROADMAP.md queue A10)")
    lv.add_argument("--num-slots", type=int, default=8)
    lv.add_argument("--max-seq", type=int, default=512)
    lv.add_argument("--prefill-buckets", default="",
                    help="comma-separated prompt buckets (default: powers "
                         "of two up to --max-seq)")
    lv.add_argument("--max-queue", type=int, default=256)
    lv.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline")
    lv.add_argument("--max-new-tokens", type=int, default=64,
                    help="default generation budget per request")
    lv.add_argument("--no-warmup", action="store_true",
                    help="skip the ahead-of-time decode/prefill captures")
    lv.add_argument("--prefix-cache", action="store_true",
                    help="enable cross-request prefix KV reuse (repeated "
                         "prompt prefixes skip their share of prefill)")
    lv.add_argument("--prefix-capacity-mb", type=float, default=256.0,
                    help="host-RAM byte budget for the prefix KV store")
    lv.add_argument("--spec-k", type=int, default=0,
                    help="draft tokens proposed per speculative decode "
                         "tick (0 disables speculative decoding)")
    lv.add_argument("--spec-draft-scale", type=int, default=4,
                    help="draft model shrink factor vs the target "
                         "(GPTConfig.draft); used when --spec-k > 0")
    lv.add_argument("--draft-state-dict", default=None,
                    help="framework_io.save'd state dict for the draft "
                         "model (omit for random draft weights — "
                         "acceptance will be ~0; smoke tests only)")
    lv.add_argument("--roles", default="",
                    help="comma-separated per-replica roles "
                         "(prefill|decode|mixed), one per --replicas: "
                         "disaggregated prefill/decode fleet with KV "
                         "handoff through a shared prefix store")
    lv.add_argument("--prefill-threshold", type=int, default=64,
                    help="prompts with at least this many tokens are "
                         "routed as prefill-phase")
    lv.add_argument("--no-handoff", action="store_true",
                    help="disable the prefill->decode KV handoff (role "
                         "routing only)")
    lv.add_argument("--autoscale", action="store_true",
                    help="run the SLO-aware autoscaler over the replica "
                         "set (requires --replicas > 1): replicas park "
                         "when calm and unpark on SLO breach")
    lv.add_argument("--slo-p95-ms", type=float, default=500.0,
                    help="autoscaler SLO: p95 request latency bound")
    lv.add_argument("--slo-max-queue", type=int, default=32,
                    help="autoscaler SLO: total queued-request bound")
    lv.add_argument("--min-replicas", type=int, default=1,
                    help="autoscaler floor; --replicas is the ceiling")
    lv.add_argument("--autoscale-interval-s", type=float, default=0.5,
                    help="autoscaler controller tick period")
    _add_device(lv)
    args = ap.parse_args(argv)

    try:
        if args.cmd == "serve-llm":
            return _serve_llm(args)
        return _serve(args)
    except NotImplementedError as e:
        # a feature the port has not reached (A10, A11): say which
        print(f"{_NAME}: {e}", file=sys.stderr, flush=True)
        return 2


def _serve(args) -> int:
    from . import Engine, EngineConfig
    from .http import serve_forever

    cfg = EngineConfig(
        batch_buckets=_parse_int_list(args.buckets),
        seq_buckets=_parse_int_list(args.seq_buckets) or None,
        max_batch=args.max_batch,
        max_queue=args.max_queue,
        max_batch_delay=args.max_delay_ms / 1000.0,
        default_deadline=args.deadline_s,
        oversize_policy=args.oversize,
    )

    def _ready(httpd):
        host, port = httpd.server_address[:2]
        print(f"{_NAME}: listening on http://{host}:{port} "
              f"(buckets={list(cfg.buckets.batch_buckets)}, "
              f"delay={cfg.max_batch_delay * 1000:.1f}ms)", flush=True)
        # machine-readable line for --port 0 callers (supervisors, tests)
        print(f"PADDLE_TPU_SERVING_PORT={port}", flush=True)

    if args.replicas > 1 or args.model_parallel > 1:
        from .router import Router, RouterConfig, predictor_replica_factory
        axes = ({"model": args.model_parallel}
                if args.model_parallel > 1 else None)
        router = Router(
            predictor_replica_factory(args.model, cfg),
            RouterConfig(num_replicas=args.replicas, model_axes=axes,
                         kind="classifier"), device=args.device)
        router.install_drain_signal_handler()
        serve_forever(None, args.host, args.port, quiet=False,
                      ready_cb=_ready, router=router)
        router.drain()
        print(f"{_NAME}: drained, bye", flush=True)
        return 0

    engine = Engine(args.model, cfg, device=args.device)
    engine.install_drain_signal_handler()

    serve_forever(engine, args.host, args.port, quiet=False, ready_cb=_ready)
    engine.drain()
    print(f"{_NAME}: drained, bye", flush=True)
    return 0


def _serve_llm(args) -> int:
    from ..core.device import resolve_device
    from ..models.gpt import GPTConfig, GPTForCausalLM
    from .http import serve_forever
    from .llm import LLMEngine, LLMEngineConfig

    dev = resolve_device(args.device)
    gcfg = GPTConfig(
        vocab_size=args.vocab_size, hidden_size=args.hidden_size,
        num_layers=args.num_layers, num_heads=args.num_heads,
        max_position_embeddings=args.max_positions,
        hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForCausalLM(gcfg, device=dev)
    model.eval()
    if args.state_dict:
        from .. import framework_io
        model.set_state_dict(framework_io.load(args.state_dict))
    else:
        print(f"{_NAME}: WARNING serving a randomly initialized "
              f"model (--state-dict not given)", flush=True)

    draft = None
    if args.spec_k > 0:
        draft = GPTForCausalLM(gcfg.draft(args.spec_draft_scale), device=dev)
        draft.eval()
        if args.draft_state_dict:
            from .. import framework_io
            draft.set_state_dict(framework_io.load(args.draft_state_dict))
        else:
            print(f"{_NAME}: WARNING speculative draft model is "
                  f"randomly initialized (--draft-state-dict not given); "
                  f"acceptance will be ~0", flush=True)

    cfg = LLMEngineConfig(
        num_slots=args.num_slots, max_seq=args.max_seq,
        prefill_buckets=_parse_int_list(args.prefill_buckets) or None,
        max_queue=args.max_queue, default_deadline=args.deadline_s,
        default_max_new_tokens=args.max_new_tokens,
        warmup=not args.no_warmup,
        prefix_cache=args.prefix_cache,
        prefix_capacity_mb=args.prefix_capacity_mb,
        spec_k=args.spec_k)

    def _ready(httpd):
        host, port = httpd.server_address[:2]
        print(f"{_NAME}: LLM listening on http://{host}:{port} "
              f"(slots={cfg.num_slots}, max_seq={cfg.max_seq}, "
              f"prefill_buckets={list(cfg.prefill_buckets)}, "
              f"device={dev})", flush=True)
        # machine-readable line for --port 0 callers (supervisors, tests)
        print(f"PADDLE_TPU_SERVING_PORT={port}", flush=True)

    roles = [r.strip() for r in args.roles.split(",") if r.strip()] or None
    if args.replicas > 1 or args.model_parallel > 1 or roles:
        from .router import Router, RouterConfig, llm_replica_factory
        axes = ({"model": args.model_parallel}
                if args.model_parallel > 1 else None)
        shared_store = None
        if args.prefix_cache or roles:
            # ONE store across replicas: prefix hits survive replica
            # hops, and it is the prefill->decode KV handoff channel
            from .llm import PrefixStore
            shared_store = PrefixStore(
                capacity_bytes=int(args.prefix_capacity_mb * (1 << 20)),
                block_tokens=cfg.prefix_block)
        router = Router(
            llm_replica_factory(
                lambda replica: model, cfg, roles=roles,
                prefix_store=shared_store,
                draft_model_factory=(
                    (lambda replica: draft) if draft is not None else None)),
            RouterConfig(num_replicas=args.replicas, model_axes=axes,
                         kind="llm", roles=roles,
                         prefill_threshold=args.prefill_threshold,
                         handoff=not args.no_handoff), device=dev)
        router.install_drain_signal_handler()
        scaler = None
        if args.autoscale:
            from .fleet import SLO, Autoscaler, AutoscalerConfig
            scaler = Autoscaler(
                router,
                SLO(p95_ms=args.slo_p95_ms, max_queue=args.slo_max_queue,
                    min_replicas=args.min_replicas,
                    max_replicas=args.replicas),
                AutoscalerConfig(interval_s=args.autoscale_interval_s))
            scaler.start()
            print(f"{_NAME}: autoscaler on "
                  f"({args.min_replicas}..{args.replicas} replicas, "
                  f"p95<={args.slo_p95_ms}ms, "
                  f"queue<={args.slo_max_queue})", flush=True)
        serve_forever(None, args.host, args.port, quiet=False,
                      ready_cb=_ready, router=router)
        if scaler is not None:
            scaler.stop()
        router.drain()
        print(f"{_NAME}: drained, bye", flush=True)
        return 0

    engine = LLMEngine(model, cfg, draft_model=draft)
    engine.install_drain_signal_handler()

    serve_forever(None, args.host, args.port, quiet=False, ready_cb=_ready,
                  llm_engine=engine)
    engine.drain()
    print(f"{_NAME}: drained, bye", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
