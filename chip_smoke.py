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
   ``Engine`` (buckets 1/2/4/8, 50 ms batching delay), then 2 windows
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
   step takes above the weights and optimizer state in each;
17. prefix reuse on GPT-3 1.3B (the weights of phases 3-6): chat traffic
   of 34 greedy requests, 32 new tokens each, 8 slots, max_seq 1024 (24
   under one 496-token system prompt with 8-64-token tails, 8 unique
   256-512-token prompts, and a pair whose second request diverges inside
   a page of the first's head), through the slot engine (host store of
   8 GiB) and the paged engine (1280 pages, page 16, B4), each with reuse
   on and off (graphed) and on in the eager lane: hit rate, reused
   tokens, TTFT p50/p95, tokens/s, the slot lane's export and insert ms,
   the paged lane's shared and copied bytes and COW splits; held: tokens
   with reuse on equal those with it off under the near-tie rule (where
   they part, the plain lane's top-2 logits there lie within the lanes'
   measured logit difference: tail against full prefill, and the next
   decode step over the two caches), graphed equal to eager, every byte
   copied on the paged lane a COW page (the one split; aligned hits copy
   none), at least 24 hits; B4 held against its plain version on a block
   table of the arena's shared pages; the tail prefill's and the full
   prefill's device ms;
18. speculative decode (k = 4) on phase 4's 8 requests, through the slot
   and the paged engine: for ``GPTConfig.draft()`` of the 1.3B config
   (hidden 512, 6 layers, 4 heads, random from seed 1) graphed and eager,
   and for the target as its own draft graphed: acceptance, tokens a slot
   a tick, fallback ticks, tick ms, and the device ms of the plain step,
   the draft's micro-steps, the verify and the whole spec step, each
   replayed from its own captured program, tokens/s against phases 4 and
   6a; held: spec tokens equal the plain engines' under the near-tie rule
   (the lanes' difference measured as the plain step chained over k+1
   tokens against the verify's logits), graphed equal to eager, and the
   target as its own draft accepting at least 0.9;
19. int8 serving on the same model: phase 4's 8 requests through the
   slot and the paged engine with int8 weights (fp32 KV), int8 KV (fp32
   weights) and both, graphed, and both on the eager lane (tokens equal
   the graphed lane's), then int8 weights with prefix reuse on phase
   17's first 12 chat requests (paged); printed for each: tokens/s, tick,
   TTFT, the decode step's device ms replayed from its program, kv_bytes
   and its ratio to fp32's, KV bytes a token, the parameter dict's bytes
   against fp32's, the slot lane's dequant share of the step, and the
   decode step's projection GEMMs int8 against fp32; held: the
   int8-weight lanes' tokens equal an fp32 engine's over the dequantized
   weights ``q * s`` under the near-tie rule (the lanes' measured logit
   difference), the KV rows of one int8 decode step within 2% of the
   fp32 range, int8 KV at least 1.8x fewer bytes, B4 24 launches a step
   over dense pages and none over int8 pages (the gather lane), and
   ``Int8Linear``'s int8 x int8 lane (``torch._int_mm``, padded) equal to
   its exact int32 product at BERT-base's FFN shape and an odd shape,
   timed against the weight-only lane;
20. the hapi loop as users write it: (a) ResNet-50 (1000 classes, seed
   0) through ``Model.fit`` over an ``io.DataLoader`` of 4 worker
   processes on an in-memory ``io.Dataset`` of 2048 seeded 224x224
   images (8 batches of 256, shuffled), each worker's shared-memory ring
   sized to hold a batch, with ``LarsMomentum(0.1, 0.9, lars_coeff
   0.001, lars_weight_decay 5e-4)``, ``CrossEntropyLoss`` and
   ``Accuracy(topk=(1, 5))``, fp32 then O1 bf16, graphed, an
   ``ExponentialMovingAverage`` updated by a callback after each step:
   imgs/s over the fit and steady (a batch's interval: the host's wait
   on the loader and the step; and the step alone) beside phase 12's
   resident-batch ``train_batch`` (an earlier run's), the host's wait on
   the loader a batch, ring and
   queue messages (held: every batch through the rings), the EMA
   update's ms; ``evaluate`` under ``ema.apply()`` through the captured
   eval program and on the eager lane (imgs/s; held: top-1 and top-5
   equal, every parameter's ``data_ptr`` kept across apply and
   restore), ``predict`` on a batch, the LARS update alone against its
   byte bound; (b) BERT-base under bench.py's MLM head through ``fit``
   with ``Lamb(1e-3, lamb_weight_decay 0.01)`` over a ``DataLoader`` of
   6 batches of seeded ids, O1 bf16, graphed (tokens/s beside phase 13's
   O1 AdamW), then ``evaluate`` over 2 batches through the captured eval
   program (capture, replay) and on the eager lane (held: B1 12 launches
   a batch in each; the losses printed, bitwise or their difference), the
   Lamb update alone against its byte bound; (c) YOLOv3-DarkNet53 (80
   classes, 608x608) over 2 batches of 8: forward, ``decode``
   (``multiclass_nms`` on B5) and ``DetectionMAP`` in both AP versions
   against seeded ground truth (about half of each image's detections
   moved a few pixels, two random boxes, a fifth difficult), held equal
   to the mAP of the same decode through B5's plain version; (d) LeNet,
   batch 64, 5 ``train_batch`` steps with each of Adamax, Adagrad,
   Adadelta, RMSProp (plain and centered), Ftrl, Lamb, LarsMomentum,
   ``LookAhead`` (over Momentum, k 2) and ``ModelAverage`` (over
   Momentum, windows 2-3, then an ``eval_batch`` under ``apply()``),
   graphed against the eager lane: losses, weights and optimizer state
   bitwise (cuDNN deterministic);
21. the dygraph loop on the port's Tensors, as a paddle user writes it
   (``to_tensor``, ``model(x)``, the loss, ``loss.backward()``,
   ``opt.step()``, ``opt.clear_grad()``): the dispatch funnel's host µs a
   call (``apply`` against the bare torch call, on torch tensors and on
   Tensors); (a) LeNet, batch 64 of random 28x28 images, 20 steps with
   Momentum, the losses bitwise equal to the same steps through
   ``Model.train_batch`` on the eager lane (cuDNN deterministic), funnel
   calls a step, step wall and device ms beside the eager
   ``train_batch`` step's; (b) GPT-3 1.3B at full width with phase 7's
   AdamW, clip, schedule and batch, 3 dygraph steps in fp32 and 3 with
   the forward under ``amp.auto_cast`` (O1 bf16), each on a fresh model
   from seed 0, B1, B2 and B3 24 launches a step each in the step's
   type, the losses against ``Model.train_batch``'s eager lane on fresh
   weights (bitwise, or within 1e-6 relative), funnel calls a step, step
   wall, device ms and idle share beside phase 7's and phase 9's graphed
   and eager steps; (c) ``paddle.grad(create_graph=True)`` (a gradient
   penalty on a small MLP, within 1e-5 of the CPU's), a ``PyLayer``,
   ``register_hook``, ``FLAGS_check_nan_inf`` raising on an eager op
   that makes a NaN and skipped inside a captured ``Program`` (the
   capture succeeds; a replay on an input holding an inf returns the
   non-finite result); (d) with no ``set_device`` call ``to_tensor``
   lands on ``cuda:0``, its ``place`` is ``CUDAPlace(0)`` and
   ``get_device()`` is ``"gpu:0"``;
22. a paddle program written from the op surface: GPT-3 1.3B as a user's
   ``nn.Layer`` (``tests/test_torch_op_table.py`` ``op_built_gpt``: every
   weight a ``create_parameter`` with ``ParamAttr(initializer=Assign(...))``
   taken by name from ``GPTForCausalLM``'s seed-0 state dict; the forward
   from ``F.embedding``, ``arange``/``unsqueeze``/``tile``,
   ``F.layer_norm``, ``matmul`` and ``+``, ``reshape``,
   ``F.flash_attention(causal=True)``, ``F.gelu``, the tied head; the loss
   through slicing, ``reshape`` and ``F.cross_entropy``) at phase 21's
   shape and recipe: (a) 3 dygraph steps in fp32 and 3 under O1 bf16,
   B1, B2 and B3 24 launches a step each, the losses against phase 21's
   ``GPTForCausalLM`` dygraph losses (bitwise where the op sequence is
   the layers', else within 1e-4 relative fp32 or 2e-2 O1 with the op
   that parts named), funnel calls, step wall, device ms and idle share
   beside phase 21's; (b) the same program through ``Model.train_batch``,
   graphed (one capture) and eager, losses bitwise equal; (c) the dense
   variant (the reference's dense branch) for one fp32 step: loss within
   1e-4 and gradient global norm within 1e-3 of the flash variant's
   first step, and its peak memory (at ``[4, 1024]``, or ``[1, 1024]``
   for both where it does not fit); (d) the op table
   (``tests/test_torch_op_table.py`` ``CUDA_CASES``, every ported op of the
   dense surface but the tie cases) on CUDA against the CPU, forward and
   gradient, and the random ops' determinism and moments on the card,
   printed as ``n held of n``;
23. a BERT-base CRF tagger as a paddle user writes it (PaddleNLP's
   BERT-CRF for MSRA-NER, ``tests/test_torch_op_table.py``
   ``bert_crf_tagger``: ``BertModel(BertConfig())`` with its dropouts, a
   ``Linear(768, 7)`` emission head over IOB tags of PER/ORG/LOC, a
   ``create_parameter([9, 7])`` transition, the loss
   ``linear_chain_crf(...).mean()``, the decode ``crf_decoding``, F1 from
   ``chunk_eval(IOB, 3)``) on [32, 128] seeded ids with lengths 64-128 and
   valid IOB tags: (a) 10 ``Model.train_batch`` steps of AdamW, graphed
   (one capture) and eager, losses bitwise equal, no kernel (attention
   dense under dropout); (b) ``Model.evaluate`` and ``Model.predict``
   through their captured programs (the Viterbi path inside the predict
   program), B1 12 launches a batch; (c) the captured predict's paths
   bitwise the eager lane's; (d) ``crf_decoding`` on the card against the
   CPU on the same emissions (equal, or the two paths' scores within
   1e-5 relative: a near tie); (e) step ms, predict tokens/s and the
   CRF's share of an eager step's device time; then the structured ops'
   table cases (``CUDA_CASES`` of ``STRUCTURED``) on CUDA against the CPU
   and the host-reading ops (``HOST_CASES``) eagerly, ``n held of n``, the
   structured draws repeated under one seed, and the capture lane of
   ``ops.cond`` (``cond_net``: a ``train_batch`` graphed against eager,
   bitwise, its branch not taken ``sqrt`` of a negative input) and a
   ``while_loop`` under a capture, which raises;
24. GPT-3 1.3B (phase 3's weights, seed 0) decoded by beam search as a
   user writes it: ``nn.BeamSearchDecoder`` and ``nn.dynamic_decode``, 2
   prompts of 64 seeded tokens ending in the start token, 4 beams, 32
   steps, under ``no_grad``, with two cells (``gpt_beam_cells``): (a) the
   incremental cache, the prefix prefilled once and tiled to the beams,
   its ``Cache`` leaves reordered by parent every step, attention dense
   (no kernel); (b) the token history as the state, the whole prefix a
   step with no cache, attention through B1 (24 launches a step). Both
   cells' ids equal under the beam near-tie rule (:func:`beam_near_ties`:
   where they part, the candidates the cells ranked differently lie
   within the cells' summed log-probability difference) and scores
   within 1e-4 relative where the ids are equal; tokens/s and step ms of
   each cell;
25. MobileNetV3-Large (BASELINE config 2's PaddleClas model,
   ``vision.models.mobilenet_v3_large()``: scale 1.0, 1000 classes, 224 x
   224, random weights from seed 0, seeded synthetic images and labels):
   (a) 10 ``Model.train_batch`` steps at batch 128 with Momentum(0.9),
   L2Decay and a CosineAnnealingDecay schedule, fp32 and O1 bf16, each
   graphed (one capture) and eager under cuDNN's deterministic
   algorithms, losses and BN statistics bitwise equal between the lanes;
   (b) ``Model.predict`` over 4 batches of 64 through its captured
   program (top-1 equal to the eager lane's), then 64 single-image
   requests at once through the dynamic-batching ``Engine`` over the same
   network in eval mode, each answer's top-1 the direct predict's (or a
   near tie there); (c) the A3 table on the card: the A3 functionals'
   op cases (``ct.A3``) and the layer table (``LAYER_CASES``) on CUDA
   against the CPU, forward, gradient and state, ``n held of n``; (d)
   imgs/s of training (fp32, O1) and predict, the engine's p50 and p99
   latency, peak memory; no kernel of the port is on this path;
26. a ViT-B/16 written from ``nn`` layers (PaddleClas's
   ``ViT_base_patch16_224``, ``tests/test_torch_op_table.py`` ``vit``:
   ``Conv2D`` patch embedding, class token and position embedding from
   ``create_parameter``, a ``LayerList`` of 12 pre-norm blocks with
   ``MultiHeadAttention`` and ``GELU``, ``Softmax`` in the predict
   program; every dropout 0, so attention takes the flash route): (a) 10
   O1 bf16 ``Model.train_batch`` steps of AdamW at batch 64 (S = 197:
   every backward meets a tail tile), graphed and eager, losses bitwise
   equal, B1, B2 and B3 exactly 12 launches a step each; (b) one fp32
   step with ``attn_impl="flash"`` against ``"dense"``, the loss within
   1e-4 relative and each gradient within GRAD_TOL; (c) ``Model.predict``
   through its captured program, B1 12 launches a batch; (d) step ms,
   imgs/s and B1-B3's share of the O1 step's device time from one
   profiled step;
27. the PTB-large LSTM language model of Zaremba, Sutskever & Vinyals
   2014 as a user writes it (``tests/test_torch_a9_table.py``
   ``lstm_lm``: ``Embedding(10000, 1500)``, dropout 0.65, ``nn.LSTM(1500,
   1500, num_layers=2, dropout=0.65)``, dropout, ``Linear(1500,
   10000)``, cross entropy; every weight uniform in +-0.04, seed 27):
   (a) 10 ``Model.train_batch`` steps of SGD(1.0) with the global norm
   clipped at 10 on seeded ids [20, 35], fp32 and O1 bf16, each graphed
   (one capture) and eager, losses bitwise equal between the lanes; (b)
   ``Model.evaluate`` (dropout off) through its captured program, its
   loss equal to the eager lane's; (c) the RNN table (``RNN_CASES``: every
   class of ``nn/rnn.py``, ``sequence_length`` forward, reverse and
   bidirectional, ``time_major``, initial states, GRU, SimpleRNN with
   relu, a custom cell) on CUDA against the CPU, ``n held of n``; (d) step
   ms and tokens/s (700 a step) of each lane and precision, peak memory,
   the recurrent loops' share of an eager step's device time (the
   ``rnn_scan_lstm`` ops' kernels and their backward), and beside them
   ``torch.nn.LSTM`` (cuDNN) forward and backward at the same shapes, a
   library yardstick only, against the port's ``nn.LSTM``, both captured
   and replayed; no port kernel runs on this path;
28. Faster R-CNN R50-FPN inference at PaddleDetection's release/2.0
   settings (``configs/faster_rcnn/_base_/faster_rcnn_r50_fpn.yml``): the
   port's ``resnet50`` C2-C5, an FPN of ``Conv2D`` (256 wide, P6 by
   ``max_pool2d``), an RPN head, then ``tests/test_torch_a9_table.py``'s
   ``rpn_to_rois`` (``anchor_generator`` and ``generate_proposals`` per
   level, both images in one call, ``collect_fpn_proposals`` per image),
   ``roi_features`` (``distribute_fpn_proposals``, ``roi_align`` 7 x 7 per
   level) and, after a ``TwoFCHead(1024)``, ``detect`` (``box_coder``
   decode, ``multiclass_nms``) on 2 seeded 800 x 1344 images, random
   weights, fp32, ``no_grad``: (a) the path twice, outputs bitwise equal;
   (b) every detection op call of the path run again on the CPU on copies
   of its inputs, values within 1e-5, counts, masks and indices equal, a
   differing kept set passing only at a named IoU near tie; (c) B5's
   launches counted (one a ``generate_proposals`` call and one the
   ``multiclass_nms`` call, 12 for two runs) and B5 timed at the path's
   own scans (P2's proposals, P = 2 and k = 1000; the final NMS, P = 160
   and k = 1000) against its plain version, bit-exact; (d) ms an image,
   device ms by stage (backbone and FPN, proposals, RoIAlign, head, NMS),
   peak memory;
29. ResNet-50 O1 ``Model.fit`` for 4 batches of 128 through PaddleClas's
   ImageNet train transforms (``RandomResizedCrop(224)``,
   ``RandomHorizontalFlip``, ``Normalize``, ``Transpose``) in 4
   ``io.DataLoader`` workers over a ``vision.datasets.DatasetFolder`` of
   1,024 seeded ``.npy`` images (8 classes, sides 256-512, written under
   ``build/`` and removed after): imgs/s, the host's wait on the loader
   as a share of each batch interval, a transform's ms an image in one
   process, the same step on a batch kept on the device; each of two
   workers' first crop and flip equal the transforms run in the main
   process under that worker's seed, bit for bit.

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
phase 15 and read after it, just before each of phase 16's four
lanes and read after it, and just before phase 17's engine runs,
phase 18's and phase 19's and read after each, and around each of
phase 20's paths (ResNet-50 fit fp32, fit O1 and evaluate, BERT fit and
evaluate, the mAP path's kernel lane, the LeNet rules; only BERT's
evaluate launches B1 and only the mAP path B5), and around each of phase
21's dygraph paths (LeNet, which launches none, and the GPT's fp32 and
O1 steps, B1-B3 24 each a step), and around each of phase 22's (the
op-built GPT's fp32 and O1 dygraph steps and its ``train_batch`` lanes,
B1-B3 24 each a step), and around each of phase 23's (the tagger's
training lanes, none; its evaluate and predict, B1 12 a batch) and
phase 24's (the cached cell, none; the full-prefix cell, B1 24 a step),
and around each of phase 25's (the four training lanes, the serving
path and the A3 table, none) and phase 26's (the O1 training lanes,
B1-B3 12 each a step; the predict program, B1 12 a batch; the flash and
dense steps, B1-B3 12 each on the flash one), and around each of phase
27's (the four LSTM training lanes, the cuDNN yardstick and the RNN
table, none), phase 28's (the path run twice: B5 12) and phase 29's (the
fit, none), and around each of phase 32's five lanes (the fp32 park and
the kill, B4 24 a decode step of every engine the lane built, the
victim's and its resurrection's included; the roll, 2 a step at its 2
layers; the int8 park and the handoff, none) (B4 there runs in the plain
paged steps only, 24 launches a step; in phase 19 in the paged runs over
dense pages, int8 weights included, and in none over int8 pages; the
prefills, tail prefills and the verify attend densely, as the JAX
package's, so B1 launches nothing on any of them). The last two lines are a
``{"kernels": [...]}`` summary and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result. ``--phase 22`` runs,
after the build, phase 21's two GPT-3 1.3B dygraph references and phase
22 alone, and prints that phase's numbers only; ``--phase 23`` to
``--phase 33`` run that phase alone after the build. B4 chunks by its
rule wherever the port's committed tuner table has no winner; its
launches never read the tuner's disk cache (phase 33's search writes to
a temporary cache of its own), and phase 2's B4 times are the rule's,
with a committed winner's timed beside them.

Phase 30 drives the host-plane substrate on GPT-3 1.3B: live MFU on
phase 7's graphed fp32 and O1 ``train_batch`` (``attach_step_meter``;
``train.flops_per_step`` held within 10% of the analytic count and the
losses bitwise those of an unmetered model), ``measure_mfu`` on the
slot and the paged ``LLMEngine`` over phase 4's 8 requests (tokens equal
to the unmetered engines'), the disabled span's host ns and the spans a
tick and a step record, the decode tick and the O1 step with tracing off
and on in alternating rounds, a ``Profiler`` around 3 graphed steps
(B1-B3's kernels in its trace) and one eager step (the funnel's
``op::`` ranges), the exported Chrome trace's nesting, a SIGTERM drain
of the metered paged engine and of a classifier ``Engine`` (an armed
flight dump each) and a preemption-guard drain of the metered slot
engine, and one CUDA graph captured while a profile runs (its result or
its fault is printed). Its launch counts are set to 0 before and read
after each path: the two train lanes (B1-B3 24 each a step), the
tracing rounds and profiles, each serving engine (B4 24 a paged step,
the metered engine's count included; the prefills attend densely, and
the slot engines launch none) and the tick rounds.

Phase 31 drives training that survives faults on GPT-3 1.3B, O1 bf16,
graphed, on phase 7's ``[4, 1024]`` shape with its dropout 0: (1) the
skip lane, ``fit`` with ``AnomalyGuardCallback`` and a NaN injected into
the gradients at the second of 4 guarded steps (through a FaultInjector
the phase owns), its parameters, moments and step count bitwise those
of a guarded run that drops that batch's update by hand,
``sentinel.host_syncs`` equal to the guarded steps; (2) the costs: the
guarded route (the captured gradients program, the probe's graph, the
eager update) against the fused graphed step in alternating rounds,
wall and device ms, the probe's device ms against its byte bound, the
host ms of an async snapshot of the full state and the step's peak
memory with its clones held; (3) the rollback lane at full width and 2
layers (time: a full checkpoint writes for about a minute): ``fit``
with ``AnomalyGuardCallback(ladder rollback, async snapshots)``, a NaN
at epoch 1's first step restores epoch 0's snapshot into the live
model (bitwise) and training completes; the async commit's enqueue,
fetch and write ms, then a sync ``save_sharded`` of its parameters, its
bytes and GB/s, the sha256 seconds and ``load_sharded`` seconds; (4)
the kill lane at the same size: a child process (``--ft-child train``)
fits with ``AnomalyGuardCallback`` and
``FaultToleranceCallback(async_save=True)`` (each epoch's commit drained
before the next) and is killed mid-epoch 1 by ``step:3:crash`` (exit
43); a second child (``--ft-child resume``) restores the last committed
epoch and fits on, its losses bitwise those of the same fit run unbroken
in this process, then halts on a NaN under a ``("halt",)`` ladder with
``DIVERGENCE_EXIT_CODE`` and one flight dump. The killed child runs
beside the unbroken fit, which times nothing, after the 1.3B lanes have
freed the card's memory; the costs and the rollback lane's I/O times
are taken with no child running.
Everything is written under a temporary directory removed at the end. Its launch counts are
set to 0 before and read after each path: the guarded fit and the
manual skip (B1-B3 24 each a step), the cost rounds and profiles, the
rollback fit and the unbroken fit (2 each a step), and the resumed
child's, which it prints.

Phase 32 drives the LLM fleet's data path on GPT-3 1.3B (seed 0, fp32):
two paged ``LLMEngine`` replicas (phase 4's config: 8 slots, 1024 rows,
16-row pages, B4) under one ``Router`` on the one card, over phase 4's 8
request lengths (prompts from phase 3's seed) at 32 new tokens each. (1)
Park: the router's undisturbed run of the 8 requests is the reference;
then the 8 again, streaming, and once every stream has 3 tokens the
busier replica is parked: its sequences are exported (their pages read
to the host) and imported into the sibling, and every stream must equal
the reference bitwise, and no sequence fails; the export's and the
import's ms and GB/s (the paged batcher's ``seq_export_ms`` and
``seq_import_ms`` and their bytes), the pages copied and shared. (2) The
same over int8 pages (the gather lane; B4 takes no int8 arena). (3)
Kill: the busier replica hard-killed mid-stream; its journaled streams
are replayed on the survivor through the dedup guard and held to (1)'s
reference under the near-tie rule (the noise: a dense prefill of the
prompt and 4 tokens against the decode steps that wrote those rows, the
first token's logits and the next step's), with no stream divergence (a
divergence fails the phase with the logit gap at its position); the
health loop resurrects the victim, whose engine captures its programs
while the survivor decodes (kept busy by a pump until the victim is
healthy); the time from the kill to each replayed stream's first new
token. (4) Roll: at 2 layers and full width (the checkpoint's I/O), one
model per replica, ``WeightSwapper.roll`` to a committed, health-stamped
checkpoint of seed 1's weights under 4 pumping streams: every finished
stream equals the old or the new weights' engine by its
``weights_version``, bitwise, at least one sequence migrated, no
admitted stream and no migrated sequence failing, no swap adding a
program to the executable cache (each engine's
``weight_swap_compiles``); the checkpoint's reads and each swap's ms as
the swapper and the engines record them. (5) Handoff: roles ("prefill",
"decode") over one shared host ``PrefixStore`` (slot layout, phase 17's
buckets, ``prefill_threshold`` 256): the 4 long prompts hand off, the
decode replica reuses their heads, and the tokens equal one slot
engine's under phase 17's prefix rule (noise: the tail prefill behind
the prefill replica's head rows against the full prefill).

Phase 33 drives the host planes' front door on GPT-3 1.3B (seed 0,
fp32), two paged replicas of phase 4's engine under one ``Router``. (1)
HTTP: ``make_server(router=)`` on 127.0.0.1, port 0; phase 4's 8
requests x 32 tokens posted from 8 client threads twice (4 streaming and
4 not, then the other way round): every token list equal to the same
router's in-process run of the 8 under the near-tie rule (noise: phase
32's replay noise; counted bitwise), a prompt's streamed and plain
lists equal, ``/healthz`` 200 with the aggregate, ``/statsz`` with the
router and both replicas, ``/metricsz`` parsed as Prometheus text with
the router's and both replicas' families; ``req_ms`` against the
in-process ms. (2) On the same router: replica 1 parked, the 8 requests
on replica 0 alone give one replica's capacity; then
``Autoscaler(min 1, max 2)`` under ``TraceReplayer`` over
``synthesize_trace(seed=0)`` at 1.5 times that capacity for 12 s, phase
4's prompt lengths and 32 tokens, SLO p95 twice the one-replica batch's
slowest request and a queue of 8: 0 drops, completed equal to offered,
every result on weights version 0, a scale-up whose unpark booted, and
a scale-down once calm; the time from the breach run's first tick to
the unparked replica admitting (``fleet.autoscale.breach_to_up_ms``),
the unpark's and the parks' ms, latency p50/p95, the retries. (3) The
CLI: ``python -m paddle_tpu_torch.serving serve-llm --port 0`` at
GPT-3 1.3B's widths (random weights) in a child process: the port line
and boot seconds, ``/healthz``, one plain and one streaming
``/generate`` of the same prompt with equal tokens, its slot engine on
the card, and SIGTERM ending in "drained, bye" and exit 0. (4) The
tuner: ``autotune_paged_attn`` at phase 4's B4 shape (8 x 16 x 128,
16-row pages, the 64 pages of 1024 rows; recorded) and at 8 pages (not
recorded) into a temporary cache, every candidate's device us beside
the rule's; the winner read back from disk after ``clear_memo()`` while
B4's launch-path lookup stays what it was before the search (the disk
cache never reaches the main path), and B4 under the winner on phase
2's inputs within 1e-4 of plain, bitwise repeatable, and captured and
replayed in a CUDA graph bitwise. Its launch counts are set to 0 before
and read after each lane: the HTTP lane and the autoscaler lane (B4 24
a decode step of every engine, the resurrected replica's included), the
CLI lane (every kernel 0, read from the child's ``/statsz``: its slot
engine attends densely), and the tuner (its search's calls, then 6
holding the winner).

Phase 34 drives distributed training on the one card. (1) A world of
one on NCCL: ``init_parallel_env()``, a dp1 x mp1 mesh, every collective
of ``distributed/collective.py`` on CUDA tensors the identity, then
GPT-3 1.3B laid out by ``tp_partition_specs`` and its [4, 1024] batch by
``shard_batch`` (the ``dryrun_multichip`` path), 3 O1 AdamW steps
through ``Model.train_batch`` on the graphed lane: losses bitwise those
of the same model without a mesh, B1-B3 24 a step each. (2) Two NCCL
ranks on the card: NCCL's "Duplicate GPU detected" refusal, kept. (3)
Four ranks on the card over gloo (``dist.spawn(backend="gloo",
gpus="0,0,0,0")``): (a) ``fleet.init`` with dp2 x mp2, the 4-layer GPT
at 1.3B's width through ``distributed_model``/``distributed_optimizer``,
3 fp32 AdamW steps on the eager lane (gloo cannot be captured; ``Model``
says so): losses within 1e-4 relative of one process on the card, the
gathered parameters within 1e-4 of each tensor's max or 5% of one
AdamW step, the larger (k_proj.bias, whose gradient is zero up to
rounding, held to Adam's step bound),
B1-B3 4 a step a
rank over its 8 local heads; (b) bench.py's ``bench_gpt_ring_flash``
stack at 1.3B's width (2 layers, 16 heads of 128, B=1, S=32768, bf16,
causal, 2 SGD steps) over an sp4 mesh with ``ring_flash_attention``:
losses within 2e-2 of the stack in one process with B1-B3 over the whole
sequence; the first forward's O and LSE against B1's and, at 256 rows,
against the plain version; the first step's wq, wk and wv gradients,
summed over the ranks, against the one-process run's (relative, bounds
set from the errors measured on an H100); rank r launching
B1-B3 (r + 1) times a layer a step (its future blocks launch nothing),
the point-to-point blocks through pinned host memory (counted); (c)
every collective once on CUDA tensors, a rank subgroup and the hybrid
axes included, against NumPy, and the compressed all-reduce's int8
codes equal to the CPU's. Each lane's wall, step ms and peak memory a
rank are printed. The gloo timings say nothing about NCCL.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import threading
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
DET_WINDOWS = 2
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
ROUNDS = 2
ROUND_ITERS = 20
#: steps a train step's profile times, then records (after one warm-up)
PROFILE_STEPS = 1
SPIN_CYCLES = 50_000_000


_T0 = time.perf_counter()


def log(msg):
    """One line of the run's record, after the seconds since the script
    started (where the time goes, phase by phase and lane by lane)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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


def funnel_share(torch, launch, rounds=5, calls=5):
    """What the dispatch funnel costs an eager step: ``launch``'s host ms
    a call (:func:`host_time_ms` over ``calls`` calls) with the funnel as
    it is and with ``apply`` calling each op's function directly (no
    unwrap, AMP handler, nan/inf check or registry: what an op cost before
    the funnel), in alternating rounds, medians kept; and the funnel's
    calls a step."""
    from paddle_tpu_torch.ops import dispatch
    run = dispatch._run

    def bare(name, fn, args, attrs):
        return fn(*args, **attrs)

    calls_per_step = funnel_calls(launch)
    per = {"funnel": [], "bare": []}
    try:
        for r in range(rounds):
            for lane in (("funnel", "bare") if r % 2 == 0
                         else ("bare", "funnel")):
                dispatch._run = run if lane == "funnel" else bare
                per[lane].append(host_time_ms(launch, calls))
    finally:
        dispatch._run = run
    f, b = (float(np.median(per[k])) for k in ("funnel", "bare"))
    return {"funnel_calls_per_step": calls_per_step, "with_funnel_ms": f,
            "funnel_bypassed_ms": b, "funnel_share": (f - b) / f}


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

#: B1-B3 at phase 26's ViT-B/16 attention: B=64, S=197 (196 patches and
#: the class token; every backward ends on a tail tile), H=12, D=64
VIT_ATTN = (64, 197, 12, 64)


def _flash_cases(torch, with_gen):
    """Phase 2's B1-B3 cases, (type name, dtype, B, Sq, Skv, H, D, causal,
    summary tag): the training path's B=4, S=1024, H=16, D=128, the odd
    length and Sq != Skv cases, BERT-base's shape (BERT_ATTN, tag
    "bert"), the ViT-B/16's (VIT_ATTN, tag "vit"), the long-context
    GPT's (LONG_ATTN, tag "s4096", and LONG_CHECK, tag "s4096_check"),
    and for B1 the short causal lengths of generate's recompute lane
    (GEN_FLASH_LENS)."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    b, s, h, d = BERT_ATTN
    vb, vs, vh, vd = VIT_ATTN
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
             ("fp32", f32, vb, vs, vs, vh, vd, False, "vit"),
             ("bf16", bf16, vb, vs, vs, vh, vd, False, "vit"),
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
    # the checks launch as the main path does (the committed table's
    # winner for this shape, else the rule); the row's times are the
    # rule's, and a committed winner's are timed beside them
    rule = pa_mod.BLOCKS_PER_SM
    bps = pa_mod.paged_blocks_per_sm(h, d, page, q.dtype, q.device) or rule
    chunk = pa_mod.chunk_pages_for(pps, s_n * h, n_sms, rule)
    row = None
    for name, pos in PAGED_CASES:
        positions = torch.tensor(pos, dtype=torch.int32, device="cuda")
        out = pa_mod.paged_attention(q, kb, vb, bt, positions)
        again = pa_mod.paged_attention(q, kb, vb, bt, positions)
        ref = pa_mod.paged_attention_plain(q, kb, vb, bt, positions)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        err = (out - ref).abs().max().item()

        def run(b=rule):
            return pa_mod.paged_attention(q, kb, vb, bt, positions,
                                          blocks_per_sm=b)
        ms = time_ms(run, spin=True)
        host_ms = host_time_ms(run)
        plain_ms = time_ms(
            lambda: pa_mod.paged_attention_plain(q, kb, vb, bt, positions),
            iters=5)
        win_ms = None if bps == rule else time_ms(lambda: run(bps),
                                                  spin=True)
        bms, by, rows = paged_bound(torch, q, kb, bt, positions)
        log(f"B4 paged {name} S={s_n} H={h} D={d} page={page} "
            f"pages/seq={pps} fp32 (the rule: {chunk} pages a chunk, {rule}"
            f" blocks an SM, {n_sms} SMs; the checks at {bps}): "
            f"max_abs_err {err:.3e} (tol {TOL['fp32']:.0e}), two launches "
            f"bitwise equal {same}; kernel {ms:.4f} ms (the wrapper's host "
            f"time a call {host_ms:.4f} ms) plain {plain_ms:.4f} ms bound "
            f"{bms:.4f} ms ({by}), {rows} visible rows"
            + ("" if win_ms is None else
               f"; the committed winner {bps} blocks an SM {win_ms:.4f} ms"))
        if not (same and err <= TOL["fp32"]
                and bool(torch.isfinite(out).all())):
            raise RuntimeError(f"paged attention kernel disagrees with its "
                               f"plain version or itself ({name})")
        if row is None:
            row = {"max_abs_err": err, "ms": ms, "host_ms": host_ms,
                   "plain_ms": plain_ms,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "tolerance": TOL["fp32"], "bitwise_repeatable": same,
                   "chunk_pages": chunk, "blocks_per_sm": rule,
                   "checked_blocks_per_sm": bps, "committed_winner_ms":
                   win_ms, "shape": f"S={s_n} H={h} D={d} page={page} "
                                    f"pages/seq={pps} fp32"}
        else:
            row.update(full_ms=ms, full_bound_ms=bms, full_max_abs_err=err,
                       full_committed_winner_ms=win_ms,
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
        if not str(e.device_type).endswith("CUDA") or e.key in ranges \
                or e.key.startswith("op::"):    # the funnel's op spans
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
    the device's clock (20 replays behind a spin kernel), or, eager, what
    the dispatch funnel costs the step call (:func:`funnel_share`)."""
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
    else:
        out["funnel"] = fs = funnel_share(torch, launch)
        line += (f"; {fs['funnel_calls_per_step']} funnel calls a step, "
                 f"host {fs['with_funnel_ms']:.4f} ms a call with the "
                 f"funnel against {fs['funnel_bypassed_ms']:.4f} with it "
                 f"bypassed ({100 * fs['funnel_share']:.2f}%)")
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


def _gpt_optimizer(net, dev, o2=False):
    """Phase 7's AdamW (weight decay 0.01, global-norm clip 1.0; float32
    masters with ``o2``) on a linear warmup over cosine decay, GPT-3
    1.3B's published peak lr with a short warmup for a 5-step run."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(2e-4, T_max=1000),
                            warmup_steps=2, start_lr=2e-5, end_lr=2e-4)
    opt = AdamW(learning_rate=sched, parameters=net.parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0),
                multi_precision=o2, device=dev)
    return opt, sched


def _train_model(torch, cfg, dev, impl, with_optimizer=True, o2=False):
    """GPT-3 1.3B wrapped in ``Model``, weights from seed 0, with AdamW
    (weight decay 0.01, global-norm clip 1.0, linear warmup over cosine
    decay) and the GPT criterion. With ``o2``, ``amp.decorate`` casts the
    model to bfloat16 first and AdamW keeps float32 masters
    (``multi_precision``)."""
    from paddle_tpu_torch import Model, amp
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion)
    net = GPTForCausalLM(GPTConfig(**cfg, attn_impl=impl), device=dev,
                         seed=0)
    if o2:
        amp.decorate(net, level="O2")
    opt = sched = None
    if with_optimizer:
        opt, sched = _gpt_optimizer(net, dev, o2)
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
                             f"{tuple(xs[0].shape)}, {lane}", step,
                             PROFILE_STEPS,
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
        out = op_attribution(torch, prof["events"], op_parts, PROFILE_STEPS)
    elif eager:       # the profiled steps' events
        if "casts" not in out:
            out["casts"] = _kernel_ms(torch, prof["events"],
                                      "aten::_to_copy") / PROFILE_STEPS
        out["optimizer"] = _kernel_ms(torch, prof["events"],
                                      "optimizer.update") / PROFILE_STEPS
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


# -- phases 17 and 18: prefix reuse and speculative decode (GPT-3 1.3B) ------

#: phase 17's chat traffic: a 496-token system prompt (31 pages of 16)
#: under 24 requests with tails of 8-64 tokens, 8 requests of unique
#: 256-512-token prompts, and a pair whose second request diverges inside
#: a page of the first's head (a COW split on the paged layout)
PREFIX_SYS = 496
PREFIX_SHARED = 24
PREFIX_UNIQUE = 8
PREFIX_NEW = 32
#: the buckets the traffic needs: tails, unique prompts, whole prompts
PREFIX_BUCKETS = (64, 512, 1024)
#: the host store's budget (one 496-token entry is 186 MiB at 1.3B fp32,
#: the engine's default 256 MB holds one): every head of the traffic
#: fits, so hits and misses do not hang on timing
PREFIX_CAPACITY_MB = 8192
#: the paged pool: the page-sharing store holds a quarter, and every
#: head of the traffic fits in that quarter
PREFIX_PAGES = 1280
#: phase 18: the speculation depth and the run's two drafts
SPEC_K = 4


def prefix_traffic(vocab):
    """Phase 17's 34 prompts in arrival order (3 shared-prompt requests,
    then a unique one, 8 times; then the COW pair) and the index of the
    pair's second request."""
    rng = np.random.default_rng(17)
    sysp = rng.integers(0, vocab, PREFIX_SYS).tolist()
    shared = [sysp + rng.integers(0, vocab, int(rng.integers(8, 65))
                                  ).tolist() for _ in range(PREFIX_SHARED)]
    unique = [rng.integers(0, vocab, int(rng.integers(256, 513))).tolist()
              for _ in range(PREFIX_UNIQUE)]
    order = []
    for i in range(PREFIX_UNIQUE):
        order += shared[3 * i:3 * i + 3] + [unique[i]]
    head = rng.integers(0, vocab, 520).tolist()
    order += [head, head[:510] + [(head[510] + 1) % vocab]]
    return order


def _engine_run(torch, model, cfg_kw, prompts, new, eager=False,
                draft=None):
    """One engine over ``prompts`` (submitted at once), built and
    drained here (inside ``disable_graphs`` for the eager lane): its
    tokens, stats, warm-up and serving wall seconds, and the engine."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving import ExecutableCache
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    ctx = graphs.disable_graphs() if eager else contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        eng = LLMEngine(model, LLMEngineConfig(**cfg_kw),
                        cache=ExecutableCache(), draft_model=draft)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
            toks = [r.result(timeout=600)["tokens"] for r in reqs]
            wall = time.perf_counter() - t0
            stats = eng.stats()
        finally:
            eng.drain(timeout=120)
    for t in toks:
        if len(t) != new:
            raise RuntimeError(f"a request returned {len(t)} tokens, not "
                               f"{new}")
    return {"tokens": toks, "stats": stats, "warm_s": warm, "wall_s": wall,
            "tokens_per_s": sum(map(len, toks)) / wall, "engine": eng}


def near_tie_parts(torch, dec, params, prompts, ref, got, noise, what):
    """The near-tie rule: where ``got``'s tokens part from ``ref``'s, the
    first differing step's logits of the plain lane (the dense prefill of
    the prompt and ``ref``'s tokens before that step) must have their
    top two within ``noise``, the two lanes' measured logit difference.
    Returns [(request, step, top-2 gap)]; any other difference raises."""
    from paddle_tpu_torch.serving.llm.decode import prefill_forward
    parts = []
    for r, (p, a, b) in enumerate(zip(prompts, ref, got)):
        if a == b:
            continue
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            raise RuntimeError(f"{what}: request {r} returned {len(b)} "
                               f"tokens where the plain lane gave {len(a)}")
        seq = torch.tensor([list(p) + list(a[:t])], dtype=torch.int32,
                           device=dec.device)
        with torch.no_grad():
            lraw, _, _ = prefill_forward(dec.spec, params, seq, torch.tensor(
                [seq.shape[1]], dtype=torch.int32, device=dec.device))
        top = lraw[0].topk(2).values
        gap = float(top[0] - top[1])
        parts.append((r, t, gap))
        if gap > noise:
            raise RuntimeError(
                f"{what}: request {r} parts from the plain lane at step {t} "
                f"where the plain lane's top-2 gap {gap:.3e} exceeds the "
                f"lanes' measured logit difference {noise:.3e}")
    return parts


def _prefill_slots(torch, dec, kv, params, prompts, extra=0):
    """Each prompt prefilled into its own slot (at its pow2 bucket; the
    paged cache maps ``extra`` more rows); returns the first tokens."""
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    dev = dec.device
    fin = torch.zeros(kv.num_slots, dtype=torch.bool, device=dev)
    samp = pack_sampling([SamplingParams()], dev)
    last = torch.zeros(kv.num_slots, dtype=torch.int32, device=dev)
    for slot, p in enumerate(prompts):
        kv.alloc()
        if hasattr(kv, "ensure_pages"):
            kv.ensure_pages(slot, min(len(p) + extra, kv.max_seq))
        lp = 1 << (len(p) - 1).bit_length()
        toks = torch.zeros(1, lp, dtype=torch.int32, device=dev)
        toks[0, :len(p)] = torch.tensor(p, device=dev)
        nxt, _ = dec.prefill(
            kv, params, toks,
            torch.tensor([len(p)], dtype=torch.int32, device=dev),
            torch.tensor([slot], dtype=torch.int32, device=dev), fin, samp,
            None)
        last[slot] = nxt[0]
    return last


def prefix_noise_and_times(torch, model, dev, prompt):
    """Phase 17, off the path, on one shared-prompt request: (a) the
    lanes' measured logit difference, the larger of the first token's
    logits from a tail prefill (the 496-token head reused) against a full
    prefill, and of the next decode step's logits over the two caches;
    (b) the tail prefill's and the full prefill's device ms, both
    replayed from their captured programs, on each layout."""
    import functools
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     insert_prefix_rows,
                                                     pack_sampling,
                                                     prefill_forward,
                                                     tail_forward)
    from paddle_tpu_torch.serving.llm.kvcache import write_prompt_kv
    from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder
    n, start = len(prompt), PREFIX_SYS
    ids = torch.tensor([prompt], dtype=torch.int32, device=dev)
    i32 = functools.partial(torch.tensor, dtype=torch.int32, device=dev)
    dec = GPTStaticDecoder(model)
    kv, params = dec.new_kv(2, CFG_13B["max_position_embeddings"]), \
        dec.params()
    with torch.no_grad():
        lfull, kf, vf = prefill_forward(dec.spec, params, ids, i32([n]))
        write_prompt_kv(kv.k, kv.v, kf, vf, [0])
        _, kh, vh = prefill_forward(dec.spec, params, ids[:, :start],
                                    i32([start]))
        write_prompt_kv(kv.k, kv.v, kh, vh, [1])

        def write(li, k, v):
            kv.k[1, li, start:n] = k[0]
            kv.v[1, li, start:n] = v[0]

        ltail, _, _ = tail_forward(
            dec.spec, params, ids[:, start:], i32([n - start]),
            i32([start]), kv.max_seq, write,
            lambda li: (kv.k[1:2, li], kv.v[1:2, li]))
        kv.lengths.fill_(n)
        nxt = lfull.argmax(-1).to(torch.int32)
        step = dec.decode_logits(kv, params, nxt.repeat(2))
    first = float((lfull - ltail).abs().max())
    after = float((step[0] - step[1]).abs().max())
    out = {"logit_diff_first": first, "logit_diff_next_step": after,
           "noise": max(first, after),
           "tokens_equal": bool(torch.equal(lfull.argmax(-1),
                                            ltail.argmax(-1)))}

    def wall(fn, reps=3):
        ts = []
        for _ in range(reps):
            sync(torch, dev)
            t0 = time.perf_counter()
            fn()
            sync(torch, dev)
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    # the slot lane's host copies of a 512-row head: the engine's (pinned
    # memory, a layer a copy) against pageable memory
    rows = 512
    out["export_pinned_ms"] = wall(lambda: kv.host_slot_kv(0, rows))
    out["export_pageable_ms"] = wall(lambda: (
        kv.k[0, :, :rows].cpu().numpy(), kv.v[0, :, :rows].cpu().numpy()))
    kp, vp = kv.host_slot_kv(0, rows)
    ka, va = np.array(kp), np.array(vp)
    out["insert_pinned_ms"] = wall(lambda: insert_prefix_rows(
        kv, kp[:, :start], vp[:, :start], 1))
    out["insert_pageable_ms"] = wall(lambda: insert_prefix_rows(
        kv, ka[:, :start], va[:, :start], 1))
    del kv, kp, vp, ka, va
    samp = pack_sampling([SamplingParams()], dev)
    for layout in ("slot", "paged"):
        d = (GPTStaticDecoder(model) if layout == "slot"
             else GPTPagedDecoder(model, page_size=16, attn_impl="kernel"))
        kv, p = d.new_kv(8, CFG_13B["max_position_embeddings"]), d.params()
        kv.alloc()
        if layout == "paged":
            kv.ensure_pages(0, n)
        fin = torch.zeros(8, dtype=torch.bool, device=dev)
        full = torch.zeros(1, PREFIX_BUCKETS[-1], dtype=torch.int32,
                           device=dev)
        full[0, :n] = ids[0]
        tail = torch.zeros(1, PREFIX_BUCKETS[0], dtype=torch.int32,
                           device=dev)
        tail[0, :n - start] = ids[0, start:]
        a = (i32([n]), i32([0]), fin, samp, None)
        b = (i32([n - start]), i32([start]), i32([0]), fin, samp, None)
        out[f"{layout}_full_prefill_ms"] = time_ms(
            lambda: d.prefill(kv, p, full, *a), iters=10, warmup=2,
            spin=True)
        out[f"{layout}_tail_prefill_ms"] = time_ms(
            lambda: d.tail_prefill(kv, p, tail, *b), iters=10, warmup=2,
            spin=True)
        del kv
        release_memory(torch)
    log(f"phase 17 lanes: first-token logits tail prefill vs full prefill "
        f"max |diff| {first:.3e} (argmax equal {out['tokens_equal']}), the "
        f"next decode step over the two caches {after:.3e}; device ms "
        f"(replayed programs), full prefill [1, {PREFIX_BUCKETS[-1]}] vs "
        f"tail prefill [1, {PREFIX_BUCKETS[0]}] at row {start}: slot "
        f"{out['slot_full_prefill_ms']:.2f} vs "
        f"{out['slot_tail_prefill_ms']:.2f}, paged "
        f"{out['paged_full_prefill_ms']:.2f} vs "
        f"{out['paged_tail_prefill_ms']:.2f}; host copies of a {rows}-row "
        f"head (K and V), wall ms: export {out['export_pinned_ms']:.1f} "
        f"pinned against {out['export_pageable_ms']:.1f} pageable, insert "
        f"of its {start} rows {out['insert_pinned_ms']:.1f} pinned against "
        f"{out['insert_pageable_ms']:.1f} pageable")
    return out


def check_shared_b4(torch, pa_mod, eng, gen):
    """B4 against its plain version on a block table of phase 17's paged
    arena in which pages are shared: four rows on the system prompt's
    cached pages, four on the COW pair's head, at varied positions."""
    kv, store = eng._batcher.kv, eng.prefix_store
    entries = sorted(store._entries.values(), key=lambda e: e.n_tokens)
    sys_e = next(e for e in entries if e.n_tokens >= PREFIX_SYS
                 and e.n_tokens < PREFIX_SYS + 64)
    pair_e = entries[-1]
    bt = torch.full((8, kv.pages_per_seq), kv.trash, dtype=torch.int32,
                    device=kv.device)
    for r, e in enumerate([sys_e] * 4 + [pair_e] * 4):
        bt[r, :len(e.page_ids)] = torch.tensor(e.page_ids, device=kv.device)
    pos = torch.tensor([495, 300, 17, sys_e.n_tokens - 1, 511, 256, 40, 0],
                       dtype=torch.int32, device=kv.device)
    q = torch.randn((8, kv.num_heads, kv.head_dim), generator=gen,
                    device=kv.device)
    li = kv.num_layers // 2
    kb, vb = kv.k[:, li], kv.v[:, li]
    shared = int((bt[:, :, None] == bt.flatten()[None, None, :]).sum(-1)
                 .gt(1).logical_and(bt != kv.trash).sum())
    out = pa_mod.paged_attention(q, kb, vb, bt, pos)
    ref = pa_mod.paged_attention_plain(q, kb, vb, bt, pos)
    err = float((out - ref).abs().max())
    log(f"B4 on phase 17's arena (layer {li}), a block table of {shared} "
        f"shared entries (system prompt {len(sys_e.page_ids)} pages x4, COW "
        f"pair head {len(pair_e.page_ids)} pages x4): max_abs_err vs plain "
        f"{err:.3e} (tol {TOL['fp32']:.0e})")
    if err > TOL["fp32"] or shared < 1:
        raise RuntimeError("the paged attention kernel disagrees with its "
                           "plain version over shared pages")
    return {"shared_table_max_abs_err": err, "shared_entries": shared}


def run_prefix_phase(torch, model, pa_mod, dev, smi, gen, reset_counters,
                     read_counters):
    """Phase 17: the traffic of :func:`prefix_traffic` through the slot
    and the paged engine, reuse on and off (graphed) and reuse on in the
    eager lane, the launch counts read over those runs alone; then, off
    the path, B4 over the paged arena's shared pages, the lanes' logit
    difference and the prefill timings, and the holds. Returns the
    phase's numbers and its launches."""
    prompts = prefix_traffic(CFG_13B["vocab_size"])
    base = dict(num_slots=8, max_seq=CFG_13B["max_position_embeddings"],
                prefill_buckets=PREFIX_BUCKETS, seed=0)
    layouts = {"slot": dict(prefix_capacity_mb=PREFIX_CAPACITY_MB),
               "paged": dict(kv_layout="paged", page_size=16,
                             paged_attn_impl="kernel",
                             num_pages=PREFIX_PAGES)}
    reset_counters()
    runs, b4_steps = {}, 0
    for layout, kw in layouts.items():
        for lane, on, eager in (("on", True, False), ("off", False, False),
                                ("on_eager", True, True)):
            run = _engine_run(torch, model, dict(base, prefix_cache=on, **kw),
                              prompts, PREFIX_NEW, eager=eager)
            st = run["stats"]["stats"]
            if layout == "paged":
                b4_steps += (st.get("serving.llm.decode_ticks", 0)
                             + st.get("serving.llm.warmup_decode_steps", 0))
            if not (layout == "paged" and lane == "on"):
                run["engine"] = None     # the arena of paged-on stays
                release_memory(torch)
            runs[(layout, lane)] = run
    launched = read_counters()
    want = CFG_13B["num_layers"] * b4_steps
    log(f"phase 17 path launches: {launched} (B4 expected {want}: "
        f"{b4_steps} paged decode steps; the prefills and tail prefills "
        f"attend densely, as the JAX package's)")
    if launched["paged_attention"] != want:
        raise RuntimeError(f"phase 17: B4 launched "
                           f"{launched['paged_attention']} times, not {want}")
    out = {"requests": len(prompts), "capacity_mb": PREFIX_CAPACITY_MB,
           "pages": PREFIX_PAGES, "b4_steps": b4_steps}
    out["b4_shared"] = check_shared_b4(torch, pa_mod,
                                       runs[("paged", "on")]["engine"], gen)
    runs[("paged", "on")]["engine"] = None
    release_memory(torch)
    out["noise"] = noise = prefix_noise_and_times(torch, model, dev,
                                                  prompts[0])
    release_memory(torch)
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    ref_dec = GPTStaticDecoder(model)
    ref_params = ref_dec.params()
    pre = "serving.llm.prefix."
    for layout in layouts:
        on, off, eager = (runs[(layout, x)] for x in ("on", "off",
                                                      "on_eager"))
        st, hist = on["stats"]["stats"], on["stats"]["histograms"]
        hits, misses = st.get(pre + "hits", 0), st.get(pre + "misses", 0)
        ps = on["stats"]["prefix_store"]
        parts = near_tie_parts(torch, ref_dec, ref_params, prompts,
                               off["tokens"], on["tokens"], noise["noise"],
                               f"phase 17 {layout} reuse on vs off")
        if on["tokens"] != eager["tokens"]:
            raise RuntimeError(f"phase 17 {layout}: the graphed lane's "
                               f"tokens differ from the eager lane's")
        ttft, ttft_off = (r["stats"]["histograms"]["serving.llm.ttft_ms"]
                          for r in (on, off))
        row = {"hit_rate": hits / max(1, hits + misses), "hits": hits,
               "misses": misses,
               "reused_tokens": st.get(pre + "reused_tokens", 0),
               "ttft_ms_p50": ttft["p50"], "ttft_ms_p95": ttft["p95"],
               "off_ttft_ms_p50": ttft_off["p50"],
               "off_ttft_ms_p95": ttft_off["p95"],
               "tokens_per_s": on["tokens_per_s"],
               "off_tokens_per_s": off["tokens_per_s"],
               "eager_tokens_per_s": eager["tokens_per_s"],
               "tick_ms_p50": hist["serving.llm.decode_tick_ms"]["p50"],
               "warm_s": on["warm_s"], "off_warm_s": off["warm_s"],
               "tokens_equal_off": on["tokens"] == off["tokens"],
               "near_tie_parts": parts, "prefix_store": ps}
        if layout == "slot":
            row["export_ms_mean"] = hist[pre + "export_ms"]["mean"]
            row["insert_ms_mean"] = hist[pre + "insert_ms"]["mean"]
            row["exports"] = hist[pre + "export_ms"]["count"]
        else:
            pages = on["stats"]["pages"]
            row["cow_splits"] = pages["cow_splits"]
            page_nbytes = on["stats"]["kv_bytes"] // (PREFIX_PAGES + 1)
            row["page_nbytes"] = page_nbytes
            # every copied byte is a COW page: the aligned hits copy none
            if ps["bytes_copied"] != pages["cow_splits"] * page_nbytes \
                    or pages["cow_splits"] != 1 or ps["bytes_shared"] < 1:
                raise RuntimeError(
                    f"phase 17 paged: bytes_copied {ps['bytes_copied']} for "
                    f"{pages['cow_splits']} COW splits of {page_nbytes} "
                    f"bytes (one expected), bytes_shared "
                    f"{ps['bytes_shared']}")
        if hits < PREFIX_SHARED or row["reused_tokens"] < \
                (PREFIX_SHARED - 1) * PREFIX_SYS:
            raise RuntimeError(f"phase 17 {layout}: {hits} hits reusing "
                               f"{row['reused_tokens']} tokens")
        log(f"phase 17 {layout} (8 slots, {len(prompts)} requests x "
            f"{PREFIX_NEW} new; {smi}): hit rate {row['hit_rate']:.3f} "
            f"({hits} hits, {misses} misses), reused tokens "
            f"{row['reused_tokens']}; TTFT p50/p95 reuse on "
            f"{row['ttft_ms_p50']:.1f}/{row['ttft_ms_p95']:.1f} ms, off "
            f"{row['off_ttft_ms_p50']:.1f}/{row['off_ttft_ms_p95']:.1f} ms; "
            f"tokens/s on {row['tokens_per_s']:.1f}, off "
            f"{row['off_tokens_per_s']:.1f}, eager lane "
            f"{row['eager_tokens_per_s']:.1f}; tick p50 "
            f"{row['tick_ms_p50']:.2f} ms; "
            + (f"export {row['export_ms_mean']:.1f} ms a miss "
               f"({row['exports']}), insert {row['insert_ms_mean']:.1f} ms "
               f"a hit; " if layout == "slot" else
               f"COW splits {row['cow_splits']}; ")
            + f"store {ps}; reuse on vs off tokens equal "
            f"{row['tokens_equal_off']}, parts at (request, step, top-2 "
            f"gap) {parts}; graphed equals eager")
        out[layout] = row
    return out, launched


def spec_noise(torch, model, dev, prompts, layout):
    """Phase 18, off the path: the lanes' measured logit difference on
    one state of the 8 prompts: the plain decode step chained over
    SPEC_K + 1 greedy tokens against the verify step's logits over the
    same tokens (both write the same rows)."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder
    from paddle_tpu_torch.serving.llm.paged.spec import paged_verify_logits
    from paddle_tpu_torch.serving.llm.spec import static_verify_logits
    paged = layout == "paged"
    dec = (GPTPagedDecoder(model, page_size=16, attn_impl="kernel") if paged
           else GPTStaticDecoder(model))
    kv, params = dec.new_kv(8, CFG_13B["max_position_embeddings"]), \
        dec.params()
    last = _prefill_slots(torch, dec, kv, params, prompts, extra=SPEC_K + 2)
    u, plain = [last], []
    with torch.no_grad():
        for _ in range(SPEC_K + 1):
            lg = dec.decode_logits(kv, params, u[-1])
            plain.append(lg)
            u.append(lg.argmax(-1).to(torch.int32))
            kv.lengths += 1
        kv.lengths -= SPEC_K + 1
        uu = torch.stack(u[:-1], dim=1)
        ver = (paged_verify_logits if paged else static_verify_logits)(
            dec.spec, params, kv, uu)
    diff = float((torch.stack(plain, dim=1) - ver).abs().max())
    del kv
    release_memory(torch)
    return diff


def spec_times(torch, model, draft, dev, prompts, layout):
    """Phase 18, off the path: device ms of the plain decode step, the
    draft's SPEC_K + 1 micro-steps, the verify, and the whole spec step,
    each replayed from its own captured program on one state of the 8
    prompts (the lengths put back before each call)."""
    import functools as ft
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving.llm import GPTSpecDecoder, GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    from paddle_tpu_torch.serving.llm.paged import (GPTPagedDecoder,
                                                    GPTPagedSpecDecoder)
    from paddle_tpu_torch.serving.llm.paged.spec import paged_verify_logits
    from paddle_tpu_torch.serving.llm.spec import (draft_propose,
                                                   static_verify_logits)
    paged = layout == "paged"
    dec = (GPTPagedDecoder(model, page_size=16, attn_impl="kernel") if paged
           else GPTStaticDecoder(model))
    spec = (GPTPagedSpecDecoder if paged else GPTSpecDecoder)(
        dec, draft, k=SPEC_K)
    kv, params = dec.new_kv(8, CFG_13B["max_position_embeddings"]), \
        dec.params()
    kvd = spec.new_draft_kv(8, kv.max_seq, lengths=kv.lengths)
    pd = spec.draft_params()
    last = _prefill_slots(torch, dec, kv, params, prompts, extra=SPEC_K + 2)
    _prefill_slots(torch, GPTStaticDecoder(draft), kvd, pd, prompts)
    saved = kv.lengths.clone()
    fin = torch.zeros(8, dtype=torch.bool, device=dev)
    samp = pack_sampling([SamplingParams()] * 8, dev)
    gen = torch.Generator(device=dev)
    u = torch.cat([last[:, None], last[:, None].repeat(1, SPEC_K)], dim=1)
    verify = paged_verify_logits if paged else static_verify_logits
    progs = {
        "plain_step": (graphs.Program(lambda p, s, t: dec.decode_logits(
            s, p, t)), params, kv, (last,)),
        "draft": (graphs.Program(lambda p, s, t: draft_propose(
            spec.dspec, p, s, s.lengths, t, SPEC_K)), pd, kvd, (last,)),
        "verify": (graphs.Program(ft.partial(verify, dec.spec)), params, kv,
                   (u,)),
    }
    out = {}
    with torch.no_grad():
        for name, (prog, p, state, args) in progs.items():
            if paged:
                kv.refresh_block_tables()
            out[f"{name}_ms"] = time_ms(lambda: prog(p, state, *args),
                                        iters=10, warmup=2, spin=True)

        def step():
            kv.lengths.copy_(saved)
            spec.step(kv, kvd, params, pd, fin, last, samp, gen)

        out["spec_step_ms"] = time_ms(step, iters=10, warmup=2, spin=True)
    del kv, kvd
    release_memory(torch)
    return out


def run_spec_phase(torch, model, dev, smi, prompts, plain, reset_counters,
                   read_counters):
    """Phase 18: phase 4's 8 requests through the slot and the paged spec
    engines with SPEC_K: graphed for the drafted config (random, seed 1)
    and for the target as its own draft, and in the eager lane for the
    drafted config; the launch counts read over those runs alone; then,
    off the path, the lanes' logit difference, the device ms of the
    step's parts, and the holds. ``plain``: {layout: (tokens, tokens/s)}
    of phases 4 and 6a. Returns the phase's numbers and its launches."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    dcfg = GPTConfig(**CFG_13B).draft()
    small = GPTForCausalLM(dcfg, device=dev, seed=1).eval()
    log(f"draft: GPTConfig.draft() of the 1.3B config, hidden "
        f"{dcfg.hidden_size}, {dcfg.num_layers} layers, {dcfg.num_heads} "
        f"heads, {sum(p.numel() for p in small.parameters())} parameters, "
        f"random (seed 1)")
    base = dict(num_slots=8, max_seq=CFG_13B["max_position_embeddings"],
                seed=0, spec_k=SPEC_K)
    layouts = {"slot": dict(kv_layout="slot"),
               "paged": dict(kv_layout="paged", page_size=16,
                             paged_attn_impl="kernel")}
    drafts = {"draft": small, "self": model}
    reset_counters()
    runs, b4_steps = {}, 0
    for layout, kw in layouts.items():
        for name, lane in (("draft", "graphed"), ("draft", "eager"),
                           ("self", "graphed")):
            run = _engine_run(torch, model, dict(base, **kw), prompts, 32,
                              eager=lane == "eager", draft=drafts[name])
            st = run["stats"]["stats"]
            if layout == "paged":
                b4_steps += (st.get("serving.llm.decode_ticks", 0)
                             + st.get("serving.llm.warmup_decode_steps", 0))
            run["engine"] = None
            release_memory(torch)
            runs[(layout, name, lane)] = run
    launched = read_counters()
    want = CFG_13B["num_layers"] * b4_steps
    log(f"phase 18 path launches: {launched} (B4 expected {want}: "
        f"{b4_steps} plain paged decode steps, warm-ups and fallback "
        f"ticks; the verify attends densely, as the JAX package's)")
    if launched["paged_attention"] != want:
        raise RuntimeError(f"phase 18: B4 launched "
                           f"{launched['paged_attention']} times, not {want}")
    ref_dec = GPTStaticDecoder(model)
    ref_params = ref_dec.params()
    out = {"k": SPEC_K, "b4_steps": b4_steps}
    for layout in layouts:
        noise = spec_noise(torch, model, dev, prompts, layout)
        out[f"{layout}_noise"] = noise
        for name in drafts:
            g = runs[(layout, name, "graphed")]
            st, hist = g["stats"]["stats"], g["stats"]["histograms"]
            eager = runs.get((layout, name, "eager"))
            if eager is not None and g["tokens"] != eager["tokens"]:
                raise RuntimeError(f"phase 18 {layout} {name}: the graphed "
                                   f"lane's tokens differ from the eager "
                                   f"lane's")
            parts = near_tie_parts(torch, ref_dec, ref_params, prompts,
                                   plain[layout][0], g["tokens"], noise,
                                   f"phase 18 {layout} {name}")
            rate = st.get("serving.llm.spec.acceptance_rate", 0.0)
            ticks = st.get("serving.llm.spec.ticks", 0)
            slot_ticks = st.get("serving.llm.spec.proposed", 0) / SPEC_K
            row = {"acceptance_rate": rate, "spec_ticks": ticks,
                   "fallback_ticks": st.get("serving.llm.spec.fallback_ticks",
                                            0),
                   "tokens_per_slot_tick": 1 + st.get(
                       "serving.llm.spec.accepted", 0) / max(1, slot_ticks),
                   "tick_ms_mean": hist["serving.llm.decode_tick_ms"]["mean"],
                   "tick_ms_p50": hist["serving.llm.decode_tick_ms"]["p50"],
                   "tokens_per_s": g["tokens_per_s"],
                   "eager_tokens_per_s": (eager["tokens_per_s"]
                                          if eager else None),
                   "plain_tokens_per_s": plain[layout][1],
                   "tokens_equal_plain": g["tokens"] == plain[layout][0],
                   "warm_s": g["warm_s"], "near_tie_parts": parts}
            row.update(spec_times(torch, model, drafts[name], dev, prompts,
                                  layout))
            log(f"phase 18 {layout}, {name} draft (k={SPEC_K}; {smi}): "
                f"acceptance {rate:.3f}, {row['tokens_per_slot_tick']:.2f} "
                f"tokens a slot a tick, {ticks} spec ticks, "
                f"{row['fallback_ticks']} fallback ticks; tick mean "
                f"{row['tick_ms_mean']:.2f} ms p50 {row['tick_ms_p50']:.2f} "
                f"ms; device ms: spec step {row['spec_step_ms']:.2f} (draft "
                f"{row['draft_ms']:.2f} + verify {row['verify_ms']:.2f}), "
                f"plain step {row['plain_step_ms']:.2f}; tokens/s "
                f"{row['tokens_per_s']:.1f} (eager lane "
                f"{row['eager_tokens_per_s']}) against the plain engine's "
                f"{plain[layout][1]:.1f}; the lanes' logit difference "
                f"{noise:.3e}; tokens equal plain "
                f"{row['tokens_equal_plain']}, parts (request, step, top-2 "
                f"gap) {parts}" + ("; graphed equals eager" if eager
                                   else ""))
            if name == "self" and rate < 0.9:
                raise RuntimeError(f"phase 18 {layout}: the target as its "
                                   f"own draft accepted {rate:.3f} < 0.9")
            out[f"{layout}_{name}"] = row
    del small
    release_memory(torch)
    return out, launched


# -- phase 19: int8 serving (GPT-3 1.3B) -------------------------------------

#: (name, weight_dtype, kv_dtype) of phase 19's engines
INT8_COMBOS = (("w8", "int8", "float32"), ("kv8", "float32", "int8"),
               ("w8kv8", "int8", "int8"))
#: phase 17's chat traffic, cut to its first requests, for prefix reuse
#: over int8 weights
INT8_PREFIX_REQUESTS = 12
#: Int8Linear's int8 x int8 lane at BERT-base's FFN (M = 256 x 128
#: tokens) and at an odd shape that needs padding
INT8_LINEAR_SHAPES = {"bert_ffn": (256 * 128, 768, 3072),
                      "odd": (37, 100, 130)}


def _int8_layout(layout):
    return (dict(kv_layout="paged", page_size=16) if layout == "paged"
            else dict(kv_layout="slot"))


def _int8_decoder(model, layout, w, kvd):
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder
    if layout == "paged":
        return GPTPagedDecoder(model, page_size=16, weight_dtype=w,
                               kv_dtype=kvd)
    return GPTStaticDecoder(model, weight_dtype=w, kv_dtype=kvd)


def _tree_nbytes(params):
    from paddle_tpu_torch.core.graphs import _leaves
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def replayed_ms(torch, fn, dev):
    """Device ms of ``fn()`` captured once as a CUDA graph and replayed
    (for work of many small launches, which the host would not queue
    behind a spin one by one)."""
    from paddle_tpu_torch.core import graphs
    prog = graphs.Program(lambda params, state: fn())
    state = _GraphState(graphs, dev)
    with torch.no_grad():
        return time_ms(lambda: prog(None, state), iters=10, warmup=2,
                       spin=True)


def int8_step_times(torch, model, dev, prompts, cfg, layout, w, kvd):
    """Phase 19, off the path: on the 8 prompts prefilled into a fresh
    cache, the decode step's device ms replayed from its program; for
    int8 KV on the slot layout also the device ms of dequantizing every
    layer's K and V view (the step's own dequant, replayed alone from a
    graph) and its share of the step."""
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    from paddle_tpu_torch.serving.llm.kvcache import (dequantize_kv,
                                                      kv_layer_view)
    dec = _int8_decoder(model, layout, w, kvd)
    kv, params = dec.new_kv(8, cfg["max_position_embeddings"]), dec.params()
    last = _prefill_slots(torch, dec, kv, params, prompts, extra=24)
    fin = torch.zeros(8, dtype=torch.bool, device=dev)
    samp = pack_sampling([SamplingParams()] * 8, dev)
    out = {"step_ms": time_ms(lambda: dec.decode_step(
        kv, params, fin, last, samp, None), iters=10, warmup=2, spin=True)}
    if kvd == "int8" and layout == "slot":
        def dequant():
            return [dequantize_kv(kv_layer_view(buf, li), torch.float32)
                    for li in range(cfg["num_layers"])
                    for buf in (kv.k, kv.v)][-1]
        out["dequant_ms"] = replayed_ms(torch, dequant, dev)
        out["dequant_share"] = out["dequant_ms"] / out["step_ms"]
    del kv
    release_memory(torch)
    return out


def int8_gemm_times(torch, model, dev):
    """Phase 19, off the path: the decode step's six projection GEMMs of
    every layer at M = 8 (one token a slot), int8 codes through ``_mm``
    (the codes cast to fp32, the product scaled) against the fp32
    weights, device ms of each set replayed from a CUDA graph; and the
    parameter dicts' bytes."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.decode import _QUANT_WEIGHT_KEYS, _mm
    p8 = GPTStaticDecoder(model, weight_dtype="int8").params()
    p32 = GPTStaticDecoder(model).params()
    xs = {k: torch.randn(8, p32["layers"][0][k].shape[0], device=dev)
          for k in _QUANT_WEIGHT_KEYS}

    def gemms(p):
        return [_mm(xs[k], lp[k]) for lp in p["layers"]
                for k in _QUANT_WEIGHT_KEYS][-1]

    out = {"gemm_int8_ms": replayed_ms(torch, lambda: gemms(p8), dev),
           "gemm_fp32_ms": replayed_ms(torch, lambda: gemms(p32), dev)}
    out["params_bytes_int8"] = _tree_nbytes(p8)
    out["params_bytes_fp32"] = _tree_nbytes(p32)
    out["params_ratio"] = out["params_bytes_fp32"] / out["params_bytes_int8"]
    del p8
    release_memory(torch)
    return out


def int8_kv_error(torch, model, dev, prompts, cfg):
    """Phase 19, off the path: one decode step from the same state with
    fp32 KV and with int8 KV (the fp32 cache after the 8 prefills,
    quantized row by row into the int8 cache): the largest difference of
    the dequantized int8 rows from the fp32 rows over every valid row of
    every layer (the new row included), as a share of the fp32 rows'
    range (the JAX package's bar is 2%)."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.kvcache import (dequantize_kv,
                                                      kv_layer_view,
                                                      quantize_kv_rows)
    d32 = GPTStaticDecoder(model)
    d8 = GPTStaticDecoder(model, kv_dtype="int8")
    max_seq = cfg["max_position_embeddings"]
    k32, k8 = d32.new_kv(8, max_seq), d8.new_kv(8, max_seq)
    params = d32.params()
    last = _prefill_slots(torch, d32, k32, params, prompts)
    with torch.no_grad():
        for b32, b8 in ((k32.k, k8.k), (k32.v, k8.v)):
            for li in range(cfg["num_layers"]):
                q = quantize_kv_rows(b32[:, li])
                b8["q"][:, li].copy_(q["q"])
                b8["s"][:, li].copy_(q["s"])
        k8.lengths.copy_(k32.lengths)
        d32.decode_logits(k32, params, last)
        d8.decode_logits(k8, params, last)
        rows = torch.arange(max_seq, device=dev)[None, :, None, None]
        valid = rows <= k32.lengths.long()[:, None, None, None]
        err = rng = 0.0
        for b32, b8 in ((k32.k, k8.k), (k32.v, k8.v)):
            for li in range(cfg["num_layers"]):
                ref = kv_layer_view(b32, li)
                got = dequantize_kv(kv_layer_view(b8, li))
                err = max(err, float(((got - ref).abs() * valid).max()))
                rng = max(rng, float((ref.abs() * valid).max()))
    del k32, k8
    release_memory(torch)
    return {"kv_row_err": err / rng, "kv_row_err_abs": err,
            "kv_fp32_range": rng}


def _dequantized_twin(torch, cfg, dev):
    """GPT-3 1.3B with the phase's weights (seed 0) whose six projection
    weights of every layer are the int8 lane's dequantized ``q * s``."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.quantization import quantize_weight_int8
    twin = GPTForCausalLM(GPTConfig(**cfg, attn_impl="flash"), device=dev,
                          seed=0).eval()
    with torch.no_grad():
        for lyr in twin.gpt.decoder.layers:
            a = lyr.self_attn
            for lin in (a.q_proj, a.k_proj, a.v_proj, a.out_proj,
                        lyr.linear1, lyr.linear2):
                q, s = quantize_weight_int8(lin.weight, quant_axis=1)
                lin.weight.copy_(q.float() * s)
    return twin


def int8_weight_noise(torch, model, twin, dev, prompts, cfg):
    """Phase 19, off the path: the lanes' measured logit difference, int8
    weights against the dequantized fp32 twin, on the 8 prompts: the
    larger of the first tokens' logits (each prefill) and of the next
    decode step's (each lane over its own cache, the same last tokens)."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.decode import prefill_forward
    d8 = GPTStaticDecoder(model, weight_dtype="int8")
    dd = GPTStaticDecoder(twin)
    max_seq = cfg["max_position_embeddings"]
    k8, kd = d8.new_kv(8, max_seq), dd.new_kv(8, max_seq)
    p8, pd = d8.params(), dd.params()
    first = 0.0
    with torch.no_grad():
        for p in prompts:
            ids = torch.tensor([p], dtype=torch.int32, device=dev)
            n = torch.tensor([len(p)], dtype=torch.int32, device=dev)
            a = prefill_forward(d8.spec, p8, ids, n)[0]
            b = prefill_forward(dd.spec, pd, ids, n)[0]
            first = max(first, float((a - b).abs().max()))
        _prefill_slots(torch, d8, k8, p8, prompts)
        last = _prefill_slots(torch, dd, kd, pd, prompts)
        step = float((d8.decode_logits(k8, p8, last)
                      - dd.decode_logits(kd, pd, last)).abs().max())
    del k8, kd
    release_memory(torch)
    return {"logit_diff_first": first, "logit_diff_next_step": step,
            "noise": max(first, step)}


def int8_linear_checks(torch, dev):
    """Phase 19, off the path: ``Int8Linear`` with a calibrated
    activation scale at BERT-base's FFN shape and at an odd shape: its
    int32 product (``torch._int_mm``, padded where the shape needs it)
    against the exact product (float64 on the card), and its output
    against the same rescale of that exact product, both bitwise; device
    ms of the int8 x int8 lane, the weight-only lane and an fp32
    ``x @ W``."""
    from paddle_tpu_torch.quantization import (Int8Linear, int8_matmul,
                                               int8_matmul_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    out = {}
    for name, (m, k, n) in INT8_LINEAR_SHAPES.items():
        w = torch.randn(k, n, generator=gen, device=dev) * 0.05
        x = torch.randn(m, k, generator=gen, device=dev)
        lin = Int8Linear.from_float(w, act_scale=float(x.abs().max()))
        wonly = Int8Linear.from_float(w)
        sa = max(lin._act_scale, 1e-8) / 127.0
        with torch.no_grad():
            aq = torch.clamp(torch.round(x / sa), -127.0, 127.0).to(
                torch.int8)
            acc = int8_matmul(aq, lin.weight_q)
            exact = int8_matmul_plain(aq, lin.weight_q)
            y = lin(x)
            row = {"product_equal": bool(torch.equal(acc, exact)),
                   "output_equal": bool(torch.equal(
                       y, exact.float() * (sa * lin.w_scale))),
                   "int8_ms": time_ms(lambda: lin(x), iters=10, warmup=2,
                                      spin=True),
                   "weight_only_ms": time_ms(lambda: wonly(x), iters=10,
                                             warmup=2, spin=True),
                   "fp32_ms": time_ms(lambda: x @ w, iters=10, warmup=2,
                                      spin=True),
                   "max_abs_err_vs_fp32": float((y - x @ w).abs().max())}
        log(f"Int8Linear {name} [{m}, {k}] x [{k}, {n}]: int32 product "
            f"equal to the exact one {row['product_equal']}, output equal "
            f"to its plain rescale {row['output_equal']}; device ms int8 x "
            f"int8 {row['int8_ms']:.4f}, weight-only "
            f"{row['weight_only_ms']:.4f}, fp32 x @ W {row['fp32_ms']:.4f}; max |int8 - fp32| "
            f"{row['max_abs_err_vs_fp32']:.3e}")
        if not (row["product_equal"] and row["output_equal"]):
            raise RuntimeError(f"Int8Linear {name}: the int8 x int8 lane "
                               f"differs from its int32 plain version")
        out[name] = row
    return out


def run_int8_phase(torch, model, pa_mod, dev, smi, prompts, cfg,
                   reset_counters, read_counters):
    """Phase 19: phase 4's 8 requests through the slot and the paged
    engine with int8 weights, int8 KV and both (graphed), both int8 on
    the eager lane, and int8 weights with prefix reuse on the first
    requests of phase 17's chat traffic (paged), the launch counts read
    over those runs alone; then, off the path, the step and GEMM device
    times, the dequant's share, the KV-row error, the dequantized-fp32
    twin's tokens and the holds. Returns the phase's numbers and its
    launches."""
    n_layers = cfg["num_layers"]
    base = dict(num_slots=8, max_seq=cfg["max_position_embeddings"],
                seed=0)
    runs = {}
    reset_counters()
    b4_want = 0
    for layout in ("slot", "paged"):
        for name, w, kvd in INT8_COMBOS:
            lanes = ("graphed", "eager") if name == "w8kv8" else ("graphed",)
            for lane in lanes:
                before = pa_mod.paged_attention.launches
                run = _engine_run(torch, model, dict(
                    base, weight_dtype=w, kv_dtype=kvd,
                    **_int8_layout(layout)), prompts, 32,
                    eager=lane == "eager")
                st = run["stats"]["stats"]
                steps = (st.get("serving.llm.decode_ticks", 0)
                         + st.get("serving.llm.warmup_decode_steps", 0))
                run["b4"] = pa_mod.paged_attention.launches - before
                run["steps"] = steps
                want = n_layers * steps if (layout == "paged"
                                            and kvd == "float32") else 0
                if run["b4"] != want:
                    raise RuntimeError(
                        f"phase 19 {layout} {name} {lane}: B4 launched "
                        f"{run['b4']} times over {steps} steps, not {want}")
                b4_want += want
                run["attn_impl"] = getattr(run["engine"].decoder, "attn_impl",
                                           "slot")
                run["engine"] = None
                release_memory(torch)
                runs[(layout, name, lane)] = run
    traffic = prefix_traffic(cfg["vocab_size"])[:INT8_PREFIX_REQUESTS]
    before = pa_mod.paged_attention.launches
    pre = _engine_run(torch, model, dict(
        base, weight_dtype="int8", prefix_cache=True,
        prefill_buckets=PREFIX_BUCKETS, num_pages=PREFIX_PAGES,
        **_int8_layout("paged")), traffic, PREFIX_NEW)
    pst = pre["stats"]["stats"]
    pre_steps = (pst.get("serving.llm.decode_ticks", 0)
                 + pst.get("serving.llm.warmup_decode_steps", 0))
    pre["b4"] = pa_mod.paged_attention.launches - before
    if pre["b4"] != n_layers * pre_steps:
        raise RuntimeError(f"phase 19 prefix: B4 launched {pre['b4']} "
                           f"times over {pre_steps} steps")
    b4_want += n_layers * pre_steps
    pre["engine"] = None
    release_memory(torch)
    launched = read_counters()
    log(f"phase 19 path launches: {launched} (B4 expected {b4_want}: 24 a "
        f"step in the paged runs over dense pages, 0 over int8 pages, "
        f"which take the gather lane)")
    if launched["paged_attention"] != b4_want:
        raise RuntimeError(f"phase 19: B4 launched "
                           f"{launched['paged_attention']} times, not "
                           f"{b4_want}")
    out = {"b4_steps": b4_want // n_layers}
    hits = pst.get("serving.llm.prefix.hits", 0)
    misses = pst.get("serving.llm.prefix.misses", 0)
    ttft = pre["stats"]["histograms"]["serving.llm.ttft_ms"]
    out["paged_w8_prefix"] = {
        "requests": len(traffic), "hits": hits, "misses": misses,
        "reused_tokens": pst.get("serving.llm.prefix.reused_tokens", 0),
        "ttft_ms_p50": ttft["p50"], "ttft_ms_p95": ttft["p95"],
        "tokens_per_s": pre["tokens_per_s"], "b4": pre["b4"]}
    log(f"phase 19 paged int8 weights, prefix reuse ({len(traffic)} chat "
        f"requests; {smi}): {hits} hits, {misses} misses, reused "
        f"{out['paged_w8_prefix']['reused_tokens']} tokens; TTFT p50/p95 "
        f"{ttft['p50']:.1f}/{ttft['p95']:.1f} ms; "
        f"{pre['tokens_per_s']:.1f} tokens/s; B4 {pre['b4']}")
    if hits < 1:
        raise RuntimeError("phase 19 prefix: no request reused a prefix")
    for layout in ("slot", "paged"):
        g, e = (runs[(layout, "w8kv8", x)] for x in ("graphed", "eager"))
        if g["tokens"] != e["tokens"]:
            raise RuntimeError(f"phase 19 {layout} int8/int8: the graphed "
                               f"lane's tokens differ from the eager "
                               f"lane's")
    gemm = int8_gemm_times(torch, model, dev)
    out["gemm"] = gemm
    kverr = int8_kv_error(torch, model, dev, prompts, cfg)
    out["kv_row_error"] = kverr
    twin = _dequantized_twin(torch, cfg, dev)
    noise = int8_weight_noise(torch, model, twin, dev, prompts, cfg)
    out["noise"] = noise
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    ref_dec = GPTStaticDecoder(twin)
    ref_params = ref_dec.params()
    fp32_kv_bytes = {}
    for layout in ("slot", "paged"):
        deq = _engine_run(torch, twin, dict(base, **_int8_layout(layout)),
                          prompts, 32)
        fp32_kv_bytes[layout] = deq["stats"]["kv_bytes"]
        deq["engine"] = None
        release_memory(torch)
        for name, w, kvd in INT8_COMBOS:
            run = runs[(layout, name, "graphed")]
            hist, st = run["stats"]["histograms"], run["stats"]["stats"]
            kvb = run["stats"]["kv_bytes"]
            row = {"tokens_per_s": run["tokens_per_s"],
                   "tick_ms_mean": hist["serving.llm.decode_tick_ms"]["mean"],
                   "tick_ms_p50": hist["serving.llm.decode_tick_ms"]["p50"],
                   "ttft_ms_p50": hist["serving.llm.ttft_ms"]["p50"],
                   "warm_s": run["warm_s"], "kv_bytes": kvb,
                   "kv_ratio": fp32_kv_bytes[layout] / kvb,
                   "kv_bytes_a_token": kvb / (
                       8 * base["max_seq"] if layout == "slot" else
                       (run["stats"]["pages"]["total"] + 1) * 16),
                   "attn_impl": run["attn_impl"], "b4": run["b4"],
                   "steps": run["steps"],
                   "params_ratio": (gemm["params_ratio"] if w == "int8"
                                    else 1.0)}
            if name == "w8kv8":
                eager = runs[(layout, name, "eager")]
                row["eager_tokens_per_s"] = eager["tokens_per_s"]
                row["eager_tick_ms_p50"] = eager["stats"]["histograms"][
                    "serving.llm.decode_tick_ms"]["p50"]
            if w == "int8" and kvd == "float32":
                row["near_tie_parts"] = near_tie_parts(
                    torch, ref_dec, ref_params, prompts, deq["tokens"],
                    run["tokens"], noise["noise"],
                    f"phase 19 {layout} int8 weights vs dequantized fp32")
                row["tokens_equal_dequantized"] = (run["tokens"]
                                                   == deq["tokens"])
            row.update(int8_step_times(torch, model, dev, prompts, cfg,
                                       layout, w, kvd))
            if kvd == "int8" and row["kv_ratio"] < 1.8:
                raise RuntimeError(f"phase 19 {layout} {name}: kv_bytes "
                                   f"ratio {row['kv_ratio']:.3f} < 1.8")
            log(f"phase 19 {layout} {name} (weights {w}, KV {kvd}; 8 "
                f"requests x 32 new; {smi}): {row['tokens_per_s']:.1f} "
                f"tokens/s, tick p50 {row['tick_ms_p50']:.2f} ms (mean "
                f"{row['tick_ms_mean']:.2f}), TTFT p50 "
                f"{row['ttft_ms_p50']:.1f} ms, decode step device "
                f"{row['step_ms']:.3f} ms (replayed); lane "
                f"{row['attn_impl']}, B4 {row['b4']} over {row['steps']} "
                f"steps; kv_bytes {kvb} ({row['kv_ratio']:.3f}x fewer than "
                f"fp32's {fp32_kv_bytes[layout]})"
                + f", {row['kv_bytes_a_token']:.0f} B a token"
                + (f"; dequant {row['dequant_ms']:.3f} ms, "
                   f"{100 * row['dequant_share']:.1f}% of the step"
                   if "dequant_ms" in row else "")
                + (f"; eager lane {row['eager_tokens_per_s']:.1f} tokens/s,"
                   f" tick p50 {row['eager_tick_ms_p50']:.2f} ms, tokens "
                   f"equal graphed" if "eager_tokens_per_s" in row else "")
                + (f"; tokens equal the dequantized fp32 engine's "
                   f"{row['tokens_equal_dequantized']}, parts (request, "
                   f"step, top-2 gap) {row['near_tie_parts']}"
                   if "near_tie_parts" in row else ""))
            out[f"{layout}_{name}"] = row
    del twin
    release_memory(torch)
    log(f"phase 19 ({smi}): parameter dict {gemm['params_bytes_int8']} B "
        f"with int8 weights against {gemm['params_bytes_fp32']} B fp32 "
        f"({gemm['params_ratio']:.3f}x; the model's fp32 weights stay "
        f"resident beside the codes); the decode step's projection GEMMs "
        f"at M = 8, {n_layers} layers: int8 {gemm['gemm_int8_ms']:.3f} ms "
        f"against fp32 {gemm['gemm_fp32_ms']:.3f} ms device; KV-row error of one "
        f"int8 step {100 * kverr['kv_row_err']:.3f}% of the fp32 range "
        f"(bar 2%); the lanes' logit difference {noise['noise']:.3e}")
    if kverr["kv_row_err"] > 0.02:
        raise RuntimeError(f"phase 19: the int8 KV rows part from fp32 by "
                           f"{100 * kverr['kv_row_err']:.3f}% of the range")
    out["int8_linear"] = int8_linear_checks(torch, dev)
    return out, launched


# -- phase 20: the hapi loop as users write it ------------------------------

HAPI_IMAGES = 2048          # ResNet-50 fit: 8 batches of RESNET_BATCH
HAPI_WORKERS = 4
HAPI_EVAL_BATCHES = 2
HAPI_BERT_STEPS = 6
HAPI_EMA_DECAY = 0.999
HAPI_DET_BATCHES, HAPI_DET_BATCH = 2, 8
HAPI_LENET_BATCH, HAPI_LENET_STEPS = 64, 5
#: phase 12's graphed train_batch on a resident batch and phase 13's O1
#: AdamW, and their updates alone, as an earlier run of this script
#: measured them on an H100 80GB HBM3 at 700 W; printed beside
RESNET_RESIDENT_IMGS_S = {"fp32": 570.1, "o1": 914.7}
BERT_O1_ADAMW_TOKENS_S = 143_548
MOMENTUM_UPDATE_MS, ADAMW_UPDATE_MS, ADAMW_BOUND_MS = 1.58, 9.01, 1.111


def _step_timer(torch):
    """A callback recording each train batch's wall (begin to end, the
    end after ``float(loss)`` synchronized) and the host's wait between
    batches (the previous end to this begin: the loader's next batch)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepTimer(Callback):
        def __init__(self):
            super().__init__()
            self.walls, self.waits, self.logs = [], [], []
            self._end = None

        def on_train_batch_begin(self, step, logs=None):
            self._begin = time.perf_counter()
            if self._end is not None:
                self.waits.append((self._begin - self._end) * 1e3)

        def on_train_batch_end(self, step, logs=None):
            self._end = time.perf_counter()
            self.walls.append((self._end - self._begin) * 1e3)
            self.logs.append(dict(logs or {}))

    return StepTimer()


def _ema_callback(torch, ema):
    from paddle_tpu_torch.hapi.callbacks import Callback

    class EMAUpdate(Callback):
        def __init__(self):
            super().__init__()
            self.ms = []

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ema.update()
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)

    return EMAUpdate()


def _steady(timer):
    """Medians over the steps after the first (which captures): the
    step's wall, and the batch's interval (the host's wait on the loader
    before the step, and the step)."""
    return (float(np.median(timer.walls[1:])),
            float(np.median([w + s for w, s in zip(timer.waits,
                                                   timer.walls[1:])])))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _resident(loader, n):
    """The first ``n`` batches of a loader, kept on the device."""
    out = []
    for batch in loader:
        out.append(batch)
        if len(out) == n:
            break
    return out


def hapi_resnet(torch, dev, smi, reset_counters, read_counters):
    """Phase 20's ResNet-50: ``fit`` with LARS and ``Accuracy(topk=(1,
    5))`` over a ``DataLoader`` of HAPI_WORKERS worker processes whose
    rings hold a batch, fp32 then O1 bf16 (graphed), the EMA updated by a
    callback after each step; ``evaluate`` under ``ema.apply()`` graphed
    and eager; ``predict``; the LARS update timed alone."""
    from paddle_tpu_torch import Model, amp, io, metric, nn
    from paddle_tpu_torch.core import graphs, shm_ring
    from paddle_tpu_torch.optimizer import (ExponentialMovingAverage,
                                            LarsMomentum)
    from paddle_tpu_torch.vision.models import resnet50

    class Images(io.Dataset):
        def __init__(self, x, y):
            self.x, self.y = x, y

        def __getitem__(self, i):
            return self.x[i], self.y[i]

        def __len__(self):
            return len(self.x)

    if not shm_ring.available():
        raise RuntimeError("phase 20: the shared-memory ring did not build")
    rng = np.random.default_rng(20)
    x = rng.random((HAPI_IMAGES, 3, RESNET_SIZE, RESNET_SIZE),
                   dtype=np.float32)
    y = rng.integers(0, RESNET_CLASSES, HAPI_IMAGES).astype(np.int64)
    ds = Images(x, y)
    batch_bytes = RESNET_BATCH * x[0].nbytes + RESNET_BATCH * 8
    capacity = batch_bytes + (1 << 20)
    torch.manual_seed(0)
    net = resnet50(num_classes=RESNET_CLASSES, device=dev, seed=0)
    model = Model(net, device=dev)
    model.prepare(LarsMomentum(0.1, momentum=0.9, lars_coeff=0.001,
                               lars_weight_decay=5e-4,
                               parameters=net.parameters(), device=dev),
                  nn.CrossEntropyLoss(),
                  metrics=metric.Accuracy(topk=(1, 5)))
    ema = ExponentialMovingAverage(HAPI_EMA_DECAY,
                                   parameters=net.parameters())
    ptrs = [p.data_ptr() for p in net.parameters()]
    log(f"ResNet-50 fit: LarsMomentum(0.1, 0.9, lars_coeff 0.001, "
        f"lars_weight_decay 5e-4), Accuracy(topk=(1, 5)), {HAPI_IMAGES} "
        f"seeded images in a Dataset, batch {RESNET_BATCH}, "
        f"{HAPI_WORKERS} workers, rings of {capacity} B (a batch is "
        f"{batch_bytes} B); {smi}")
    res, launches = {}, {}
    for prec in ("fp32", "o1"):
        cast = amp.auto_cast if prec == "o1" else contextlib.nullcontext
        if prec == "o1":
            # the fp32 programs are not run again: free their graphs'
            # pool before O1 captures its own
            model._invalidate_compiled()
        loader = io.DataLoader(ds, batch_size=RESNET_BATCH, shuffle=True,
                               num_workers=HAPI_WORKERS, timeout=120,
                               shm_capacity=capacity, device=dev)
        timer, ema_cb = _step_timer(torch), _ema_callback(torch, ema)
        reset_counters()
        np.random.seed(0)
        with cast():
            _, wall = _timed(torch, lambda: model.fit(
                loader, epochs=1, verbose=2, log_freq=4,
                callbacks=[ema_cb, timer]))
        launches[f"hapi_resnet50_fit_{prec}"] = read_counters()
        st, n_batches = loader.stats, HAPI_IMAGES // RESNET_BATCH
        if st["queue"] != 0 or st["shm"] != n_batches:
            raise RuntimeError(f"ResNet-50 fit {prec}: {st['shm']} batches "
                               f"through the rings and {st['queue']} "
                               f"through the queue (all {n_batches} must "
                               f"take the rings)")
        losses = [d["loss"] for d in timer.logs]
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"ResNet-50 fit {prec}: losses {losses}")
        steady, interval = _steady(timer)
        r = {"fit_imgs_per_s": HAPI_IMAGES / wall * 1e3,
             "steady_imgs_per_s": RESNET_BATCH / interval * 1e3,
             "step_only_imgs_per_s": RESNET_BATCH / steady * 1e3,
             "step_wall_ms": timer.walls, "steady_step_ms": steady,
             "steady_interval_ms": interval,
             "resident_train_batch_imgs_per_s":
                 RESNET_RESIDENT_IMGS_S[prec],
             "loader_wait_ms": timer.waits,
             "loader_wait_median_ms": float(np.median(timer.waits)),
             "loader_main_ms_per_batch": {
                 k[:-2]: st[k] * 1e3 / st["batches"]
                 for k in ("wait_s", "pop_s", "convert_s")},
             "shm_messages": st["shm"], "queue_messages": st["queue"],
             "losses": losses,
             "acc_top1": [float(d["acc_top1"][0]) for d in timer.logs],
             "acc_top5": [float(d["acc_top1"][1]) for d in timer.logs],
             "ema_update_ms": ema_cb.ms,
             "ema_update_median_ms": float(np.median(ema_cb.ms))}
        log(f"ResNet-50 fit {prec}: {r['fit_imgs_per_s']:.1f} imgs/s over "
            f"the fit ({wall:.0f} ms, the first step captures), steady "
            f"{r['steady_imgs_per_s']:.1f} imgs/s (a batch every "
            f"{interval:.1f} ms, median; the step alone {steady:.1f} ms, "
            f"{r['step_only_imgs_per_s']:.1f} imgs/s) "
            f"against train_batch on a resident batch "
            f"{RESNET_RESIDENT_IMGS_S[prec]} (an earlier run); host wait on "
            f"the loader {r['loader_wait_median_ms']:.2f} ms a batch "
            f"(median; the main process's mean ms a batch, the first "
            f"included: {r['loader_main_ms_per_batch']}); {st['shm']} ring "
            f"and {st['queue']} "
            f"queue messages; EMA update {r['ema_update_median_ms']:.3f} "
            f"ms; losses {[round(v, 4) for v in losses]}")
        res[prec] = r
    # evaluate under the EMA weights, graphed and eager, on two resident
    # batches (the program's throughput, not the loader's)
    eval_batches = _resident(io.DataLoader(
        io.Subset(ds, range(HAPI_EVAL_BATCHES * RESNET_BATCH)),
        batch_size=RESNET_BATCH, device=dev), HAPI_EVAL_BATCHES)
    n_eval = HAPI_EVAL_BATCHES * RESNET_BATCH
    reset_counters()
    with cudnn_deterministic(torch), ema.apply():
        if [p.data_ptr() for p in net.parameters()] != ptrs:
            raise RuntimeError("ema.apply() moved a parameter")
        model.evaluate(eval_batches, verbose=0)         # captures
        g_ms, e_ms = [], []
        for _ in range(3):
            graphed, ms = _timed(torch, lambda: model.evaluate(
                eval_batches, verbose=0))
            g_ms.append(ms)
            with graphs.disable_graphs():
                eager, ms = _timed(torch, lambda: model.evaluate(
                    eval_batches, verbose=0))
            e_ms.append(ms)
        g_ms, e_ms = float(np.median(g_ms)), float(np.median(e_ms))
        pred = model.predict([eval_batches[0][:1]], stack_outputs=True)
    launches["hapi_resnet50_evaluate"] = read_counters()
    if [p.data_ptr() for p in net.parameters()] != ptrs:
        raise RuntimeError("ema.restore() moved a parameter")
    if graphed["acc_top1"] != eager["acc_top1"]:
        raise RuntimeError(f"ResNet-50 evaluate: top-1/top-5 of the "
                           f"program {graphed['acc_top1']} against the eager "
                           f"lane's {eager['acc_top1']}")
    if pred[0].shape != (RESNET_BATCH, RESNET_CLASSES) or \
            not np.isfinite(pred[0]).all():
        raise RuntimeError(f"ResNet-50 predict: {pred[0].shape}")
    ev = {"graphed": graphed, "eager": eager,
          "graphed_imgs_per_s": n_eval / g_ms * 1e3,
          "eager_imgs_per_s": n_eval / e_ms * 1e3,
          "loss_equal": graphed["loss"] == eager["loss"],
          "loss_rel_diff": abs(graphed["loss"] - eager["loss"])
          / abs(eager["loss"]),
          "data_ptrs_unchanged": True}
    log(f"ResNet-50 evaluate under ema.apply(): graphed "
        f"{ev['graphed_imgs_per_s']:.1f} imgs/s, eager "
        f"{ev['eager_imgs_per_s']:.1f}; top-1/top-5 {graphed['acc_top1']} "
        f"both lanes; loss {graphed['loss']!r} / {eager['loss']!r}; "
        f"predict {pred[0].shape}; data_ptrs kept across apply/restore")
    res["evaluate"] = ev
    res["lars_update"] = profile_update(
        torch, model, "ResNet-50 LarsMomentum update (one replay)",
        passes=5)
    log(f"  against Momentum's {MOMENTUM_UPDATE_MS} ms (an earlier run)")
    model._invalidate_compiled()
    del model, net, ema, ds, x, eval_batches
    release_memory(torch)
    return res, launches


def hapi_bert(torch, fa_mod, dev, bcfg, smi, reset_counters,
              read_counters):
    """Phase 20's BERT-base (``bcfg``): ``fit`` with Lamb over a
    ``DataLoader`` of seeded ids (O1 bf16, graphed), then ``evaluate``
    through the captured eval program (B1 once a layer a batch), graphed
    and eager; the Lamb update timed alone."""
    from paddle_tpu_torch import amp, io
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.optimizer import Lamb
    model = _bert_model(torch, dev, bcfg)
    model.prepare(Lamb(1e-3, lamb_weight_decay=0.01,
                       parameters=model.network.parameters(), device=dev),
                  model._loss)
    ids = np.random.RandomState(20).randint(
        0, bcfg.vocab_size, (HAPI_BERT_STEPS * BERT_BATCH, BERT_SEQ)) \
        .astype(np.int64)
    loader = io.DataLoader(io.TensorDataset([ids, ids]),
                           batch_size=BERT_BATCH, device=dev)
    log(f"BERT-base fit: Lamb(1e-3, lamb_weight_decay 0.01), O1 bf16, "
        f"{HAPI_BERT_STEPS} batches of [{BERT_BATCH}, {BERT_SEQ}] seeded ids "
        f"through a DataLoader; {smi}")
    timer = _step_timer(torch)
    launches = {}
    reset_counters()
    with amp.auto_cast():
        model.fit(loader, epochs=1, verbose=0, callbacks=[timer])
    launches["hapi_bert_fit"] = read_counters()
    losses = [d["loss"] for d in timer.logs]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"BERT-base fit: losses {losses}")
    steady, interval = _steady(timer)
    res = {"losses": losses, "step_wall_ms": timer.walls,
           "loader_wait_ms": timer.waits,
           "tokens_per_s": BERT_BATCH * BERT_SEQ / interval * 1e3,
           "step_only_tokens_per_s": BERT_BATCH * BERT_SEQ / steady * 1e3,
           "o1_adamw_tokens_per_s": BERT_O1_ADAMW_TOKENS_S}
    log(f"BERT-base fit: {res['tokens_per_s']:.0f} tokens/s steady (a "
        f"batch every {interval:.1f} ms, median; the step alone "
        f"{steady:.1f} ms, {res['step_only_tokens_per_s']:.0f} tokens/s) "
        f"against phase 13's O1 AdamW "
        f"{BERT_O1_ADAMW_TOKENS_S} (an earlier run); losses "
        f"{[round(v, 4) for v in losses]}")
    eids = np.random.RandomState(21).randint(
        0, bcfg.vocab_size, (HAPI_EVAL_BATCHES * BERT_BATCH, BERT_SEQ))
    eval_batches = [[torch.from_numpy(b).to(dev)] * 2
                    for b in np.split(eids, HAPI_EVAL_BATCHES)]
    n_tok = HAPI_EVAL_BATCHES * BERT_BATCH * BERT_SEQ
    reset_counters()
    per_call = []
    with amp.auto_cast():
        for lane in ("capture", "graphed", "eager"):
            ctx = graphs.disable_graphs() if lane == "eager" \
                else contextlib.nullcontext()
            before = fa_mod.flash_attention_fwd.launches
            with ctx:
                logs, ms = _timed(torch, lambda: model.evaluate(
                    eval_batches, verbose=0))
            per_call.append(fa_mod.flash_attention_fwd.launches - before)
            res[f"evaluate_{lane}"] = {"loss": logs["loss"], "ms": ms}
    launches["hapi_bert_evaluate"] = read_counters()
    by_dtype = {c.__name__: dict(c.launches_by_dtype)
                for c in _counters(fa_mod)}
    want = bcfg.num_layers * HAPI_EVAL_BATCHES
    if per_call != [want] * 3:
        raise RuntimeError(f"BERT-base evaluate: B1 launched {per_call} "
                           f"times in the three evaluate calls, {want} "
                           f"({bcfg.num_layers} a batch) expected in each")
    g, e = res["evaluate_graphed"]["loss"], res["evaluate_eager"]["loss"]
    res.update(b1_launches_per_evaluate=per_call,
               b1_launches_per_batch=bcfg.num_layers,
               eval_tokens_per_s_graphed=n_tok / res["evaluate_graphed"][
                   "ms"] * 1e3,
               eval_tokens_per_s_eager=n_tok / res["evaluate_eager"]["ms"]
               * 1e3, eval_loss_equal=g == e,
               eval_loss_rel_diff=abs(g - e) / abs(e))
    log(f"BERT-base evaluate (O1): B1 {per_call} launches in the "
        f"capture, graphed and eager calls ({bcfg.num_layers} a batch); "
        f"{res['eval_tokens_per_s_graphed']:.0f} tokens/s graphed, "
        f"{res['eval_tokens_per_s_eager']:.0f} eager; loss {g!r} graphed, "
        f"{e!r} eager ("
        + ("bitwise equal" if g == e else f"differ by {abs(g - e)!r}") + ")")
    res["lamb_update"] = profile_update(
        torch, model, "BERT-base Lamb update (one replay)", passes=7)
    log(f"  against AdamW's {ADAMW_UPDATE_MS} ms (bound {ADAMW_BOUND_MS}; "
        f"an earlier run)")
    model._invalidate_compiled()
    del model, eval_batches
    release_memory(torch)
    return res, launches, by_dtype


def _seeded_ground_truth(dets, counts, rng, slots=50):
    """Ground truth for mAP on random weights: about half of each image's
    detections (moved by a few pixels) and two random boxes, a fifth of
    them difficult."""
    n = dets.shape[0]
    box = np.zeros((n, slots, 4), np.float32)
    lab = np.zeros((n, slots), np.int64)
    dif = np.zeros((n, slots), np.int64)
    for i in range(n):
        d = dets[i, :counts[i]]
        d = d[d[:, 0] >= 0]
        pick = d[rng.random(len(d)) < 0.5][:slots - 2]
        b = pick[:, 2:6] + rng.normal(0, 4, (len(pick), 4))
        xy = rng.random((2, 2)) * (DET_SIZE - 100)
        b = np.concatenate([b, np.concatenate([xy, xy + 60], 1)])
        m = len(b)
        box[i, :m] = b
        lab[i, :m] = np.concatenate([pick[:, 0].astype(np.int64),
                                     rng.integers(0, DET_CLASSES, 2)])
        dif[i, :m] = rng.random(m) < 0.2
    return box, lab, dif


def hapi_yolov3_map(torch, nms_mod, det_mod, dev, reset_counters,
                    read_counters):
    """Phase 20's YOLOv3-DarkNet53 mAP: HAPI_DET_BATCHES batches of
    HAPI_DET_BATCH 608x608 images through the forward and ``decode``
    (``yolo_box``, ``multiclass_nms`` on B5) into ``DetectionMAP`` in both
    AP versions, against the same detections through B5's plain
    version: the mAPs must be equal."""
    from paddle_tpu_torch import metric
    from paddle_tpu_torch.vision.models import yolov3_darknet53
    det = yolov3_darknet53(num_classes=DET_CLASSES, device=dev,
                           seed=0).eval()
    rng = np.random.default_rng(20)
    maps = {lane: {v: metric.DetectionMAP(DET_CLASSES, ap_version=v)
                   for v in ("integral", "11point")}
            for lane in ("kernel", "plain")}
    reset_counters()
    ms = []
    batches = [_det_batch(torch, rng, HAPI_DET_BATCH, dev)
               for _ in range(HAPI_DET_BATCHES)]
    kernel_dets = []
    for img, hw in batches:
        def run():
            with torch.inference_mode():
                return det.decode(det(img), hw, **DET_DECODE)
        (dk, ck), t = _timed(torch, run)
        ms.append(t)
        kernel_dets.append((dk.cpu().numpy(), ck.cpu().numpy()))
    launches = read_counters()
    if launches["greedy_nms"] < 1:
        raise RuntimeError("phase 20: B5 was not launched by the mAP "
                           "path's multiclass_nms")
    kernel_nms = det_mod.greedy_nms
    det_mod.greedy_nms = nms_mod.greedy_nms_plain
    try:
        plain_dets = []
        for img, hw in batches:
            with torch.inference_mode():
                dp, cp = det.decode(det(img), hw, **DET_DECODE)
            plain_dets.append((dp.cpu().numpy(), cp.cpu().numpy()))
    finally:
        det_mod.greedy_nms = kernel_nms
    same = True
    for (dk, ck), (dp, cp) in zip(kernel_dets, plain_dets):
        same &= np.array_equal(dk, dp) and np.array_equal(ck, cp)
        gt = _seeded_ground_truth(dk, ck, rng)
        for lane, (d, c) in (("kernel", (dk, ck)), ("plain", (dp, cp))):
            for m in maps[lane].values():
                m.update(d, c, *gt)
    res = {v: {lane: maps[lane][v].accumulate() for lane in maps}
           for v in ("integral", "11point")}
    log(f"YOLOv3 mAP over {HAPI_DET_BATCHES} batches of {HAPI_DET_BATCH}: "
        f"{res}; detections of B5 and of its plain version "
        f"{'equal' if same else 'DIFFER'}; B5 launches "
        f"{launches['greedy_nms']}; forward + decode {ms} ms")
    for v, r in res.items():
        if r["kernel"] != r["plain"] or not same:
            raise RuntimeError(f"YOLOv3 {v} mAP from B5's detections "
                               f"{r['kernel']} against the plain lane's "
                               f"{r['plain']}")
    res.update(b5_launches=launches["greedy_nms"], eval_ms=ms,
               detections_equal=same)
    del det, batches
    release_memory(torch)
    return res, launches


def hapi_lenet_rules(torch, dev):
    """Phase 20's other rules on LeNet (batch HAPI_LENET_BATCH): each of
    Adamax, Adagrad, Adadelta, RMSProp (plain and centered), Ftrl, Lamb,
    LarsMomentum, LookAhead (over Momentum, k 2) and ModelAverage (over
    Momentum, windows 2-3) for HAPI_LENET_STEPS graphed ``train_batch``
    steps against the eager lane on fresh weights: losses, weights and
    optimizer state bitwise (cuDNN deterministic)."""
    from paddle_tpu_torch import Model, nn, optimizer
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.incubate.optimizer import LookAhead, ModelAverage
    from paddle_tpu_torch.vision.models import LeNet
    rng = np.random.default_rng(20)
    xs = rng.random((HAPI_LENET_STEPS, HAPI_LENET_BATCH, 1, 28, 28),
                    dtype=np.float32)
    ys = rng.integers(0, 10, (HAPI_LENET_STEPS, HAPI_LENET_BATCH))
    rules = {
        "Adamax": ("Adamax", dict(learning_rate=0.01)),
        "Adagrad": ("Adagrad", dict(learning_rate=0.01)),
        "Adadelta": ("Adadelta", dict(learning_rate=0.5)),
        "RMSProp": ("RMSProp", dict(learning_rate=0.001, momentum=0.5)),
        "RMSProp centered": ("RMSProp", dict(learning_rate=0.001,
                                             momentum=0.5, centered=True)),
        "Ftrl": ("Ftrl", dict(learning_rate=0.02, l1=0.01, l2=0.02)),
        "Lamb": ("Lamb", dict(learning_rate=0.01)),
        "LarsMomentum": ("LarsMomentum", dict(learning_rate=0.1)),
        "LookAhead": ("Momentum", dict(learning_rate=0.05, momentum=0.9)),
        "ModelAverage": ("Momentum", dict(learning_rate=0.05,
                                          momentum=0.9)),
    }
    res = {}
    for name, (cls, kw) in rules.items():
        lanes = {}
        for lane in ("graphed", "eager"):
            net = LeNet(device=dev, seed=0)
            model = Model(net, device=dev)
            opt = getattr(optimizer, cls)(parameters=net.parameters(),
                                          device=dev, **kw)
            model.prepare(opt, nn.CrossEntropyLoss())
            after, avg = (lambda: None), None
            if name == "LookAhead":
                la = LookAhead(opt, alpha=0.5, k=2)
                la._track()
                after = la._after_inner_step
            elif name == "ModelAverage":
                avg = ModelAverage(0.5, parameters=net.parameters(),
                                   min_average_window=2,
                                   max_average_window=3)
                after = avg.step
            ctx = graphs.disable_graphs() if lane == "eager" \
                else contextlib.nullcontext()
            with ctx, cudnn_deterministic(torch):
                losses = []
                for x, y in zip(xs, ys):
                    losses.append(model.train_batch([x], [y])[0])
                    after()
                if avg is not None:
                    with avg.apply():
                        losses.append(model.eval_batch([xs[0]], [ys[0]])[0])
            state = {k: v.detach().clone()
                     for k, v in net.state_dict().items()}
            state.update({k: v.clone() for k, v in
                          opt.state_dict().items()
                          if isinstance(v, torch.Tensor)})
            lanes[lane] = (losses, state)
        equal = lanes["graphed"][0] == lanes["eager"][0] and all(
            torch.equal(lanes["graphed"][1][k], v)
            for k, v in lanes["eager"][1].items())
        losses = lanes["graphed"][0]
        log(f"LeNet {name}: graphed {'==' if equal else '!='} eager "
            f"(losses, weights, state bitwise), losses "
            f"{[round(v, 5) for v in losses]}")
        if not equal or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"LeNet {name}: graphed lane "
                               f"{lanes['graphed'][0]} against eager "
                               f"{lanes['eager'][0]}")
        res[name] = {"losses": losses, "graphed_equals_eager": equal}
    release_memory(torch)
    return res


# -- phase 21: the dygraph loop on the port's Tensors -------------------------

DY_LENET_STEPS, DY_LENET_BATCH = 20, 64
DY_GPT_STEPS = 3
#: the dygraph GPT's losses against train_batch's eager lane: bitwise, or
#: within this, relative, with the cause named in PERF.md
DY_LOSS_TOL = 1e-6
#: funnel calls a host-time round, and rounds (median kept)
FUNNEL_CALLS, FUNNEL_ROUNDS = 10_000, 3


def funnel_calls(step):
    """The dispatch funnel's calls in one run of ``step`` (its inner
    ``_run`` wrapped by a counter for that run)."""
    from paddle_tpu_torch.ops import dispatch
    run, n = dispatch._run, [0]

    def counting(*args):
        n[0] += 1
        return run(*args)
    dispatch._run = counting
    try:
        step()
    finally:
        dispatch._run = run
    return n[0]


def funnel_host_us(torch, dev):
    """Host µs of one funnel call: ``apply("add", torch.add, a, a)`` on
    two 16-element CUDA tensors against ``torch.add(a, a)`` alone, with
    torch tensors in (no wrap) and with Tensors in (unwrap and wrap),
    under ``no_grad``; FUNNEL_CALLS calls a round, rounds in turns,
    medians kept. The kernels are queued, never waited for inside a
    round: the host is what is timed."""
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.ops import dispatch
    a = torch.ones(16, device=dev)
    ta = Tensor(a)
    fns = {"torch_us": lambda: torch.add(a, a),
           "funnel_torch_us": lambda: dispatch.apply("add", torch.add, a, a),
           "funnel_tensor_us": lambda: dispatch.apply("add", torch.add, ta,
                                                      ta)}
    per = {k: [] for k in fns}
    with torch.no_grad():
        for _ in range(FUNNEL_ROUNDS):
            for k, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(FUNNEL_CALLS):
                    fn()
                per[k].append((time.perf_counter() - t0) / FUNNEL_CALLS
                              * 1e6)
    torch.cuda.synchronize()
    out = {k: float(np.median(v)) for k, v in per.items()}
    out["funnel_overhead_us"] = out["funnel_torch_us"] - out["torch_us"]
    out["funnel_tensor_overhead_us"] = (out["funnel_tensor_us"]
                                        - out["torch_us"])
    log(f"funnel host time a call (median of {FUNNEL_ROUNDS} rounds of "
        f"{FUNNEL_CALLS}): torch.add {out['torch_us']:.3f} us, apply on "
        f"torch tensors {out['funnel_torch_us']:.3f} us (+"
        f"{out['funnel_overhead_us']:.3f}), apply on Tensors "
        f"{out['funnel_tensor_us']:.3f} us (+"
        f"{out['funnel_tensor_overhead_us']:.3f})")
    return out


def dygraph_lenet(torch, dev, reset_counters, read_counters):
    """Phase 21a: LeNet (10 classes, seed 0), DY_LENET_STEPS dygraph
    steps of batch DY_LENET_BATCH with Momentum(0.05, 0.9): to_tensor,
    forward, ``F.cross_entropy``, ``loss.backward()``, ``opt.step()``,
    ``opt.clear_grad()``; the losses bitwise equal to the same steps
    through ``Model.train_batch`` on the eager lane on fresh weights
    (cuDNN deterministic). Funnel calls a step, and step wall and device
    ms against the eager ``train_batch`` step's."""
    from paddle_tpu_torch import Model, optimizer, to_tensor
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import LeNet
    rng = np.random.default_rng(21)
    xs = rng.random((DY_LENET_STEPS, DY_LENET_BATCH, 1, 28, 28),
                    dtype=np.float32)
    ys = rng.integers(0, 10, (DY_LENET_STEPS, DY_LENET_BATCH))

    def fresh():
        net = LeNet(device=dev, seed=0)
        return net, optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                       parameters=net.parameters(),
                                       device=dev)

    with cudnn_deterministic(torch):
        net, opt = fresh()

        def one(x, y):
            loss = F.cross_entropy(net(to_tensor(x)), to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        reset_counters()
        losses = [float(one(x, y)) for x, y in zip(xs, ys)]
        launches = read_counters()
        calls = funnel_calls(lambda: one(xs[0], ys[0]))
        prof = profile_steps(torch, "LeNet dygraph step", lambda: float(
            one(xs[0], ys[0])), 5)
        net2, opt2 = fresh()
        model = Model(net2, device=dev)
        model.prepare(opt2, F.cross_entropy)
        with graphs.disable_graphs():
            ref = [model.train_batch([x], [y])[0] for x, y in zip(xs, ys)]
            ref_prof = profile_steps(
                torch, "LeNet train_batch step, eager lane",
                lambda: model.train_batch([xs[0]], [ys[0]]), 5)
    equal = losses == ref
    log(f"LeNet dygraph x{DY_LENET_STEPS} vs train_batch eager lane: "
        f"{'bitwise equal' if equal else 'DIFFERENT'}; losses "
        f"{[round(v, 5) for v in losses[:3]]} ... {losses[-1]:.6f}; "
        f"{calls} funnel calls a step; step wall {prof['wall_ms']:.3f} ms "
        f"(device {prof['device_ms']:.3f}) against train_batch's "
        f"{ref_prof['wall_ms']:.3f} ms (device {ref_prof['device_ms']:.3f})")
    if not equal:
        raise RuntimeError(f"LeNet dygraph losses {losses} against "
                           f"train_batch's {ref}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"LeNet dygraph: the loss did not fall {losses}")
    release_memory(torch)
    return {"losses": losses, "train_batch_losses": ref, "bitwise": equal,
            "funnel_calls_per_step": calls, "step_wall_ms": prof["wall_ms"],
            "step_device_ms": prof["device_ms"],
            "idle_share": 1 - prof["device_ms"] / prof["wall_ms"],
            "train_batch_step_wall_ms": ref_prof["wall_ms"],
            "train_batch_step_device_ms": ref_prof["device_ms"]}, launches


def dygraph_gpt(torch, fa_mod, dev, cfg, ids, o1, reset_counters,
                read_counters):
    """Phase 21b: GPT-3 1.3B at full width (phase 7's model, optimizer,
    schedule and batch, fresh from seed 0), DY_GPT_STEPS dygraph steps
    (fp32, or O1 bf16 with the forward under ``auto_cast``): B1, B2 and
    B3 24 launches a step each, from their counters; the losses against
    the same steps through ``Model.train_batch`` on the eager lane on
    fresh weights, bitwise or within DY_LOSS_TOL. Funnel calls a step,
    step wall, device ms and idle share (two more steps, profiled)."""
    from paddle_tpu_torch import amp, to_tensor
    from paddle_tpu_torch.core import graphs
    what = "O1 bf16" if o1 else "fp32"
    cast = amp.auto_cast if o1 else contextlib.nullcontext
    model, sched = _train_model(torch, cfg, dev, "flash")
    net, opt, crit = model.network, model._optimizer, model._loss
    x = to_tensor(ids)

    def one():
        with cast():
            loss = crit(net(x), x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    reset_counters()
    losses, walls = [], []
    for step in range(DY_GPT_STEPS):
        before = [c.launches for c in _counters(fa_mod)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(one()))
        walls.append((time.perf_counter() - t0) * 1e3)
        sched.step()
        launched = [c.launches - b for c, b in zip(_counters(fa_mod),
                                                   before)]
        log(f"GPT-3 1.3B {what} dygraph step {step + 1}: loss "
            f"{losses[-1]:.6f}, wall {walls[-1]:.1f} ms, launches "
            f"B1/B2/B3 {launched}")
        if launched != [cfg["num_layers"]] * 3:
            raise RuntimeError(f"{what} dygraph step {step + 1} launched "
                               f"B1/B2/B3 {launched} times, not "
                               f"{cfg['num_layers']} each")
        if not math.isfinite(losses[-1]):
            raise RuntimeError(f"{what} dygraph step {step + 1}: loss "
                               f"{losses[-1]}")
    launches = read_counters()
    by_dtype = {c.__name__: dict(c.launches_by_dtype)
                for c in _counters(fa_mod)}
    calls = funnel_calls(one)
    prof = profile_steps(torch, f"GPT-3 1.3B {what} dygraph step", one,
                         PROFILE_STEPS)
    del model, net, opt, crit, x
    release_memory(torch)
    ref_model, ref_sched = _train_model(torch, cfg, dev, "flash")
    ref = []
    with graphs.disable_graphs():
        for _ in range(DY_GPT_STEPS):
            with cast():
                ref.append(ref_model.train_batch([ids], [ids])[0])
            ref_sched.step()
    del ref_model
    release_memory(torch)
    cmp = check_lane_losses(losses, ref, f"GPT-3 1.3B {what} dygraph vs "
                            f"train_batch eager lane", tol=DY_LOSS_TOL)
    out = {"losses": losses, "train_batch_losses": ref, **cmp,
           "step_wall_ms": walls, "funnel_calls_per_step": calls,
           "profiled_step_wall_ms": prof["wall_ms"],
           "step_device_ms": prof["device_ms"],
           "idle_share": 1 - prof["device_ms"] / prof["wall_ms"],
           "kernels_per_step": sum(r[1] for r in prof["kernels"])}
    log(f"GPT-3 1.3B {what} dygraph: {calls} funnel calls a step, step "
        f"wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, "
        f"idle {100 * out['idle_share']:.1f}%")
    return out, launches, by_dtype


def autograd_surface(torch, dev):
    """Phase 21c: on the card, ``paddle.grad(create_graph=True)`` (a
    gradient penalty on a small MLP, within 1e-5 of its largest value of
    the same on the CPU), a ``PyLayer`` forward and backward,
    ``register_hook``, and ``FLAGS_check_nan_inf``: an eager op making an
    inf raises ``EnforceNotMet`` naming the op, and a ``core/graphs.py``
    ``Program`` captured with the flag on skips the check (a sync would
    break the capture): one capture, and a replay on inputs holding an
    inf returns the non-finite result without raising. (d) Placement:
    with no ``set_device`` call, ``to_tensor`` lands on ``cuda:0``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.core.errors import EnforceNotMet
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(22)
    w1 = rng.standard_normal((16, 32), dtype=np.float32) * 0.3
    w2 = rng.standard_normal((32, 1), dtype=np.float32) * 0.3
    xv = rng.standard_normal((8, 16), dtype=np.float32)

    def penalty(place):
        a = paddle.to_tensor(w1, place=place, stop_gradient=False)
        b = paddle.to_tensor(w2, place=place, stop_gradient=False)
        x = paddle.to_tensor(xv, place=place, stop_gradient=False)
        out = paddle.matmul(paddle.tanh(paddle.matmul(x, a)), b)
        (gx,) = paddle.grad(out.sum(), x, create_graph=True)
        pen = ((paddle.sqrt((gx * gx).sum(axis=1)) - 1.0) ** 2).mean()
        pen.backward()
        return [pen.numpy(), gx.numpy(), a.grad.numpy(), b.grad.numpy()]

    cuda_res, cpu_res = penalty(None), penalty("cpu")
    pen_err = max(float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-12))
                  for g, c in zip(cuda_res, cpu_res))

    class Cube(paddle.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, gy):
            (x,) = ctx.saved_tensor()
            return gy * 3.0 * x * x

    xs = paddle.to_tensor([2.0, -1.0, 0.5], stop_gradient=False)
    Cube.apply(xs).sum().backward()
    pylayer_ok = np.allclose(xs.grad.numpy(), 3 * xs.numpy() ** 2,
                             rtol=1e-6)
    h = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    seen = []
    h.register_hook(lambda g: (seen.append(g.place), g * 2)[1])
    (h * 3).sum().backward()
    hook_ok = (np.array_equal(h.grad.numpy(), [6.0, 6.0])
               and seen == [paddle.CUDAPlace(0)])

    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        raised = None
        try:
            paddle.log(paddle.to_tensor([1.0]) - 2.0)
        except EnforceNotMet as e:
            raised = str(e)
        w = torch.randn(8, 8, device=dev)

        class _Pool:
            graph_pool = graphs.GraphPool(dev)
        state = _Pool()
        prog = graphs.Program(lambda params, st, a: F.softmax(
            F.linear(a, params[0])))
        a = torch.randn(4, 8, device=dev)
        first = prog([w], state, a).clone()        # warm-up (checked)
        bad = a.clone()
        bad[0, 0] = float("inf")
        replayed = prog([w], state, bad)           # a replay: no check
        torch.cuda.synchronize()
        capture_ok = (prog.trace_counter["traces"] == 1
                      and prog.replays == 1
                      and bool(torch.isfinite(first).all())
                      and not bool(torch.isfinite(replayed).all()))
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})
    t = paddle.to_tensor([1.0])
    placement = {"device": str(t._data.device), "place": repr(t.place),
                 "get_device": paddle.get_device()}
    out = {"grad_penalty_rel_err": pen_err, "pylayer": pylayer_ok,
           "hook": hook_ok, "nan_inf_raised": raised,
           "nan_inf_capture": capture_ok, "placement": placement}
    log(f"autograd surface on the card: gradient penalty vs CPU rel err "
        f"{pen_err:.3e}, PyLayer {pylayer_ok}, hook {hook_ok}, "
        f"check_nan_inf eager: {raised!r}, under capture: one capture "
        f"and a non-finite replay without raising {capture_ok}; "
        f"placement {placement}")
    if not (pen_err <= 1e-5 and pylayer_ok and hook_ok and capture_ok
            and raised and "'log'" in raised):
        raise RuntimeError(f"phase 21 autograd surface: {out}")
    if (placement["device"] != "cuda:0" or t.place != paddle.CUDAPlace(0)
            or placement["get_device"] != "gpu:0"):
        raise RuntimeError(f"phase 21 placement: {placement}")
    return out


# -- phase 22: a paddle program written from the op surface ------------------

#: the op-built GPT's losses against GPTForCausalLM's dygraph losses of
#: phase 21 from the same weights: bitwise where the program's op sequence
#: is the layers', else within these, relative, with the op that parts
OPG_TOL = {"fp32": 1e-4, "o1": 2e-2}
#: the dense variant's first step against the flash variant's: the loss,
#: and the gradients' global norm, relative
DENSE_LOSS_TOL, DENSE_NORM_TOL = 1e-4, 1e-3


def _op_table():
    """``tests/test_torch_op_table.py``, which holds the op table, its
    checks and the op-built GPT (it imports neither jax nor the JAX
    package); ``tests/`` goes last on the path, so it shadows nothing."""
    sys.path.append(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import test_torch_op_table
    return test_torch_op_table


def _op_gpt(torch, ct, cfg, dev, dense=False, with_optimizer=True):
    """The op-built GPT-3 1.3B (``ct.op_built_gpt``: ``create_parameter``
    with ``ParamAttr(initializer=Assign(...))`` for every weight, the
    forward from Tensor ops) on the weights of ``GPTForCausalLM`` from
    seed 0 (phase 21's), taken by name from its state dict, with phase
    7's AdamW, clip and schedule (None, None without the optimizer)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    src = GPTForCausalLM(GPTConfig(**cfg, attn_impl="flash"), device=dev,
                         seed=0)
    net = ct.op_built_gpt(paddle, src.state_dict(), cfg["num_layers"],
                          cfg["num_heads"], dense=dense)
    del src
    release_memory(torch)
    if not with_optimizer:
        return net, None, None
    opt, sched = _gpt_optimizer(net, dev)
    return net, opt, sched


def _grad_norm(torch, net):
    return float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in net.parameters()])))


def op_gpt_dygraph(torch, fa_mod, ct, dev, cfg, ids, o1, ref,
                   reset_counters, read_counters):
    """Phase 22a: the op-built GPT-3 1.3B, DY_GPT_STEPS dygraph steps
    (fp32, or the forward under ``auto_cast``, O1 bf16): B1, B2 and B3 24
    launches a step each; the losses against ``GPTForCausalLM``'s
    dygraph losses of phase 21 from the same weights (``ref``); the first
    step's gradient norm (for the dense check); funnel calls a step, step
    wall, device ms and idle share (two more steps, profiled)."""
    from paddle_tpu_torch import amp, to_tensor
    what = "O1 bf16" if o1 else "fp32"
    cast = amp.auto_cast if o1 else contextlib.nullcontext
    net, opt, sched = _op_gpt(torch, ct, cfg, dev)
    x = to_tensor(ids)
    norms = []

    def one():
        with cast():
            loss = net.loss(net(x), x)
        loss.backward()
        if not norms:
            norms.append(_grad_norm(torch, net))
        opt.step()
        opt.clear_grad()
        return loss

    reset_counters()
    losses, walls = [], []
    for step in range(DY_GPT_STEPS):
        before = [c.launches for c in _counters(fa_mod)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(one()))
        walls.append((time.perf_counter() - t0) * 1e3)
        sched.step()
        launched = [c.launches - b for c, b in zip(_counters(fa_mod),
                                                   before)]
        log(f"op-built GPT-3 1.3B {what} step {step + 1}: loss "
            f"{losses[-1]:.6f}, wall {walls[-1]:.1f} ms, launches "
            f"B1/B2/B3 {launched}")
        if launched != [cfg["num_layers"]] * 3:
            raise RuntimeError(f"op-built {what} step {step + 1} launched "
                               f"B1/B2/B3 {launched} times, not "
                               f"{cfg['num_layers']} each")
    launches = read_counters()
    by_dtype = {c.__name__: dict(c.launches_by_dtype)
                for c in _counters(fa_mod)}
    calls = funnel_calls(one)
    prof = profile_steps(torch, f"op-built GPT-3 1.3B {what} dygraph step",
                         one, PROFILE_STEPS)
    del net, opt, x
    release_memory(torch)
    tol = OPG_TOL["o1" if o1 else "fp32"]
    cmp = check_lane_losses(losses, ref, f"op-built GPT-3 1.3B {what} vs "
                            f"GPTForCausalLM dygraph (phase 21)", tol=tol)
    if not cmp["bitwise"]:
        # O1: the program adds each bias after a matmul_v2 (white-listed);
        # the layers' linear (white-listed too) casts the bias with it.
        # fp32: the op sequence and the parameter order are the layers'
        cmp["parting_op"] = ("the bias add: matmul_v2 + add in float32 "
                             "against linear in bfloat16") if o1 else \
            "none named: the ops and the parameter order are the layers'"
    out = {"losses": losses, "reference_losses": ref, **cmp,
           "first_grad_norm": norms[0], "step_wall_ms": walls,
           "funnel_calls_per_step": calls,
           "profiled_step_wall_ms": prof["wall_ms"],
           "step_device_ms": prof["device_ms"],
           "idle_share": 1 - prof["device_ms"] / prof["wall_ms"],
           "kernels_per_step": sum(r[1] for r in prof["kernels"])}
    log(f"op-built GPT-3 1.3B {what}: {calls} funnel calls a step, step "
        f"wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, "
        f"idle {100 * out['idle_share']:.1f}%, B1-B3 by type {by_dtype}")
    return out, launches, by_dtype


def op_gpt_model_lanes(torch, ct, dev, cfg, ids):
    """Phase 22b: the op-built GPT as a ``Model`` network with its own
    criterion, DY_GPT_STEPS ``train_batch`` calls on the graphed lane
    (one capture: ``arange``, ``unsqueeze``, ``tile``, slicing and
    ``matmul`` inside a CUDA graph) and on the eager lane, each on fresh
    weights: the losses bitwise equal."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.core import graphs
    lanes = {}
    for lane in ("graphed", "eager"):
        net, opt, sched = _op_gpt(torch, ct, cfg, dev)
        model = Model(net, device=dev)
        model.prepare(opt, net.loss)
        ctx = graphs.disable_graphs() if lane == "eager" else \
            contextlib.nullcontext()
        losses = []
        with ctx:
            for _ in range(DY_GPT_STEPS):
                losses.append(model.train_batch([ids], [ids])[0])
                sched.step()
        lanes[lane] = {"losses": losses}
        if lane == "graphed":
            lanes[lane].update(program_report(
                model, "op-built GPT train_batch, graphed", DY_GPT_STEPS))
        model._invalidate_compiled()
        del model, net, opt
        release_memory(torch)
    lanes.update(check_lane_losses(
        lanes["graphed"]["losses"], lanes["eager"]["losses"],
        "op-built GPT train_batch, graphed vs eager lane", tol=0.0))
    return lanes


def op_gpt_dense(torch, ct, dev, cfg, ids, flash):
    """Phase 22c: the dense variant (the reference's dense branch:
    ``transpose``, ``triu(full(-1e9), 1)``, ``matmul``, ``F.softmax``)
    for one fp32 forward and backward on the same weights and batch: its
    loss within DENSE_LOSS_TOL of the flash variant's first step and its
    gradients' global norm within DENSE_NORM_TOL; its peak memory. At
    ``[4, 1024]`` if it fits beside the model and its gradients, else at
    ``[1, 1024]`` for both variants."""
    from paddle_tpu_torch import to_tensor
    release_memory(torch)
    out = {}
    for rows in (ids.shape[0], 1):
        batch = ids[:rows]
        try:
            torch.cuda.reset_peak_memory_stats()
            net, _, _ = _op_gpt(torch, ct, cfg, dev, dense=True,
                                with_optimizer=False)
            x = to_tensor(batch)
            loss = net.loss(net(x), x)
            loss.backward()
            out = {"batch": list(batch.shape), "loss": float(loss),
                   "grad_norm": _grad_norm(torch, net),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del net, x, loss
            release_memory(torch)
            break
        except torch.cuda.OutOfMemoryError:
            log(f"dense variant at {list(batch.shape)} does not fit; "
                f"retrying at [1, {batch.shape[1]}]")
            release_memory(torch)
    if out["batch"][0] != ids.shape[0]:
        net, _, _ = _op_gpt(torch, ct, cfg, dev, with_optimizer=False)
        x = to_tensor(ids[:1])
        loss = net.loss(net(x), x)
        loss.backward()
        flash = {"losses": [float(loss)],
                 "first_grad_norm": _grad_norm(torch, net)}
        del net, x, loss
        release_memory(torch)
    out["flash_loss"] = flash["losses"][0]
    out["flash_grad_norm"] = flash["first_grad_norm"]
    out["loss_rel"] = abs(out["loss"] - out["flash_loss"]) / abs(
        out["flash_loss"])
    out["grad_norm_rel"] = abs(out["grad_norm"] - out["flash_grad_norm"]) \
        / out["flash_grad_norm"]
    log(f"op-built GPT-3 1.3B dense variant {out['batch']} fp32: loss "
        f"{out['loss']:.6f} vs flash {out['flash_loss']:.6f} (rel "
        f"{out['loss_rel']:.2e}), gradient norm {out['grad_norm']:.6f} vs "
        f"{out['flash_grad_norm']:.6f} (rel {out['grad_norm_rel']:.2e}), "
        f"peak {out['peak_gib']:.2f} GiB")
    if out["loss_rel"] > DENSE_LOSS_TOL or \
            out["grad_norm_rel"] > DENSE_NORM_TOL:
        raise RuntimeError(f"phase 22 dense variant: {out}")
    return out


def cases_on_the_card(ct, cases):
    """``(held, failures)`` of ``ct.cuda_case_holds`` over ``cases``."""
    import paddle_tpu_torch as paddle
    held, failed = 0, []
    for case in cases:
        try:
            ct.cuda_case_holds(case, paddle)
            held += 1
        except Exception as e:   # noqa: BLE001 (every case is reported)
            failed.append(f"{case.name}: {str(e).splitlines()[0][:200]}")
    return held, failed


def op_table_on_the_card(torch, ct):
    """Phase 22d: every case of the op table (``OP_CASES`` but the tie
    cases) on CUDA against the CPU on the same seeded inputs, forward and
    gradient, and the random ops' determinism and moments on the card;
    ``n held of n``."""
    import paddle_tpu_torch as paddle
    t0 = time.perf_counter()
    # the dense surface's cases; phase 23 holds the structured half's
    cases = [c for c in ct.CUDA_CASES if c.module not in ct.STRUCTURED]
    held, failed = cases_on_the_card(ct, cases)
    random_fails = ct.random_ops_hold(paddle, "gpu")
    n = len(cases)
    log(f"op table on the card: {held} held of {n} "
        f"({time.perf_counter() - t0:.1f} s); random ops "
        f"{'held' if not random_fails else random_fails}")
    for f in failed:
        log(f"  op table case failed: {f}")
    if failed or random_fails:
        raise RuntimeError(f"phase 22 op table: {len(failed)} of {n} cases "
                           f"failed, random ops {random_fails}")
    dense = sum(c.module not in ct.STRUCTURED for c in ct.OP_CASES)
    return {"held": held, "cases": n, "tie_cases_on_cpu_only": dense - n,
            "random_ops": "held"}


def run_op_program_phase(torch, fa_mod, dev, cfg, ids, dy, smi,
                         reset_counters, read_counters):
    """Phase 22: the op-built GPT-3 1.3B (fp32 and O1 dygraph, the
    ``train_batch`` lanes, the dense variant) and the op table on the
    card. Returns the phase's numbers and its launches by path."""
    ct = _op_table()
    out, launches, dtypes = {}, {}, {}
    for o1 in (False, True):
        key = "op_gpt_o1_bf16" if o1 else "op_gpt_fp32"
        ref = dy["gpt_o1_bf16" if o1 else "gpt_fp32"]["losses"]
        out[key], launches[key], dtypes[key] = op_gpt_dygraph(
            torch, fa_mod, ct, dev, cfg, ids, o1, ref, reset_counters,
            read_counters)
        d = dy["gpt_o1_bf16" if o1 else "gpt_fp32"]
        out[key]["beside_phase_21"] = {
            "dygraph_step_wall_ms": d["profiled_step_wall_ms"],
            "dygraph_device_ms": d["step_device_ms"],
            "dygraph_idle_share": d["idle_share"],
            "dygraph_funnel_calls": d["funnel_calls_per_step"]}
        log(f"op-built {key} beside phase 21's GPTForCausalLM dygraph step "
            f"({smi}): wall {out[key]['profiled_step_wall_ms']:.1f} vs "
            f"{d['profiled_step_wall_ms']:.1f} ms, device "
            f"{out[key]['step_device_ms']:.1f} vs {d['step_device_ms']:.1f} "
            f"ms, idle {100 * out[key]['idle_share']:.1f}% vs "
            f"{100 * d['idle_share']:.1f}%, funnel calls "
            f"{out[key]['funnel_calls_per_step']} vs "
            f"{d['funnel_calls_per_step']}")
    reset_counters()
    out["train_batch_lanes"] = op_gpt_model_lanes(torch, ct, dev, cfg, ids)
    launches["op_gpt_train_batch"] = read_counters()
    out["dense"] = op_gpt_dense(torch, ct, dev, cfg, ids, out["op_gpt_fp32"])
    out["op_table"] = op_table_on_the_card(torch, ct)
    return out, launches, dtypes


# -- phase 23: a BERT-base CRF tagger ------------------------------------------

#: the tagger's batch (MSRA-NER lengths 64-128 of 128), its train steps
#: and its eval/predict batches
CRF_BATCH, CRF_SEQ, CRF_STEPS, CRF_EVAL_BATCHES = 32, 128, 10, 2


def _tagger(torch, ct, dev, cfg):
    """Phase 23's tagger (``ct.bert_crf_tagger`` over BERT-base from seed
    0) under ``Model`` with AdamW(5e-5); the port's generator seeded 23
    first, so every build draws the same weights and masks."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.models import BertModel
    from paddle_tpu_torch.optimizer import AdamW
    paddle.seed(23)
    net, loss = ct.bert_crf_tagger(paddle, BertModel(cfg, device=dev,
                                                     seed=0),
                                   cfg.hidden_size)
    model = Model(net)
    model.prepare(AdamW(learning_rate=5e-5, parameters=net.parameters(),
                        device=dev), loss)
    return model, net


def _path_scores(em, tr, paths, lens):
    """float64 score of each row's tag path (start, emissions,
    transitions, stop) over its length."""
    out = []
    for e, p, n in zip(em.astype(np.float64), paths, lens):
        p = p[:n]
        out.append(tr[0, p[0]] + tr[1, p[-1]] + e[np.arange(n), p].sum()
                   + tr[2:][p[:-1], p[1:]].sum())
    return np.array(out)


def structured_ops_on_the_card(torch, ct):
    """Phase 23's table check: the structured half's cases on CUDA against
    the CPU (``CUDA_CASES`` of ``ct.STRUCTURED``) and the host-reading
    ops run eagerly on the card (``HOST_CASES``), forward and gradient,
    and the structured draws repeated under one seed; ``n held of n``."""
    import paddle_tpu_torch as paddle
    cases = [c for c in ct.CUDA_CASES if c.module in ct.STRUCTURED] + \
        list(ct.HOST_CASES)
    t0 = time.perf_counter()
    held, failed = cases_on_the_card(ct, cases)
    random_fails = ct.structured_draws_hold(paddle, "gpu")
    n = len(cases)
    log(f"structured op table on the card: {held} held of {n} "
        f"({len(ct.HOST_CASES)} host-reading ops run eagerly; "
        f"{time.perf_counter() - t0:.1f} s); draws "
        f"{'repeat under one seed' if not random_fails else random_fails}")
    for f in failed:
        log(f"  structured case failed: {f}")
    if failed or random_fails:
        raise RuntimeError(f"phase 23 op table: {len(failed)} of {n} cases "
                           f"failed, draws {random_fails}")
    return {"held": held, "cases": n, "host_cases": len(ct.HOST_CASES),
            "draws": "repeat under one seed"}


def cond_capture_lane(torch, ct, dev):
    """Phase 23's control flow: ``ct.cond_net`` through
    ``Model.train_batch`` graphed (``ops.cond`` selects between both
    branches in the capture, no host read) against eager (which reads the
    predicate), 5 SGD steps, losses and weights bitwise; then the
    ``while_loop`` variant, which runs eagerly and raises under a
    capture."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.optimizer import SGD
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.random((64, 4), dtype=np.float32)).to(dev)
    Y = torch.from_numpy(rng.random((64, 1), dtype=np.float32)).to(dev)

    def build(loop=False):
        paddle.seed(0)
        net = ct.cond_net(paddle, loop)
        model = Model(net)
        model.prepare(SGD(learning_rate=0.05, parameters=net.parameters(),
                          device=dev),
                      lambda pred, y: ((pred - y) ** 2).mean())
        return model, net
    out = {}
    for lane in ("graphed", "eager"):
        model, net = build()
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx:
            losses = [model.train_batch([X], [Y])[0] for _ in range(5)]
        out[lane] = (losses, [p.detach().clone() for p in net.parameters()])
    (gl, gp), (el, ep) = out["graphed"], out["eager"]
    equal = gl == el and all(torch.equal(a, b) for a, b in zip(gp, ep))
    finite = all(math.isfinite(v) for v in gl) and all(
        bool(torch.isfinite(p).all()) for p in gp)
    model, _ = build(loop=True)
    with graphs.disable_graphs():
        eager_loop = model.train_batch([X], [Y])[0]
    model, _ = build(loop=True)
    try:
        model.train_batch([X], [Y])
        raised = None
    except NotImplementedError as e:
        raised = str(e).splitlines()[0][:80]
    log(f"ops.cond under a train_batch capture: losses {gl} graphed, "
        f"{'bitwise equal to eager' if equal else f'eager {el}'}; finite "
        f"{finite}; while_loop eager loss {eager_loop:.6f}, under a "
        f"capture raised: {raised!r}")
    if not (equal and finite and raised and math.isfinite(eager_loop)):
        raise RuntimeError("phase 23 control flow: cond lanes "
                           f"{gl} / {el}, finite {finite}, while_loop "
                           f"under capture raised {raised!r}")
    return {"cond_losses": gl, "cond_lanes_bitwise": equal,
            "while_loop_capture_raises": raised}


def crf_tagger_phase(torch, fa_mod, dev, smi, reset_counters,
                     read_counters, cfg=None):
    """Phase 23 (module docstring) on BERT-base (``cfg``, by default
    ``BertConfig()``): returns (results, launches by path, B1-B3 launches
    by type)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.models import BertConfig
    ct = _op_table()
    cfg = BertConfig() if cfg is None else cfg
    rng = np.random.default_rng(23)
    n_rows = CRF_BATCH * (1 + CRF_EVAL_BATCHES)
    lens = rng.integers(CRF_SEQ // 2, CRF_SEQ + 1, n_rows)
    ids = rng.integers(0, cfg.vocab_size, (n_rows, CRF_SEQ))
    tags = ct.iob_tags(rng, lens, CRF_SEQ)
    on = [torch.from_numpy(a).to(dev) for a in (ids, lens, tags)]
    X, Y = [t[:CRF_BATCH] for t in on[:2]], [on[2][:CRF_BATCH]]
    batches = [[t[CRF_BATCH * (i + 1):CRF_BATCH * (i + 2)] for t in on]
               for i in range(CRF_EVAL_BATCHES)]
    log(f"phase 23: BERT-base ({cfg}) + Linear({cfg.hidden_size}, "
        f"{ct.NER_TAGS}) + CRF transition create_parameter"
        f"([{ct.NER_TAGS + 2}, {ct.NER_TAGS}]), AdamW(5e-5), [{CRF_BATCH}, "
        f"{CRF_SEQ}] seeded ids, lengths {int(lens.min())}-"
        f"{int(lens.max())}, IOB tags of PER/ORG/LOC; {smi}")
    res, launches = {}, {}
    # (a) training, graphed and eager
    for lane in ("graphed", "eager"):
        model, net = _tagger(torch, ct, dev, cfg)
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        reset_counters()
        losses, walls = [], []
        with ctx:
            for _ in range(CRF_STEPS):
                sync(torch, dev)
                t0 = time.perf_counter()
                losses.append(model.train_batch(X, Y)[0])
                sync(torch, dev)
                walls.append((time.perf_counter() - t0) * 1e3)
        launches[f"crf_tagger_train_{lane}"] = read_counters()
        step_ms = float(np.median(walls[2:]))
        res[f"train_{lane}"] = {
            "losses": losses, "step_ms": step_ms,
            "tokens_per_s": CRF_BATCH * CRF_SEQ / step_ms * 1e3}
        if lane == "eager":
            # (e) the CRF's share of an eager step's device time
            with graphs.disable_graphs():
                prof = profile_train_step(
                    torch, model, None, False, "eager", batch=(X, Y),
                    count=CRF_BATCH * CRF_SEQ, op_parts=(
                        ("crf_forward", r"^crf$"),
                        ("crf_backward", "link:crf")),
                    labels=((paddle.ops, "linear_chain_crf", "crf"),))
            by = prof["device_ms_by_part"]
            crf_ms = by["crf_forward"] + by["crf_backward"]
            res["crf_share"] = {
                "crf_forward_ms": by["crf_forward"],
                "crf_backward_ms": by["crf_backward"],
                "step_device_ms": prof["device_busy_ms"],
                "share": crf_ms / prof["device_busy_ms"],
                "eager_step_wall_ms": prof["step_ms"],
                "kernels_per_step": prof["kernels_per_step"]}
        else:
            tagger, tagger_net = model, net
            continue
        model._invalidate_compiled()
        del model, net
    g, e = res["train_graphed"]["losses"], res["train_eager"]["losses"]
    res["train_lanes_bitwise"] = g == e
    log(f"tagger train_batch: losses {[round(v, 4) for v in g]} graphed, "
        + ("bitwise equal to eager" if g == e else f"eager {e}")
        + f"; step {res['train_graphed']['step_ms']:.2f} ms graphed, "
        f"{res['train_eager']['step_ms']:.2f} ms eager "
        f"({res['train_graphed']['tokens_per_s']:.0f} / "
        f"{res['train_eager']['tokens_per_s']:.0f} tokens/s); the CRF "
        f"(forward {res['crf_share']['crf_forward_ms']:.3f} + backward "
        f"{res['crf_share']['crf_backward_ms']:.3f} ms) is "
        f"{100 * res['crf_share']['share']:.1f}% of an eager step's "
        f"{res['crf_share']['step_device_ms']:.2f} device ms")
    if g != e or not all(math.isfinite(v) for v in g):
        raise RuntimeError(f"phase 23: tagger lanes {g} graphed, {e} eager")
    for lane in ("graphed", "eager"):
        if any(launches[f"crf_tagger_train_{lane}"].values()):
            raise RuntimeError(f"a port kernel launched on the tagger's "
                               f"{lane} training path (dropout trains: "
                               f"attention is dense)")
    # (b) evaluate and predict through their captured programs
    per_batch = cfg.num_layers
    reset_counters()
    ev = {}
    for lane in ("capture", "graphed", "eager"):
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        before = fa_mod.flash_attention_fwd.launches
        with ctx:
            logs, ms = _timed(torch, lambda: tagger.evaluate(
                batches, verbose=0))
        ev[lane] = {"loss": logs["loss"], "ms": ms,
                    "b1": fa_mod.flash_attention_fwd.launches - before}
    launches["crf_tagger_evaluate"] = read_counters()
    reset_counters()
    pred = {}
    for lane in ("capture", "graphed", "eager"):
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        before = fa_mod.flash_attention_fwd.launches
        with ctx:
            outs, ms = _timed(torch, lambda: tagger.predict(
                batches, verbose=0))
        pred[lane] = {"outs": outs, "ms": ms,
                      "b1": fa_mod.flash_attention_fwd.launches - before}
    launches["crf_tagger_predict"] = read_counters()
    by_dtype = {c.__name__: dict(c.launches_by_dtype)
                for c in _counters(fa_mod)}
    want = per_batch * CRF_EVAL_BATCHES
    got_b1 = [ev[k]["b1"] for k in ev] + [pred[k]["b1"] for k in pred]
    n_tok = CRF_EVAL_BATCHES * CRF_BATCH * CRF_SEQ
    # (c) the captured predict's paths against the eager lane's
    same_paths = all(
        np.array_equal(a[2], b[2]) for a, b in zip(
            pred["graphed"]["outs"], pred["eager"]["outs"]))
    paths = np.concatenate([o[2] for o in pred["graphed"]["outs"]])
    lens_eval = lens[CRF_BATCH:]
    f1 = paddle.ops.chunk_eval(paths, tags[CRF_BATCH:], "IOB", ct.NER_TYPES,
                               lens_eval)
    # (d) crf_decoding on the card against the CPU on the same emissions
    em = np.concatenate([o[0] for o in pred["graphed"]["outs"]])
    tr = tagger.network.transition.detach().cpu().numpy()
    cpu_paths = paddle.ops.crf_decoding(
        torch.from_numpy(em), torch.from_numpy(tr),
        length=torch.from_numpy(lens_eval)).numpy()
    differ = np.nonzero((cpu_paths != paths).any(1))[0]
    s_card = _path_scores(em, tr, paths, lens_eval)
    s_cpu = _path_scores(em, tr, cpu_paths, lens_eval)
    rel = np.abs(s_card - s_cpu) / np.abs(s_cpu)
    near = [(int(r), float(rel[r])) for r in differ]
    res.update(
        evaluate={k: {"loss": v["loss"], "ms": v["ms"], "b1": v["b1"]}
                  for k, v in ev.items()},
        eval_losses_bitwise=ev["graphed"]["loss"] == ev["eager"]["loss"],
        predict={k: {"ms": v["ms"], "b1": v["b1"],
                     "tokens_per_s": n_tok / v["ms"] * 1e3}
                 for k, v in pred.items()},
        predict_paths_bitwise=same_paths, b1_per_batch=per_batch,
        chunk_eval={"precision": f1[0], "recall": f1[1], "f1": f1[2],
                    "infer_chunks": f1[3], "label_chunks": f1[4],
                    "correct_chunks": f1[5]},
        card_vs_cpu_paths={"rows": len(paths), "differ": near})
    log(f"tagger evaluate: loss {ev['graphed']['loss']!r} graphed, "
        f"{ev['eager']['loss']!r} eager, {ev['graphed']['ms']:.1f} / "
        f"{ev['eager']['ms']:.1f} ms; predict "
        f"{res['predict']['graphed']['tokens_per_s']:.0f} tokens/s graphed, "
        f"{res['predict']['eager']['tokens_per_s']:.0f} eager; B1 {got_b1} "
        f"in the capture, graphed and eager calls of evaluate then predict "
        f"({per_batch} a batch); paths "
        f"{'bitwise equal' if same_paths else 'DIFFER'} graphed vs eager; "
        f"card vs CPU crf_decoding: {len(near)} of {len(paths)} rows "
        f"differ {near}; chunk_eval F1 {f1[2]:.4f} (random weights)")
    if got_b1 != [want] * 6 or not same_paths or \
            not res["eval_losses_bitwise"] or any(r > 1e-5 for _, r in near):
        raise RuntimeError(f"phase 23: B1 {got_b1} (want {want} each), "
                           f"predict paths equal {same_paths}, eval losses "
                           f"equal {res['eval_losses_bitwise']}, card vs "
                           f"CPU paths {near}")
    tagger._invalidate_compiled()
    del tagger, tagger_net, pred
    release_memory(torch)
    res["op_table"] = structured_ops_on_the_card(torch, ct)
    reset_counters()
    res["control_flow"] = cond_capture_lane(torch, ct, dev)
    launches["cond_train_batch"] = read_counters()
    release_memory(torch)
    return res, launches, by_dtype


# -- phase 24: GPT-3 1.3B decoded by beam search ---------------------------------

#: prompts, their length, beams and decode steps
BEAM_B, BEAM_PROMPT, BEAM_K, BEAM_STEPS = 2, 64, 4, 32
#: relative tolerance of the two cells' final scores
BEAM_SCORE_TOL = 1e-4


def beam_replay(torch, logps, B, K, end):
    """``dynamic_decode``'s selection replayed on a cell's recorded
    log-probabilities (``[B * K, V]`` a step): per step (tokens, parents,
    the top K + 1 candidate scores), and the final scores."""
    dev = logps[0].device
    log_probs = torch.zeros((B, K), device=dev)
    log_probs[:, 1:] = -1e9
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    steps = []
    for lp in logps:
        V = lp.shape[-1]
        fmask = torch.full((V,), -1e9, device=dev)
        fmask[end] = 0.0
        lp = torch.where(finished[..., None], fmask, lp.reshape(B, K, V))
        vals, idx = torch.sort((log_probs[..., None] + lp).reshape(B, K * V),
                               dim=1, descending=True, stable=True)
        parent, token = idx[:, :K] // V, idx[:, :K] % V
        log_probs = vals[:, :K]
        finished = torch.take_along_dim(finished, parent, 1) | (token == end)
        steps.append((token, parent, vals[:, :K + 1]))
    return steps, log_probs


def beam_near_ties(torch, rec_a, rec_b, B, K, end):
    """The beam near-tie rule between two cells' recorded steps: per batch
    row, the first step whose selection parts (tokens or parents) and,
    there, the smallest gap between adjacent candidates of the top K + 1,
    which must not exceed the cells' accumulated log-probability
    difference (both cells scored the same histories until then). Returns
    [(row, step, gap, noise)]; raises where a gap exceeds its noise."""
    sa, _ = beam_replay(torch, rec_a, B, K, end)
    sb, _ = beam_replay(torch, rec_b, B, K, end)
    out = []
    for b in range(B):
        noise = 0.0
        for t, ((ta, pa, va), (tb, pb, _)) in enumerate(zip(sa, sb)):
            rows = slice(b * K, (b + 1) * K)
            noise += float((rec_a[t][rows] - rec_b[t][rows]).abs().max())
            if torch.equal(ta[b], tb[b]) and torch.equal(pa[b], pb[b]):
                continue
            gap = float((va[b, :-1] - va[b, 1:]).min())
            out.append((b, t, gap, 2 * noise))
            if gap > 2 * noise:
                raise RuntimeError(
                    f"beam search: row {b} parts between the cells at step "
                    f"{t} where the nearest candidates lie {gap:.3e} apart, "
                    f"beyond the cells' difference {2 * noise:.3e}")
            break
    return out


def beam_phase(torch, fa_mod, dev, smi, reset_counters, read_counters,
               cfg=CFG_13B):
    """Phase 24 (module docstring) on the GPT of ``cfg`` (GPT-3 1.3B):
    returns (results, launches by path, B1-B3 launches by type)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    ct = _op_table()
    model = GPTForCausalLM(GPTConfig(**cfg, attn_impl="flash"),
                           device=dev, seed=0).eval()
    rng = np.random.default_rng(24)
    prompts = rng.integers(0, cfg["vocab_size"], (BEAM_B, BEAM_PROMPT))
    start = int(prompts[0, -1])
    prompts[:, -1] = start
    end = cfg["vocab_size"] - 1
    log(f"phase 24: GPT-3 1.3B (seed 0) beam search, {BEAM_B} prompts of "
        f"{BEAM_PROMPT} seeded tokens ending in start token {start}, "
        f"{BEAM_K} beams, {BEAM_STEPS} steps, end token {end}; {smi}")
    res, launches, recs = {}, {}, {}
    for name, cached in (("cached", True), ("full_prefix", False)):
        rec = []
        with torch.no_grad():
            cell, inits = ct.gpt_beam_cells(paddle, model, prompts, cached)

            def recorded(ids, states, cell=cell, rec=rec):
                logits, states = cell(ids, states)
                rec.append(torch.log_softmax(logits._data.float(), dim=-1))
                return logits, states
            dec = paddle.nn.BeamSearchDecoder(recorded, start, end, BEAM_K)
            paddle.nn.dynamic_decode(dec, inits=inits, max_step_num=2)
            rec.clear()
            reset_counters()
            sync(torch, dev)
            t0 = time.perf_counter()
            ids, scores = paddle.nn.dynamic_decode(dec, inits=inits,
                                                   max_step_num=BEAM_STEPS)
            sync(torch, dev)
            wall = (time.perf_counter() - t0) * 1e3
        launches[f"beam_{name}"] = read_counters()
        _, replayed = beam_replay(torch, rec, BEAM_B, BEAM_K, end)
        if not torch.equal(replayed, scores._data):
            raise RuntimeError(f"phase 24 {name}: the replayed selection "
                               f"does not give dynamic_decode's scores")
        recs[name] = rec
        res[name] = {"ids": ids.numpy(), "scores": scores.numpy(),
                     "wall_ms": wall, "step_ms": wall / BEAM_STEPS,
                     "beam_tokens_per_s": BEAM_B * BEAM_K * BEAM_STEPS
                     / wall * 1e3,
                     "b1": launches[f"beam_{name}"]["flash_attention_fwd"]}
        log(f"beam {name}: {wall:.1f} ms for {BEAM_STEPS} steps "
            f"({res[name]['step_ms']:.2f} ms a step, "
            f"{res[name]['beam_tokens_per_s']:.0f} beam tokens/s), B1 "
            f"{res[name]['b1']} launches; best scores "
            f"{res[name]['scores'][:, 0].tolist()}")
    by_dtype = {c.__name__: dict(c.launches_by_dtype)
                for c in _counters(fa_mod)}
    near = beam_near_ties(torch, recs["cached"], recs["full_prefix"],
                          BEAM_B, BEAM_K, end)
    a, b = res["cached"], res["full_prefix"]
    parted = {r for r, *_ in near}
    same = [r for r in range(BEAM_B) if r not in parted]
    ids_equal = all(np.array_equal(a["ids"][r], b["ids"][r]) for r in same)
    rel = max([float(np.abs(a["scores"][r] - b["scores"][r]).max()
                     / np.abs(b["scores"][r]).max()) for r in same] or [0.0])
    want_b1 = cfg["num_layers"] * BEAM_STEPS
    log(f"beam cells: ids {'equal' if ids_equal else 'DIFFER'} on rows "
        f"{same}, near ties {near}; scores within {rel:.3e} relative; B1 "
        f"{a['b1']} cached (0 expected), {b['b1']} full prefix "
        f"({want_b1} expected)")
    if not ids_equal or rel > BEAM_SCORE_TOL or a["b1"] != 0 or \
            b["b1"] != want_b1:
        raise RuntimeError(f"phase 24: ids equal {ids_equal}, scores "
                           f"{rel:.3e}, B1 {a['b1']} / {b['b1']}")
    for k in ("cached", "full_prefix"):
        res[k]["ids"] = res[k]["ids"].tolist()
        res[k]["scores"] = res[k]["scores"].tolist()
    res.update(near_ties=near, scores_rel_diff=rel)
    del model, recs
    release_memory(torch)
    return res, launches, by_dtype


# -- phase 25: MobileNetV3-Large trained and served (BASELINE config 2) -------

#: PaddleClas's MobileNetV3_large_x1_0 at full width (scale 1.0, 1000
#: classes, 224 x 224): train batch and steps, the predict batches and the
#: engine's single-image requests
MB_BATCH, MB_SIZE, MB_CLASSES, MB_STEPS = 128, 224, 1000, 10
MB_PRED_BATCH, MB_PRED_BATCHES, MB_REQUESTS = 64, 4, 64
#: the engine's answer against the direct predict: the same top-1, or a
#: near tie in the direct predict's logits (top two within this of the
#: largest |logit|), where batches of another size may round the other way
MB_NEAR_TIE = 1e-4


def _mobilenet_model(torch, dev):
    """MobileNetV3-Large from seed 0 under ``Model`` with Momentum(0.9),
    L2Decay(2e-5) and a CosineAnnealingDecay(0.05) schedule over the
    phase's steps (PaddleClas's recipe, its learning rate scaled to batch
    128); returns (model, schedule)."""
    from paddle_tpu_torch import Model, nn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision.models import mobilenet_v3_large
    net = mobilenet_v3_large(num_classes=MB_CLASSES, device=dev, seed=0)
    sched = CosineAnnealingDecay(0.05, T_max=MB_STEPS)
    model = Model(net, device=dev)
    model.prepare(Momentum(learning_rate=sched, momentum=0.9,
                           parameters=net.parameters(),
                           weight_decay=L2Decay(2e-5), device=dev),
                  nn.CrossEntropyLoss())
    return model, sched


def a3_table_on_the_card(torch, ct):
    """Phase 25c: the A3 functionals' op cases (``ct.A3``) and every case
    of the A3 layer table (``ct.LAYER_CASES``) on CUDA against the CPU,
    forward and gradient (and a layer's state after the call); ``n held
    of n``."""
    import paddle_tpu_torch as paddle
    t0 = time.perf_counter()
    ops = [c for c in ct.CUDA_CASES if c.module in ct.A3]
    held, failed = cases_on_the_card(ct, ops)
    for case in ct.LAYER_CASES:
        try:
            ct.layer_case_holds(case, paddle)
            held += 1
        except Exception as e:   # noqa: BLE001 (every case is reported)
            failed.append(f"{case.name}: {str(e).splitlines()[0][:200]}")
    n = len(ops) + len(ct.LAYER_CASES)
    log(f"A3 table on the card: {held} held of {n} ({len(ops)} op cases, "
        f"{len(ct.LAYER_CASES)} layer cases; "
        f"{time.perf_counter() - t0:.1f} s)")
    for f in failed:
        log(f"  A3 case failed: {f}")
    if failed:
        raise RuntimeError(f"phase 25 A3 table: {len(failed)} of {n} cases "
                           f"failed")
    return {"held": held, "cases": n, "op_cases": len(ops),
            "layer_cases": len(ct.LAYER_CASES)}


def _mobilenet_lane(torch, dev, x, y, prec, lane):
    """One training lane: P.seed(0), a fresh model, MB_STEPS train_batch
    calls (the schedule stepped after each), graphed or eager, under
    cuDNN's deterministic algorithms. Returns (results, model, buffers
    after the steps)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    cast = amp.auto_cast if prec == "o1" else contextlib.nullcontext
    torch.cuda.reset_peak_memory_stats()
    P.seed(0)
    model, sched = _mobilenet_model(torch, dev)
    ctx = graphs.disable_graphs() if lane == "eager" \
        else contextlib.nullcontext()
    losses, walls = [], []
    with ctx, cudnn_deterministic(torch):
        for _ in range(MB_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cast():
                losses.append(model.train_batch([x], [y])[0])
            walls.append((time.perf_counter() - t0) * 1e3)
            sched.step()
    buffers = {k: b.detach().clone()
               for k, b in model.network.named_buffers()}
    step_ms = float(np.median(walls[2:]))
    res = {"losses": losses, "step_wall_ms": walls, "step_ms": step_ms,
           "imgs_per_s": MB_BATCH / step_ms * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"MobileNetV3-Large {prec} {lane} lane: losses "
        f"{[round(v, 6) for v in losses]}, step {step_ms:.1f} ms "
        f"({res['imgs_per_s']:.0f} imgs/s), peak {res['peak_gib']:.2f} GiB")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"MobileNetV3-Large {prec} {lane}: {losses}")
    if lane == "graphed":
        res.update(program_report(model, f"MobileNetV3-Large {prec} "
                                  f"graphed lane", MB_STEPS))
    return res, model, buffers


def _stacked(outs):
    """The batches of a one-output network (``Model.predict``'s, or the
    engine's answers), stacked."""
    return np.concatenate([o[0] if isinstance(o, (list, tuple)) else o
                           for o in outs])


def _top1_agree(got, ref):
    """(rows whose top-1 differs and is no near tie, near ties) of logits
    ``got`` against ``ref``."""
    bad, near = [], []
    for i in np.nonzero(got.argmax(1) != ref.argmax(1))[0]:
        top2 = np.sort(ref[i])[-2:]
        if top2[1] - top2[0] <= MB_NEAR_TIE * np.abs(ref[i]).max():
            near.append(int(i))
        else:
            bad.append(int(i))
    return bad, near


def mobilenet_serving(torch, model, dev):
    """Phase 25b: ``Model.predict`` over MB_PRED_BATCHES batches of
    MB_PRED_BATCH through its captured program (capture, graphed, eager;
    the graphed top-1 ids equal to the eager lane's), then MB_REQUESTS
    single-image requests at once through the dynamic-batching ``Engine``
    over the same network in eval mode, each answer's top-1 equal to the
    direct predict's (or a near tie), with p50 and p99 latency."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving import Engine, EngineConfig
    rng = np.random.default_rng(25)
    imgs = rng.random((MB_PRED_BATCHES * MB_PRED_BATCH, 3, MB_SIZE, MB_SIZE),
                      dtype=np.float32)
    batches = [[torch.from_numpy(imgs[i:i + MB_PRED_BATCH]).to(dev)]
               for i in range(0, len(imgs), MB_PRED_BATCH)]
    model.network.eval()
    pred = {}
    for lane in ("capture", "graphed", "eager"):
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx, cudnn_deterministic(torch):
            outs, ms = _timed(torch, lambda: model.predict(batches,
                                                           verbose=0))
        pred[lane] = {"logits": _stacked(outs), "ms": ms,
                      "imgs_per_s": len(imgs) / ms * 1e3}
    same = bool((pred["graphed"]["logits"].argmax(1)
                 == pred["eager"]["logits"].argmax(1)).all())
    net = model.network

    def serve(img):
        with torch.inference_mode():
            return net(img)
    eng = Engine(serve, EngineConfig(batch_buckets=(1, 2, 4, 8, 16, 32, 64),
                                     max_batch=64, max_batch_delay=0.005),
                 device=dev)
    eng.submit([imgs[:8]]).result(timeout=600)     # the worker's warm-up
    done = []
    t0 = time.perf_counter()
    futs = eng.submit_many([[imgs[i:i + 1]] for i in range(MB_REQUESTS)])
    for f in futs:
        f.add_done_callback(lambda _f: done.append(time.perf_counter()))
    answers = _stacked([f.result(timeout=600) for f in futs])
    wall = time.perf_counter() - t0
    batches_run = eng.stats()["stats"]["serving.batches"] - 1
    eng.drain(timeout=60)
    lat = (np.array(done) - t0) * 1e3
    bad, near = _top1_agree(answers, pred["eager"]["logits"][:MB_REQUESTS])
    res = {"predict": {k: {"ms": v["ms"], "imgs_per_s": v["imgs_per_s"]}
                       for k, v in pred.items()},
           "predict_top1_graphed_equals_eager": same,
           "engine": {"requests": MB_REQUESTS, "batches": batches_run,
                      "wall_s": wall, "latency_ms_p50": float(
                          np.percentile(lat, 50)),
                      "latency_ms_p99": float(np.percentile(lat, 99)),
                      "top1_differs": bad, "near_ties": near}}
    log(f"MobileNetV3-Large predict {len(imgs)} images in batches of "
        f"{MB_PRED_BATCH}: {pred['graphed']['imgs_per_s']:.0f} imgs/s "
        f"graphed, {pred['eager']['imgs_per_s']:.0f} eager (capture call "
        f"{pred['capture']['ms']:.1f} ms); top-1 graphed "
        f"{'equals' if same else 'DIFFERS from'} eager; engine: "
        f"{MB_REQUESTS} single-image requests in {batches_run} batches, "
        f"{wall:.3f} s, latency p50 {res['engine']['latency_ms_p50']:.1f} "
        f"ms p99 {res['engine']['latency_ms_p99']:.1f} ms; top-1 against "
        f"the direct predict: {MB_REQUESTS - len(bad) - len(near)} equal, "
        f"near ties {near}, differing {bad}")
    if not same or bad:
        raise RuntimeError(f"phase 25 serving: predict top-1 graphed vs "
                           f"eager equal {same}, engine rows {bad} differ")
    return res


def mobilenet_phase(torch, fa_mod, dev, smi, reset_counters,
                    read_counters):
    """Phase 25 (module docstring): returns (results, launches by
    path)."""
    ct = _op_table()
    rng = np.random.default_rng(250)
    x = torch.from_numpy(rng.random((MB_BATCH, 3, MB_SIZE, MB_SIZE),
                                    dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, MB_CLASSES, (MB_BATCH,))).to(dev)
    log(f"phase 25: MobileNetV3-Large (scale 1.0, {MB_CLASSES} classes), "
        f"batch {MB_BATCH} at {MB_SIZE}x{MB_SIZE}, Momentum(0.9), "
        f"L2Decay(2e-5), CosineAnnealingDecay(0.05, {MB_STEPS}), random "
        f"weights (seed 0), cuDNN deterministic; {smi}")
    res, launches, kept = {}, {}, None
    for prec in ("fp32", "o1"):
        lanes = {}
        for lane in ("graphed", "eager"):
            reset_counters()
            out, model, buf = _mobilenet_lane(torch, dev, x, y, prec, lane)
            launches[f"mobilenet_train_{prec}_{lane}"] = read_counters()
            lanes[lane] = (out, buf)
            if prec == "fp32" and lane == "graphed":
                kept = model
            else:
                model._invalidate_compiled()
            del model
            release_memory(torch)
        (g, gbuf), (e, ebuf) = lanes["graphed"], lanes["eager"]
        g.update(check_lane_losses(g["losses"], e["losses"],
                                   f"MobileNetV3-Large {prec} train_batch, "
                                   f"graphed vs eager lane"))
        same, worst = _state_diff(torch, gbuf, ebuf)
        log(f"MobileNetV3-Large {prec} BN running statistics, graphed vs "
            f"eager: " + ("bitwise equal" if same else
                          f"worst relative {worst:.3e}"))
        if worst > LANE_TOL:
            raise RuntimeError(f"MobileNetV3-Large {prec}: buffers differ "
                               f"by {worst}")
        g["buffers_bitwise"] = same
        res[f"train_{prec}"] = {"graphed": g, "eager": e}
    reset_counters()
    res["serving"] = mobilenet_serving(torch, kept, dev)
    res["serving"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    launches["mobilenet_serving"] = read_counters()
    kept._invalidate_compiled()
    del kept
    release_memory(torch)
    reset_counters()
    res["a3_table"] = a3_table_on_the_card(torch, ct)
    launches["a3_table"] = read_counters()
    log(f"MobileNetV3-Large: training {res['train_fp32']['graphed']['imgs_per_s']:.0f} "
        f"imgs/s fp32, {res['train_o1']['graphed']['imgs_per_s']:.0f} O1 "
        f"(graphed); predict "
        f"{res['serving']['predict']['graphed']['imgs_per_s']:.0f} imgs/s; "
        f"engine p50 {res['serving']['engine']['latency_ms_p50']:.1f} ms, "
        f"p99 {res['serving']['engine']['latency_ms_p99']:.1f} ms; peak "
        f"{max(res['train_fp32']['graphed']['peak_gib'], res['train_o1']['graphed']['peak_gib']):.2f} "
        f"GiB training, {res['serving']['peak_gib']:.2f} GiB serving; {smi}")
    release_memory(torch)
    return res, launches, {}


# -- phase 26: a ViT-B/16 written from nn layers --------------------------------

#: PaddleClas's ViT_base_patch16_224: the O1 train batch and steps, the
#: predict batches
VIT_BATCH, VIT_STEPS, VIT_PRED_BATCHES = 64, 10, 2
VIT_DEPTH = 12


def _vit_model(torch, ct, dev, impl="auto"):
    """``ct.vit`` at its defaults (ViT-B/16, 1000 classes) with
    ``attn_impl=impl``, the generator seeded 26 first (so every build
    draws the same weights), under ``Model`` with AdamW(5e-5, weight
    decay 0.3: PaddleClas's, its rate scaled to batch 64)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.optimizer import AdamW
    paddle.seed(26)
    net = ct.vit(paddle, attn_impl=impl)
    model = Model(net, device=dev)
    model.prepare(AdamW(learning_rate=5e-5, parameters=net.parameters(),
                        weight_decay=0.3, device=dev),
                  paddle.nn.CrossEntropyLoss())
    return model, net


def _per_step(fa_mod, fn, steps):
    """``fn()`` ``steps`` times; B1-B3's launches of each call."""
    counts = []
    for _ in range(steps):
        before = [c.launches for c in _counters(fa_mod)]
        fn()
        counts.append([c.launches - b for c, b in zip(_counters(fa_mod),
                                                      before)])
    return counts


def vit_flash_vs_dense(torch, ct, dev, x, y):
    """Phase 26b: one fp32 step of the ViT with ``attn_impl="flash"``
    against ``"dense"`` from the same weights, on the eager lane: the
    losses within 1e-4 relative, every gradient within GRAD_TOL of its
    largest entry but ``k_proj.bias``'s (zero but for rounding: held to
    "tiny" against ``k_proj.weight``'s)."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.nn import functional as F
    out = {}
    with graphs.disable_graphs():
        for impl in ("flash", "dense"):
            _, net = _vit_model(torch, ct, dev, impl)
            loss = F.cross_entropy(net(x), y)
            loss.backward()
            out[impl] = (float(loss.detach()), {n: p.grad.detach().clone()
                                       for n, p in net.named_parameters()})
            del net
            release_memory(torch)
    (lf, gf), (ld, gd) = out["flash"], out["dense"]
    rel_loss = abs(lf - ld) / abs(ld)
    worst, worst_name, tiny = 0.0, None, 0.0
    for n, g in gd.items():
        d = float((gf[n] - g).abs().max())
        if n.endswith("k_proj.bias"):
            w = n.replace("k_proj.bias", "k_proj.weight")
            tiny = max(tiny, max(float(gf[n].abs().max()),
                                 float(g.abs().max()))
                       / float(gd[w].abs().max()))
            continue
        r = d / (float(g.abs().max()) or 1.0)
        if r > worst:
            worst, worst_name = r, n
    log(f"ViT-B/16 fp32 step, flash (B1-B3) vs dense: loss {lf!r} vs "
        f"{ld!r} (relative {rel_loss:.3e}, tol 1e-4); worst gradient "
        f"{worst:.3e} of its max ({worst_name}, tol {GRAD_TOL}); k_proj "
        f"bias gradients {tiny:.3e} of k_proj.weight's (zero but for "
        f"rounding)")
    if rel_loss > 1e-4 or worst > GRAD_TOL or tiny > 1e-3:
        raise RuntimeError(f"phase 26 flash vs dense: loss {rel_loss}, "
                           f"gradient {worst} ({worst_name}), k_proj bias "
                           f"{tiny}")
    return {"loss_flash": lf, "loss_dense": ld, "loss_rel": rel_loss,
            "grad_worst_rel": worst, "grad_worst_name": worst_name,
            "k_proj_bias_rel": tiny}


def vit_phase(torch, fa_mod, dev, smi, reset_counters, read_counters):
    """Phase 26 (module docstring): returns (results, launches by path,
    B1-B3 launches by type)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    ct = _op_table()
    rng = np.random.default_rng(26)
    imgs = rng.random(((1 + VIT_PRED_BATCHES) * VIT_BATCH, 3, 224, 224),
                      dtype=np.float32)
    x = torch.from_numpy(imgs[:VIT_BATCH]).to(dev)
    y = torch.from_numpy(rng.integers(0, 1000, (VIT_BATCH,))).to(dev)
    log(f"phase 26: ViT-B/16 from nn layers (Conv2D patches, LayerList of "
        f"{VIT_DEPTH} pre-norm blocks, MultiHeadAttention, GELU, Softmax "
        f"in predict; PaddleClas ViT_base_patch16_224), batch {VIT_BATCH}, "
        f"S = 197, AdamW(5e-5, weight decay 0.3), O1 bf16, random weights "
        f"(seed 26); {smi}")
    res, launches = {}, {}
    for lane in ("graphed", "eager"):
        model, net = _vit_model(torch, ct, dev)
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        reset_counters()
        losses, walls = [], []

        def step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp.auto_cast():
                losses.append(model.train_batch([x], [y])[0])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with ctx:
            counts = _per_step(fa_mod, step, VIT_STEPS)
        launches[f"vit_train_o1_{lane}"] = read_counters()
        step_ms = float(np.median(walls[2:]))
        res[f"train_o1_{lane}"] = {
            "losses": losses, "step_ms": step_ms,
            "imgs_per_s": VIT_BATCH / step_ms * 1e3,
            "b1_b3_per_step": counts,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"ViT-B/16 O1 {lane} lane: losses "
            f"{[round(v, 6) for v in losses]}, step {step_ms:.1f} ms "
            f"({VIT_BATCH / step_ms * 1e3:.0f} imgs/s), B1/B2/B3 launches a "
            f"step {counts}")
        if any(c != [VIT_DEPTH] * 3 for c in counts):
            raise RuntimeError(f"ViT {lane}: B1-B3 launched {counts} a "
                               f"step, not {VIT_DEPTH} each")
        if lane == "graphed":
            res["train_o1_graphed"].update(program_report(
                model, "ViT-B/16 O1 graphed lane", VIT_STEPS))
            # (d) the B1-B3 share of the O1 step's device time
            prof = profile_train_step(
                torch, model, None, True, "graphed", batch=([x], [y]),
                count=VIT_BATCH, unit="imgs", parts=GPT_PARTS)
            by = prof["device_ms_by_part"]
            res["o1_profile"] = {
                "step_device_ms": prof["device_busy_ms"],
                "flash_b1_b3_ms": by["flash_B1_B3"], "gemm_ms": by["gemm"],
                "flash_share": by["flash_B1_B3"] / prof["device_busy_ms"],
                "idle_share": prof["idle_share"],
                "kernels_per_step": prof["kernels_per_step"]}
            vit_model, vit_net = model, net
            continue
        model._invalidate_compiled()
        del model, net
        release_memory(torch)
    g, e = res["train_o1_graphed"], res["train_o1_eager"]
    g.update(check_lane_losses(g["losses"], e["losses"],
                               "ViT-B/16 O1 train_batch, graphed vs eager "
                               "lane"))
    if not g["bitwise"]:
        raise RuntimeError(f"ViT O1 lanes not bitwise: {g['losses']} vs "
                           f"{e['losses']}")
    by_dtype = {c.__name__: dict(c.launches_by_dtype)
                for c in _counters(fa_mod)}
    # (c) predict through its captured program: B1 once a block a batch
    batches = [[torch.from_numpy(imgs[VIT_BATCH * (i + 1):
                                      VIT_BATCH * (i + 2)]).to(dev)]
               for i in range(VIT_PRED_BATCHES)]
    vit_net.eval()
    reset_counters()
    pred = {}
    for lane in ("capture", "graphed", "eager"):
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        before = fa_mod.flash_attention_fwd.launches
        with ctx:
            outs, ms = _timed(torch, lambda: vit_model.predict(batches,
                                                               verbose=0))
        pred[lane] = {"probs": _stacked(outs), "ms": ms,
                      "b1": fa_mod.flash_attention_fwd.launches - before,
                      "imgs_per_s": VIT_PRED_BATCHES * VIT_BATCH / ms * 1e3}
    launches["vit_predict"] = read_counters()
    want = VIT_DEPTH * VIT_PRED_BATCHES
    got_b1 = [p["b1"] for p in pred.values()]
    same = bool((pred["graphed"]["probs"].argmax(1)
                 == pred["eager"]["probs"].argmax(1)).all())
    sums = float(np.abs(pred["graphed"]["probs"].sum(1) - 1).max())
    res["predict"] = {k: {"ms": v["ms"], "b1": v["b1"],
                          "imgs_per_s": v["imgs_per_s"]}
                      for k, v in pred.items()}
    res["predict"]["top1_graphed_equals_eager"] = same
    log(f"ViT-B/16 predict (Softmax) {VIT_PRED_BATCHES} batches of "
        f"{VIT_BATCH}: {pred['graphed']['imgs_per_s']:.0f} imgs/s graphed, "
        f"{pred['eager']['imgs_per_s']:.0f} eager; B1 {got_b1} in the "
        f"capture, graphed and eager calls ({want} each); top-1 "
        f"{'equal' if same else 'DIFFERS'} graphed vs eager; probabilities "
        f"sum to 1 within {sums:.1e}")
    if got_b1 != [want] * 3 or not same or sums > 1e-3:
        raise RuntimeError(f"phase 26 predict: B1 {got_b1}, top-1 equal "
                           f"{same}, sums {sums}")
    vit_model._invalidate_compiled()
    del vit_model, vit_net, pred
    release_memory(torch)
    # (b) the first training path whose backward meets a tail tile
    reset_counters()
    res["flash_vs_dense"] = vit_flash_vs_dense(torch, ct, dev, x, y)
    launches["vit_flash_vs_dense"] = read_counters()
    p = res["o1_profile"]
    log(f"ViT-B/16 O1: step {g['step_ms']:.1f} ms graphed "
        f"({g['imgs_per_s']:.0f} imgs/s), {e['step_ms']:.1f} ms eager; "
        f"B1-B3 {p['flash_b1_b3_ms']:.2f} ms of a "
        f"{p['step_device_ms']:.2f} ms device step "
        f"({100 * p['flash_share']:.1f}%), GEMMs {p['gemm_ms']:.2f} ms; "
        f"{smi}")
    release_memory(torch)
    return res, launches, by_dtype


# -- phase 27: the PTB-large LSTM language model ---------------------------

#: Zaremba, Sutskever & Vinyals 2014 (arXiv:1409.2329), "large": 35
#: unrolled steps, batch 20, vocabulary 10,000 (the network's widths are
#: ``lstm_lm``'s defaults); steps of each lane
LSTM_T, LSTM_BATCH, LSTM_VOCAB, LSTM_HIDDEN = 35, 20, 10000, 1500
LSTM_STEPS = 10


def _a9_table():
    """``tests/test_torch_a9_table.py`` (the A9 cases and user programs;
    it imports neither jax nor the JAX package)."""
    _op_table()
    import test_torch_a9_table
    return test_torch_a9_table


def _lstm_model(torch, c9, dev):
    """The LM from seed 27 under ``Model`` with SGD(1.0) and the global
    norm clipped at 10."""
    import paddle_tpu_torch as P
    P.seed(27)
    net, loss = c9.lstm_lm(P)
    model = P.Model(net, device=dev)
    model.prepare(P.optimizer.SGD(
        learning_rate=1.0, parameters=net.parameters(), device=dev,
        grad_clip=P.nn.ClipGradByGlobalNorm(10.0)), loss)
    return model


def _lstm_lane(torch, c9, dev, x, y, prec, lane):
    """LSTM_STEPS train_batch calls on fresh weights, the dropout stream
    from seed 270 (so both lanes draw the same masks), graphed or eager;
    then ``evaluate`` (dropout off) over two batches. Returns (results,
    model)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import graphs
    cast = amp.auto_cast if prec == "o1" else contextlib.nullcontext
    torch.cuda.reset_peak_memory_stats()
    model = _lstm_model(torch, c9, dev)
    P.seed(270)
    ctx = graphs.disable_graphs() if lane == "eager" \
        else contextlib.nullcontext()
    losses, walls = [], []
    with ctx:
        for t in range(LSTM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cast():
                losses.append(model.train_batch([x[t]], [y[t]])[0])
            walls.append((time.perf_counter() - t0) * 1e3)
        with cast():
            ev = model.evaluate([(x[0], y[0]), (x[1], y[1])], verbose=0)
    step_ms = float(np.median(walls[2:]))
    tokens = LSTM_BATCH * LSTM_T
    res = {"losses": losses, "step_wall_ms": walls, "step_ms": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "eval_loss": ev["loss"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"LSTM LM {prec} {lane} lane: losses "
        f"{[round(v, 6) for v in losses]}, step {step_ms:.2f} ms "
        f"({res['tokens_per_s']:.0f} tokens/s), evaluate loss "
        f"{ev['loss']!r}, peak {res['peak_gib']:.2f} GiB")
    if not all(math.isfinite(v) for v in losses) or \
            not math.isfinite(ev["loss"]):
        raise RuntimeError(f"LSTM LM {prec} {lane}: {losses}, {ev}")
    if lane == "graphed":
        res.update(program_report(model, f"LSTM LM {prec} graphed lane",
                                  LSTM_STEPS))
    return res, model


def lstm_loop_share(torch, model, x, y, prec):
    """One eager O1 or fp32 step profiled by op: the device ms of the
    recurrent loops (the ``rnn_scan_lstm`` ops' kernels, forward, and
    their backward through the autograd link) against the step's."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.ops import dispatch
    parts = (("rnn_loop_forward", r"^op::rnn_scan_lstm$"),
             ("rnn_loop_backward", "link:op::rnn_scan_lstm"))
    dispatch._PROF_ACTIVE[0] = True
    try:
        with graphs.disable_graphs():
            prof = profile_train_step(
                torch, model, None, prec == "o1", "eager",
                batch=([x[0]], [y[0]]), count=LSTM_BATCH * LSTM_T,
                op_parts=parts)
    finally:
        dispatch._PROF_ACTIVE[0] = False
    by = prof["device_ms_by_part"]
    loop = by["rnn_loop_forward"] + by["rnn_loop_backward"]
    prof["rnn_loop_ms"] = loop
    prof["rnn_loop_share"] = loop / prof["device_busy_ms"]
    log(f"LSTM LM {prec} eager step: the recurrent loops {loop:.2f} ms "
        f"(forward {by['rnn_loop_forward']:.2f}, backward "
        f"{by['rnn_loop_backward']:.2f}) of {prof['device_busy_ms']:.2f} "
        f"device ms ({100 * prof['rnn_loop_share']:.1f}%)")
    return prof


def lstm_vs_cudnn(torch, dev):
    """The port's 2-layer ``nn.LSTM`` (dropout 0) against
    ``torch.nn.LSTM`` (cuDNN) at the LM's shapes ([35, 20, 1500], time
    major), forward and backward, each captured in a CUDA graph and
    replayed, device clock behind a spin; cuDNN is a yardstick only."""
    import paddle_tpu_torch as P
    gen = torch.Generator(device="cuda").manual_seed(271)
    x = torch.randn(LSTM_T, LSTM_BATCH, LSTM_HIDDEN, device=dev,
                    generator=gen, requires_grad=True)
    g = torch.randn(LSTM_T, LSTM_BATCH, LSTM_HIDDEN, device=dev,
                    generator=gen)
    P.seed(272)
    port = P.nn.LSTM(LSTM_HIDDEN, LSTM_HIDDEN, num_layers=2,
                     time_major=True)
    ref = torch.nn.LSTM(LSTM_HIDDEN, LSTM_HIDDEN, num_layers=2).to(dev)

    def port_step():
        port(x)[0].backward(g)

    def cudnn_step():
        ref(x)[0].backward(g)

    out = {}
    for name, fn in (("port", port_step), ("cudnn", cudnn_step)):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        out[f"{name}_graphed_ms"] = time_ms(graph.replay, iters=10,
                                            spin=True)
        out[f"{name}_eager_ms"] = time_ms(fn, iters=5)
        del graph
    # the recurrent GEMMs' floor: 4 gates x (input + hidden) x hidden
    # weights, a multiply-add each, per token and layer, times 3 for the
    # backward; fp32 outside the tensor cores (TF32 is off)
    flops = 3 * 2 * 2 * 4 * (2 * LSTM_HIDDEN) * LSTM_HIDDEN * \
        LSTM_T * LSTM_BATCH
    out["bound_ms"] = flops / PEAK_FP32 * 1e3
    log(f"nn.LSTM 2x{LSTM_HIDDEN} at [{LSTM_T}, {LSTM_BATCH}] forward + "
        f"backward: the port {out['port_graphed_ms']:.3f} ms graphed "
        f"({out['port_eager_ms']:.3f} eager), torch.nn.LSTM (cuDNN, a "
        f"yardstick) {out['cudnn_graphed_ms']:.3f} ms graphed "
        f"({out['cudnn_eager_ms']:.3f} eager); fp32 FMA bound "
        f"{out['bound_ms']:.3f} ms")
    del port, ref, x, g
    return out


def rnn_table_on_the_card(torch, ct, c9):
    """Phase 27c: every case of ``RNN_CASES`` on CUDA against the CPU
    (forward, final states, gradients); ``n held of n``."""
    t0 = time.perf_counter()
    import paddle_tpu_torch as paddle
    held, failed = 0, []
    for case in c9.RNN_CASES:
        try:
            ct.layer_case_holds(case, paddle)
            held += 1
        except Exception as e:   # noqa: BLE001 (every case is reported)
            failed.append(f"{case.name}: {str(e).splitlines()[0][:200]}")
    n = len(c9.RNN_CASES)
    log(f"RNN table on the card: {held} held of {n} "
        f"({time.perf_counter() - t0:.1f} s)")
    for f in failed:
        log(f"  RNN case failed: {f}")
    if failed:
        raise RuntimeError(f"phase 27 RNN table: {len(failed)} of {n} "
                           f"cases failed")
    return {"held": held, "cases": n}


def lstm_phase(torch, fa_mod, dev, smi, reset_counters, read_counters):
    """Phase 27 (module docstring): returns (results, launches by
    path)."""
    ct, c9 = _op_table(), _a9_table()
    ids = np.random.default_rng(270).integers(
        0, LSTM_VOCAB, (LSTM_STEPS, LSTM_BATCH, LSTM_T + 1))
    x = torch.from_numpy(ids[..., :-1]).to(dev)
    y = torch.from_numpy(ids[..., 1:]).to(dev)
    log(f"phase 27: the PTB-large LSTM LM (Embedding({LSTM_VOCAB}, "
        f"{LSTM_HIDDEN}), LSTM 2x{LSTM_HIDDEN}, dropout 0.65, uniform "
        f"+-0.04, Linear({LSTM_HIDDEN}, {LSTM_VOCAB})), batch {LSTM_BATCH} "
        f"x {LSTM_T} steps, SGD(1.0), global norm clipped at 10, random "
        f"weights (seed 27); {smi}")
    res, launches = {}, {}
    for prec in ("fp32", "o1"):
        lanes = {}
        for lane in ("graphed", "eager"):
            reset_counters()
            out, model = _lstm_lane(torch, c9, dev, x, y, prec, lane)
            launches[f"lstm_train_{prec}_{lane}"] = read_counters()
            if lane == "eager":
                out["profile"] = lstm_loop_share(torch, model, x, y, prec)
            lanes[lane] = out
            model._invalidate_compiled()
            del model
            release_memory(torch)
        g, e = lanes["graphed"], lanes["eager"]
        if g["losses"] != e["losses"]:
            raise RuntimeError(f"LSTM LM {prec}: graphed losses "
                               f"{g['losses']} vs eager {e['losses']} (bitwise "
                               f"equal required)")
        if g["eval_loss"] != e["eval_loss"]:
            raise RuntimeError(f"LSTM LM {prec}: evaluate {g['eval_loss']!r} "
                               f"graphed vs {e['eval_loss']!r} eager")
        log(f"LSTM LM {prec}: graphed and eager losses bitwise equal over "
            f"{LSTM_STEPS} steps, evaluate losses equal")
        res[f"train_{prec}"] = lanes
    reset_counters()
    res["vs_cudnn"] = lstm_vs_cudnn(torch, dev)
    launches["lstm_vs_cudnn"] = read_counters()
    release_memory(torch)
    reset_counters()
    res["rnn_table"] = rnn_table_on_the_card(torch, ct, c9)
    launches["rnn_table"] = read_counters()
    log(f"LSTM LM: fp32 {res['train_fp32']['graphed']['tokens_per_s']:.0f} "
        f"tokens/s graphed ({res['train_fp32']['graphed']['step_ms']:.2f} ms "
        f"a step), {res['train_fp32']['eager']['tokens_per_s']:.0f} eager; "
        f"O1 {res['train_o1']['graphed']['tokens_per_s']:.0f} graphed "
        f"({res['train_o1']['graphed']['step_ms']:.2f} ms), "
        f"{res['train_o1']['eager']['tokens_per_s']:.0f} eager; peak "
        f"{res['train_fp32']['graphed']['peak_gib']:.2f} GiB fp32; {smi}")
    release_memory(torch)
    return res, launches, {}


# -- phase 28: Faster R-CNN R50-FPN inference ----------------------------------

#: PaddleDetection release/2.0 faster_rcnn_r50_fpn's test reader: a batch
#: of 2 images of 800 x 1344, 80 classes
FRCNN_BATCH, FRCNN_H, FRCNN_W, FRCNN_CLASSES = 2, 800, 1344, 80
#: detection ops held CUDA vs CPU: values at this tolerance
FRCNN_TOL = 1e-5


def _frcnn_model(torch, dev):
    """ResNet-50 C2-C5 (the port's ``resnet50``), an FPN (lateral 1x1
    and output 3x3 convolutions 256 wide, P6 by ``max_pool2d`` of P5 at
    stride 2), the RPN head (a 3x3 convolution, then 1x1 ones to 3
    scores and 12 deltas), and the box head (``TwoFCHead``: two Linear
    of 1024 over the 7x7 RoI features) with its class scores (81) and
    box deltas (4, class-agnostic: the port's ``multiclass_nms`` takes one
    box a candidate, as the JAX package's). Random weights: the backbone
    from seed 0, the rest from ``paddle.seed(28)``."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.vision.models import resnet50
    nn, F = P.nn, P.nn.functional
    P.seed(28)

    class FasterRCNN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.backbone = resnet50(num_classes=-1, with_pool=False,
                                     device=dev, seed=0)
            self.lateral = nn.LayerList([nn.Conv2D(c, 256, 1)
                                         for c in (256, 512, 1024, 2048)])
            self.fpn_out = nn.LayerList([nn.Conv2D(256, 256, 3, padding=1)
                                         for _ in range(4)])
            self.rpn_conv = nn.Conv2D(256, 256, 3, padding=1)
            self.rpn_cls = nn.Conv2D(256, 3, 1)
            self.rpn_box = nn.Conv2D(256, 12, 1)
            self.fc6 = nn.Linear(256 * 7 * 7, 1024)
            self.fc7 = nn.Linear(1024, 1024)
            # class biases spread (N(0, 2)) so that, untrained, scores
            # pass MultiClassNMS's 0.05 and the final scan keeps boxes
            self.cls_score = nn.Linear(1024, FRCNN_CLASSES + 1,
                                       bias_attr=P.ParamAttr(
                                           initializer=nn.initializer.Normal(
                                               0.0, 2.0)))
            self.bbox_pred = nn.Linear(1024, 4)

        def features(self, img):
            b = self.backbone
            x = b.maxpool(b.relu(b.bn1(b.conv1(img))))
            cs = []
            for layer in (b.layer1, b.layer2, b.layer3, b.layer4):
                x = layer(x)
                cs.append(x)
            lat = [conv(c) for conv, c in zip(self.lateral, cs)]
            for k in range(2, -1, -1):
                lat[k] = lat[k] + F.interpolate(lat[k + 1], scale_factor=2,
                                                mode="nearest")
            ps = [conv(t) for conv, t in zip(self.fpn_out, lat)]
            return ps + [F.max_pool2d(ps[-1], 1, stride=2)]

        def rpn(self, feats):
            hs = [F.relu(self.rpn_conv(f)) for f in feats]
            return [self.rpn_cls(h) for h in hs], [self.rpn_box(h)
                                                     for h in hs]

        def head(self, pooled):
            h = F.relu(self.fc6(P.flatten(pooled, 1)))
            h = F.relu(self.fc7(h))
            return self.cls_score(h), self.bbox_pred(h)

    return FasterRCNN().eval()


class _Recorder:
    """A package proxy whose ``ops`` records each detection op call (its
    name, arguments and outputs) for the CUDA-vs-CPU hold; everything
    else is the package's."""

    def __init__(self, pkg, names):
        self._pkg, self.calls = pkg, []
        rec = self

        class Ops:
            def __getattr__(_, name):
                fn = getattr(pkg.ops, name)
                if name not in names:
                    return fn

                def call(*a, **k):
                    out = fn(*a, **k)
                    rec.calls.append((name, a, k, out))
                    return out
                return call
        self.ops = Ops()

    def __getattr__(self, name):
        return getattr(self._pkg, name)


FRCNN_OPS = ("anchor_generator", "generate_proposals",
             "collect_fpn_proposals", "distribute_fpn_proposals",
             "roi_align", "box_coder", "multiclass_nms")


def frcnn_path(torch, c9, net, pkg, img, im_shape, stage=None):
    """The whole path on ``img``: backbone and FPN, RPN, proposals, RoI
    features, head, decode and NMS. ``stage(name)`` gives a context for
    each stage (profiler ranges). Returns (rois, pooled, detections,
    counts)."""
    stage = stage or (lambda name: contextlib.nullcontext())
    with stage("frcnn.backbone_fpn"):
        feats = net.features(img)
    with stage("frcnn.proposals"):
        scores, deltas = net.rpn(feats)
        rois, rois_num = c9.rpn_to_rois(pkg, feats, scores, deltas,
                                        im_shape)
    with stage("frcnn.roi_align"):
        pooled = c9.roi_features(pkg, feats[:4], rois, rois_num)
    with stage("frcnn.head"):
        logits, box_d = net.head(pooled)
    with stage("frcnn.nms"):
        var = torch.tensor(c9.FRCNN["box_variances"], device=img.device)
        dets, counts = c9.detect(pkg, rois, logits, box_d, var,
                                 img.shape[0])
    return rois, pooled, dets, counts


def _to_cpu(v):
    import torch
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, (list, tuple)):
        return type(v)(_to_cpu(x) for x in v)
    return v


def _flat_tensors(v):
    import torch
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _flat_tensors(x)]
    return []


def _with_scans(det_mod, store, fn):
    """``fn()`` with the greedy scans it runs recorded in ``store`` (their
    IoU, valid and threshold inputs, in order)."""
    real = det_mod.greedy_nms

    def rec(iou, valid, thr, eta=1.0):
        store.append((iou, valid, thr))
        return real(iou, valid, thr, eta)
    det_mod.greedy_nms = rec
    try:
        return fn()
    finally:
        det_mod.greedy_nms = real


def frcnn_ops_hold(torch, det_mod, calls):
    """Phase 28b: each recorded detection op call run again on the CPU on
    copies of its CUDA inputs: float outputs within FRCNN_TOL of the
    largest entry, integer and boolean outputs (counts, masks, restore
    index) equal. Where a kept set differs, the greedy scans' IoU inputs
    of both devices are compared: a pair on opposite sides of the
    threshold is a named near tie (ROADMAP C4); any other difference
    fails. Returns (held, near ties, worst error)."""
    import paddle_tpu_torch as P
    held, near, worst = 0, [], 0.0
    for name, a, k, out in calls:
        op = getattr(P.ops, name)
        cpu_scans = []
        t0 = time.perf_counter()
        ref = _with_scans(det_mod, cpu_scans,
                          lambda: op(*_to_cpu(a), **_to_cpu(k)))
        log(f"  {name} on the CPU: {time.perf_counter() - t0:.2f} s")
        got, want = _flat_tensors(out), _flat_tensors(ref)
        ok, err = len(got) == len(want), 0.0
        for g, w in zip(got, want):
            g = g.detach().cpu()
            if g.shape != w.shape:
                ok = False
            elif g.is_floating_point() and w.numel():
                e = float((g - w).abs().max()) / max(
                    1.0, float(w.abs().max()))
                err = max(err, e)
                ok = ok and e <= FRCNN_TOL
            elif not g.is_floating_point():
                ok = ok and torch.equal(g, w)
        worst = max(worst, err)
        if ok:
            held += 1
            continue
        # a kept set differs: an overlap on the other side of the
        # threshold on the two devices is a near tie
        cuda_scans = []
        _with_scans(det_mod, cuda_scans, lambda: op(*a, **k))
        tie = None
        for (ic, _, _), (ip, vp, tp) in zip(cuda_scans, cpu_scans):
            thr = tp[:, None, None].expand_as(ip)
            flip = ((ic.cpu() > thr) != (ip > thr)) & (vp[:, :, None] != 0)
            if bool(flip.any()):
                m = float((ip[flip] - thr[flip]).abs().max())
                tie = m if tie is None else max(tie, m)
        if tie is None or tie > 1e-5:
            raise RuntimeError(f"phase 28: {name} on the card differs from "
                               f"the CPU (worst {err:.3e}; IoU near-tie "
                               f"margin {tie})")
        near.append({"op": name, "iou_margin": tie})
        log(f"  {name}: a kept set differs at an IoU near-tie (margin "
            f"{tie:.2e}), named")
    return held, near, worst


def frcnn_nms_times(torch, nms_mod, scans):
    """B5 at the path's shapes, from the scans the path ran (its IoU,
    valid and threshold inputs): kernel against plain bit for bit, timed
    on the device's clock, with its byte bound for this data."""
    out = []
    for label, (iou, valid, thr) in scans:
        kept = nms_mod.greedy_nms(iou, valid, thr, 1.0)
        ref = nms_mod.greedy_nms_plain(iou, valid, thr, 1.0)
        mism = int((kept != ref).sum().item())
        if mism:
            raise RuntimeError(f"B5 at {label}: {mism} mismatches")
        ms = time_ms(lambda: nms_mod.greedy_nms(iou, valid, thr, 1.0),
                     spin=True)
        plain_ms = time_ms(lambda: nms_mod.greedy_nms_plain(
            iou, valid, thr, 1.0), iters=3)
        bms, full_ms = nms_bound(torch, valid, kept)
        p_n, k = valid.shape
        row = {"shape": f"P={p_n} k={k}", "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bms, "bound_ms_full_iou": full_ms,
               "kept_per_problem": int(kept.sum().item()) / p_n,
               "mismatches": 0}
        log(f"B5 at Faster R-CNN's {label} (P={p_n}, k={k}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"(whole matrices {full_ms:.4f}), {row['kept_per_problem']:.1f} "
            f"kept a problem, bit-exact")
        out.append((label, row))
    return out


def frcnn_phase(torch, fa_mod, dev, smi, reset_counters, read_counters):
    """Phase 28 (module docstring): returns (results, launches by
    path)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.ops import custom as nms_mod
    from paddle_tpu_torch.ops import detection as det_mod
    from torch.profiler import ProfilerActivity, profile
    c9 = _a9_table()
    gen = torch.Generator(device="cuda").manual_seed(28)
    img = torch.rand(FRCNN_BATCH, 3, FRCNN_H, FRCNN_W, device=dev,
                     generator=gen)
    im_shape = torch.tensor([[FRCNN_H, FRCNN_W]] * FRCNN_BATCH,
                            dtype=torch.float32, device=dev)
    net = _frcnn_model(torch, dev)
    log(f"phase 28: Faster R-CNN R50-FPN (PaddleDetection release/2.0 "
        f"faster_rcnn_r50_fpn: FPN 256 over P2-P6, anchors 32-512 at "
        f"strides 4-64, ratios 0.5/1/2, proposals pre/post 1000, NMS 0.7, "
        f"RoIAlign 7x7 sampling 0 aligned, TwoFCHead 1024, "
        f"{FRCNN_CLASSES} classes, MultiClassNMS 0.05/0.5/100), batch "
        f"{FRCNN_BATCH} of {FRCNN_H}x{FRCNN_W}, fp32, no_grad, random "
        f"weights (seeds 0 and 28); {smi}")
    res, launches = {}, {}
    outs = []
    with torch.no_grad():
        frcnn_path(torch, c9, net, P, img, im_shape)         # warm-up
        torch.cuda.synchronize()
        reset_counters()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append([v.clone() for v in frcnn_path(
                torch, c9, net, P, img, im_shape)])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches["frcnn_inference"] = read_counters()
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        levels = len(c9.FRCNN["strides"])
        want = 2 * (levels + 1)
        got_b5 = launches["frcnn_inference"]["greedy_nms"]
        log(f"Faster R-CNN path twice: outputs "
            f"{'bitwise equal' if same else 'DIFFER'}; B5 launched "
            f"{got_b5} times (expected {want}: one a generate_proposals "
            f"call, {levels} levels, and one a multiclass_nms call, both "
            f"images in each); wall {walls[1]:.1f} ms "
            f"({walls[1] / FRCNN_BATCH:.1f} ms an image), peak "
            f"{peak:.2f} GiB")
        if not same or got_b5 != want:
            raise RuntimeError(f"phase 28: repeat bitwise {same}, B5 "
                               f"launches {got_b5} (expected {want})")
        rois, pooled, dets, counts = outs[0]
        if not (torch.isfinite(dets).all() and torch.isfinite(pooled).all()
                and dets.shape == (FRCNN_BATCH, 100, 6)
                and int(counts.min()) > 0):
            raise RuntimeError(f"phase 28: detections {tuple(dets.shape)}, "
                               f"counts {counts.tolist()}")
        # (b) every detection op of the path on the CPU, on its inputs
        rec, path_scans = _Recorder(P, FRCNN_OPS), []
        _with_scans(det_mod, path_scans, lambda: frcnn_path(
            torch, c9, net, rec, img, im_shape))
        # the P2 level's proposals and the final NMS
        scans = {"generate_proposals (P2)": path_scans[0],
                 "multiclass_nms": path_scans[-1]}
        t0 = time.perf_counter()
        held, near, worst = frcnn_ops_hold(torch, det_mod, rec.calls)
        log(f"Faster R-CNN detection ops on the card against the CPU: "
            f"{held} held of {len(rec.calls)} calls (worst relative "
            f"{worst:.3e}, tolerance {FRCNN_TOL}), near ties {near} "
            f"({time.perf_counter() - t0:.1f} s)")
        # (d) each stage's device time from one profiled run
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            frcnn_path(torch, c9, net, P, img, im_shape,
                       stage=torch.profiler.record_function)
            torch.cuda.synchronize()
        events = prof.events()
        stages = {n: _kernel_ms(torch, events, f"frcnn.{n}")
                  for n in ("backbone_fpn", "proposals", "roi_align", "head",
                            "nms")}
        log("Faster R-CNN device ms by stage: " + ", ".join(
            f"{k} {v:.2f}" for k, v in stages.items()))
    res.update({"repeat_bitwise": same, "b5_launches_per_path": got_b5 // 2,
                "wall_ms": walls, "ms_per_image": walls[1] / FRCNN_BATCH,
                "peak_gib": peak, "device_ms_by_stage": stages,
                "ops_held": held, "ops_calls": len(rec.calls),
                "ops_worst_rel": worst, "near_ties": near,
                "detections_per_image": counts.tolist()})
    del rec, outs, rois, pooled, dets
    release_memory(torch)
    res["b5"] = dict(frcnn_nms_times(torch, nms_mod, list(scans.items())))
    del net, img, scans, path_scans
    release_memory(torch)
    log(f"Faster R-CNN: {res['ms_per_image']:.1f} ms an image, stages "
        f"{stages}, peak {peak:.2f} GiB; {smi}")
    return res, launches, {}


# -- phase 29: ResNet-50 through PaddleClas's ImageNet input pipeline -------

#: 1,024 seeded images of 8 classes, sides in [256, 512], in batches of
#: 128 through 4 loader workers; 4 O1 batches
PIPE_IMAGES, PIPE_CLASSES, PIPE_BATCH, PIPE_WORKERS = 1024, 8, 128, 4
PIPE_SIDES = (256, 512)


def _pipeline_transforms():
    from paddle_tpu_torch.vision import transforms as T
    return T.Compose([T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
                      T.Normalize(mean=[123.675, 116.28, 103.53],
                                  std=[58.395, 57.12, 57.375],
                                  data_format="HWC"), T.Transpose()])


def _write_image_folder(root):
    """PIPE_IMAGES seeded HWC uint8 ``.npy`` images in PIPE_CLASSES class
    directories under ``root`` (made anew)."""
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(29)
    for i in range(PIPE_IMAGES):
        d = os.path.join(root, f"class_{i % PIPE_CLASSES}")
        os.makedirs(d, exist_ok=True)
        h, w = rng.integers(PIPE_SIDES[0], PIPE_SIDES[1] + 1, 2)
        np.save(os.path.join(d, f"{i:05d}.npy"),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def pipeline_crop_check(torch, ds, dev):
    """The first image each of 2 workers transforms equals the transforms
    run here under that worker's ``random.seed`` (the iterator's seed
    plus the worker's id): one crop and one flip, bit for bit."""
    import random
    import paddle_tpu_torch as P
    sub = P.io.Subset(ds, range(8))
    loader = P.io.DataLoader(sub, batch_size=4, num_workers=2, timeout=120,
                             device=dev)
    np.random.seed(290)
    seed = np.random.RandomState(290).randint(0, 2 ** 31)
    batches = [b[0].cpu().numpy() for b in loader]
    tf = ds.transform
    for wid in (0, 1):
        random.seed(seed + wid)
        want = tf(np.load(ds.samples[4 * wid][0]))
        if not np.array_equal(batches[wid][0], want):
            raise RuntimeError(f"phase 29: worker {wid}'s first image "
                               f"differs from the CPU transforms")
    log("pipeline check: each worker's first crop and flip equal the CPU "
        "transforms under its seed, bit for bit")
    return True


def pipeline_phase(torch, fa_mod, dev, smi, reset_counters, read_counters):
    """Phase 29 (module docstring): returns (results, launches by
    path)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import shm_ring
    from paddle_tpu_torch.vision.models import resnet50
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_imagenet")
    t0 = time.perf_counter()
    _write_image_folder(root)
    made_s = time.perf_counter() - t0
    tf = _pipeline_transforms()
    ds = P.vision.datasets.DatasetFolder(root, transform=tf)
    log(f"phase 29: ResNet-50 O1 fit over a DatasetFolder of "
        f"{len(ds)} seeded .npy images ({PIPE_CLASSES} classes, sides "
        f"{PIPE_SIDES[0]}-{PIPE_SIDES[1]}, written in {made_s:.1f} s), "
        f"RandomResizedCrop(224), RandomHorizontalFlip, Normalize, "
        f"Transpose in {PIPE_WORKERS} loader workers, batch {PIPE_BATCH}; "
        f"{smi}")
    if not shm_ring.available():
        raise RuntimeError("phase 29: the shared-memory ring did not build")
    res, launches = {}, {}
    # a transform's cost in one process, an image at a time
    t0 = time.perf_counter()
    for i in range(32):
        ds[i]
    res["transform_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / 32
    res["crop_check"] = pipeline_crop_check(torch, ds, dev)
    torch.manual_seed(0)
    net = resnet50(num_classes=1000, device=dev, seed=0)
    model = P.Model(net, device=dev)
    model.prepare(P.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                       parameters=net.parameters(),
                                       weight_decay=1e-4, device=dev),
                  P.nn.CrossEntropyLoss())
    batch_bytes = PIPE_BATCH * (3 * 224 * 224 * 4 + 8)
    loader = P.io.DataLoader(ds, batch_size=PIPE_BATCH, shuffle=True,
                             num_workers=PIPE_WORKERS, timeout=300,
                             shm_capacity=batch_bytes + (1 << 20),
                             device=dev, drop_last=True)
    timer = _step_timer(torch)
    n_batches = 4
    reset_counters()
    np.random.seed(29)
    with amp.auto_cast():
        _, wall = _timed(torch, lambda: model.fit(
            loader, epochs=1, verbose=0, num_iters=n_batches,
            callbacks=[timer]))
    launches["pipeline_fit_o1"] = read_counters()
    losses = [d["loss"] for d in timer.logs]
    if len(losses) != n_batches or not all(math.isfinite(v)
                                           for v in losses):
        raise RuntimeError(f"phase 29: losses {losses}")
    intervals = [w + s for w, s in zip(timer.waits, timer.walls[1:])]
    shares = [w / i for w, i in zip(timer.waits, intervals)]
    steady, interval = _steady(timer)
    # the same step on a batch kept on the device
    xs, ys = _resident(P.io.DataLoader(P.io.Subset(ds, range(PIPE_BATCH)),
                                       batch_size=PIPE_BATCH, device=dev),
                       1)[0]
    with amp.auto_cast():
        model.train_batch([xs], [ys])
        walls = []
        for _ in range(5):
            _, ms = _timed(torch, lambda: model.train_batch([xs], [ys]))
            walls.append(ms)
    resident = PIPE_BATCH / float(np.median(walls)) * 1e3
    res.update({"fit_wall_ms": wall, "losses": losses,
                "imgs_per_s": PIPE_BATCH / interval * 1e3,
                "batch_interval_ms": intervals,
                "loader_wait_ms": timer.waits,
                "loader_wait_share": shares,
                "step_ms": steady,
                "resident_imgs_per_s": resident,
                "phase20_resident_o1_imgs_per_s":
                    RESNET_RESIDENT_IMGS_S["o1"],
                "loader_stats": {k: v for k, v in loader.stats.items()}})
    log(f"ResNet-50 O1 fit through the pipeline: {res['imgs_per_s']:.1f} "
        f"imgs/s (a batch every {interval:.1f} ms, median after the "
        f"capture), the host's wait on the loader "
        f"{[round(100 * v, 1) for v in shares]}% of each batch interval; "
        f"the step on a resident batch {resident:.1f} imgs/s (phase 20's "
        f"resident O1 figure {RESNET_RESIDENT_IMGS_S['o1']}, an earlier "
        f"run); a transform {res['transform_ms_per_image']:.2f} ms an "
        f"image in one process; losses {[round(v, 4) for v in losses]}")
    model._invalidate_compiled()
    del model, net, loader, xs, ys
    release_memory(torch)
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return res, launches, {}


# -- phase 30: the host-plane substrate ---------------------------------------

#: phase 30's train steps a precision (fp32, then O1), metered and not;
#: the profiler's graphed steps; the tracing on/off rounds
OBS_STEPS = 2
OBS_PROFILED_STEPS = 3
OBS_ROUNDS = 2
OBS_TICKS = 10              # decode ticks a round
OBS_TRAIN_ITERS = 2         # O1 train steps a round
OBS_SPAN_CALLS = 200_000    # disabled span() calls timed on the host
#: the step meter's count against the analytic count (the reference's
#: own tolerance, tests/test_observability.py's MFU agreement)
OBS_FLOPS_TOL = 0.10
OBS_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
               "flash_bwd_dkv_kernel")


def analytic_step_flops(cfg, batch, seq):
    """GPT train-step FLOPs under the MAC convention: 3 x the forward's
    products, ``3*T*(12*L*h^2 + h*V)``, plus B1-B3's causal attention by
    PERF.md's formulas (4, 6 and 8 FLOPs a pair a head-dim element),
    halved."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    t, h, n_l = batch * seq, cfg["hidden_size"], cfg["num_layers"]
    dense = 3 * t * (12 * n_l * h * h + h * cfg["vocab_size"])
    pairs = fa.attention_pairs(seq, seq, True)
    return dense + n_l * 18 * batch * h * pairs / 2


def _wall_rounds(torch, fns, rounds):
    """Host wall ms a call of each function (each ends in a host fetch,
    so the wall is the device's too), in alternating rounds, the order
    reversed every other round: {name: median round ms}, and every
    round's ms by name."""
    per = {n: [] for n in fns}
    for r in range(rounds):
        for n in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            t0 = time.perf_counter()
            calls = fns[n]()
            per[n].append((time.perf_counter() - t0) * 1e3 / calls)
    return {n: float(np.median(v)) for n, v in per.items()}, per


def _traced(tracer, on, fn, n):
    def run():
        (tracer.enable if on else tracer.disable)()
        for _ in range(n):
            fn()
        tracer.disable()
        return n
    return run


def _spans_of(tracer, fn):
    """The spans one call of ``fn`` records, by name (the ring keeps
    them: the exported trace reads it)."""
    ring = tracer.default_tracer()
    before = len(ring.spans())
    tracer.enable()
    try:
        fn()
    finally:
        tracer.disable()
    names = [s["name"] for s in ring.spans()[before:]]
    return {n: names.count(n) for n in sorted(set(names))}


def disabled_span_ns(tracer, calls=OBS_SPAN_CALLS):
    """Host ns of one ``with span(...)`` while tracing is off (best of 3
    timed loops, the empty loop's cost taken off)."""
    span = tracer.span
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            with span("serving.llm/decode_tick"):
                pass
        t1 = time.perf_counter_ns()
        for _ in range(calls):
            pass
        t2 = time.perf_counter_ns()
        best = min(best, ((t1 - t0) - (t2 - t1)) / calls)
    return best


def _obs_train_lane(torch, cfg, dev, ids, meter, registry):
    """GPT-3 1.3B (phase 7's model, seed 0, AdamW, lr fixed) through
    OBS_STEPS graphed fp32 train_batch steps, then OBS_STEPS O1 bf16
    steps; with ``meter`` a StepMeter on ``registry``. Returns the model,
    the losses by precision and, metered, each precision's FLOPs a step,
    last MFU and step times."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.observability import stepmeter
    model, _ = _train_model(torch, cfg, dev, "flash")
    if meter:
        model.attach_step_meter(stepmeter.StepMeter(registry=registry,
                                                    device=dev))
    losses, metered = {}, {}
    for prec in ("fp32", "o1"):
        losses[prec] = []
        for _ in range(OBS_STEPS):
            with (amp.auto_cast() if prec == "o1"
                  else contextlib.nullcontext()):
                loss, _ = model.train_batch([ids], [ids])
            losses[prec].append(loss)
            if not math.isfinite(loss):
                raise RuntimeError(f"phase 30 {prec} loss {loss}")
        if meter:
            flops, mfu = (registry.get("train.flops_per_step"),
                          registry.get("train.mfu"))
            # the last step's wall, from its MFU
            metered[prec] = {
                "flops_per_step": flops, "mfu": mfu,
                "last_step_ms": flops / mfu / model._step_meter.peak_flops
                * 1e3}
    return model, losses, metered


def _obs_engine(model, cfg, layout, measure):
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    kw = (dict(kv_layout="paged", page_size=16, paged_attn_impl="kernel")
          if layout == "paged" else dict(kv_layout="slot"))
    return LLMEngine(model, LLMEngineConfig(
        num_slots=8, max_seq=cfg["max_position_embeddings"], seed=0,
        measure_mfu=measure, **kw))


def _obs_serve(eng, prompts, interrupt=None):
    """Phase 4's 8 greedy requests, 32 new tokens each; ``interrupt()``
    runs once the first request has streamed 2 tokens (the others then
    in flight or queued). Returns the token lists."""
    reqs = [eng.submit(p, max_new_tokens=32, stream=(i == 0))
            for i, p in enumerate(prompts)]
    if interrupt is not None:
        it = reqs[0].iter_tokens(timeout=600)
        next(it)
        next(it)
        interrupt()
    results = [r.result(timeout=600) for r in reqs]
    for r in results:
        if len(r["tokens"]) != 32:
            raise RuntimeError(f"request {r['req_id']} returned "
                               f"{len(r['tokens'])} tokens, not 32")
    return [r["tokens"] for r in results]


def _metered_stats(eng, lane, tokens):
    """A metered engine's count, its last tick's MFU, and the MFU at its
    median tick (``mfu`` is the last tick's gauge)."""
    stats = eng.stats()
    st, tick = stats["stats"], stats["histograms"][
        "serving.llm.decode_tick_ms"]
    flops = st.get("serving.llm.decode_flops_per_tick")
    peak = eng._batcher._peak_flops
    return {"metered_equal": tokens == lane["plain_tokens"],
            "decode_flops_per_tick": flops, "mfu": st.get("serving.llm.mfu"),
            "tick_ms_p50": tick["p50"],
            "mfu_at_p50_tick": flops / (tick["p50"] / 1e3) / peak
            if flops else None}


def _flight_lines(directory):
    dumps = sorted(f for f in os.listdir(directory)
                   if f.startswith("flight_"))
    out = []
    for f in dumps:
        with open(os.path.join(directory, f)) as fh:
            out.append([json.loads(line) for line in fh if line.strip()])
    return out


def _check_dump(lines, engine, what):
    kinds = [line.get("kind") for line in lines[1:]]
    ok = (lines[0]["schema"] == "paddle-tpu-flight/2"
          and lines[0]["reason"] == "sigterm_drain"
          and any(e.get("kind") == "sigterm_drain"
                  and e.get("engine") == engine for e in lines)
          and "span" in kinds and kinds[-1] == "stats")
    if not ok:
        raise RuntimeError(f"{what}: the flight dump lacks the "
                           f"sigterm_drain event, spans or stats: {kinds}")
    return {"lines": len(lines), "spans": kinds.count("span"),
            "stats": len(lines[-1]["stats"])}


def _nested(child, parent):
    return (parent["ts"] <= child["ts"] and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + 1e-3
            and child["tid"] == parent["tid"])


def check_trace_nesting(events):
    """The exported spans nest as the JAX package's: a signature's first
    ``train/step`` holds its ``jit/compile`` and the meter's
    ``observability/cost_analysis``; an engine's warm-up compiles at
    depth 0 in the constructing thread; ``serving.llm/prefill`` and
    ``serving.llm/decode_tick`` run at depth 0 in the worker, and a
    metered engine's first plain tick holds its cost analysis."""
    xev = [e for e in events if e["ph"] == "X"]
    by = {}
    for e in xev:
        by.setdefault(e["name"], []).append(e)
    need = ("train/step", "jit/compile", "serving.llm/prefill",
            "serving.llm/decode_tick", "observability/cost_analysis")
    missing = [n for n in need if n not in by]
    if missing:
        raise RuntimeError(f"exported trace lacks spans {missing}")
    steps = by["train/step"]
    in_steps = [c for c in by["jit/compile"]
                if any(_nested(c, s) for s in steps)]
    cost_in_steps = [c for c in by["observability/cost_analysis"]
                     if any(_nested(c, s) for s in steps)]
    cost_in_ticks = [c for c in by["observability/cost_analysis"]
                     if any(_nested(c, t)
                            for t in by["serving.llm/decode_tick"])]
    warm = [c for c in by["jit/compile"]
            if c.get("args", {}).get("depth", 0) == 0]
    worker_roots = all(e.get("args", {}).get("depth", 0) == 0
                       for n in ("serving.llm/prefill",
                                 "serving.llm/decode_tick")
                       for e in by[n])
    out = {"spans": {n: len(v) for n, v in sorted(by.items())},
           "compiles_in_train_steps": len(in_steps),
           "cost_analysis_in_train_steps": len(cost_in_steps),
           "cost_analysis_in_decode_ticks": len(cost_in_ticks),
           "warmup_compiles_at_depth_0": len(warm),
           "serving_spans_at_depth_0": worker_roots}
    if not (in_steps and cost_in_steps and cost_in_ticks and warm
            and worker_roots and all(c["args"]["depth"] >= 1
                                     for c in in_steps)):
        raise RuntimeError(f"the exported spans do not nest as the "
                           f"reference's: {out}")
    return out


def _profiled_kernels(path):
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    return names


def capture_under_profiler(torch, dev, log_dir):
    """One CUDA graph captured while a Profiler runs: a program whose
    function goes through the op funnel (so a ``record_function`` range
    opens inside the capture); then two replays against the plain
    product. Returns the result or the fault, never raises."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.core import graphs

    class _State:
        graph_pool = graphs.GraphPool(dev)

    x = torch.randn(256, 256, device=dev)
    prog = graphs.Program(lambda params, state, a: P.matmul(a, a),
                          name="capture_under_profiler")
    try:
        with profiler.Profiler(log_dir=log_dir) as prof:
            prog([], _State, x)
            for _ in range(2):
                out = prog([], _State, x)
        torch.cuda.synchronize()
        err = float((out - x @ x).abs().max())
        res = {"captured": prog.trace_counter["traces"] == 1,
               "replays": prog.replays, "max_abs_err": err,
               "op_range_in_trace": "op::matmul_v2" in _profiled_kernels(
                   prof.trace_path)}
        if not (res["captured"] and err < 1e-3 and (
                res["replays"] == 2 or dev.type != "cuda")):
            res["fault"] = "the capture did not replay the product"
        return res
    except Exception as e:  # noqa: BLE001 -- reported, not hidden
        return {"fault": f"{type(e).__name__}: {e}"}


def observability_phase(torch, fa_mod, dev, smi, reset_counters,
                        read_counters):
    """Phase 30 (module docstring): the host-plane substrate on GPT-3
    1.3B. Returns (results, launches by path, B1-B3 by type)."""
    import signal
    import tempfile
    from paddle_tpu_torch import amp, observability as obs
    from paddle_tpu_torch.core import graphs, monitor
    from paddle_tpu_torch.distributed.elastic import PreemptionGuard
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.observability import export, flight, tracer
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.serving.engine import Engine, EngineConfig
    from paddle_tpu_torch.serving.llm.decode import SamplingParams
    from paddle_tpu_torch.serving.llm.scheduler import GenerationRequest
    cfg = CFG_13B
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    os.environ["PADDLE_TPU_FLIGHT_DIR"] = os.path.join(work, "flight")
    os.makedirs(os.environ["PADDLE_TPU_FLIGHT_DIR"])
    rng = np.random.default_rng(0)          # phase 3's seed
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist()
               for n in PROMPT_LENS]
    ids = rng.integers(0, cfg["vocab_size"],
                       (4, cfg["max_position_embeddings"]))
    log(f"phase 30: spans, the flight recorder, live MFU and preemption "
        f"drains on GPT-3 1.3B (seed 0; phase 7's [4, 1024] batch, phase "
        f"4's 8 requests; fp32 TF32 off and O1 bf16); {smi}")
    out, launches, dtypes = {}, {}, {}
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    span_ns = disabled_span_ns(tracer)

    # -- MFU, training: unmetered, then metered with tracing on ---------
    reg = monitor.default_registry()
    for k in [k for k in reg.stats() if k.startswith("train.")]:
        reg.reset(k)
    reset_counters()
    plain_model, plain_losses, _ = _obs_train_lane(torch, cfg, dev, ids,
                                                   False, None)
    plain_model._invalidate_compiled()
    del plain_model
    release_memory(torch)
    obs.enable()
    model, losses, metered = _obs_train_lane(torch, cfg, dev, ids, True,
                                             reg)
    launches["obs_train"] = read_counters()
    dtypes["obs_train"] = {c.__name__: dict(c.launches_by_dtype)
                           for c in _counters(fa_mod)}
    if losses != plain_losses:
        raise RuntimeError(f"metered losses {losses} are not the "
                           f"unmetered {plain_losses}")
    analytic = analytic_step_flops(cfg, *ids.shape)
    for prec, m in metered.items():
        rel = m["flops_per_step"] / analytic - 1
        m["vs_analytic"] = rel
        if abs(rel) > OBS_FLOPS_TOL:
            raise RuntimeError(f"{prec} train.flops_per_step "
                               f"{m['flops_per_step']:.6g} is {rel:+.2%} "
                               f"off the analytic {analytic:.6g}")
    out["train"] = {"losses": losses, "metered": metered,
                    "analytic_flops": analytic,
                    "peak_flops": model._step_meter.peak_flops}
    log(f"train MFU (MAC convention, peak {model._step_meter.peak_flops:.4g}"
        f" FLOP/s): {json.dumps(metered)}; analytic {analytic:.6g}; "
        f"losses bitwise equal to the unmetered lane's {losses}")

    # spans of a step, tracing cost on the step, the profiler
    o1 = amp.auto_cast

    def o1_step():
        with o1():
            model.train_batch([ids], [ids])

    out["train"]["spans_per_step"] = _spans_of(tracer, o1_step)
    reset_counters()
    medians, rounds = _wall_rounds(torch, {
        "disabled": _traced(tracer, False, o1_step, OBS_TRAIN_ITERS),
        "enabled": _traced(tracer, True, o1_step, OBS_TRAIN_ITERS)},
        OBS_ROUNDS)
    out["train"]["tracing_ms"] = {"median": medians, "rounds": rounds}
    prof_dir = os.path.join(work, "prof")
    with profiler.Profiler(log_dir=prof_dir) as prof:
        for _ in range(OBS_PROFILED_STEPS):
            o1_step()
            prof.step()
    names = _profiled_kernels(prof.trace_path)
    seen = {k: any(k in n for n in names) for k in OBS_KERNELS}
    with profiler.Profiler(log_dir=os.path.join(work, "prof_eager")) as pe:
        with graphs.disable_graphs(), o1():
            model.train_batch([ids], [ids])
    eager_ops = sorted(n for n in _profiled_kernels(pe.trace_path)
                       if n.startswith("op::"))
    launches["obs_rounds_and_profiles"] = read_counters()
    out["profiler"] = {"graphed_steps_kernels": seen,
                       "step_info": prof.step_info(),
                       "eager_step_op_ranges": eager_ops[:20],
                       "eager_step_op_range_count": len(eager_ops)}
    if not all(seen.values()) or not eager_ops:
        raise RuntimeError(f"profiler traces: kernels {seen}, op ranges "
                           f"{eager_ops[:5]}")
    log(f"train step tracing (O1, {OBS_ROUNDS} alternating rounds of "
        f"{OBS_TRAIN_ITERS} steps): {json.dumps(medians)} ms a step; spans "
        f"a step {out['train']['spans_per_step']}; profiler: "
        f"{json.dumps(out['profiler'])}")
    model._invalidate_compiled()
    del model
    release_memory(torch)

    # -- MFU, serving; the drains -----------------------------------------
    smodel = GPTForCausalLM(GPTConfig(**cfg, attn_impl="flash"), device=dev,
                            seed=0).eval()
    serving = {}
    obs.disable()
    for layout in ("paged", "slot"):
        reset_counters()
        eng = _obs_engine(smodel, cfg, layout, False)
        plain_tokens = _obs_serve(eng, prompts)
        eng.drain(timeout=120)
        launches[f"obs_serving_{layout}"] = read_counters()
        serving[layout] = {"plain_tokens": plain_tokens}
        if layout == "paged":
            # the decode tick with tracing off and on, on this engine's
            # batcher (its worker has stopped)
            b = eng._batcher
            for i in range(8):
                b.admit(GenerationRequest(
                    prompts[i][:16], SamplingParams(max_new_tokens=900)))
            tick_spans = _spans_of(tracer, b.tick)
            reset_counters()
            t_med, t_rounds = _wall_rounds(torch, {
                "disabled": _traced(tracer, False, b.tick, OBS_TICKS),
                "enabled": _traced(tracer, True, b.tick, OBS_TICKS)},
                OBS_ROUNDS)
            launches["obs_tick_rounds"] = read_counters()
            b.abort_all(lambda req: RuntimeError("phase 30: done"))
            serving["tick_tracing_ms"] = {"median": t_med,
                                          "rounds": t_rounds,
                                          "spans_per_tick": tick_spans}
        del eng
        release_memory(torch)
    obs.enable()
    flight_dir = os.environ["PADDLE_TPU_FLIGHT_DIR"]
    # paged, metered, drained by a real SIGTERM in flight
    reset_counters()
    eng = _obs_engine(smodel, cfg, "paged", True)
    chain = eng.install_drain_signal_handler()
    try:
        tokens = _obs_serve(eng, prompts,
                            lambda: signal.raise_signal(signal.SIGTERM))
        if not eng._stopped.wait(120):
            raise RuntimeError("the SIGTERM drain did not stop the worker")
    finally:
        chain.uninstall()
    launches["obs_serving_paged_metered"] = read_counters()
    serving["paged"].update(_metered_stats(eng, serving["paged"], tokens),
                            draining=eng.draining)
    dumps = _flight_lines(flight_dir)
    if len(dumps) != 1:
        raise RuntimeError(f"{len(dumps)} flight dumps after the SIGTERM "
                           f"drain, not 1")
    serving["paged"]["flight_dump"] = _check_dump(dumps[0], "serving.llm",
                                                  "LLMEngine")
    del eng
    release_memory(torch)
    # slot, metered, drained by the preemption guard
    reset_counters()
    eng = _obs_engine(smodel, cfg, "slot", True)
    guard = PreemptionGuard(install=False)
    eng.arm_preemption(guard)
    tokens = _obs_serve(eng, prompts, guard.preempt)
    if not eng._stopped.wait(120):
        raise RuntimeError("the preemption drain did not stop the worker")
    launches["obs_serving_slot_metered"] = read_counters()
    serving["slot"].update(
        _metered_stats(eng, serving["slot"], tokens),
        preemption_drains=eng.registry.get("serving.llm.preemption_drains"))
    del eng, smodel
    release_memory(torch)
    # the classifier Engine, drained by a real SIGTERM with work queued
    gate = threading.Event()

    def slow(x):
        gate.wait(60)
        return x * 2

    ceng = Engine(slow, EngineConfig(batch_buckets=(1, 2, 4), max_batch=4,
                                     max_batch_delay=0.0), device=dev)
    chain = ceng.install_drain_signal_handler()
    try:
        futs = [ceng.submit([np.full((1, 8), i, np.float32)])
                for i in range(12)]
        signal.raise_signal(signal.SIGTERM)
        gate.set()
        if not ceng._stopped.wait(120):
            raise RuntimeError("the Engine's SIGTERM drain did not stop")
    finally:
        gate.set()
        chain.uninstall()
    done = sum(bool(np.all(f.result(60)[0] == 2 * i))
               for i, f in enumerate(futs))
    dumps = _flight_lines(flight_dir)
    engine_dump = _check_dump(dumps[-1], "serving", "Engine")
    restored = signal.getsignal(signal.SIGTERM) == prev_sigterm
    serving["engine_drain"] = {"requests": len(futs), "completed": done,
                               "flight_dump": engine_dump,
                               "handlers_restored": restored}
    for layout in ("paged", "slot"):
        s = serving[layout]
        if not s["metered_equal"] or not s["decode_flops_per_tick"] \
                or not s["mfu"]:
            raise RuntimeError(f"{layout} measure_mfu: {s}")
        s.pop("plain_tokens")
    if serving["slot"]["preemption_drains"] != 1 or done != len(futs) \
            or not restored or not serving["paged"]["draining"]:
        raise RuntimeError(f"drains: {serving}")
    out["serving"] = serving
    log(f"serving MFU and drains: {json.dumps(serving)}")

    # -- the exported trace, the capture under the profiler -----------------
    path = os.path.join(work, "trace.json")
    n = export.export_chrome_trace(path)
    out["trace"] = dict(check_trace_nesting(
        export.load_chrome_trace(path)["traceEvents"]), exported=n,
        dropped=tracer.default_tracer().dropped)
    obs.disable()
    tracer.default_tracer().clear()
    flight.default_recorder().clear()
    out["capture_under_profiler"] = capture_under_profiler(
        torch, dev, os.path.join(work, "prof_capture"))
    out["disabled_span_ns"] = span_ns
    out["seconds"] = time.perf_counter() - t_phase
    log(f"exported trace: {json.dumps(out['trace'])}; capture under the "
        f"profiler: {json.dumps(out['capture_under_profiler'])}; a "
        f"disabled span {span_ns:.1f} ns on the host; phase 30 "
        f"{out['seconds']:.1f} s")
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    os.environ.pop("PADDLE_TPU_FLIGHT_DIR", None)
    return out, launches, dtypes


# -- phase 31: training that survives faults ----------------------------------
FT_STEPS = 4               # guarded O1 steps of the skip lane
FT_NAN_FIRE = 2            # the grads site's firing the NaN lands on
FT_ROUNDS = 2              # alternating guarded/unguarded rounds
FT_ROUND_STEPS = 2         # O1 steps a round
FT_CKPT_LAYERS = 2         # depth of the checkpoint lanes (full width)
FT_EPOCHS = 3              # epochs of the kill lane
FT_RB_EPOCHS = 2           # epochs of the rollback lane
FT_EPOCH_STEPS = 2         # batches an epoch in both
FT_CRASH_STEP = 3          # step:N:crash of the killed child: mid epoch 1
FT_CHILD_TIMEOUT = 300


def _ft_cfg(layers=None):
    return dict(CFG_13B, num_layers=layers or CFG_13B["num_layers"])


def _ft_batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [(x, x) for x in (rng.integers(
        0, cfg["vocab_size"], (4, cfg["max_position_embeddings"]))
        for _ in range(n))]


def _own_injector(spec):
    """The process-wide FaultInjector set to ``spec`` (None: back to the
    environment's) for the in-process lanes."""
    from paddle_tpu_torch.utils import resilience
    resilience._INJECTOR = None if spec is None else \
        resilience.FaultInjector(spec)


def _train_state(model, to=None):
    """Copies of the parameters, the optimizer's tensors and its step
    count (on the device, or on ``to``): what the bitwise checks
    compare."""
    out = {f"p.{k}": v.detach().to(to, copy=True)
           for k, v in model.network.state_dict().items()}
    for k, v in model._optimizer.state_dict().items():
        out[f"o.{k}"] = v.to(to, copy=True) if hasattr(v, "clone") else v
    return out


def _states_equal(torch, a, b):
    bad = [k for k in a if (not torch.equal(a[k], b[k])
                            if hasattr(a[k], "shape") else a[k] != b[k])]
    return sorted(a) == sorted(b) and not bad, bad[:5]


def _loss_log():
    """A fit callback keeping each batch's loss (the fit loop's float)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class LossLog(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.ravel(logs["loss"])[0]))
    return LossLog()


def ft_skip_lane(torch, fa_mod, dev, reset_counters, read_counters):
    """GPT-3 1.3B O1 graphed through ``fit`` with AnomalyGuardCallback and
    a NaN injected into the gradients at guarded step FT_NAN_FIRE, against
    a guarded run that drops that batch's update by hand; returns the
    second model (for the cost lane), the results and the launches."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.hapi.callbacks import AnomalyGuardCallback
    from paddle_tpu_torch.sentinel import Sentinel, SentinelConfig
    cfg = _ft_cfg()
    batches = _ft_batches(cfg, FT_STEPS, 31)
    reg = monitor.default_registry()
    for k in [k for k in reg.stats() if k.startswith("sentinel.")]:
        reg.reset(k)
    launches = {}
    model, _ = _train_model(torch, cfg, dev, "flash")
    log(f"phase 31 skip lane: model built, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    guard = AnomalyGuardCallback(config=SentinelConfig(ladder=("skip_step",)))
    losses = _loss_log()
    _own_injector(f"grads:{FT_NAN_FIRE}:nan")
    reset_counters()
    try:
        with amp.auto_cast():
            model.fit(batches, epochs=1, verbose=0,
                      callbacks=[guard, losses])
    finally:
        _own_injector(None)
    launches["fault_tolerance_skip"] = read_counters()
    mem = {"allocated_gib_after_fit": torch.cuda.memory_allocated() / 2**30,
           "peak_gib_fit": torch.cuda.max_memory_allocated() / 2**30}
    log(f"phase 31 skip lane memory: {json.dumps(mem)}")
    syncs = reg.get("sentinel.host_syncs")
    want = cfg["num_layers"] * FT_STEPS
    bad = {n: c for n, c in launches["fault_tolerance_skip"].items()
           if n in [f.__name__ for f in _counters(fa_mod)] and c != want}
    if bad or syncs != FT_STEPS or guard.sentinel.anomalies != 1 \
            or reg.get("sentinel.skipped_steps") != 1:
        raise RuntimeError(f"skip lane: launches {bad} (want {want} each), "
                           f"host syncs {syncs} (want {FT_STEPS}), "
                           f"anomalies {guard.sentinel.anomalies}")
    skipped = _train_state(model)
    guarded_step = model._optimizer._global_step
    fit_losses, anomalies = losses.losses, guard.sentinel.anomalies
    model._invalidate_compiled()
    del model, guard, losses    # the callbacks hold the model too
    release_memory(torch)

    model, sched = _train_model(torch, cfg, dev, "flash")
    opt = model._optimizer
    Sentinel(SentinelConfig(ladder=("skip_step",)), optimizer=opt)
    manual = []
    reset_counters()
    with amp.auto_cast():
        for i, (x, y) in enumerate(batches):
            if i == FT_NAN_FIRE - 1:
                manual.append(model.train_batch([x], [y], update=False)[0])
                opt.clear_grad()
            else:
                manual.append(model.train_batch([x], [y])[0])
            sched.step()        # the LRScheduler callback's step in fit
    launches["fault_tolerance_manual_skip"] = read_counters()
    equal, bad = _states_equal(torch, skipped, _train_state(model))
    if not equal or fit_losses != manual or \
            guarded_step != opt._global_step:
        raise RuntimeError(f"skip lane: the guarded run's state differs from "
                           f"the manual skip's at {bad}; losses "
                           f"{fit_losses} vs {manual}")
    del skipped
    out = {"steps": FT_STEPS, "nan_at_step": FT_NAN_FIRE - 1,
           "anomalies": anomalies,
           "skipped_steps": reg.get("sentinel.skipped_steps"),
           "losses": fit_losses, "host_syncs": syncs,
           "state_bitwise_manual_skip": True,
           "optimizer_steps": guarded_step,
           "b1_b3_per_guarded_step": cfg["num_layers"], **mem}
    log(f"phase 31 skip lane: NaN gradients at guarded step "
        f"{FT_NAN_FIRE} of {FT_STEPS} skipped; parameters, moments and "
        f"step count bitwise the manual skip's; host syncs {syncs}; losses "
        f"{fit_losses}")
    return model, out, launches


def ft_cost_lane(torch, fa_mod, dev, model, reset_counters, read_counters):
    """The guarded route against the fused graphed step on one model, in
    alternating rounds; the probe alone against its byte bound; the peak
    memory of a step with an async snapshot's clones held."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate.checkpoint import async_ckpt
    from paddle_tpu_torch.sentinel import Sentinel, SentinelConfig
    cfg = _ft_cfg()
    x = _ft_batches(cfg, 1, 32)[0][0]
    opt = model._optimizer
    sentinel = opt._sentinel or Sentinel(SentinelConfig(
        ladder=("skip_step",)), optimizer=opt)

    def steps(guarded):
        def run():
            if guarded:
                sentinel.attach(opt)
            else:
                sentinel.detach(opt)
            with amp.auto_cast():
                for _ in range(FT_ROUND_STEPS):
                    model.train_batch([x], [x])
            return FT_ROUND_STEPS
        return run

    reset_counters()
    steps(False)()              # the fused step's capture, outside rounds
    medians, rounds = _wall_rounds(torch, {"guarded": steps(True),
                                           "unguarded": steps(False)},
                                   FT_ROUNDS)
    launches = {"fault_tolerance_costs": read_counters()}
    def one_step():
        with amp.auto_cast():
            model.train_batch([x], [x])

    prof = {}
    for name in ("guarded", "unguarded"):
        if name == "guarded":
            sentinel.attach(opt)
        else:
            sentinel.detach(opt)
        prof[name] = profile_steps(torch, f"phase 31 {name} O1 step",
                                   one_step, FT_ROUND_STEPS)
    sentinel.attach(opt)
    one_step()
    # the probe's replay alone (the fetch after it left out), on the
    # profiler's device timeline
    prog = next(iter(sentinel.guard._probes.values()))
    holder = sentinel.guard._holders[torch.device(dev)]
    bound = prog._bound[holder][None]
    grads = bound.inputs[:-1]
    probe = profile_steps(torch, "phase 31 probe replay",
                          lambda: prog([], holder, *bound.inputs), 5)
    probe_ms = probe["device_ms"]
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    probe_bound = grad_bytes / PEAK_BYTES * 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one_step()
    base_peak = torch.cuda.max_memory_allocated()
    state = {"model": model.network.state_dict(),
             "optimizer": opt.state_dict()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = async_ckpt.snapshot(state)
    enqueue_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    one_step()
    clone_peak = torch.cuda.max_memory_allocated()
    clone_bytes = sum(v.numel() * v.element_size()
                      for v in snap.flat.values() if hasattr(v, "numel"))
    del snap, state
    out = {"wall_ms_median": medians, "wall_ms_rounds": rounds,
           "device_ms": {n: p["device_ms"] for n, p in prof.items()},
           "profiled_wall_ms": {n: p["wall_ms"] for n, p in prof.items()},
           "probe_device_ms": probe_ms, "probe_bound_ms": probe_bound,
           "probe_kernels": sum(r[1] for r in probe["kernels"]),
           "probe_host_wall_ms": probe["wall_ms"],
           "probe_bound_by": "bytes", "gradient_bytes": grad_bytes,
           "probe_gradients": len(grads),
           "snapshot_host_ms_full_state": enqueue_host_ms,
           "snapshot_bytes": clone_bytes,
           "peak_gib_step": base_peak / 2**30,
           "peak_gib_step_with_snapshot": clone_peak / 2**30}
    log(f"phase 31 costs (O1, {FT_ROUNDS} alternating rounds of "
        f"{FT_ROUND_STEPS} steps): wall ms a step {json.dumps(medians)}; "
        f"device ms {json.dumps(out['device_ms'])}; probe {probe_ms:.3f} ms "
        f"device over {len(grads)} gradients ({grad_bytes / 1e9:.3f} GB; "
        f"byte bound {probe_bound:.3f} ms); snapshot of the full state "
        f"{clone_bytes / 1e9:.3f} GB in {enqueue_host_ms:.2f} ms host; peak "
        f"{base_peak / 2**30:.2f} GiB a step, "
        f"{clone_peak / 2**30:.2f} GiB with the snapshot held")
    return out, launches


def ft_rollback_lane(torch, fa_mod, dev, work, reset_counters,
                     read_counters):
    """GPT-3 1.3B's width at FT_CKPT_LAYERS layers, O1 graphed, through
    ``fit`` with AnomalyGuardCallback(ladder rollback, async snapshots):
    epoch 0 ends in a snapshot, a NaN at epoch 1's first step rolls the
    live model back to it (bitwise), and epoch 1's second step trains
    from it; then the checkpoint's sync save, checksum and load times."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.hapi.callbacks import (AnomalyGuardCallback,
                                                 Callback)
    from paddle_tpu_torch.incubate.checkpoint import (
        load_sharded, read_health_stamp, save_sharded, sharded)
    from paddle_tpu_torch.sentinel import SentinelConfig
    cfg = _ft_cfg(FT_CKPT_LAYERS)
    batches = _ft_batches(cfg, FT_EPOCH_STEPS, 33)
    reg = monitor.default_registry()
    for k in list(reg.histograms()):
        if k.startswith("ckpt.async."):
            reg.reset(k)
    model, _ = _train_model(torch, cfg, dev, "flash")
    guard = AnomalyGuardCallback(
        save_dir=os.path.join(work, "guard"),
        config=SentinelConfig(ladder=("rollback",)), async_snapshots=True)
    seen = {}

    class Check(Callback):
        def on_epoch_end(self, epoch, logs=None):
            if epoch == 0:
                seen["snapshot"] = _train_state(model)

        def on_train_batch_end(self, step, logs=None):
            r = guard.sentinel.last_report
            if r is not None and r.rolled_back_to is not None \
                    and "restored" not in seen:
                seen["restored"] = _states_equal(
                    torch, seen["snapshot"], _train_state(model))
                seen["rolled_back_to"] = r.rolled_back_to

    losses = _loss_log()
    _own_injector(f"grads:{FT_EPOCH_STEPS + 1}:nan")
    reset_counters()
    try:
        with amp.auto_cast():
            model.fit(batches, epochs=FT_RB_EPOCHS, verbose=0,
                      callbacks=[Check(), guard, losses])
    finally:
        _own_injector(None)
    launches = {"fault_tolerance_rollback": read_counters()}
    snaps = guard.rollback.steps()
    stamps = {s: read_health_stamp(os.path.join(
        guard.rollback.path, f"snap_{s}"))["healthy"] for s in snaps}
    if not seen.get("restored", (False,))[0] or \
            not all(math.isfinite(v) for v in losses.losses) or \
            len(losses.losses) != FT_RB_EPOCHS * FT_EPOCH_STEPS:
        raise RuntimeError(f"rollback lane: restored {seen.get('restored')}, "
                           f"losses {losses.losses}")
    hist = {k: reg.histogram(f"ckpt.async.{k}") for k in
            ("enqueue_ms", "fetch_ms", "write_ms", "commit_ms")}
    # the sync timings on the parameters alone (0.82 GB; with the AdamW
    # moments 2.47 GB, three times the seconds for the same rates)
    state = {"model": model.network.state_dict()}
    path = os.path.join(work, "sync")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_sharded(state, path)
    save_s = time.perf_counter() - t0
    shards = os.path.join(path, "shards_0.npz")
    nbytes = os.path.getsize(shards)
    t0 = time.perf_counter()
    sharded._sha256_of(shards)
    sha_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_sharded(path, return_tensor=False, device="cpu")
    load_s = time.perf_counter() - t0
    live = state["model"]
    if not all(torch.equal(back["model"][k], v.cpu()) for k, v in
               live.items()):
        raise RuntimeError("rollback lane: the sync checkpoint did not load "
                           "back bitwise")
    out = {"layers": FT_CKPT_LAYERS, "losses": losses.losses,
           "rolled_back_to": seen["rolled_back_to"],
           "restored_bitwise_snapshot": True, "snapshots": stamps,
           "async_ms": {k: {q: v.get(q) for q in ("count", "p50", "max")}
                        for k, v in hist.items()},
           "checkpoint_bytes": nbytes, "sync_save_s": save_s,
           "sync_save_gb_s": nbytes / save_s / 1e9, "sha256_s": sha_s,
           "sha256_gb_s": nbytes / sha_s / 1e9, "load_s": load_s,
           "load_gb_s": nbytes / load_s / 1e9}
    log(f"phase 31 rollback lane ({FT_CKPT_LAYERS} layers at full width): "
        f"rolled back to snapshot {seen['rolled_back_to']}, live state "
        f"bitwise the snapshot, training completed (losses "
        f"{losses.losses}); snapshots {stamps}; async "
        f"{json.dumps(out['async_ms'])}; sync save_sharded "
        f"{nbytes / 1e9:.3f} GB in {save_s:.2f} s "
        f"({out['sync_save_gb_s']:.3f} GB/s), sha256 {sha_s:.2f} s, "
        f"load_sharded {load_s:.2f} s")
    model._invalidate_compiled()
    del model, state, back
    release_memory(torch)
    return out, launches


def ft_child(torch, argv):
    """``chip_smoke.py --ft-child {train,resume} SAVE_DIR LOG``: the kill
    lane's child. Fit GPT-3 1.3B's width at FT_CKPT_LAYERS layers, O1
    graphed, FT_EPOCHS epochs of FT_EPOCH_STEPS batches, with
    AnomalyGuardCallback and FaultToleranceCallback(async_save=True)
    (each epoch's commit drained before the next epoch, so the resume
    point is the last epoch ended), appending each batch's loss to LOG;
    ``resume`` first restores ``SAVE_DIR/latest`` and fits the epochs
    after it, prints its launches, then halts: a ladder ``("halt",)``
    sentinel on a NaN step exits with DIVERGENCE_EXIT_CODE."""
    import importlib
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.hapi import callbacks as cbs
    from paddle_tpu_torch.incubate.checkpoint import read_health_stamp
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.sentinel import Sentinel, SentinelConfig
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.ops import custom, paged_attention
    mode, save_dir, log_path = argv[:3]
    dev = resolve_device()
    fa_mod = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    reset_counters, read_counters = counter_fns(
        torch, fa_mod, (paged_attention.paged_attention, custom.greedy_nms))
    cfg = _ft_cfg(FT_CKPT_LAYERS)
    model, _ = _train_model(torch, cfg, dev, "flash")
    latest = os.path.join(save_dir, "latest")
    start = read_health_stamp(latest)["step"] + 1 \
        if mode == "resume" and os.path.isdir(latest) else 0

    class FT(cbs.FaultToleranceCallback):
        def on_epoch_end(self, epoch, logs=None):   # the run's epoch
            super().on_epoch_end(epoch + start, logs)

    # the resumed child's own checkpoints are never read: it saves none
    ft = FT(save_dir, async_save=True,
            save_freq=FT_EPOCHS + 1 if start else 1)
    if start:
        ft.set_model(model)
        ft.restore()

    class Log(cbs.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch + start

        def on_train_batch_end(self, step, logs=None):
            with open(log_path, "a") as f:
                f.write(f"{self.epoch} {step} "
                        f"{float(np.ravel(logs['loss'])[0])!r}\n")

        def on_epoch_end(self, epoch, logs=None):
            ft._ckpt.wait()

    reset_counters()
    with amp.auto_cast():
        model.fit(_ft_batches(cfg, FT_EPOCH_STEPS, 34),
                  epochs=FT_EPOCHS - start, verbose=0,
                  callbacks=[cbs.AnomalyGuardCallback(), ft, Log()])
    print(json.dumps({"resumed_from_epoch": start - 1,
                      "launches": read_counters()}), flush=True)
    Sentinel(SentinelConfig(ladder=("halt",)),
             optimizer=model._optimizer)
    flight.arm()
    _own_injector("grads:1:nan")
    with amp.auto_cast():
        model.train_batch(*_ft_batches(cfg, 1, 34)[0])
    return 0          # not reached: the halt exits


class _Child:
    """One ``--ft-child`` process, its output in files under ``work``."""

    def __init__(self, mode, work, env):
        self.mode, self.t0 = mode, time.perf_counter()
        self.out = open(os.path.join(work, f"{mode}.out"), "w+")
        self.err = open(os.path.join(work, f"{mode}.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ft-child", mode,
             os.path.join(work, "ft"), os.path.join(work, "log")],
            env=env, stdout=self.out, stderr=self.err, text=True)

    def wait(self, code):
        """Its exit, held to ``code``: (stdout, seconds)."""
        try:
            rc = self.proc.wait(FT_CHILD_TIMEOUT)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        seconds = time.perf_counter() - self.t0
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        self.out.close()
        self.err.close()
        if rc != code:
            raise RuntimeError(f"kill lane: the {self.mode} child exited "
                               f"{rc}, not {code}: {err[-2000:]}")
        return out, seconds


def _child_env(work, spec=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PADDLE_TPU_FAULT_SPEC", "PADDLE_TPU_FLIGHT")}
    env["PADDLE_TPU_FLIGHT_DIR"] = os.path.join(work, "flight")
    if spec:
        env["PADDLE_TPU_FAULT_SPEC"] = spec
    return env


def ft_kill_lane(torch, fa_mod, dev, work, reset_counters, read_counters):
    """A child hard-killed mid-epoch 1 by ``step:N:crash`` (while this
    process runs the same guarded fit unbroken, small and timing
    nothing), then a child resuming from the last committed epoch and
    halting: its losses after the resume bitwise the unbroken run's."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.elastic import DIVERGENCE_EXIT_CODE
    from paddle_tpu_torch.hapi import callbacks as cbs
    from paddle_tpu_torch.utils.resilience import FAULT_CRASH_EXIT_CODE
    killed = _Child("train", work,
                    _child_env(work, f"step:{FT_CRASH_STEP}:crash"))
    try:
        cfg = _ft_cfg(FT_CKPT_LAYERS)
        model, _ = _train_model(torch, cfg, dev, "flash")
        ref = _loss_log()
        reset_counters()
        # the same guarded fit, without checkpoints (they change no number)
        with amp.auto_cast():
            model.fit(_ft_batches(cfg, FT_EPOCH_STEPS, 34),
                      epochs=FT_EPOCHS, verbose=0,
                      callbacks=[cbs.AnomalyGuardCallback(), ref])
        launches = {"fault_tolerance_unbroken": read_counters()}
        ref_losses = ref.losses
        model._invalidate_compiled()
        del model, ref              # the callback holds the model too
        release_memory(torch)
    finally:
        _, crash_s = killed.wait(FAULT_CRASH_EXIT_CODE)
    resumed = _Child("resume", work, _child_env(work))
    stdout, resume_s = resumed.wait(DIVERGENCE_EXIT_CODE)
    child = json.loads([ln for ln in stdout.splitlines()
                        if ln.startswith("{")][-1])
    launches["fault_tolerance_resumed_child"] = child["launches"]
    flight_dir = os.path.join(work, "flight")
    dumps = os.listdir(flight_dir) if os.path.isdir(flight_dir) else []
    if len(dumps) != 1:
        raise RuntimeError(f"kill lane: {len(dumps)} flight dumps after the "
                           f"halt, not 1")
    with open(os.path.join(flight_dir, dumps[0])) as f:
        header = json.loads(f.readline())
    rows = [ln.split() for ln in open(os.path.join(work, "log"))]
    got = {(int(e), int(st)): float(v) for e, st, v in rows}
    start = child["resumed_from_epoch"] + 1
    resumed_losses = [got[(e, st)] for e in range(start, FT_EPOCHS)
                      for st in range(FT_EPOCH_STEPS)]
    want = ref_losses[start * FT_EPOCH_STEPS:]
    killed_at = len(rows) - len(resumed_losses)
    if start != 1 or resumed_losses != want or \
            header.get("reason") != "sentinel_halt":
        raise RuntimeError(f"kill lane: resumed from epoch {start - 1}; "
                           f"losses after the resume {resumed_losses} vs "
                           f"the unbroken run's {want}; dump {header}")
    out = {"layers": FT_CKPT_LAYERS, "crash_exit_code": FAULT_CRASH_EXIT_CODE,
           "killed_after_batches": killed_at,
           "resumed_from_epoch": start - 1,
           "resumed_losses": resumed_losses,
           "resumed_bitwise_unbroken": True,
           "halt_exit_code": DIVERGENCE_EXIT_CODE,
           "halt_flight_dump": header.get("reason"),
           "child_s": {"killed": crash_s, "resumed_and_halted": resume_s}}
    log(f"phase 31 kill lane: the child exited {FAULT_CRASH_EXIT_CODE} "
        f"(step:{FT_CRASH_STEP}:crash) after {killed_at} batches, the "
        f"second resumed from epoch {start - 1} with losses bitwise the "
        f"unbroken run's ({resumed_losses}) and halted with "
        f"{DIVERGENCE_EXIT_CODE}, dump {header.get('reason')}; children "
        f"{crash_s:.1f} s and {resume_s:.1f} s")
    return out, launches


def fault_tolerance_phase(torch, fa_mod, dev, smi, reset_counters,
                          read_counters):
    """Phase 31 (module docstring): training that survives faults on GPT-3
    1.3B. Returns (results, launches by path, B1-B3 by type)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    log(f"phase 31: the sentinel, rollback, async checkpoints and a killed "
        f"and resumed fit on GPT-3 1.3B, O1 bf16 graphed, phase 7's "
        f"[4, 1024] batches, dropout 0 as phase 7 has it; checkpoint lanes "
        f"at {FT_CKPT_LAYERS} layers; {smi}")
    out, launches, dtypes = {}, {}, {}
    release_memory(torch)
    out["allocated_gib_at_start"] = torch.cuda.memory_allocated() / 2**30
    try:
        model, out["skip"], paths = ft_skip_lane(
            torch, fa_mod, dev, reset_counters, read_counters)
        launches.update(paths)
        out["costs"], paths = ft_cost_lane(torch, fa_mod, dev, model,
                                           reset_counters, read_counters)
        launches.update(paths)
        model._invalidate_compiled()
        del model
        # the children need the card's memory this process cached
        release_memory(torch)
        out["kill_resume"], paths = ft_kill_lane(
            torch, fa_mod, dev, work, reset_counters, read_counters)
        launches.update(paths)
        out["rollback"], paths = ft_rollback_lane(
            torch, fa_mod, dev, work, reset_counters, read_counters)
        launches.update(paths)
        dtypes["fault_tolerance_rollback"] = {
            c.__name__: dict(c.launches_by_dtype) for c in _counters(fa_mod)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 31 {out['seconds']:.1f} s")
    return out, launches, dtypes


# -- phase 32: the LLM fleet's data path ---------------------------------------

FLEET_NEW = 32            # phase 4's new tokens a request
FLEET_AT = 3              # tokens every stream has before a park or a kill
FLEET_ROLL_LAYERS = 2     # the roll's depth (full width): its checkpoint I/O
FLEET_ROLL_STREAMS = 4    # pumping streams through the roll
FLEET_HANDOFF_AT = 256    # the handoff lane's prefill_threshold
FLEET_STORE_MB = 8192     # its shared host prefix store
FLEET_REPLAY_K = 4        # the replay noise's resume point (tokens)
FLEET_TIMEOUT = 600.0     # every wait of the phase


def _fleet_cfg(**kw):
    """Phase 4's paged engine config (8 slots, 1024 rows, 16-row pages,
    B4), per replica."""
    from paddle_tpu_torch.serving.llm import LLMEngineConfig
    return LLMEngineConfig(**dict(dict(
        num_slots=8, max_seq=CFG_13B["max_position_embeddings"],
        kv_layout="paged", page_size=16, paged_attn_impl="kernel",
        seed=0), **kw))


class _FleetLog:
    """Every engine one lane's factories built, with the B4 launches each
    of its decode steps makes (the layer count on the kernel lane, else
    0)."""

    def __init__(self):
        self.engines = []

    def track(self, eng, b4_per_step):
        self.engines.append((eng, b4_per_step))
        return eng

    def factory(self, inner, b4_per_step):
        return lambda replica: self.track(inner(replica), b4_per_step)

    def b4(self):
        """B4's launches by replica (stat prefix), and their sum: one a
        layer a decode step on the kernel lane. A resurrected replica's
        engine counts its ticks under its predecessor's prefix (one
        registry), so a prefix's steps are its ticks plus one warm-up
        step for each engine that warmed up under it."""
        per, regs = {}, []
        for eng, n in self.engines:
            if not any(eng.registry is r for r in regs):
                regs.append(eng.registry)
            k = next(i for i, r in enumerate(regs) if r is eng.registry)
            key = f"{eng._prefix}@registry{k}"
            st = eng.registry.stats_with_prefix(eng._prefix + ".")
            if key not in per:
                per[key] = n * st.get(f"{eng._prefix}.decode_ticks", 0)
            per[key] += n * st.get(f"{eng._prefix}.warmup_decode_steps", 0)
        return per, sum(per.values())


def _fleet_io(reg, kind):
    """Every sequence export's or import's wall ms and payload bytes on a
    router's engines, as the paged batcher records them (``seq_<kind>_ms``
    and ``seq_<kind>_bytes``; an import's ms end with its host-to-device
    copies)."""
    hs = [h for k, h in reg.histograms().items()
          if k.endswith(f".seq_{kind}_ms")]
    n = sum(h["count"] for h in hs)
    if not n:
        return None
    secs = sum(h["sum"] for h in hs) / 1e3
    nbytes = sum(v for k, v in reg.stats().items()
                 if k.endswith(f".seq_{kind}_bytes"))
    return {"sequences": n, "ms_total": secs * 1e3,
            "ms_max": max(h["max"] for h in hs), "bytes": nbytes,
            "gb_per_s": nbytes / max(secs, 1e-9) / 1e9}


def _fleet_check_b4(lane, launched, log_, base=0):
    """B4's launches in ``launched`` against one a layer a decode step of
    every engine ``log_`` tracks, less ``base`` (its total before the
    lane); returns (by engine, the lane's launches)."""
    per, want = log_.b4()
    got = launched["paged_attention"]
    if got != want - base:
        raise RuntimeError(f"{lane}: B4 launched {got} times, not the "
                           f"{want - base} of one a layer a decode step "
                           f"({per})")
    return per, got


def _fleet_router(torch, log_, model_factory, cfg, b4_per_step, **rcfg):
    from paddle_tpu_torch.core.monitor import StatRegistry
    from paddle_tpu_torch.serving.router import (Router, RouterConfig,
                                                 llm_replica_factory)
    rcfg.setdefault("health_interval", 0.05)
    reg = StatRegistry()
    t0 = time.perf_counter()
    router = Router(log_.factory(llm_replica_factory(model_factory, cfg),
                                 b4_per_step),
                    RouterConfig(num_replicas=2, kind="llm", **rcfg),
                    registry=reg)
    return router, reg, time.perf_counter() - t0


def _fleet_wait(pred, what, timeout=FLEET_TIMEOUT, poll=0.0005):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise RuntimeError(f"phase 32: timed out waiting for {what}")
        time.sleep(poll)


def _first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def fleet_park_lane(torch, model, prompts, kv_dtype, smi, reset_counters,
                    read_counters):
    """Phase 32 lanes 1 and 2: a 2-replica paged router (recovery on) on
    the 8 requests, undisturbed (the reference), then again with the
    busier replica parked once every stream has FLEET_AT tokens: every
    stream must equal its undisturbed tokens bitwise."""
    log_ = _FleetLog()
    kw = {} if kv_dtype == "float32" else dict(kv_dtype="int8",
                                                paged_attn_impl="auto")
    b4 = CFG_13B["num_layers"] if kv_dtype == "float32" else 0
    reset_counters()
    router, reg, boot_s = _fleet_router(torch, log_, lambda r: model,
                                        _fleet_cfg(**kw), b4)
    try:
        ref = [r.result(timeout=FLEET_TIMEOUT)["tokens"] for r in
               [router.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]]
        reqs = [router.submit(p, max_new_tokens=FLEET_NEW, stream=True)
                for p in prompts]
        _fleet_wait(lambda: min(len(r.tokens) for r in reqs) >= FLEET_AT,
                    f"{FLEET_AT} tokens on every stream")
        at = [len(r.tokens) for r in reqs]
        donor = max(router.replicas, key=lambda r: r.outstanding)
        t0 = time.perf_counter()
        if not router.park(donor.replica_id):
            raise RuntimeError("phase 32: the park was refused")
        park_ms = (time.perf_counter() - t0) * 1e3
        got = [list(r.iter_tokens(timeout=FLEET_TIMEOUT)) for r in reqs]
        stats = reg.stats()
        lat = reg.histogram("fleet.migrate.latency_ms")
        io = {k: _fleet_io(reg, k) for k in ("export", "import")}
    finally:
        router.drain(timeout=FLEET_TIMEOUT)
    launched = read_counters()
    per, _ = _fleet_check_b4(f"phase 32 park {kv_dtype}", launched, log_)
    mig = {k.split("fleet.migrate.")[1]: v for k, v in stats.items()
           if k.startswith("fleet.migrate.")}
    pages = {k: sum(v for n, v in stats.items()
                    if n.endswith(f".migrated_pages_{k}"))
             for k in ("shared", "copied")}
    out = {"kv_dtype": kv_dtype, "boot_s": boot_s, "park_ms": park_ms,
           "donor": donor.replica_id, "tokens_at_park": at,
           "migrate": mig, "migrate_latency_ms": lat.get("mean"),
           "pages": pages, "export": io["export"], "import": io["import"],
           "b4_by_engine": per,
           "tokens_equal": sum(a == b for a, b in zip(ref, got))}
    log(f"phase 32 park ({kv_dtype} pages; {smi}): 2 replicas booted in "
        f"{boot_s:.1f} s; replica {donor.replica_id} parked at stream "
        f"lengths {at} in {park_ms:.1f} ms (migration "
        f"{out['migrate_latency_ms']}); {mig}; pages {pages}; export "
        f"{out['export']}; import {out['import']}; {out['tokens_equal']}/"
        f"{len(prompts)} streams bitwise the undisturbed run's; B4 by "
        f"engine {per}")
    for i, (a, b) in enumerate(zip(ref, got)):
        if a != b:
            raise RuntimeError(
                f"phase 32 park {kv_dtype}: request {i} parts from the "
                f"undisturbed run at step {_first_difference(a, b)}")
    if len(ref[0]) != FLEET_NEW or mig.get("sequences_exported", 0) < 1 \
            or mig.get("sequences_failed", 0) != 0:
        raise RuntimeError(f"phase 32 park {kv_dtype}: {mig}")
    return out, launched, ref


def fleet_replay_noise(torch, model, dev, prompt, toks, k=FLEET_REPLAY_K):
    """The kill lane's measured logit difference: a replay rebuilds by a
    dense prefill the rows the undisturbed run wrote by decode steps. On
    one request (eager, the kernel lane): the decode lane's logits for
    token k against the dense prefill's of ``prompt + toks[:k]``, and the
    next decode step's logits over the two caches; the larger."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling,
                                                     prefill_forward)
    from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder
    cfg = _fleet_cfg()
    dec = GPTPagedDecoder(model, page_size=cfg.page_size, attn_impl="kernel")
    kv, params = dec.new_kv(2, cfg.max_seq), dec.params()

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def padded(seq):
        p = torch.zeros(1, cfg.bucket_for(len(seq)), dtype=torch.int32,
                        device=dev)
        p[0, :len(seq)] = i32(list(seq))
        return p
    one, two = (pack_sampling([SamplingParams()] * n, dev) for n in (1, 2))
    fin = torch.zeros(2, dtype=torch.bool, device=dev)
    seq = list(prompt) + list(toks[:k])
    with graphs.disable_graphs(), torch.no_grad():
        for s in (0, 1):
            kv.alloc()
            kv.ensure_pages(s, len(seq) + 2)
        dec.prefill(kv, params, padded(prompt), i32([len(prompt)]), i32([0]),
                    fin, one, None)
        for t in toks[:k - 1]:
            dec.decode_step(kv, params, fin, i32([t, 0]), two, None)
        ldec = dec.decode_logits(kv, params, i32([toks[k - 1], 0]))[0]
        dec.decode_step(kv, params, fin, i32([toks[k - 1], 0]), two, None)
        lpre, _, _ = prefill_forward(dec.spec, params, padded(seq),
                                     i32([len(seq)]))
        dec.prefill(kv, params, padded(seq), i32([len(seq)]), i32([1]), fin,
                    one, None)
        step = dec.decode_logits(kv, params, i32([toks[k], toks[k]]))
    first = float((ldec - lpre[0]).abs().max())
    after = float((step[0] - step[1]).abs().max())
    del kv
    release_memory(torch)
    return {"logit_diff_first": first, "logit_diff_next_step": after,
            "noise": max(first, after), "resume_at": k}


def _divergence_gap(torch, ref_dec, ref_params, prompt, ref, exc):
    """The top-2 gap of the plain lane's logits where a replayed stream
    failed the dedup guard (its message names the position)."""
    import re
    from paddle_tpu_torch.serving.llm.decode import prefill_forward
    m = re.search(r"at position (\d+)", str(exc))
    if m is None:
        return None, None
    pos = int(m.group(1))
    seq = torch.tensor([list(prompt) + list(ref[:pos])], dtype=torch.int32,
                       device=ref_dec.device)
    with torch.no_grad():
        lraw, _, _ = prefill_forward(ref_dec.spec, ref_params, seq,
                                     torch.tensor([seq.shape[1]],
                                                  dtype=torch.int32,
                                                  device=ref_dec.device))
    top = lraw[0].topk(2).values
    return pos, float(top[0] - top[1])


def fleet_kill_lane(torch, model, prompts, ref, noise, ref_dec, ref_params,
                    smi, reset_counters, read_counters):
    """Phase 32 lane 3: the busier replica hard-killed mid-stream; its
    streams replay on the survivor through the dedup guard and are held
    to the undisturbed run under the near-tie rule; the health loop
    resurrects the victim, whose new engine captures its programs while
    the survivor decodes (kept busy until the victim is healthy)."""
    log_ = _FleetLog()
    boots = []
    reset_counters()

    def ticks():
        return sum(e.registry.get(f"{e._prefix}.decode_ticks", 0)
                   for e, _ in log_.engines if not e._stopped.is_set())

    def build(replica):
        before, t0 = ticks(), time.perf_counter()
        eng = inner(replica)
        boots.append({"replica": replica.replica_id,
                      "s": time.perf_counter() - t0,
                      "sibling_ticks": ticks() - before})
        return eng
    from paddle_tpu_torch.core.monitor import StatRegistry
    from paddle_tpu_torch.serving.router import (Router, RouterConfig,
                                                 llm_replica_factory)
    inner = log_.factory(llm_replica_factory(lambda r: model, _fleet_cfg()),
                         CFG_13B["num_layers"])
    reg = StatRegistry()
    router = Router(build, RouterConfig(
        num_replicas=2, kind="llm", health_interval=0.05,
        restart_backoff=0.05, restart_backoff_cap=0.05), registry=reg)
    arrivals, errors = {}, {}

    def consume(i, req):
        arrivals[i] = []
        try:
            for _ in req.iter_tokens(timeout=FLEET_TIMEOUT):
                arrivals[i].append(time.perf_counter())
        except Exception as e:  # held below, with the logit gap
            errors[i] = e
    stop = threading.Event()
    pumped = []
    try:
        reqs = [router.submit(p, max_new_tokens=FLEET_NEW, stream=True)
                for p in prompts]
        readers = [threading.Thread(target=consume, args=(i, r), daemon=True)
                   for i, r in enumerate(reqs)]
        for t in readers:
            t.start()
        _fleet_wait(lambda: min(len(r.tokens) for r in reqs) >= FLEET_AT,
                    f"{FLEET_AT} tokens on every stream")
        victim = max(router.replicas, key=lambda r: r.outstanding)
        survivor = router.replicas[1 - victim.replica_id]
        dead, live = victim.engine, survivor.engine

        def pump():
            while not stop.is_set():
                pumped.append(live.submit(prompts[0], max_new_tokens=FLEET_NEW
                                          ).result(timeout=FLEET_TIMEOUT))
        pumper = threading.Thread(target=pump, daemon=True)
        pumper.start()
        t_kill = time.perf_counter()
        if not victim.kill("chaos: phase 32"):
            raise RuntimeError("phase 32: the kill was refused")
        if not dead._stopped.wait(FLEET_TIMEOUT):
            raise RuntimeError("phase 32: the killed engine did not stop")
        evac = {rec["req_id"] for rec in victim.last_kill_records
                if rec.get("evacuated")}
        at_kill = {i: len(r.tokens) for i, r in enumerate(reqs)
                   if r.req_id in evac}
        for t in readers:
            t.join(FLEET_TIMEOUT)
        if any(t.is_alive() for t in readers):
            raise RuntimeError("phase 32: a replayed stream did not end")
        _fleet_wait(lambda: victim.state == "HEALTHY"
                    and victim.engine is not dead, "the resurrection",
                    poll=0.01)
        resurrected_s = time.perf_counter() - t_kill
        stop.set()
        pumper.join(FLEET_TIMEOUT)
        if pumper.is_alive():
            raise RuntimeError("phase 32: the survivor's pump did not end")
        stats = reg.stats()
        budget = router.budget.used
    finally:
        stop.set()
        router.drain(timeout=FLEET_TIMEOUT)
    launched = read_counters()
    for i, e in errors.items():
        pos, gap = _divergence_gap(torch, ref_dec, ref_params, prompts[i],
                                   ref[i], e)
        raise RuntimeError(
            f"phase 32 kill: request {i} failed ({type(e).__name__}: {e}); "
            f"the plain lane's top-2 gap at position {pos} is {gap}, the "
            f"lanes' measured logit difference {noise['noise']:.3e}")
    got = [list(r.tokens) for r in reqs]
    parts = near_tie_parts(torch, ref_dec, ref_params, prompts, ref, got,
                           noise["noise"], "phase 32 kill replay")
    per, _ = _fleet_check_b4("phase 32 kill", launched, log_)
    first = sorted((arrivals[i][n] - t_kill) * 1e3
                   for i, n in at_kill.items() if len(arrivals[i]) > n)
    divergence = sum(v for k, v in stats.items()
                     if k.endswith(".stream_divergence"))
    recovered = stats.get("fleet.migrate.sequences_recovered", 0)
    capture = boots[-1] if len(boots) > 2 else None
    out = {"evacuated": len(at_kill), "tokens_at_kill": at_kill,
           "recovered": recovered, "stream_divergence": divergence,
           "first_replayed_token_ms": first,
           "resurrected_s": resurrected_s, "restarts_used": budget,
           "boots": boots, "pumped_requests": len(pumped),
           "noise": noise, "near_tie_parts": parts, "b4_by_engine": per,
           "tokens_equal": sum(a == b for a, b in zip(ref, got))}
    log(f"phase 32 kill ({smi}): replica {victim.replica_id} killed with "
        f"{len(at_kill)} streams in flight at lengths {at_kill}; "
        f"{recovered} replayed on replica {survivor.replica_id}, stream "
        f"divergence {divergence}; first replayed token after "
        f"{', '.join(f'{x:.1f}' for x in first)} ms; resurrected in "
        f"{resurrected_s:.1f} s ({budget} restart), its boot "
        f"{capture and round(capture['s'], 2)} s while the survivor ran "
        f"{capture and capture['sibling_ticks']} decode ticks; "
        f"{out['tokens_equal']}/{len(prompts)} streams bitwise the "
        f"undisturbed run's, parts at (request, step, top-2 gap) {parts} "
        f"under noise {noise}; B4 by engine {per}")
    if divergence != 0 or recovered < 1 or budget != 1 or len(at_kill) < 1 \
            or capture is None or capture["sibling_ticks"] < 1 \
            or any(len(t) != FLEET_NEW for t in got):
        raise RuntimeError(f"phase 32 kill: {out}")
    return out, launched


def fleet_tail_noise(torch, model, dev, prompt, start, buckets):
    """The handoff lane's measured logit difference (phase 17's rule):
    the decode replica's tail prefill behind the head rows the prefill
    replica's full prefill wrote, against the single engine's full
    prefill: first-token logits and the next decode step's over the two
    caches (slot layout); the larger."""
    from paddle_tpu_torch.serving.llm import (GPTStaticDecoder,
                                              LLMEngineConfig)
    from paddle_tpu_torch.serving.llm.decode import (prefill_forward,
                                                     tail_forward)
    from paddle_tpu_torch.serving.llm.kvcache import write_prompt_kv
    cfg = LLMEngineConfig(max_seq=CFG_13B["max_position_embeddings"],
                          prefill_buckets=buckets)
    n = len(prompt)

    def padded(seq):
        p = torch.zeros(1, cfg.bucket_for(len(seq)), dtype=torch.int32,
                        device=dev)
        p[0, :len(seq)] = torch.tensor(list(seq), dtype=torch.int32,
                                       device=dev)
        return p

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    dec = GPTStaticDecoder(model)
    kv, params = dec.new_kv(2, cfg.max_seq), dec.params()
    with torch.no_grad():
        lfull, kf, vf = prefill_forward(dec.spec, params, padded(prompt),
                                        i32([n]))
        write_prompt_kv(kv.k, kv.v, kf, vf, [0])
        write_prompt_kv(kv.k, kv.v, kf[:, :, :start], vf[:, :, :start], [1])
        tail = padded(prompt[start:])
        lt = tail.shape[1]

        def write(li, k, v):
            kv.k[1, li, start:start + lt] = k[0]
            kv.v[1, li, start:start + lt] = v[0]
        ltail, _, _ = tail_forward(
            dec.spec, params, tail, i32([n - start]), i32([start]),
            kv.max_seq, write, lambda li: (kv.k[1:2, li], kv.v[1:2, li]))
        kv.lengths.fill_(n)
        nxt = lfull.argmax(-1).to(torch.int32)
        step = dec.decode_logits(kv, params, nxt.repeat(2))
    first = float((lfull - ltail).abs().max())
    after = float((step[0] - step[1]).abs().max())
    del kv
    release_memory(torch)
    return {"logit_diff_first": first, "logit_diff_next_step": after,
            "noise": max(first, after), "start": start, "prompt_len": n}


def fleet_handoff_lane(torch, model, dev, prompts, ref_dec, ref_params, smi,
                       reset_counters, read_counters):
    """Phase 32 lane 5: roles ("prefill", "decode") over one shared host
    PrefixStore (slot layout, phase 17's buckets): every prompt of
    FLEET_HANDOFF_AT tokens or more hands its head off; the tokens are
    held to one engine's under phase 17's prefix rule."""
    from paddle_tpu_torch.core.monitor import StatRegistry
    from paddle_tpu_torch.serving.llm import LLMEngineConfig, PrefixStore
    from paddle_tpu_torch.serving.router import (Router, RouterConfig,
                                                 llm_replica_factory)
    base = dict(num_slots=8, max_seq=CFG_13B["max_position_embeddings"],
                prefill_buckets=PREFIX_BUCKETS, seed=0)
    reset_counters()
    single = _engine_run(torch, model, base, prompts, FLEET_NEW)
    single["engine"] = None
    release_memory(torch)
    reg = StatRegistry()
    store = PrefixStore(capacity_bytes=FLEET_STORE_MB << 20, registry=reg)
    roles = ("prefill", "decode")
    t0 = time.perf_counter()
    router = Router(
        llm_replica_factory(lambda r: model, LLMEngineConfig(**base),
                            roles=roles, prefix_store=store),
        RouterConfig(kind="llm", num_replicas=2, roles=roles,
                     prefill_threshold=FLEET_HANDOFF_AT, health_interval=0.2,
                     auto_resurrect=False), registry=reg)
    boot_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        reqs = [router.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
        got = [r.result(timeout=FLEET_TIMEOUT)["tokens"] for r in reqs]
        wall = time.perf_counter() - t0
        stats, hist = reg.stats(), reg.histograms()
        ps = store.stats()
    finally:
        router.drain(timeout=FLEET_TIMEOUT)
    launched = read_counters()
    longs = [p for p in prompts if len(p) >= FLEET_HANDOFF_AT]
    longest = max(longs, key=len)
    noise = fleet_tail_noise(torch, model, dev, longest,
                             (len(longest) - 1) // 16 * 16, PREFIX_BUCKETS)
    parts = near_tie_parts(torch, ref_dec, ref_params, prompts,
                           single["tokens"], got, noise["noise"],
                           "phase 32 handoff")
    pre = "serving.router."
    reused = stats.get("serving.llm.replica1.prefix.reused_tokens", 0)
    out = {"boot_s": boot_s, "wall_s": wall,
           "handoff_prefills": stats.get(pre + "handoff_prefills", 0),
           "handoff_failed": stats.get(pre + "handoff_failed", 0),
           "dispatched_role_prefill": stats.get(
               pre + "dispatched_role_prefill", 0),
           "dispatched_role_decode": stats.get(
               pre + "dispatched_role_decode", 0),
           "decode_reused_tokens": reused,
           "decode_prefill_ms_p50": hist.get(
               "serving.llm.replica1.prefill_ms", {}).get("p50"),
           "prefill_prefill_ms_p50": hist.get(
               "serving.llm.replica0.prefill_ms", {}).get("p50"),
           "single_tokens_per_s": single["tokens_per_s"],
           "tokens_per_s": sum(map(len, got)) / wall,
           "store": ps, "noise": noise, "near_tie_parts": parts,
           "tokens_equal": sum(a == b for a, b in zip(single["tokens"],
                                                      got))}
    log(f"phase 32 handoff ({smi}): roles {roles}, threshold "
        f"{FLEET_HANDOFF_AT}, {len(longs)} long prompts; "
        f"{out['handoff_prefills']} handoffs ({out['handoff_failed']} "
        f"failed), the decode replica reused {reused} tokens, its prefill "
        f"p50 {out['decode_prefill_ms_p50']} ms against the prefill "
        f"replica's {out['prefill_prefill_ms_p50']} ms; store {ps}; "
        f"{out['tokens_equal']}/{len(prompts)} token lists equal the single "
        f"engine's, parts {parts} under noise {noise}; launches {launched}")
    if out["handoff_prefills"] != len(longs) or out["handoff_failed"] \
            or reused < FLEET_HANDOFF_AT or any(launched.values()):
        raise RuntimeError(f"phase 32 handoff: {out}, launches {launched}")
    return out, launched


def fleet_roll_lane(torch, dev, prompts, work, smi, reset_counters,
                    read_counters):
    """Phase 32 lane 4: ``WeightSwapper.roll`` to a committed, health-
    stamped checkpoint of other weights (seed 1), one model per replica,
    at FLEET_ROLL_LAYERS layers and full width, under FLEET_ROLL_STREAMS
    pumping streams: every finished stream is the old weights' or the new
    weights' engine's, bitwise, by its version; no admitted stream and no
    migrated sequence fails; no swap adds a program."""
    from paddle_tpu_torch.incubate.checkpoint import commit_checkpoint
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import EngineDraining, NoHealthyReplicas
    from paddle_tpu_torch.serving.fleet import WeightSwapper
    from paddle_tpu_torch.serving.llm import LLMEngine
    cfg2 = dict(CFG_13B, num_layers=FLEET_ROLL_LAYERS)

    def build(seed):
        return GPTForCausalLM(GPTConfig(**cfg2, attn_impl="flash"),
                              device=dev, seed=seed).eval()
    log_ = _FleetLog()
    reset_counters()
    pumped = prompts[:FLEET_ROLL_STREAMS]
    refs = {}
    for version, seed in ((0, 0), (1, 1)):
        m = build(seed)
        eng = log_.track(LLMEngine(m, _fleet_cfg()), FLEET_ROLL_LAYERS)
        try:
            reqs = [eng.submit(p, max_new_tokens=FLEET_NEW) for p in pumped]
            refs[version] = [r.result(timeout=FLEET_TIMEOUT)["tokens"]
                             for r in reqs]
        finally:
            eng.drain(timeout=FLEET_TIMEOUT)
        if seed == 1:
            ckpt = os.path.join(work, "ckpt-step1")
            t0 = time.perf_counter()
            commit_checkpoint({"model": m.state_dict()}, ckpt, healthy=True,
                              step=1)
            save_s = time.perf_counter() - t0
            ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f))
                             for f in os.listdir(ckpt))
        del m, eng
    release_memory(torch)
    router, reg, boot_s = _fleet_router(
        torch, log_, lambda r: build(0), _fleet_cfg(), FLEET_ROLL_LAYERS)
    stop = threading.Event()
    done, failed = [], []

    def pump(i):
        while not stop.is_set():
            try:
                r = router.submit(pumped[i], max_new_tokens=FLEET_NEW,
                                  stream=True)
            except (NoHealthyReplicas, EngineDraining):
                time.sleep(0.01)     # a paused window: submit again
                continue
            except Exception as e:   # any other refusal fails the lane
                failed.append(f"{type(e).__name__}: {e}")
                return
            try:
                toks = list(r.iter_tokens(timeout=FLEET_TIMEOUT))
                done.append((i, toks, r.result(timeout=5)["weights_version"]))
            except Exception as e:   # an admitted stream failed
                failed.append(f"{type(e).__name__}: {e}")
    threads = [threading.Thread(target=pump, args=(i,), daemon=True)
               for i in range(len(pumped))]
    try:
        for t in threads:
            t.start()
        _fleet_wait(lambda: sum(r.outstanding for r in router.replicas) >= 2,
                    "two streams in flight")
        t0 = time.perf_counter()
        report = WeightSwapper(
            router, reg, quiesce_timeout=FLEET_TIMEOUT,
            probe_timeout=FLEET_TIMEOUT).roll(
                os.path.join(work, "ckpt-step1"))
        roll_s = time.perf_counter() - t0
        _fleet_wait(lambda: any(v == 1 for _, _, v in done),
                    "a stream on the new weights", poll=0.01)
        stop.set()
        for t in threads:
            t.join(FLEET_TIMEOUT)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("phase 32 roll: a pump did not end")
        stats = reg.stats()
        # the roll's checkpoint reads and each engine's swap, as the
        # swapper and the engines record them
        io = {k: reg.histogram(f"fleet.swap.{k}_ms")["sum"]
              for k in ("eligible", "load")}
        swaps = [{"engine": p, "swaps": stats.get(f"{p}.weight_swaps", 0),
                  "version": stats.get(f"{p}.weights_version"),
                  "ms": reg.histogram(f"{p}.weight_swap_ms")["max"],
                  "compiles": stats.get(f"{p}.weight_swap_compiles")}
                 for p in sorted({r.engine._prefix
                                  for r in router.replicas})]
    finally:
        stop.set()
        router.drain(timeout=FLEET_TIMEOUT)
    launched = read_counters()
    per, _ = _fleet_check_b4("phase 32 roll", launched, log_)
    bad = [(i, v, _first_difference(t, refs[v][i])) for i, t, v in done
           if t != refs[v][i]]
    versions = sorted({v for _, _, v in done})
    mig = {k.split("fleet.migrate.")[1]: v for k, v in stats.items()
           if k.startswith("fleet.migrate.")}
    out = {"layers": FLEET_ROLL_LAYERS, "checkpoint_bytes": ckpt_bytes,
           "save_s": save_s, "boot_s": boot_s, "roll_s": roll_s,
           "roll_checkpoint_io": io,
           "swapped": report["swapped"], "versions": report["versions"],
           "downtime_ms": report["downtime_ms"],
           "migrated": report.get("migrated", {}), "migrate": mig,
           "swaps": swaps, "streams": len(done),
           "streams_by_version": {v: sum(1 for _, _, x in done if x == v)
                                  for v in versions},
           "failed": len(failed), "failed_kinds": sorted(
               {f.split(":")[0] for f in failed}),
           "b4_by_engine": per}
    log(f"phase 32 roll ({FLEET_ROLL_LAYERS} layers, full width; {smi}): "
        f"checkpoint {ckpt_bytes} bytes committed in {save_s:.1f} s; roll "
        f"{roll_s:.2f} s (its checkpoint reads, ms {io}), swapped "
        f"{report['swapped']} to {report['versions']}"
        f", downtime ms {report['downtime_ms']}, migrated "
        f"{out['migrated']}; {mig}; swaps {swaps}; {len(done)} streams "
        f"finished {out['streams_by_version']} by version, {len(bad)} "
        f"neither the old nor the new weights' ({bad}); {len(failed)} "
        f"refused or failed {out['failed_kinds']}; B4 by engine {per}")
    if bad or versions != [0, 1] or report["aborted"] \
            or sorted(report["swapped"]) != [0, 1] \
            or sum(out["migrated"].values()) < 1 \
            or mig.get("sequences_failed", 0) != 0 or failed \
            or any(s["swaps"] != 1 or s["compiles"] != 0 for s in swaps) \
            or len(swaps) != 2:
        raise RuntimeError(f"phase 32 roll: {out}")
    return out, launched


def fleet_phase(torch, fa_mod, dev, smi, reset_counters, read_counters):
    """Phase 32 (module docstring): the LLM fleet's data path on GPT-3
    1.3B, two paged replicas on one card. Returns (results, launches by
    path, {})."""
    import shutil
    import tempfile
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)          # phase 3's seed
    prompts = [rng.integers(0, CFG_13B["vocab_size"], n).tolist()
               for n in PROMPT_LENS]
    log(f"phase 32: the LLM fleet's data path on GPT-3 1.3B (seed 0, fp32): "
        f"two paged replicas under one Router on one card, phase 4's 8 "
        f"request lengths x {FLEET_NEW} new tokens: a park, a park over "
        f"int8 pages, a kill with replay and resurrection, a weight roll "
        f"({FLEET_ROLL_LAYERS} layers), the prefill->decode handoff; {smi}")
    out, launches = {}, {}
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    release_memory(torch)
    try:
        model = GPTForCausalLM(GPTConfig(**CFG_13B, attn_impl="flash"),
                               device=dev, seed=0).eval()
        ref_dec = GPTStaticDecoder(model)
        ref_params = ref_dec.params()
        out["park"], launches["fleet_park"], ref = fleet_park_lane(
            torch, model, prompts, "float32", smi, reset_counters,
            read_counters)
        release_memory(torch)
        noise = fleet_replay_noise(torch, model, dev, prompts[3], ref[3])
        out["kill"], launches["fleet_kill"] = fleet_kill_lane(
            torch, model, prompts, ref, noise, ref_dec, ref_params, smi,
            reset_counters, read_counters)
        release_memory(torch)
        out["park_int8"], launches["fleet_park_int8"], _ = fleet_park_lane(
            torch, model, prompts, "int8", smi, reset_counters,
            read_counters)
        release_memory(torch)
        out["handoff"], launches["fleet_handoff"] = fleet_handoff_lane(
            torch, model, dev, prompts, ref_dec, ref_params, smi,
            reset_counters, read_counters)
        del model, ref_dec, ref_params
        release_memory(torch)
        out["roll"], launches["fleet_roll"] = fleet_roll_lane(
            torch, dev, prompts, work, smi, reset_counters, read_counters)
        release_memory(torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 32 {out['seconds']:.1f} s")
    return out, launches, {}


# -- phase 33: the front door, the autoscaler, replay and the tuner ------------

FRONT_SCALE_S = 12.0      # seconds of arrivals in the autoscaler's storm
FRONT_OVERLOAD = 1.5      # the storm's rate over one replica's capacity
FRONT_TIMEOUT = 600.0     # every wait of the phase
TUNE_TRIALS = 5           # timed trials of each B4 candidate
TUNE_ITERS = 20           # launches a trial


def _http(url, payload=None, timeout=FRONT_TIMEOUT):
    """(status, body bytes, content type) of a GET, or of a JSON POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, method="GET" if payload is None else "POST",
        data=None if payload is None else json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers["Content-Type"]


def _generate_over_http(url, prompt, stream):
    """One ``/generate`` of FLEET_NEW tokens: (tokens, the server's
    req_ms, the client's wall ms)."""
    t0 = time.perf_counter()
    code, body, _ = _http(f"{url}/generate", {
        "prompt": prompt, "max_new_tokens": FLEET_NEW, "stream": stream,
        "timeout_s": FRONT_TIMEOUT})
    wall = (time.perf_counter() - t0) * 1e3
    if code != 200:
        raise RuntimeError(f"phase 33: /generate answered {code}: {body!r}")
    if not stream:
        out = json.loads(body)
        return out["tokens"], out["req_ms"], wall
    lines = [json.loads(ln) for ln in body.splitlines() if ln]
    if not lines[-1].get("done") or any("error" in ln for ln in lines):
        raise RuntimeError(f"phase 33: the stream ended with {lines[-1]}")
    return [ln["token"] for ln in lines[:-1]], lines[-1]["req_ms"], wall


def _prometheus_ok(text):
    """The families of a Prometheus text exposition (format 0.0.4), every
    sample line parsed as ``name{labels} value``; raises on a line that
    is neither."""
    import re
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                        r'(-?[0-9.eE+-]+|NaN|[+-]Inf)$')
    fams = set()
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            fams.add(ln.split()[2])
        elif ln and not ln.startswith("#") and not sample.match(ln):
            raise RuntimeError(f"phase 33: /metricsz line {ln!r} is not a "
                               f"Prometheus sample")
    return fams


def _in_process(router, prompts):
    """The 8 requests submitted at once to the router: (tokens, each
    one's ms from the submit to its result)."""
    done = {}
    t0 = time.perf_counter()
    reqs = [router.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    for i, r in enumerate(reqs):
        r.future.add_done_callback(
            lambda f, i=i: done.setdefault(i, time.perf_counter()))
    toks = [r.result(timeout=FRONT_TIMEOUT)["tokens"] for r in reqs]
    return toks, [(done[i] - t0) * 1e3 for i in range(len(reqs))]


def front_http_lane(torch, router, log_, prompts, smi, reset_counters,
                    read_counters):
    """Phase 33 lane 1: the 8 requests through ``make_server(router=)``
    on 127.0.0.1 from 8 client threads, twice (4 streaming and 4 not,
    then the other way round), against the same router's in-process run;
    ``/healthz``, ``/statsz`` and ``/metricsz``. Returns (results,
    launches, in-process tokens, HTTP tokens by round)."""
    from paddle_tpu_torch.serving.http import make_server
    reset_counters()
    _, base = log_.b4()
    ref, inproc_ms = _in_process(router, prompts)
    httpd = make_server(None, port=0, router=router)
    srv = threading.Thread(target=httpd.serve_forever, daemon=True)
    srv.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rounds = []
    try:
        for flip in (0, 1):
            got = [None] * len(prompts)

            def client(i):
                got[i] = _generate_over_http(url, prompts[i],
                                             (i + flip) % 2 == 0)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(FRONT_TIMEOUT)
            if any(g is None for g in got):
                raise RuntimeError("phase 33: a client thread failed")
            rounds.append(got)
        code, body, _ = _http(f"{url}/healthz")
        health = json.loads(body)
        if code != 200 or health["status"] != "ok" \
                or len(health["replicas"]) != 2:
            raise RuntimeError(f"phase 33: /healthz {code} {health}")
        code, body, _ = _http(f"{url}/statsz")
        st = json.loads(body)
        if code != 200 or set(st["router"]["replicas"]) != {"0", "1"}:
            raise RuntimeError(f"phase 33: /statsz {code} {list(st)}")
        code, body, ctype = _http(f"{url}/metricsz")
        fams = _prometheus_ok(body.decode())
        want_fams = {"paddle_tpu_serving_router_dispatched_total",
                     "paddle_tpu_serving_router_replica_healthy",
                     *(f"paddle_tpu_serving_llm_replica{r}_tokens_generated"
                       f"_total" for r in (0, 1))}
        if code != 200 or not ctype.startswith("text/plain; version=0.0.4") \
                or not want_fams <= fams:
            raise RuntimeError(f"phase 33: /metricsz {code} {ctype} lacks "
                               f"{sorted(want_fams - fams)}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.join(60)
    launched = read_counters()
    per, want = _fleet_check_b4("phase 33 http", launched, log_, base)
    for i in range(len(prompts)):
        if rounds[0][i][0] != rounds[1][i][0]:
            raise RuntimeError(f"phase 33: request {i}'s streamed and plain "
                               f"tokens differ")
    req_ms = [[g[1] for g in r] for r in rounds]
    out = {"requests": 2 * len(prompts), "streamed": len(prompts),
           "in_process_ms": inproc_ms, "req_ms": req_ms,
           "client_ms": [[g[2] for g in r] for r in rounds],
           "bitwise": sum(g[0] == a for r in rounds
                          for g, a in zip(r, ref)),
           "healthz": health["status"], "metric_families": len(fams),
           "b4_by_engine": per, "b4_launches": want}
    log(f"phase 33 http ({smi}): {out['bitwise']}/{out['requests']} token "
        f"lists bitwise the in-process run's; req_ms {req_ms} against "
        f"in-process {[round(x, 1) for x in inproc_ms]}; /healthz ok, "
        f"/statsz router and 2 replicas, /metricsz {len(fams)} families; "
        f"B4 {want} ({per})")
    return out, launched, ref, [[g[0] for g in r] for r in rounds]


def _one_replica_capacity(router, prompts):
    """Requests a second one replica serves: the 8 requests at once on
    replica 0 alone (replica 1 parked); also their ms."""
    t0 = time.perf_counter()
    _, ms = _in_process(router, prompts)
    wall = time.perf_counter() - t0
    return len(prompts) / wall, ms


def front_autoscale_lane(torch, router, log_, prompts, smi, reset_counters,
                         read_counters):
    """Phase 33 lane 2: ``Autoscaler(min 1, max 2)`` over the same router,
    fed by ``TraceReplayer`` over ``synthesize_trace(seed=0)`` with phase
    4's prompt lengths and FLEET_NEW tokens, at FRONT_OVERLOAD times the
    measured capacity of one replica; then calm until a scale-down."""
    from paddle_tpu_torch.serving.fleet import (SLO, Autoscaler,
                                                AutoscalerConfig,
                                                TraceReplayer,
                                                synthesize_trace)
    reg = router.registry
    reset_counters()
    _, base = log_.b4()
    t0 = time.perf_counter()
    if not router.park(1):
        raise RuntimeError("phase 33: replica 1 was not parked")
    park0_ms = (time.perf_counter() - t0) * 1e3
    cap, one_ms = _one_replica_capacity(router, prompts)
    rate = FRONT_OVERLOAD * cap
    slo = SLO(p95_ms=2.0 * max(one_ms), max_queue=len(prompts),
              min_replicas=1, max_replicas=2)
    trace = synthesize_trace(int(rate * FRONT_SCALE_S), rate, seed=0,
                             max_new_tokens=FLEET_NEW)
    for i, rec in enumerate(trace):
        rec["prompt_len"] = PROMPT_LENS[i % len(PROMPT_LENS)]
    scaler = Autoscaler(router, slo, AutoscalerConfig(
        interval_s=0.25, breach_ticks=2, calm_ticks=4, cooldown_s=2.0))
    t_start = time.perf_counter()
    with scaler:
        rep = TraceReplayer(router, trace, vocab=CFG_13B["vocab_size"],
                            request_timeout=FRONT_TIMEOUT, workers=256,
                            default_max_new_tokens=FLEET_NEW).run()
        deadline = time.monotonic() + FRONT_TIMEOUT
        while scaler.stats().get("fleet.autoscale.scale_downs", 0) < 1:
            if time.monotonic() > deadline:
                raise RuntimeError("phase 33: no scale-down once calm")
            time.sleep(0.05)
    seconds = time.perf_counter() - t_start
    stats = reg.stats()
    launched = read_counters()
    per, want = _fleet_check_b4("phase 33 autoscale", launched, log_, base)
    hist = {k: reg.histogram(f"fleet.autoscale.{k}")
            for k in ("breach_to_up_ms", "unpark_ms", "park_ms")}
    mig = {k.split("fleet.migrate.")[1]: v for k, v in stats.items()
           if k.startswith("fleet.migrate.")}
    out = {"rate_rps": rate, "one_replica_rps": cap,
           "one_replica_ms": one_ms, "slo_p95_ms": slo.p95_ms,
           "slo_max_queue": slo.max_queue, "offered": rep["offered"],
           "completed": rep["completed"], "dropped": rep["dropped"],
           "retries": rep["retries"], "latency_p50_ms": rep["latency_p50_ms"],
           "latency_p95_ms": rep["latency_p95_ms"],
           "arrival_lag_p95_ms": rep["arrival_lag_p95_ms"],
           "weights_versions": rep["weights_versions"],
           "scale_ups": stats.get("fleet.autoscale.scale_ups", 0),
           "scale_downs": stats.get("fleet.autoscale.scale_downs", 0),
           "resurrections": stats.get("serving.router.resurrections", 0),
           "ticks": stats.get("fleet.autoscale.ticks_total", 0),
           "tick_errors": stats.get("fleet.autoscale.tick_errors", 0),
           "breach_to_up_ms": hist["breach_to_up_ms"],
           "unpark_ms": hist["unpark_ms"], "park_ms": hist["park_ms"],
           "first_park_ms": park0_ms, "migrate": mig, "seconds": seconds,
           "b4_by_engine": per, "b4_launches": want}
    log(f"phase 33 autoscale ({smi}): one replica {cap:.2f} req/s, storm "
        f"{rate:.2f} req/s x {FRONT_SCALE_S} s ({rep['offered']} requests), "
        f"SLO p95 {slo.p95_ms:.0f} ms / queue {slo.max_queue}; completed "
        f"{rep['completed']}, dropped {rep['dropped']}, retries "
        f"{rep['retries']}; p50 {rep['latency_p50_ms']:.0f} ms p95 "
        f"{rep['latency_p95_ms']:.0f} ms; ups {out['scale_ups']} downs "
        f"{out['scale_downs']}; breach to admitting "
        f"{hist['breach_to_up_ms'].get('max')} ms, unpark "
        f"{hist['unpark_ms'].get('max')} ms, park {hist['park_ms']}; "
        f"migrate {mig}; B4 {want}")
    if rep["dropped"] or rep["completed"] != rep["offered"] \
            or rep["weights_versions"] != {0: rep["offered"]}:
        raise RuntimeError(f"phase 33 autoscale: {rep}")
    if out["scale_ups"] < 1 or hist["breach_to_up_ms"].get("count", 0) < 1 \
            or out["scale_downs"] < 1 or out["tick_errors"] \
            or mig.get("sequences_failed", 0):
        raise RuntimeError(f"phase 33 autoscale: no booted scale-up and "
                           f"scale-down, or a failure: {out}")
    return out, launched


def front_cli_lane(torch, dev, prompt, smi, reset_counters, read_counters):
    """Phase 33 lane 3: ``python -m paddle_tpu_torch.serving serve-llm
    --port 0`` at GPT-3 1.3B's widths (random weights) in a child
    process: the port line, ``/healthz``, one plain and one streaming
    ``/generate`` of the same prompt, ``/statsz``'s slot layout, and
    SIGTERM ending in "drained, bye" and exit 0. The launch counts are
    the child's, from its ``/statsz`` after both requests: its slot
    engine attends densely, so every kernel counts 0."""
    import queue
    import signal
    reset_counters()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.serving", "serve-llm",
           "--port", "0", "--device", str(dev),
           "--vocab-size", str(CFG_13B["vocab_size"]),
           "--hidden-size", str(CFG_13B["hidden_size"]),
           "--num-layers", str(CFG_13B["num_layers"]),
           "--num-heads", str(CFG_13B["num_heads"]),
           "--max-positions", str(CFG_13B["max_position_embeddings"]),
           "--num-slots", "8",
           "--max-seq", str(CFG_13B["max_position_embeddings"]),
           "--prefill-buckets", "64,{0},{1}".format(
               CFG_13B["max_position_embeddings"] // 2,
               CFG_13B["max_position_embeddings"]),
           "--max-new-tokens", str(FLEET_NEW)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, out_lines = queue.Queue(), []

    def read():
        for ln in proc.stdout:
            out_lines.append(ln)
            lines.put(ln.strip())
        lines.put(None)
    threading.Thread(target=read, daemon=True).start()
    try:
        port = None
        while port is None:
            ln = lines.get(timeout=FRONT_TIMEOUT)
            if ln is None:
                raise RuntimeError("phase 33: serve-llm exited before its "
                                   "port line: " + "".join(out_lines[-20:]))
            if ln.startswith("PADDLE_TPU_SERVING_PORT="):
                port = int(ln.split("=", 1)[1])
        boot_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        code, body, _ = _http(f"{url}/healthz")
        health = json.loads(body)
        plain, plain_ms, _ = _generate_over_http(url, prompt, False)
        streamed, stream_ms, _ = _generate_over_http(url, prompt, True)
        stats = json.loads(_http(f"{url}/statsz")[1])
        st, launched = stats["llm"], stats["kernel_launches"]
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=FRONT_TIMEOUT)
        drain_s = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
    while lines.get(timeout=60) is not None:
        pass
    text = "".join(out_lines)
    here = read_counters()
    out = {"boot_s": boot_s, "drain_s": drain_s, "exit_code": rc,
           "healthz": [code, health], "kv_layout": st["kv_layout"],
           "device": st["device"], "tokens_equal": plain == streamed,
           "req_ms": [plain_ms, stream_ms], "child_launches": launched}
    log(f"phase 33 cli ({smi}): serve-llm booted in {boot_s:.1f} s (the "
        f"port line), /healthz {code} {health}, plain and streamed tokens "
        f"equal {plain == streamed} ({len(plain)} tokens, req_ms "
        f"{plain_ms:.1f} / {stream_ms:.1f}), engine {st['kv_layout']} on "
        f"{st['device']}, the child's kernel launches {launched}; "
        f"SIGTERM: exit {rc} in {drain_s:.1f} s")
    if code != 200 or health.get("status") != "ok" or plain != streamed \
            or len(plain) != FLEET_NEW or rc != 0 \
            or "drained, bye" not in text or st["kv_layout"] != "slot" \
            or st["device"] != str(dev) or set(launched) != set(here) \
            or any(launched.values()) or any(here.values()):
        raise RuntimeError(f"phase 33 cli: {out}\n{text[-2000:]}")
    return out, launched


def tuner_lane(torch, pa_mod, dev, gen, smi, reset_counters, read_counters):
    """Phase 33 lane 4: ``autotune_paged_attn`` at phase 4's B4 shape (8
    sequences, 16 heads of 128, 16-row pages, 64 pages: the 1024 rows)
    into a temporary cache, recorded; at 8 pages (128 rows) not recorded;
    then the winner read back from disk after ``clear_memo()`` while B4's
    launch-path lookup stays what it was before the search, and B4 under
    the winner on phase 2's inputs: within 1e-4 of plain, bitwise
    repeatable, captured and replayed in a CUDA graph."""
    import shutil
    import tempfile
    from paddle_tpu_torch import tuner
    from paddle_tpu_torch.core import graphs
    work = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    old = os.environ.get("PADDLE_TPU_TUNE_CACHE")
    os.environ["PADDLE_TPU_TUNE_CACHE"] = work
    tuner.clear_memo()
    main_bps = tuner.paged_blocks_per_sm(16, 128, 16, torch.float32, dev)
    try:
        reset_counters()
        res = {pps: tuner.autotune_paged_attn(
            8, 16, 128, 16, pages_per_seq=pps, trials=TUNE_TRIALS,
            iters=TUNE_ITERS, record=pps == 64, device=dev)
            for pps in (64, 8)}
        in_search = read_counters()
        searched = in_search["paged_attention"]
        calls = sum(r["launches"] for r in res.values())
        if searched != calls:
            raise RuntimeError(f"phase 33 tuner: B4 launched {searched} "
                               f"times in the search, not its {calls} calls")
        win = res[64]["blocks_per_sm"]
        tuner.clear_memo()
        back = (tuner.get_paged_attn_config(16, 128, 16, "float32",
                                            device=dev)
                or {}).get("blocks_per_sm")
        main_after = tuner.paged_blocks_per_sm(16, 128, 16, torch.float32,
                                               dev)
        q, kb, vb, bt = paged_case(torch, gen)
        pos = torch.tensor(PAGED_CASES[0][1], dtype=torch.int32, device=dev)
        reset_counters()
        out = pa_mod.paged_attention(q, kb, vb, bt, pos, blocks_per_sm=win)
        again = pa_mod.paged_attention(q, kb, vb, bt, pos,
                                       blocks_per_sm=win)
        ref = pa_mod.paged_attention_plain(q, kb, vb, bt, pos)
        prog = graphs.Program(lambda params, state, q, positions:
                              pa_mod.paged_attention(q, kb, vb, bt,
                                                     positions,
                                                     blocks_per_sm=win))
        state = _GraphState(graphs, dev)
        prog(None, state, q.clone(), pos.clone())
        replays = [prog(None, state, q.clone(), pos.clone())
                   for _ in range(3)]
        torch.cuda.synchronize()
        in_checks = read_counters()
        held = in_checks["paged_attention"]
        err = (out - ref).abs().max().item()
        same = torch.equal(out, again)
        replayed = all(torch.equal(r, out) for r in replays)
        # the winner against the rule on phase 2's positions, in turns
        # (outside the counted window)
        ab = {"rule": [], "winner": []}
        for lane in ("rule", "winner", "winner", "rule"):
            bps = pa_mod.BLOCKS_PER_SM if lane == "rule" else win
            ab[lane].append(time_ms(lambda: pa_mod.paged_attention(
                q, kb, vb, bt, pos, blocks_per_sm=bps), spin=True))
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_TUNE_CACHE", None)
        else:
            os.environ["PADDLE_TPU_TUNE_CACHE"] = old
        tuner.clear_memo()
        shutil.rmtree(work, ignore_errors=True)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for pps, r in res.items():
        rule = repr({"blocks_per_sm": pa_mod.BLOCKS_PER_SM})
        best = repr({"blocks_per_sm": r["blocks_per_sm"]})

        def spread(k):
            t = r["rounds"][k]
            return (max(t) - min(t)) * 1e6
        rows[pps] = {
            "candidates": {k: {"us": v * 1e6, "chunk_pages":
                               r["chunk_pages"][k],
                               "trials_us": [t * 1e6 for t in
                                             r["rounds"][k]]}
                           for k, v in r["results"].items()},
            "pruned_early": sorted(set(r["rounds"]) - set(r["results"])),
            "winner": r["blocks_per_sm"], "winner_us": r["us"],
            "rule_us": r["rule"]["us"],
            "beats_rule_by_more_than_spread":
                r["rule"]["us"] - r["us"] > max(spread(rule), spread(best)),
            "launches": r["launches"]}
        log(f"phase 33 tuner ({smi}): B4 8 x 16 x 128, page 16, {pps} pages "
            f"a sequence, {n_sms} SMs: " + ", ".join(
                f"{k} {v['us']:.2f} us ({v['chunk_pages']} pages a chunk)"
                for k, v in rows[pps]["candidates"].items())
            + f"; rule {r['rule']['us']:.2f} us, winner "
              f"{r['blocks_per_sm']} at {r['us']:.2f} us, beats the rule "
              f"by more than the trials' spread: "
              f"{rows[pps]['beats_rule_by_more_than_spread']}")
    out_row = {"shapes": rows, "winner": win, "read_back": back,
               "main_path_blocks_per_sm": [main_bps, main_after],
               "max_abs_err": err, "bitwise_repeatable": same,
               "graph_replays_bitwise": replayed,
               "phase2_positions_ms": ab,
               "search_launches": searched, "check_launches": held}
    log(f"phase 33 tuner: winner {win} read back from disk as {back}; "
        f"B4's launch-path target {main_bps} before the search, {main_after}"
        f" after (None: the rule); B4 under the winner on phase 2's inputs max_abs_err {err:.3e} (tol "
        f"{TOL['fp32']:.0e}), bitwise repeatable {same}, 3 graph replays "
        f"bitwise {replayed}; launches {searched} searching, {held} holding;"
        f" at phase 2's positions in turns rule "
        f"{'/'.join(f'{x:.4f}' for x in ab['rule'])} ms, winner "
        f"{'/'.join(f'{x:.4f}' for x in ab['winner'])} ms")
    if back != win or main_after != main_bps or err > TOL["fp32"] \
            or not same or not replayed or held != 6:
        raise RuntimeError(f"phase 33 tuner: {out_row}")
    return out_row, {k: in_search[k] + in_checks[k] for k in in_search}


def front_door_phase(torch, fa_mod, dev, smi, reset_counters, read_counters):
    """Phase 33 (module docstring): the HTTP front door over two paged
    replicas of GPT-3 1.3B, the SLO autoscaler under a replayed storm, the
    ``serve-llm`` CLI, and the tuner's B4 family. Returns (results,
    launches by path, {})."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import paged_attention as pa_mod
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)          # phase 3's seed
    prompts = [rng.integers(0, CFG_13B["vocab_size"], n).tolist()
               for n in PROMPT_LENS]
    log(f"phase 33: the front door on GPT-3 1.3B (seed 0, fp32): HTTP over "
        f"two paged replicas under one Router, the SLO autoscaler under a "
        f"replayed storm, the serve-llm CLI, the tuner's B4 family; {smi}")
    out, launches = {}, {}
    release_memory(torch)
    model = GPTForCausalLM(GPTConfig(**CFG_13B, attn_impl="flash"),
                           device=dev, seed=0).eval()
    log_ = _FleetLog()
    router, _, boot_s = _fleet_router(torch, log_, lambda r: model,
                                      _fleet_cfg(), CFG_13B["num_layers"])
    out["boot_s"] = boot_s
    try:
        out["http"], launches["front_http"], ref, got = front_http_lane(
            torch, router, log_, prompts, smi, reset_counters,
            read_counters)
        out["autoscale"], launches["front_autoscale"] = front_autoscale_lane(
            torch, router, log_, prompts, smi, reset_counters, read_counters)
    finally:
        router.drain(timeout=FRONT_TIMEOUT)
    if out["http"]["bitwise"] != 2 * len(prompts):
        noise = fleet_replay_noise(torch, model, dev, prompts[3], ref[3])
        ref_dec = GPTStaticDecoder(model)
        out["http"]["near_tie_parts"] = [near_tie_parts(
            torch, ref_dec, ref_dec.params(), prompts, ref, g,
            noise["noise"], "phase 33 http") for g in got]
        out["http"]["noise"] = noise
    del router, model
    release_memory(torch)
    out["cli"], launches["front_cli"] = front_cli_lane(
        torch, dev, prompts[3], smi, reset_counters, read_counters)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)
    out["tuner"], launches["tuner"] = tuner_lane(
        torch, pa_mod, dev, gen, smi, reset_counters, read_counters)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 33 {out['seconds']:.1f} s")
    return out, launches, {}


# -- phase 34: distributed training, first half ------------------------------

DIST_STEPS = 3            # train steps of the world-of-one and dp x mp lanes
DIST_LR = 1e-4            # their AdamW's lr and epsilon: with the default
DIST_EPS = 1e-6           # 1e-8 an element whose gradient is near zero
#                           moves by a rounding-driven part of lr, so two
#                           runs summing in other orders part by up to 2 lr
#                           a step (as tests/test_torch_hapi_train.py)
DIST_DP_LAYERS = 4        # depth of the four-rank dp2 x mp2 GPT (full width)
DIST_BATCH = (4, 1024)    # global batch of both GPT lanes
DIST_LOSS_RTOL = 1e-4     # dp2 x mp2 losses against one process, relative
DIST_PARAM_TOL = 1e-4     # its gathered parameters, of each tensor's max,
DIST_PARAM_LR_PART = 0.05  # or of one AdamW step (lr), the larger
DIST_RING_SEQ = 32768     # bench_gpt_ring_flash's sequence, Tl = 8192 a rank
DIST_RING_LAYERS = 2
DIST_RING_STEPS = 2
DIST_RING_HEADS = 16      # GPT-3 1.3B's width: 16 heads of 128
DIST_RING_INIT_STD = 0.02
DIST_RING_LOSS_TOL = 2e-2  # relative
DIST_RING_O_TOL = 2e-2    # bf16: the ring's first O against whole-S B1's
# the bounds below are about twice to ten times the errors measured on an
# H100 (2.7e-3, 1.9e-6 and 4.4e-3 at most); whole-S B1's own O is 1.8e-3
# from the plain version's
DIST_RING_LSE_TOL = 2e-5  # its merged LSE against B1's and the plain
#                           version's (f32 rows)
DIST_RING_O_RTOL = 6e-3   # the ring's first O a rank, relative (Frobenius),
#                           against whole-S B1's and against the plain
#                           version at DIST_RING_PLAIN_ROWS rows
DIST_RING_PLAIN_ROWS = 32  # rows at each end of each rank's chunk
DIST_RING_GRAD_RTOL = 1e-2  # the first step's wq, wk, wv gradients of each
#                           layer, summed over the ranks, relative
#                           (Frobenius), against whole-S B1-B3's: wq's
#                           comes only through B2's dQ, wk's and wv's only
#                           through B3's dK and dV
DIST_WORLD = 4
DIST_TIMEOUT = 600


def _dist_ids():
    return np.random.default_rng(34).integers(
        0, CFG_13B["vocab_size"], DIST_BATCH)


def _dist_gpt(torch, dev, layers=None):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = dict(CFG_13B, num_layers=layers or CFG_13B["num_layers"])
    return GPTForCausalLM(GPTConfig(**cfg, attn_impl="flash"), device=dev,
                          seed=0)


def _dist_model(net, dev, wrap=lambda opt: opt):
    """``Model`` over ``net`` with AdamW (lr DIST_LR, epsilon DIST_EPS,
    weight decay 0.01),
    passed through ``wrap`` (``fleet.distributed_optimizer``), and the GPT
    criterion."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    opt = wrap(AdamW(learning_rate=DIST_LR, parameters=net.parameters(),
                     weight_decay=0.01, epsilon=DIST_EPS, device=dev))
    m = Model(net, device=dev)
    m.prepare(opt, GPTPretrainingCriterion())
    return m


def _dist_steps(torch, m, x, steps, o1=False):
    """``steps`` train_batch calls; returns (losses, step ms each)."""
    from paddle_tpu_torch import amp
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (amp.auto_cast() if o1 else contextlib.nullcontext()):
            losses.append(m.train_batch([x], [x])[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def collectives_at_world_one(torch, dev):
    """Every collective of ``collective.py`` on CUDA tensors in the NCCL
    world of one: each must be the identity (returns their names)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    x = torch.arange(8, dtype=torch.float32, device=dev)
    want = x.clone()
    checked = []

    def same(name, got):
        got = got if isinstance(got, torch.Tensor) else x
        if not torch.equal(got.reshape(-1)[:8], want):
            raise RuntimeError(f"{name} at a world of one is not the "
                               f"identity: {got}")
        checked.append(name)
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        same(f"all_reduce_{op}", dist.all_reduce(x, getattr(C.ReduceOp, op)))
    same("reduce", dist.reduce(x, 0))
    same("broadcast", dist.broadcast(x, 0))
    same("all_gather", dist.all_gather([], x)[0])
    same("reduce_scatter", dist.reduce_scatter(None, x))
    same("alltoall", dist.alltoall(x))
    same("p2p_exchange", dist.p2p_exchange(x, 0, 0))
    same("send", dist.send(x, 0))
    same("recv", dist.recv(x, 0))
    same("scatter", dist.scatter(x, [x], 0))
    same("compressed_all_reduce", dist.compressed_all_reduce(x))
    objs = dist.all_gather_object([], {"r": 0})
    if objs != [{"r": 0}]:
        raise RuntimeError(f"all_gather_object at a world of one: {objs}")
    dist.barrier()
    dist.wait(x)
    return checked + ["all_gather_object", "barrier", "wait"]


def dist_world1_lane(torch, fa_mod, dev, smi, reset_counters, read_counters):
    """Lane 34.1: init_parallel_env on CUDA (NCCL, a world of one), a dp1
    x mp1 mesh, GPT-3 1.3B laid out by ``tp_partition_specs`` and its
    batch by ``shard_batch`` (the ``dryrun_multichip`` path), O1 AdamW
    through ``Model.train_batch``, graphed, against the same model
    without a mesh: losses bitwise. B1-B3 24 a step each."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.models import gpt as gpt_mod
    out = {}
    t0 = time.perf_counter()
    env = dist.init_parallel_env()
    out["backend"] = dist.env.backend()
    mesh = dist.build_mesh({"dp": 1, "mp": 1})
    dist.set_mesh(mesh)
    out["collectives_identity"] = collectives_at_world_one(torch, dev)
    ids = torch.as_tensor(_dist_ids(), device=dev)
    try:
        release_memory(torch)
        net = _dist_gpt(torch, dev)
        specs = gpt_mod.tp_partition_specs(net)
        for name, p in list(net.named_parameters()):
            dist.shard_tensor(p, specs[name], mesh)
        m = _dist_model(net, dev)
        x = dist.shard_batch(ids, mesh)
        reset_counters()
        losses, ms = _dist_steps(torch, m, x, DIST_STEPS, o1=True)
        launches = read_counters()
        dtypes = {c.__name__: dict(c.launches_by_dtype)
                  for c in _counters(fa_mod)}
        out.update(lane=m.lane, lane_reason=m.lane_reason, losses=losses,
                   step_ms=ms, peak_gib=torch.cuda.max_memory_allocated()
                   / 2 ** 30, rank=env.rank, world=env.world_size,
                   traces=m._train_step_fn["fn"].trace_counter["traces"])
        m._invalidate_compiled()
        del m, net, x
        release_memory(torch)
        ref = _dist_model(_dist_gpt(torch, dev), dev)
        ref_losses, ref_ms = _dist_steps(torch, ref, ids, DIST_STEPS,
                                         o1=True)
        ref._invalidate_compiled()
        del ref
        release_memory(torch)
    finally:
        dist.set_mesh(None)
    out.update(ref_losses=ref_losses, ref_step_ms=ref_ms,
               bitwise=losses == ref_losses,
               seconds=time.perf_counter() - t0)
    log(f"phase 34.1 world of one ({out['backend']}, dp1 x mp1 mesh, "
        f"GPT-3 1.3B O1, lane {out['lane']}): losses {losses} vs no mesh "
        f"{ref_losses}; step ms {[round(v, 1) for v in ms]} vs "
        f"{[round(v, 1) for v in ref_ms]}; peak {out['peak_gib']:.2f} GiB; "
        f"{out['seconds']:.1f} s; {smi}")
    if out["lane"] != "graphed":
        raise RuntimeError(f"phase 34.1: the world of one ran the "
                           f"{out['lane']} lane ({out['lane_reason']})")
    if not out["bitwise"]:
        raise RuntimeError("phase 34.1: the mesh model's losses are not "
                           "bitwise those without a mesh")
    for c in _counters(fa_mod):
        want = CFG_13B["num_layers"] * DIST_STEPS
        if launches[c.__name__] != want:
            raise RuntimeError(f"phase 34.1: {c.__name__} launched "
                               f"{launches[c.__name__]} times, not {want}")
    return out, launches, dtypes


def _nccl_rank():
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()


def nccl_refusal():
    """Two NCCL ranks on the one card, started (not joined): NCCL refuses
    them ("Duplicate GPU detected"); the port keeps the refusal, no
    backend switch. Returns the ranks' context for
    :func:`nccl_refused`."""
    import paddle_tpu_torch.distributed as dist
    return dist.spawn(_nccl_rank, nprocs=2, gpus="0,0", backend="nccl",
                      join=False), time.perf_counter()


def nccl_refused(started):
    ctx, t0 = started
    try:
        ctx.join(DIST_TIMEOUT)
    except RuntimeError as e:
        if "Duplicate GPU" not in str(e):
            raise
        line = next(ln for ln in str(e).splitlines() if "Duplicate" in ln)
        log(f"phase 34: NCCL refused two ranks on one card, as expected: "
            f"{line.strip()} ({time.perf_counter() - t0:.1f} s)")
        return line.strip()
    raise RuntimeError("phase 34: NCCL took two ranks on one card")


def _ring_weights(torch, dev):
    """bench_gpt_ring_flash's stack at GPT-3 1.3B's width (bf16, seeded on
    the device), and its x, y. bench.py draws N(0, 0.1) weights for its
    E = 512; at E = 2048 each product would grow the activations 4.5
    times and SGD at lr 0.1 diverges (NaN by the second step), so the
    weights are N(0, 0.02), GPT-3's own init."""
    E = CFG_13B["hidden_size"]
    g = torch.Generator(device=dev)
    g.manual_seed(34)

    def w(*shape):
        return (torch.randn(shape, generator=g, device=dev)
                * DIST_RING_INIT_STD).to(torch.bfloat16)
    params = [[w(E, E), w(E, E), w(E, E), w(E, E), w(E, 2 * E),
               w(2 * E, E)] for _ in range(DIST_RING_LAYERS)]
    x = torch.randn((1, DIST_RING_SEQ, E), generator=g, device=dev).to(
        torch.bfloat16)
    y = torch.randn((1, DIST_RING_SEQ, E), generator=g, device=dev).to(
        torch.bfloat16)
    return params, x, y


def _ring_layer(torch, h, lp, attn):
    """One block of bench.py's ring stack: ``attn`` on ``[B, H, T, D]``."""
    wq, wk, wv, wo, w1, w2 = lp
    B, T, E = h.shape
    H = DIST_RING_HEADS

    def heads(w):
        return (h @ w).reshape(B, T, H, E // H).transpose(1, 2)
    o = attn(heads(wq), heads(wk), heads(wv))
    h = h + o.transpose(1, 2).reshape(B, T, E) @ wo
    return h + torch.nn.functional.gelu(h @ w1) @ w2


def _ring_step(torch, params, x, y, attn, whole=lambda t: t,
               reduced=lambda g: g):
    """One SGD step (lr 0.1) of the stack; returns the loss and the
    gradients it stepped with. ``whole`` makes the loss one value,
    ``reduced`` a gradient the parameter's layout (on a mesh: the sum of
    the ranks' partials)."""
    flat = [p for lp in params for p in lp]
    h = x
    for lp in params:
        h = _ring_layer(torch, h, lp, attn)
    loss = whole(((h - y).float() ** 2).mean())
    grads = [reduced(g) for g in torch.autograd.grad(loss, flat)]
    with torch.no_grad():
        for p, g in zip(flat, grads):
            p -= 0.1 * g
    return float(loss.detach()), grads


def _qkv_grads(grads, local=lambda g: g):
    """The wq, wk and wv gradients of each layer, on the host."""
    return [local(grads[6 * i + j]).detach().cpu()
            for i in range(DIST_RING_LAYERS) for j in range(3)]


def _plain_rows():
    """The query rows held to the plain version: DIST_RING_PLAIN_ROWS at
    each end of each rank's chunk (the first see the fewest keys of the
    chunk, the last the most)."""
    tl, n = DIST_RING_SEQ // DIST_WORLD, DIST_RING_PLAIN_ROWS
    return np.concatenate([np.r_[r * tl:r * tl + n, (r + 1) * tl - n:
                                 (r + 1) * tl] for r in range(DIST_WORLD)])


def plain_rows_attention(torch, q, k, v, rows):
    """Causal attention's plain version at the query ``rows`` only, in
    f32 from the same q, k, v ``[B, S, H, D]``: ``(o [B, H, R, D], lse
    [B, H, R])`` on the host."""
    idx = torch.as_tensor(rows, device=q.device)
    qf = q[:, idx].float().transpose(1, 2) * q.shape[-1] ** -0.5
    s = qf @ k.float().permute(0, 2, 3, 1)                  # [B, H, R, S]
    keep = torch.arange(k.shape[1], device=q.device)[None, :] <= idx[:, None]
    s = s.masked_fill(~keep, float("-inf"))
    o = torch.softmax(s, -1) @ v.float().transpose(1, 2)
    return o.cpu(), torch.logsumexp(s, -1).cpu()


def _rel(a, b):
    """``|a - b| / |b|`` (Frobenius) in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def ring_reference(torch, dev):
    """The ring stack in one process, B1-B3 over the whole sequence
    (``flash_attention``), DIST_RING_STEPS steps: the losses, the first
    step's wq, wk and wv gradients, the first layer's first-forward O and
    LSE (B1 alone), and the plain version's at :func:`_plain_rows`."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    t0 = time.perf_counter()
    params, x, y = _ring_weights(torch, dev)
    with torch.no_grad():
        wq, wk, wv = params[0][:3]
        B, T, E = x.shape
        H = DIST_RING_HEADS
        q, k, v = ((x @ w).reshape(B, T, H, E // H) for w in (wq, wk, wv))
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        o_ref = o.transpose(1, 2).float().cpu()
        lse_ref = lse.cpu()
        plain = plain_rows_attention(torch, q, k, v, _plain_rows())
        del q, k, v, o, lse
    for p in (p for lp in params for p in lp):
        p.requires_grad_(True)

    def attn(q, k, v):
        out, _ = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=True)
        return out.transpose(1, 2)
    losses, ms, grads0 = [], [], None
    for i in range(DIST_RING_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, grads = _ring_step(torch, params, x, y, attn)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
        if i == 0:
            grads0 = _qkv_grads(grads)
        del grads
    del params, x, y
    release_memory(torch)
    return {"losses": losses, "step_ms": ms,
            "seconds": time.perf_counter() - t0}, o_ref, lse_ref, plain, \
        grads0


def dp_reference(torch, dev):
    """The 4-layer GPT at full width in one process on the card: fp32
    AdamW, DIST_STEPS steps on the global batch (eager, as the four-rank
    lane runs); the losses and the parameters after the last step."""
    from paddle_tpu_torch.core.graphs import disable_graphs
    t0 = time.perf_counter()
    net = _dist_gpt(torch, dev, DIST_DP_LAYERS)
    m = _dist_model(net, dev)
    ids = torch.as_tensor(_dist_ids(), device=dev)
    with disable_graphs():
        losses, ms = _dist_steps(torch, m, ids, DIST_STEPS)
    params = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    del m, net
    release_memory(torch)
    return {"losses": losses, "step_ms": ms,
            "seconds": time.perf_counter() - t0}, params


def _rank_counts(fa_mod):
    return {c.__name__: c.launches for c in _counters(fa_mod)}


def _zero_counts(fa_mod):
    for c in _counters(fa_mod):
        c.launches = 0
        c.launches_by_dtype = {}


def _rank_dp_lane(torch, fa_mod, dev, work):
    """Lane 34.2a on this rank: fleet.init (dp2 x mp2), the 4-layer GPT
    at full width laid out by tp_partition_specs, distributed_model and
    distributed_optimizer, fp32 AdamW through Model.train_batch (the
    eager lane: gloo's collectives cannot be captured)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt as gpt_mod
    t0 = time.perf_counter()
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    net = _dist_gpt(torch, dev, DIST_DP_LAYERS)
    specs = gpt_mod.tp_partition_specs(net)
    for name, p in list(net.named_parameters()):
        dist.shard_tensor(p, specs[name])
    net = fleet.distributed_model(net)
    m = _dist_model(net, dev, fleet.distributed_optimizer)
    x = dist.shard_batch(torch.as_tensor(_dist_ids(), device=dev))
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa_mod)
    losses, ms = _dist_steps(torch, m, x, DIST_STEPS)
    launches = _rank_counts(fa_mod)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sd = net.state_dict()                      # gathered, global shapes
    if dist.get_rank() == 0:
        torch.save({k: v.cpu() for k, v in sd.items()},
                   os.path.join(work, "dp_params.pt"))
    q = net.gpt.decoder.layers[0].self_attn.q_proj.weight
    out = {"losses": losses, "step_ms": ms, "lane": m.lane,
           "lane_reason": m.lane_reason, "launches": launches,
           "peak_gib": peak, "local_q_proj": tuple(q.to_local().shape),
           "mode": fleet.get_hybrid_communicate_group_().get_parallel_mode(),
           "seconds": time.perf_counter() - t0}
    del m, net, sd
    dist.set_mesh(None)
    dist.set_hybrid_communicate_group(None)
    release_memory(torch)
    return out


def _rank_ring_lane(torch, fa_mod, dev):
    """Lane 34.2b on this rank: the ring stack over an sp4 mesh, x and y
    sequence-sharded, the weights replicated; the first layer's first
    O and LSE from the ring's forward (counted apart), then
    DIST_RING_STEPS SGD steps with ``ring_flash_attention``."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import sequence_parallel as sp
    t0 = time.perf_counter()
    mesh = dist.build_mesh({"sp": DIST_WORLD})
    dist.set_mesh(mesh)
    params, x, y = _ring_weights(torch, dev)
    B, T, E = x.shape
    H = DIST_RING_HEADS
    xs = dist.constrain(x, (None, "sp", None), mesh)
    ys = dist.constrain(y, (None, "sp", None), mesh)
    ps = [[dist.replicate_tensor(w, mesh).detach().requires_grad_(True)
           for w in lp] for lp in params]
    del params, x, y
    with torch.no_grad():
        g = sp._ring_group(mesh, "sp")
        qkv = [(xs.to_local() @ w.to_local()).reshape(
            B, T // DIST_WORLD, H, E // H).transpose(1, 2)
            for w in ps[0][:3]]
        o, lse = sp.ring_flash_forward(*qkv, g, True, None)
        first = (o.float().cpu().numpy(), lse.cpu().numpy())
    staged0 = dict(dist.collective.HOST_STAGED)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa_mod)

    def attn(q, k, v):
        return sp.ring_flash_attention(q, k, v, mesh=mesh, axis="sp",
                                       causal=True)

    def reduced(g):
        from torch.distributed.tensor import Replicate
        return g.redistribute(mesh, [Replicate()])
    losses, ms = [], []
    for i in range(DIST_RING_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, grads = _ring_step(torch, ps, xs, ys, attn, dist.mesh.full,
                                 reduced)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
        if i == 0:
            # summed over the ranks: every rank holds the same values
            grads0 = _qkv_grads(grads, lambda g: g.to_local())
        del grads
    launches = _rank_counts(fa_mod)
    staged = {k: dist.collective.HOST_STAGED[k] - staged0[k]
              for k in staged0}
    out = {"losses": losses, "step_ms": ms, "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first": first, "host_staged": staged,
           "grad_sums": [float(g.double().sum()) for g in grads0],
           "grads0": grads0 if dist.get_rank() == 0 else None,
           "seconds": time.perf_counter() - t0}
    del ps, xs, ys
    dist.set_mesh(None)
    release_memory(torch)
    return out


def _rank_collectives(torch, dev):
    """Lane 34.2c on this rank: every collective once on CUDA tensors,
    over the world, a rank subgroup and the hybrid axes; returns the
    results as arrays (the parent holds them to NumPy), and the
    compressed all-reduce's int8 codes and scales."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    r = dist.get_rank()
    base = np.arange(8, dtype=np.float32) + 10 * r
    x = torch.as_tensor(base, device=dev)
    res = {}
    for name in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = x.clone()
        dist.all_reduce(t, getattr(C.ReduceOp, name))
        res[f"all_reduce_{name}"] = t.cpu().numpy()
    sub = dist.new_group([1, 3])
    t = x.clone()
    dist.all_reduce(t, group=sub)
    res["all_reduce_sub"] = t.cpu().numpy()
    t = x.clone()
    dist.broadcast(t, 2)
    res["broadcast"] = t.cpu().numpy()
    t = x.clone()
    dist.broadcast(t, 3, group=sub)
    res["broadcast_sub"] = t.cpu().numpy()
    t = x.clone()
    dist.reduce(t, 1)
    res["reduce"] = t.cpu().numpy()
    res["all_gather"] = dist.all_gather([], x).cpu().numpy()
    if r in (1, 3):
        res["all_gather_sub"] = dist.all_gather([], x, group=sub) \
            .cpu().numpy()
    res["reduce_scatter"] = dist.reduce_scatter(None, x).cpu().numpy()
    res["alltoall"] = dist.alltoall(x).cpu().numpy()
    res["p2p_exchange"] = dist.p2p_exchange(x.clone(), 0, 2).cpu().numpy()
    t = x.clone()
    if r == 3:
        dist.send(t, 0)
    elif r == 0:
        dist.recv(t, 3)
    res["send_recv"] = t.cpu().numpy()
    t = torch.zeros_like(x)
    dist.scatter(t, [x * 0 + i for i in range(DIST_WORLD)]
                 if r == 2 else None, 2)
    res["scatter"] = t.cpu().numpy()
    res["objects"] = dist.all_gather_object([], ("rank", r))
    dist.barrier()
    dist.wait(x)
    hcg = dist.HybridCommunicateGroup(dp_degree=2, mp_degree=2)
    for axis, grp in (("dp", hcg.get_data_parallel_group()),
                      ("mp", hcg.get_model_parallel_group())):
        t = x.clone()
        dist.all_reduce(t, group=grp)
        res[f"all_reduce_{axis}"] = t.cpu().numpy()
        res[f"members_{axis}"] = C._get_group(grp)._members()
    dist.set_mesh(dist.build_mesh({"dp": DIST_WORLD}))
    grad = torch.as_tensor(np.random.default_rng(r).standard_normal(
        4096).astype(np.float32), device=dev)
    q, s = C._block_quantize_int8(grad.reshape(-1, 256))
    res["codes"], res["scales"] = q.cpu().numpy(), s.cpu().numpy()
    t = grad.clone()
    dist.compressed_all_reduce(t, C.ReduceOp.AVG, group=C.Group(axis="dp"))
    res["compressed"] = t.cpu().numpy()
    res["grad"] = grad.cpu().numpy()
    dist.set_mesh(None)
    dist.set_hybrid_communicate_group(None)
    return res


def _dist_rank(work):
    """A rank of phase 34's world of four on the one card (gloo): lanes
    34.2a, 34.2b and 34.2c; pickles its results into ``work``."""
    import faulthandler
    import pickle
    import torch
    import paddle_tpu_torch.distributed as dist
    faulthandler.enable()
    fa_mod = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    t0 = time.perf_counter()
    env = dist.init_parallel_env()
    dev = dist.env._rank_device()
    res = {"rank": env.rank, "backend": dist.env.backend(),
           "init_s": time.perf_counter() - t0}
    log(f"phase 34 rank {env.rank}: up in {res['init_s']:.1f} s")
    res["collectives"] = _rank_collectives(torch, dev)
    log(f"phase 34 rank {env.rank}: 34.2c done")
    # the timed lanes wait for the parent's one-process references to
    # leave the card
    go = os.path.join(work, "go")
    deadline = time.perf_counter() + DIST_TIMEOUT
    while not os.path.exists(go):
        if time.perf_counter() > deadline:
            raise RuntimeError("phase 34: the parent never said go")
        time.sleep(0.05)
    res["dp"] = _rank_dp_lane(torch, fa_mod, dev, work)
    log(f"phase 34 rank {env.rank}: 34.2a done")
    res["ring"] = _rank_ring_lane(torch, fa_mod, dev)
    log(f"phase 34 rank {env.rank}: 34.2b done")
    res["imported"] = sorted(m for m in ("jax", "paddle_tpu")
                             if m in sys.modules)
    with open(os.path.join(work, f"rank{env.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.env.destroy_process_group()


def _check_collectives(results):
    """Hold lane 34.2c's results to NumPy; returns the checks made."""
    from paddle_tpu_torch.distributed import collective as C
    n = DIST_WORLD
    xs = [np.arange(8, dtype=np.float32) + 10 * r for r in range(n)]
    red = {"SUM": sum(xs), "MAX": np.max(xs, 0), "MIN": np.min(xs, 0),
           "PROD": np.prod(np.array(xs, np.float64), 0).astype(np.float32),
           "AVG": sum(xs) / n}
    checks = 0

    def hold(name, got, want, exact=False):
        nonlocal checks
        if exact:
            ok = np.array_equal(got, want)
        else:
            ok = np.allclose(got, want, rtol=1e-6, atol=1e-6)
        if not ok:
            raise RuntimeError(f"phase 34.2c {name}: {got} vs {want}")
        checks += 1
    codes_cpu = []
    for r, res in enumerate(results):
        c = res["collectives"]
        for op, want in red.items():
            hold(f"all_reduce_{op} rank {r}", c[f"all_reduce_{op}"], want)
        hold(f"subgroup rank {r}", c["all_reduce_sub"],
             xs[1] + xs[3] if r in (1, 3) else xs[r])
        hold(f"broadcast rank {r}", c["broadcast"], xs[2], True)
        hold(f"broadcast_sub rank {r}", c["broadcast_sub"],
             xs[3] if r in (1, 3) else xs[r], True)
        hold(f"reduce rank {r}", c["reduce"], sum(xs) if r == 1 else xs[r])
        hold(f"all_gather rank {r}", c["all_gather"], np.stack(xs), True)
        if r in (1, 3):
            hold(f"all_gather_sub rank {r}", c["all_gather_sub"],
                 np.stack([xs[1], xs[3]]), True)
        hold(f"reduce_scatter rank {r}", c["reduce_scatter"],
             sum(xs)[2 * r:2 * r + 2])
        hold(f"alltoall rank {r}", c["alltoall"],
             np.concatenate([xs[i][2 * r:2 * r + 2] for i in range(n)]),
             True)
        hold(f"p2p rank {r}", c["p2p_exchange"], xs[0] if r == 2 else xs[r],
             True)
        hold(f"send_recv rank {r}", c["send_recv"],
             xs[3] if r == 0 else xs[r], True)
        hold(f"scatter rank {r}", c["scatter"], np.full(8, r, np.float32),
             True)
        if c["objects"] != [("rank", i) for i in range(n)]:
            raise RuntimeError(f"phase 34.2c objects: {c['objects']}")
        for axis in ("dp", "mp"):
            hold(f"all_reduce_{axis} rank {r}", c[f"all_reduce_{axis}"],
                 sum(xs[i] for i in c[f"members_{axis}"]))
        import torch
        q, s = C._block_quantize_int8(torch.as_tensor(
            c["grad"]).reshape(-1, 256))
        hold(f"int8 codes rank {r}", c["codes"], q.numpy(), True)
        hold(f"int8 scales rank {r}", c["scales"], s.numpy(), True)
        codes_cpu.append(q)
    mean = sum(res["collectives"]["grad"] for res in results) / n
    bound = (n + 1) * max(np.abs(res["collectives"]["grad"]).max()
                          for res in results) / 127
    for r, res in enumerate(results):
        got = res["collectives"]["compressed"]
        if np.abs(got - mean).max() > bound or \
                not np.array_equal(got, results[0]["collectives"]
                                   ["compressed"]):
            raise RuntimeError(f"phase 34.2c compressed rank {r}: "
                               f"{np.abs(got - mean).max()} vs {bound}")
        checks += 1
    return checks


def ring_errors(ring, o_ref, lse_ref, plain, gref):
    """Lane 34.2b's ranks (``ring``) against the one-process run: the
    first O and LSE a rank against whole-S B1's (``o_ref``, ``lse_ref``)
    and against the plain version at :func:`_plain_rows` (``plain``), and
    the first step's wq, wk, wv gradients summed over the ranks against
    whole-S B1-B3's (``gref``)."""
    tl = DIST_RING_SEQ // DIST_WORLD
    o_ref, lse_ref = o_ref.numpy(), lse_ref.numpy()
    o_plain, lse_plain = plain[0].numpy(), plain[1].numpy()
    rows = _plain_rows()
    e = {"first_o_max_abs_err": 0.0, "first_lse_max_abs_err": 0.0,
         "first_o_rel_err": [], "first_o_plain_rel_err": [],
         "first_lse_plain_max_abs_err": []}
    for r, d in enumerate(ring):
        o, lse = d["first"]
        chunk = slice(r * tl, (r + 1) * tl)
        e["first_o_max_abs_err"] = max(e["first_o_max_abs_err"], float(
            np.abs(o - o_ref[:, :, chunk]).max()))
        e["first_lse_max_abs_err"] = max(e["first_lse_max_abs_err"], float(
            np.abs(lse - lse_ref[:, :, chunk]).max()))
        e["first_o_rel_err"].append(_rel(o, o_ref[:, :, chunk]))
        sel = (rows >= r * tl) & (rows < (r + 1) * tl)
        mine = rows[sel] - r * tl
        e["first_o_plain_rel_err"].append(_rel(o[:, :, mine],
                                               o_plain[:, :, sel]))
        e["first_lse_plain_max_abs_err"].append(float(np.abs(
            lse[:, :, mine] - lse_plain[:, :, sel]).max()))
    # whole-S B1 against the same plain rows: the bf16 floor
    e["b1_o_plain_rel_err"] = _rel(o_ref[:, :, rows], o_plain)
    names = [f"layer{i}.{w}" for i in range(DIST_RING_LAYERS)
             for w in ("wq", "wk", "wv")]
    got = [g.float().numpy() for g in ring[0]["grads0"]]
    want = [g.float().numpy() for g in gref]
    e["qkv_grad_rel_err"] = {n: _rel(a, b)
                             for n, a, b in zip(names, got, want)}
    e["qkv_grad_max_err_over_max"] = {
        n: float(np.abs(a - b).max() / np.abs(b).max())
        for n, a, b in zip(names, got, want)}
    e["grads_equal_on_ranks"] = all(d["grad_sums"] == ring[0]["grad_sums"]
                                    for d in ring)
    return e


def ring_hold(e):
    """Raise where :func:`ring_errors`' ``e`` is out of tolerance."""
    if e["first_o_max_abs_err"] > DIST_RING_O_TOL or \
            e["first_lse_max_abs_err"] > DIST_RING_LSE_TOL or \
            max(e["first_o_rel_err"]) > DIST_RING_O_RTOL:
        raise RuntimeError("phase 34.2b: the ring's first O or LSE parts "
                           "from whole-S B1's")
    if max(e["first_o_plain_rel_err"]) > DIST_RING_O_RTOL or \
            max(e["first_lse_plain_max_abs_err"]) > DIST_RING_LSE_TOL:
        raise RuntimeError("phase 34.2b: the ring's first O or LSE parts "
                           "from the plain version")
    if max(e["qkv_grad_rel_err"].values()) > DIST_RING_GRAD_RTOL or \
            not e["grads_equal_on_ranks"]:
        raise RuntimeError("phase 34.2b: the ring's first-step gradients "
                           "part from whole-S B1-B3's")


def distributed_phase(torch, fa_mod, dev, smi, reset_counters,
                      read_counters):
    """Phase 34 (module docstring): distributed training, first half.
    Returns (results, launches by path, B1-B3 launches by type)."""
    import pickle
    import tempfile
    import paddle_tpu_torch.distributed as dist
    t_phase = time.perf_counter()
    log(f"phase 34: distributed training on one card; {smi}")
    out, launches, dtypes = {}, {}, {}
    # the refusal's two ranks start now and fail at their first NCCL
    # call, beside lane 34.1
    refusal = nccl_refusal()
    w1, launches["dist_world1_nccl"], dtypes["dist_world1_nccl"] = \
        dist_world1_lane(torch, fa_mod, dev, smi, reset_counters,
                         read_counters)
    out["world1"] = w1
    out["nccl_two_ranks"] = nccl_refused(refusal)
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        # the four ranks import and meet (host work) while this process
        # runs the one-process references on the card
        world = dist.spawn(_dist_rank, args=(work,), nprocs=DIST_WORLD,
                           gpus=",".join(["0"] * DIST_WORLD),
                           backend="gloo", join=False)
        try:
            out["dp_reference"], ref_params = dp_reference(torch, dev)
            out["ring_reference"], o_ref, lse_ref, plain, gref = \
                ring_reference(torch, dev)
        except BaseException:
            world.terminate()
            raise
        open(os.path.join(work, "go"), "w").close()
        world.join(DIST_TIMEOUT)
        world_s = time.perf_counter() - t0
        results = []
        for r in range(DIST_WORLD):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        got_params = torch.load(os.path.join(work, "dp_params.pt"))
    out["world4_s"] = world_s
    for r, res in enumerate(results):
        if res["imported"] or res["backend"] != "gloo" or res["rank"] != r:
            raise RuntimeError(f"phase 34: rank {r}: {res['backend']}, "
                               f"imported {res['imported']}")
    # 34.2c
    out["collective_checks"] = _check_collectives(results)
    # 34.2a
    ref = out["dp_reference"]["losses"]
    dp = [res["dp"] for res in results]
    worst = max(abs(a - b) / abs(b) for d in dp
                for a, b in zip(d["losses"], ref))
    # k_proj.bias's gradient is zero up to rounding (softmax ignores a
    # score shift shared by all keys), so Adam moves it by a
    # rounding-driven fraction of lr in each run: held to "tiny" (Adam's
    # step bound, lr a step), the rest to each tensor's max
    # AdamW normalizes each gradient, so an element whose gradient is
    # near its epsilon moves by a rounding-driven part of lr: each
    # tensor within DIST_PARAM_TOL of its max or DIST_PARAM_LR_PART of
    # one step (lr), whichever is larger
    tiny = DIST_STEPS * DIST_LR * 1.01
    perr = {k: float((got_params[k] - v).abs().max()
                     / max(float(v.abs().max()) * DIST_PARAM_TOL,
                           DIST_PARAM_LR_PART * DIST_LR))
            for k, v in ref_params.items() if not k.endswith("k_proj.bias")}
    kbias = max(max(float(got_params[k].abs().max()),
                    float(v.abs().max()))
                for k, v in ref_params.items() if k.endswith("k_proj.bias"))
    out["dp2_mp2"] = {
        "losses": dp[0]["losses"], "ref_losses": ref,
        "loss_rel_err": worst, "param_err_over_tol_max": max(perr.values()),
        "param_worst": max(perr, key=perr.get),
        "k_proj_bias_max_abs": kbias, "lane": dp[0]["lane"],
        "lane_reason": dp[0]["lane_reason"], "mode": dp[0]["mode"],
        "local_q_proj": dp[0]["local_q_proj"],
        "step_ms": [d["step_ms"] for d in dp],
        "peak_gib": [d["peak_gib"] for d in dp],
        "seconds": [d["seconds"] for d in dp]}
    launches["dist_dp2_mp2"] = {
        n: sum(d["launches"].get(n, 0) for d in dp)
        for n in launches["dist_world1_nccl"]}
    log(f"phase 34.2a dp2 x mp2 (gloo, 4 ranks on one card, lane "
        f"{dp[0]['lane']}): losses {dp[0]['losses']} vs one process {ref} "
        f"(worst rel {worst:.3e}); params worst err over tolerance "
        f"{max(perr.values()):.3e} ({out['dp2_mp2']['param_worst']}), "
        f"k_proj.bias max |v| {kbias:.3e} (tiny: <= {tiny:.3e}); step ms "
        f"a rank {out['dp2_mp2']['step_ms']}; peak GiB "
        f"{out['dp2_mp2']['peak_gib']}; {smi}")
    # 34.2b
    rr = out["ring_reference"]["losses"]
    ring = [res["ring"] for res in results]
    e = ring_errors(ring, o_ref, lse_ref, plain, gref)
    loss_err = max(abs(a - b) / abs(b) for d in ring
                   for a, b in zip(d["losses"], rr))
    out["sp4_ring_flash"] = {
        "losses": ring[0]["losses"], "ref_losses": rr,
        "loss_rel_err": loss_err, **e,
        "step_ms": [d["step_ms"] for d in ring],
        "peak_gib": [d["peak_gib"] for d in ring],
        "host_staged": [d["host_staged"] for d in ring],
        "launches_by_rank": [d["launches"] for d in ring],
        "seconds": [d["seconds"] for d in ring]}
    launches["dist_sp4_ring_flash"] = {
        n: sum(d["launches"].get(n, 0) for d in ring)
        for n in launches["dist_world1_nccl"]}
    log(f"phase 34.2b sp4 ring-flash (S {DIST_RING_SEQ}, bf16, causal, gloo "
        f"p2p through pinned host memory): losses {ring[0]['losses']} vs "
        f"whole-S flash {rr} (rel err {loss_err:.3e}); first O max err "
        f"{e['first_o_max_abs_err']:.3e}, LSE "
        f"{e['first_lse_max_abs_err']:.3e}; first O relative err a rank "
        f"{e['first_o_rel_err']}; against the plain version at "
        f"{len(_plain_rows())} rows: O {e['first_o_plain_rel_err']}, LSE "
        f"{e['first_lse_plain_max_abs_err']} (whole-S B1's O "
        f"{e['b1_o_plain_rel_err']:.3e}); first-step gradients against "
        f"whole-S B1-B3, relative {e['qkv_grad_rel_err']}, max over max "
        f"{e['qkv_grad_max_err_over_max']}, equal on every rank "
        f"{e['grads_equal_on_ranks']}; step ms a rank "
        f"{out['sp4_ring_flash']['step_ms']}; launches by rank "
        f"{out['sp4_ring_flash']['launches_by_rank']}; {smi}")
    if worst > DIST_LOSS_RTOL or max(perr.values()) > 1.0 or kbias > tiny:
        raise RuntimeError("phase 34.2a: dp2 x mp2 parts from one process")
    if dp[0]["lane"] != "eager" or dp[0]["mode"] != "model":
        raise RuntimeError(f"phase 34.2a: lane {dp[0]['lane']}, mode "
                           f"{dp[0]['mode']}")
    for r, d in enumerate(dp):
        for n, c in d["launches"].items():
            if c != DIST_DP_LAYERS * DIST_STEPS:
                raise RuntimeError(f"phase 34.2a rank {r}: {n} launched "
                                   f"{c} times")
    if loss_err > DIST_RING_LOSS_TOL:
        raise RuntimeError("phase 34.2b: the ring's losses part from "
                           "whole-S flash's")
    ring_hold(e)
    for r, d in enumerate(ring):
        want = (r + 1) * DIST_RING_LAYERS * DIST_RING_STEPS
        for n, c in d["launches"].items():
            if c != want:
                raise RuntimeError(f"phase 34.2b rank {r}: {n} launched "
                                   f"{c} times, not {want}")
    dist.env.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 34 {out['seconds']:.1f} s (the world of four "
        f"{world_s:.1f} s)")
    return out, launches, dtypes


def counter_fns(torch, fa_mod, extra=()):
    """``(reset_counters, read_counters)`` over B1-B3's launch counts (and
    their counts by type) and ``extra``'s; the reset also resets the peak
    memory statistics."""
    ctrs = (*_counters(fa_mod), *extra)

    def reset_counters():
        for c in ctrs:
            c.launches = 0
        for c in _counters(fa_mod):
            c.launches_by_dtype = {}
        torch.cuda.reset_peak_memory_stats()

    def read_counters():
        return {c.__name__: c.launches for c in ctrs}
    return reset_counters, read_counters


def phase_alone(torch, fa_mod, dev, smi, phase, extra_counters):
    """``python3 chip_smoke.py --phase 23`` to ``34``: after the build,
    that phase alone; prints its numbers, not the summary lines."""
    reset_counters, read_counters = counter_fns(torch, fa_mod,
                                                extra_counters)
    fn = {23: crf_tagger_phase, 24: beam_phase, 25: mobilenet_phase,
          26: vit_phase, 27: lstm_phase, 28: frcnn_phase,
          29: pipeline_phase, 30: observability_phase,
          31: fault_tolerance_phase, 32: fleet_phase,
          33: front_door_phase, 34: distributed_phase}[phase]
    out, launches, dtypes = fn(torch, fa_mod, dev, smi, reset_counters,
                               read_counters)
    log(f"phase {phase} paths launches: {launches}, B1-B3 by type {dtypes}")
    log(f"phase {phase}: {json.dumps(out)}")
    return 0


def phase22_alone(torch, fa_mod, dev, smi):
    """``python3 chip_smoke.py --phase 22``: after the build, phase 21's
    two GPT-3 1.3B dygraph references (fp32 and O1) and phase 22, on a
    batch of its own; prints the phase's numbers, not the summary
    lines."""
    reset_counters, read_counters = counter_fns(torch, fa_mod)
    ids = np.random.default_rng(22).integers(
        0, CFG_13B["vocab_size"], (4, CFG_13B["max_position_embeddings"]))
    dy = {}
    for o1 in (False, True):
        dy["gpt_o1_bf16" if o1 else "gpt_fp32"], _, _ = dygraph_gpt(
            torch, fa_mod, dev, CFG_13B, ids, o1, reset_counters,
            read_counters)
    opg, launches, dtypes = run_op_program_phase(
        torch, fa_mod, dev, CFG_13B, ids, dy, smi, reset_counters,
        read_counters)
    log(f"op-built GPT paths launches: {launches}, B1-B3 by type {dtypes}")
    log(f"op program: {json.dumps(opg)}")
    return 0


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
        fa_mod = importlib.import_module(
            "paddle_tpu_torch.ops.flash_attention")
        from paddle_tpu_torch.ops import custom as nms_mod
        from paddle_tpu_torch.ops import detection as det_mod
        from paddle_tpu_torch.ops import paged_attention as pa_mod
        from paddle_tpu_torch.vision.models import yolov3_darknet53
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2

    if sys.argv[1:2] == ["--ft-child"]:
        return ft_child(torch, sys.argv[2:])
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
    if sys.argv[1:] == ["--phase", "22"]:
        return phase22_alone(torch, fa_mod, dev, smi)
    if sys.argv[1:] in [["--phase", str(n)] for n in range(23, 35)]:
        return phase_alone(torch, fa_mod, dev, smi, int(sys.argv[2]),
                           (pa_mod.paged_attention, nms_mod.greedy_nms))
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

    # -- phase 34: distributed training, first half ---------------------------
    # run while the card is clean: the later phases' engines, programs and
    # caches leave tens of GiB allocated by the end, and phase 34 trains
    # GPT-3 1.3B and starts four ranks on the card
    stamp("34 distributed training (the world, collectives, dp/mp, ring)")
    distres, dist_launches, dist_dtypes = distributed_phase(
        torch, fa_mod, dev, smi, *counter_fns(
            torch, fa_mod, (pa_mod.paged_attention, nms_mod.greedy_nms)))
    log(f"phase 34 paths launches: {dist_launches}, B1-B3 by type "
        f"{dist_dtypes}")
    release_memory(torch)

    # -- phases 3 and 4: the serving path ------------------------------------
    stamp("3-4 serving path")
    rng = np.random.default_rng(0)
    model = GPTForCausalLM(GPTConfig(**CFG_13B, attn_impl="flash"),
                           device=dev, seed=0).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: GPT-3 1.3B, {n_params} parameters, fp32, random weights "
        f"(seed 0)")
    reset_counters, read_counters = counter_fns(
        torch, fa_mod, (pa_mod.paged_attention, nms_mod.greedy_nms))

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

    # -- phases 17 and 18: prefix reuse and speculative decode ----------------
    stamp("17 prefix reuse")
    model = GPTForCausalLM(GPTConfig(**CFG_13B, attn_impl="flash"),
                           device=dev, seed=0).eval()
    log(f"model: GPT-3 1.3B, the weights of phases 3-6 (seed 0), fp32, "
        f"TF32 off; {smi}")
    g17 = torch.Generator(device="cuda")
    g17.manual_seed(17)
    prefix, prefix_launches = run_prefix_phase(
        torch, model, pa_mod, dev, smi, g17, reset_counters, read_counters)
    b4.update(prefix["b4_shared"])
    stamp("18 speculative decode")
    spec, spec_launches = run_spec_phase(
        torch, model, dev, smi, prompts,
        {"paged": (paged_tokens, serve["tokens_per_s"]),
         "slot": (slot_tokens, slot["tokens_per_s"])},
        reset_counters, read_counters)
    stamp("19 int8 serving")
    int8, int8_launches = run_int8_phase(
        torch, model, pa_mod, dev, smi, prompts, CFG_13B, reset_counters,
        read_counters)
    del model
    release_memory(torch)

    # -- phase 20: the hapi loop as users write it ----------------------------
    stamp("20 hapi fit and evaluate")
    hapi_res, hapi_launches = hapi_resnet(torch, dev, smi, reset_counters,
                                          read_counters)
    hapi_bert_res, bert_launches_20, bert_dtypes_20 = hapi_bert(
        torch, fa_mod, dev, bcfg, smi, reset_counters, read_counters)
    hapi_launches.update(bert_launches_20)
    hapi_map, map_launches = hapi_yolov3_map(
        torch, nms_mod, det_mod, dev, reset_counters, read_counters)
    hapi_launches["hapi_yolov3_map"] = map_launches
    reset_counters()
    hapi_rules = hapi_lenet_rules(torch, dev)
    hapi_launches["hapi_lenet_rules"] = read_counters()
    log(f"hapi paths launches: {hapi_launches}")
    for path, counts in hapi_launches.items():
        expect = {"hapi_bert_evaluate": "flash_attention_fwd",
                  "hapi_yolov3_map": "greedy_nms"}.get(path)
        for n, c in counts.items():
            if (c > 0) != (n == expect):
                raise RuntimeError(f"{path}: kernel {n} launched {c} "
                                   f"times")

    # -- phase 21: the dygraph loop on the port's Tensors ----------------------
    stamp("21 dygraph loop on Tensors")
    log(f"phase 21: to_tensor, forward, loss.backward(), opt.step(), "
        f"opt.clear_grad() on the port's Tensors; {smi}")
    dy = {"funnel_host": funnel_host_us(torch, dev)}
    dy["lenet"], lenet_launches = dygraph_lenet(torch, dev, reset_counters,
                                                read_counters)
    dy_launches = {"dygraph_lenet": lenet_launches}
    dy_dtypes = {}
    if any(lenet_launches.values()):
        raise RuntimeError(f"a port kernel launched on the LeNet dygraph "
                           f"path: {lenet_launches}")
    for o1, dtype in ((False, "float32"), (True, "bfloat16")):
        key = "gpt_o1_bf16" if o1 else "gpt_fp32"
        dy[key], dy_launches[f"dygraph_{key}"], dy_dtypes[f"dygraph_{key}"] \
            = dygraph_gpt(torch, fa_mod, dev, CFG_13B, ids, o1,
                          reset_counters, read_counters)
        for n in flash_names:
            if set(dy_dtypes[f"dygraph_{key}"][n]) != {dtype}:
                raise RuntimeError(f"kernel {n} was launched "
                                   f"{dy_dtypes[f'dygraph_{key}'][n]} on the "
                                   f"{key} dygraph path, not in {dtype}")
    for key, ref, label in (("gpt_fp32", train, "phase 7 fp32"),
                            ("gpt_o1_bf16", amp_o1, "phase 9 O1 bf16")):
        d, g, e = dy[key], ref["graphed"], ref["eager"]
        dy[key]["beside"] = {
            "graphed_step_ms": g["step_ms"],
            "graphed_device_ms": g["device_busy_ms"],
            "eager_step_ms": e["step_ms"],
            "eager_device_ms": e["device_busy_ms"]}
        log(f"{label} step beside the dygraph loop ({smi}): dygraph wall "
            f"{d['profiled_step_wall_ms']:.1f} ms, device "
            f"{d['step_device_ms']:.1f} ms, idle "
            f"{100 * d['idle_share']:.1f}%, {d['funnel_calls_per_step']} "
            f"funnel calls; train_batch eager lane wall "
            f"{e['step_ms']:.1f} ms, device {e['device_busy_ms']:.1f}; "
            f"graphed wall {g['step_ms']:.1f} ms, device "
            f"{g['device_busy_ms']:.1f}")
    dy["autograd"] = autograd_surface(torch, dev)
    log(f"dygraph paths launches: {dy_launches}, B1-B3 by type {dy_dtypes}")

    # -- phase 22: a paddle program written from the op surface ----------------
    stamp("22 op-built GPT and the op table")
    log(f"phase 22: GPT-3 1.3B written from Tensor ops (create_parameter "
        f"with ParamAttr(Assign), reshape, flash_attention, matmul, "
        f"cross_entropy) on GPTForCausalLM's seed-0 weights; the op table "
        f"on the card; {smi}")
    opg, opg_launches, opg_dtypes = run_op_program_phase(
        torch, fa_mod, dev, CFG_13B, ids, dy, smi, reset_counters,
        read_counters)
    log(f"op-built GPT paths launches: {opg_launches}, B1-B3 by type "
        f"{opg_dtypes}")
    for path in ("op_gpt_fp32", "op_gpt_o1_bf16", "op_gpt_train_batch"):
        for n in flash_names:
            if opg_launches[path][n] < 1:
                raise RuntimeError(f"kernel {n} was not launched on the "
                                   f"{path} path")

    # -- phase 23: a BERT-base CRF tagger ------------------------------------
    stamp("23 BERT-base CRF tagger and the structured ops")
    crf, crf_launches, crf_dtypes = crf_tagger_phase(
        torch, fa_mod, dev, smi, reset_counters, read_counters)
    log(f"tagger paths launches: {crf_launches}, B1-B3 by type "
        f"{crf_dtypes}")
    for path, counts in crf_launches.items():
        for n, c in counts.items():
            want = path in ("crf_tagger_evaluate", "crf_tagger_predict") \
                and n == "flash_attention_fwd"
            if (c > 0) != want:
                raise RuntimeError(f"{path}: kernel {n} launched {c} times")

    # -- phase 24: GPT-3 1.3B decoded by beam search ---------------------------
    stamp("24 GPT-3 1.3B beam search")
    beam, beam_launches, beam_dtypes = beam_phase(
        torch, fa_mod, dev, smi, reset_counters, read_counters)
    log(f"beam search paths launches: {beam_launches}, B1-B3 by type "
        f"{beam_dtypes}")
    for path, counts in beam_launches.items():
        for n, c in counts.items():
            want = path == "beam_full_prefix" and n == "flash_attention_fwd"
            if (c > 0) != want:
                raise RuntimeError(f"{path}: kernel {n} launched {c} times")

    # -- phase 25: MobileNetV3-Large trained and served ---------------------
    stamp("25 MobileNetV3-Large training and serving, the A3 table")
    mobilenet, mb_launches, _ = mobilenet_phase(
        torch, fa_mod, dev, smi, reset_counters, read_counters)
    log(f"MobileNetV3-Large paths launches: {mb_launches}")
    for path, counts in mb_launches.items():
        if any(counts.values()):
            raise RuntimeError(f"{path}: a port kernel launched {counts}")

    # -- phase 26: a ViT-B/16 written from nn layers -------------------------
    stamp("26 ViT-B/16 from nn layers")
    vitres, vit_launches, vit_dtypes = vit_phase(
        torch, fa_mod, dev, smi, reset_counters, read_counters)
    log(f"ViT-B/16 paths launches: {vit_launches}, B1-B3 by type "
        f"{vit_dtypes}")
    for path, counts in vit_launches.items():
        for n, c in counts.items():
            want = n in flash_names and (path != "vit_predict"
                                         or n == "flash_attention_fwd")
            if (c > 0) != want:
                raise RuntimeError(f"{path}: kernel {n} launched {c} times")

    # -- phase 27: the PTB-large LSTM language model --------------------------
    stamp("27 PTB-large LSTM LM")
    lstm, lstm_launches, _ = lstm_phase(torch, fa_mod, dev, smi,
                                        reset_counters, read_counters)
    log(f"LSTM LM paths launches: {lstm_launches}")
    for path, counts in lstm_launches.items():
        if any(counts.values()):
            raise RuntimeError(f"{path}: a port kernel launched {counts}")

    # -- phase 28: Faster R-CNN R50-FPN inference ------------------------------
    stamp("28 Faster R-CNN R50-FPN")
    frcnn, frcnn_launches, _ = frcnn_phase(torch, fa_mod, dev, smi,
                                           reset_counters, read_counters)
    log(f"Faster R-CNN paths launches: {frcnn_launches}")
    for path, counts in frcnn_launches.items():
        for n, c in counts.items():
            if (c > 0) != (n == "greedy_nms"):
                raise RuntimeError(f"{path}: kernel {n} launched {c} times")
    b5.update({f"frcnn_{k.split(' ')[0]}": v
               for k, v in frcnn["b5"].items()})

    # -- phase 29: ResNet-50 through PaddleClas's input pipeline --------------
    stamp("29 ImageNet input pipeline")
    pipe, pipe_launches, _ = pipeline_phase(torch, fa_mod, dev, smi,
                                            reset_counters, read_counters)
    log(f"input pipeline paths launches: {pipe_launches}")
    for path, counts in pipe_launches.items():
        if any(counts.values()):
            raise RuntimeError(f"{path}: a port kernel launched {counts}")

    # -- phase 30: spans, the flight recorder, MFU and drains ----------------
    stamp("30 the host-plane substrate")
    obsres, obs_launches, obs_dtypes = observability_phase(
        torch, fa_mod, dev, smi, reset_counters, read_counters)
    log(f"phase 30 paths launches: {obs_launches}, B1-B3 by type "
        f"{obs_dtypes}")
    for path, names in (("obs_train", flash_names),
                        ("obs_serving_paged_metered",
                         ("paged_attention",))):
        for n in names:
            if obs_launches[path][n] < 1:
                raise RuntimeError(f"kernel {n} was not launched on the "
                                   f"{path} path")

    # -- phase 31: training that survives faults ------------------------------
    stamp("31 training that survives faults")
    ftres, ft_launches, ft_dtypes = fault_tolerance_phase(
        torch, fa_mod, dev, smi, reset_counters, read_counters)
    log(f"phase 31 paths launches: {ft_launches}, B1-B3 by type "
        f"{ft_dtypes}")
    for path, counts in ft_launches.items():
        for n in flash_names:
            if counts[n] < 1:
                raise RuntimeError(f"kernel {n} was not launched on the "
                                   f"{path} path")

    # -- phase 32: the LLM fleet's data path -----------------------------------
    stamp("32 the LLM fleet's data path")
    fleet, fleet_launches, _ = fleet_phase(torch, fa_mod, dev, smi,
                                           reset_counters, read_counters)
    log(f"phase 32 paths launches: {fleet_launches}")
    for path in ("fleet_park", "fleet_kill", "fleet_roll"):
        if fleet_launches[path]["paged_attention"] < 1:
            raise RuntimeError(f"kernel paged_attention was not launched on "
                               f"the {path} path")

    # -- phase 33: the front door, the autoscaler, replay and the tuner -------
    stamp("33 the front door, the autoscaler, replay and the tuner")
    front, front_launches, _ = front_door_phase(
        torch, fa_mod, dev, smi, reset_counters, read_counters)
    log(f"phase 33 paths launches: {front_launches}")
    for path in ("front_http", "front_autoscale", "tuner"):
        if front_launches[path]["paged_attention"] < 1:
            raise RuntimeError(f"kernel paged_attention was not launched on "
                               f"the {path} path")

    # -- summary --------------------------------------------------------------
    paths = {"serving": serve_launches, "serving_slot": slot_launches,
             "generate": gen_launches, "training": train_launches,
             **amp_launches, "detection": det_launches,
             "training_resnet50": resnet_launches,
             "training_bert": bert_launches,
             "bert_flash_checks": bert_flash_launches,
             "serving_c6": c6_launches, "training_yolov3": yolo_launches,
             **{f"training_gpt_s4096_{k}": v for k, v in long_paths.items()},
             "serving_prefix": prefix_launches, "serving_spec": spec_launches,
             "serving_int8": int8_launches, **hapi_launches, **dy_launches,
             **opg_launches, **crf_launches, **beam_launches,
             **mb_launches, **vit_launches, **lstm_launches,
             **frcnn_launches, **pipe_launches, **obs_launches,
             **ft_launches, **fleet_launches, **front_launches,
             **{p: {**dict.fromkeys(front_launches["front_http"], 0), **c}
                for p, c in dist_launches.items()}}
    amp_dtypes["bert_flash_checks"] = bert_dtypes
    amp_dtypes.update({f"training_gpt_s4096_{k}": v
                       for k, v in long_dtypes.items()})
    amp_dtypes["hapi_bert_evaluate"] = bert_dtypes_20
    amp_dtypes.update(dy_dtypes)
    amp_dtypes.update(opg_dtypes)
    amp_dtypes["crf_tagger_evaluate_predict"] = crf_dtypes
    amp_dtypes["beam_full_prefix"] = beam_dtypes
    amp_dtypes["vit_train_o1"] = vit_dtypes
    amp_dtypes.update(obs_dtypes)
    amp_dtypes.update(ft_dtypes)
    amp_dtypes.update(dist_dtypes)

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
    log(f"serving, prefix reuse: {json.dumps(prefix)}")
    log(f"serving, speculative decode: {json.dumps(spec)}")
    log(f"serving, int8: {json.dumps(int8)}")
    log("hapi: " + json.dumps({"resnet50": hapi_res,
                               "bert_base": hapi_bert_res,
                               "yolov3_map": hapi_map,
                               "lenet_rules": hapi_rules}))
    log(f"dygraph: {json.dumps(dy)}")
    log(f"op program: {json.dumps(opg)}")
    log(f"BERT-base CRF tagger: {json.dumps(crf)}")
    log(f"GPT-3 1.3B beam search: {json.dumps(beam)}")
    log(f"MobileNetV3-Large: {json.dumps(mobilenet)}")
    log(f"ViT-B/16: {json.dumps(vitres)}")
    log(f"PTB-large LSTM LM: {json.dumps(lstm)}")
    log(f"Faster R-CNN R50-FPN: {json.dumps(frcnn)}")
    log(f"ImageNet input pipeline: {json.dumps(pipe)}")
    log(f"host-plane substrate: {json.dumps(obsres)}")
    log(f"training that survives faults: {json.dumps(ftres)}")
    log(f"the LLM fleet's data path: {json.dumps(fleet)}")
    log(f"the front door, the autoscaler and the tuner: {json.dumps(front)}")
    log(f"distributed training: {json.dumps(distres)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
