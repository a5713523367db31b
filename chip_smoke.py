#!/usr/bin/env python3
"""Drive the PyTorch port (yoda_scheduler_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. build: the card's name and power limit, and the CUDA kernels compiled
   from the sources in this checkout (nvcc, sm_90a, one process per source);
   each of the thirty-six wgmma kernels (`WGMMA_KERNELS`) without a spill
   or a serialised wgmma.
2. kernel: the flash forward kernel against its plain version on the card,
   elementwise and by O's worst 64-row tile, at the main path's shape (also
   as the model's transposed [B, S, H, D] views), at Mixtral's GQA 32/8
   (contiguous and as the model's views) and at cross-length, window,
   non-causal, fp32, ragged and unaligned shapes, and at head dim 64
   (bench_mfu's d1024 train widths as their model gives them, GQA, window,
   cross-length, non-causal and ragged), each on the
   route `_route` picks, with the kernel's, the plain version's and one
   library call's times, TF/s and the card's bound for the same work; at
   the main shape, at d1024_bshd, at phi3_d96_bshd and at fp16_main the
   wgmma and mma routes are timed in turns (mma, wgmma, wgmma, mma), SDPA's
   default backend after each turn, and at d1024_bshd
   SDPA under its default backend (named) and under its flash backend; at
   head dim 96 (cross-length, non-causal, ragged) on the head-dim-96 wgmma
   kernel; in fp16 at head dim 128 (the model's views, GQA 32/8, window,
   ragged, cross-length) on the fp16 wgmma kernels. Then the head dims and
   dtypes of the padded simt and mma kernels
   (`WIDE_SHAPES`): Phi-3-mini's attention (32 heads of 96, S=2048; GQA 32/8
   and window 512 at 96; wgmma there), 80 (StableLM-3B's, also as its
   model's views, with GQA 32/8, window 512, ragged, cross-length and
   non-causal rows: every kernel on its wgmma kernel), Gemma-2B's 8 heads
   of 256 over one and Gemma-7B's 16 over 16 (with window-512 rows at
   Gemma-2B's 8 over 1 and Gemma-2-9B's 16 over 8, ragged, cross-length and
   non-causal rows at 256: every kernel on its wgmma kernel), 40 ragged, 100
   (OpenLLaMA-3B's 200-byte rows, also as its model's views), the forward at
   80 and 100 on its wgmma kernels and timed in turns against its old route
   (mma at 80, simt at 100) at each of those four rows, and so at 256
   (gemma_d256) and in fp16 at 64 (fp16_d1024_bshd) against mma, fp16 at
   the main shape and the
   five fp16 rows above (every kernel on wgmma), at d1024_bshd and at
   OPT-1.3B's 32 heads of 64 and a ragged GQA row (every kernel on its fp16
   wgmma kernel at 64), fp16 at 80, 96, 100 and 256 (OPT-2.7B's,
   GPT-NeoX-20B's, OpenLLaMA-3B's and GPT-J-6B's attention as their models
   give them, with GQA, window, ragged, cross-length and non-causal rows:
   the forward, dQ and dK/dV on their fp16 wgmma kernels, each model's row
   timed in turns against the forward's old route), simt in
   fp32 and fp16, and 320 on simt in fp32 and bf16 (SDPA's memory-efficient
   backend timed beside the fp32 row, its K and V repeated to q's heads);
   each on every route `_routes` admits, with SDPA's default backend timed
   where its inputs are aligned bf16 or fp16 (a failure of the library's
   call is recorded with its error); and head dim 520 refused by every wrapper on every route with no launch.
3. backward: the dQ and dK/dV kernels against the plain backward at the
   same shapes (a non-zero LSE cotangent at some), elementwise and by each
   output's worst tile, each kernel on the route `_route` picks for it
   (in fp16 at head dim 128 its fp16 wgmma kernel), twice with equal
   bits, with their times, TF/s, the plain backward's time, the bound of
   each, and at the main shape, at d1024_bshd, at phi3_d96_bshd and at
   fp16_main the
   library's backward (timed alone) and the wgmma and mma routes of each
   kernel that takes them, each held against the plain backward and timed
   in turns (mma, wgmma, wgmma, mma), SDPA's backward after each turn; at
   d1024_bshd SDPA's backward under
   its default and its flash backends; at head dims 80 (d80, d80_bshd),
   100 (unaligned_d100, d100_bshd) and 256 (gemma_d256) dQ and dK/dV on
   their wgmma kernels timed in turns against their old route (mma at 80
   and 256, simt at 100: old, wgmma, wgmma, old), SDPA's backward after
   each turn under its default backend (cuDNN) at 80 and 256 and its flash
   backend at 100; and so in fp16 at 64 (fp16_d1024_bshd, opt13b_d64_bshd)
   against mma, with SDPA's default backward after each turn, and in fp16
   at 100 (openllama3b_fp16_d100_bshd, fp16_unaligned_d100) against simt,
   with its flash backward after each turn, and in fp16 at 80, 96 and 256
   (opt27b_d80_bshd, neox20b_fp16_d96_bshd, gptj6b_fp16_d256_bshd) against
   mma, with SDPA's default backward after each turn. Last seven fp16 rows
   with a large LSE cotangent (dO x1e-5, S=2048, head dim 128) through the
   kernels' autograd node, g_lse x1e3 of random sign and, with an attention
   sink at key 0, x100 of one sign, at head dim 128 and again at 64, 96,
   100, 256 and 80: finite, and within twice the fp32 backward's own
   rounding to fp16 of the fp32 backward.
4. forward: Llama-2-7B width, all 32 layers, bf16, random weights from a
   seed, B=1, S=2048: one `llama_forward` must launch the kernel once per
   layer, and its logits must agree with the forward through the plain
   attention.
5. serving: the same weights answer 4 requests (512-token prompts, 64 new
   tokens, greedy) twice with equal tokens, prefill's logits agree with the
   forward's at every prompt position, and one sampled request is
   deterministic per seed.
6. gradient: at 7B width with 4 layers, the loss's gradient through the
   kernels against the gradient through the plain attention, every leaf.
7. train: the 7B-width, 32-layer, bf16 train step (remat, AdamW), B=1,
   S=2048, 4 steps on one batch: launches per step, every one on the wgmma
   route, a falling loss, step time, tokens/s, MFU and peak memory.

The MoE phases run Mixtral-8x7B's published widths (8 experts, top-2, GQA
32/8) with random bf16 weights from a seed, depth cut to fit the card:
moe_forward and moe_serving (16 layers) after serving, moe_train (4 layers)
after train.

After moe_train, head dims 96, 100 and 80, and fp16:

- phi3_forward, phi3_gradient, phi3_train: Phi-3-mini's published widths
  (`profile_path.phi3_mini`: hidden 3072, 32 layers, 32 heads of 96,
  intermediate 8192, vocab 32064), random bf16 weights from a seed: as forward (32 layers),
  gradient (4 layers) and train (32 layers, B=1, S=2048), every flash
  launch on the wgmma route.
- fp16_forward, fp16_gradient: Llama-2-7B in fp16, the dtype of its
  published weights: as forward and gradient, every launch on the wgmma
  route; fp16_gradient also times the 4-layer loss's forward and backward
  on the host's clock in turns, all on wgmma against the backward on mma
  (`profile_path.fp16_backward_on_mma(128)`).
- openllama3b_forward, stablelm3b_forward: OpenLLaMA-3B's widths (26
  layers, 32 heads of 100) and StableLM-3B-4E1T's (32 layers, 32 heads of
  80) on the Llama block (`profile_path.openllama_3b`,
  `stablelm_3b_4e1t`), random bf16 weights from a seed: as forward, every
  flash_fwd launch on wgmma, also timed on the host's clock in turns
  against the forward on its old route (`profile_path.d100_forward_on_simt`,
  `d80_forward_on_mma`); the weights freed after each.
- gemma2b_forward, opt13b_fp16_forward: Gemma-2B's widths (18 layers, 8
  query heads of 256 over one KV head, vocab 256000; bf16) and OPT-1.3B's
  (24 layers, 32 heads of 64, vocab 50272) in its published dtype, fp16,
  on the Llama block (`profile_path.gemma_2b`, `opt_1_3b`), random weights
  from a seed: as forward, all 18 (24) flash_fwd launches on wgmma, also
  timed on the host's clock in turns against the forward on mma
  (`profile_path.d256_forward_on_mma`, `fp16_d64_forward_on_mma`).
- openllama3b_gradient, openllama3b_train: OpenLLaMA-3B's widths as
  gradient (4 layers) and train (all 26 layers, B=1, S=2048, 52/26/26
  launches a step), every flash launch on wgmma, dQ and dK/dV on their
  head-dim-100 kernels; both also timed on the host's clock in turns
  against dQ and dK/dV on simt (`profile_path.d100_backward_on_simt`), the
  train step's turns after its 4 steps.
- stablelm3b_gradient, stablelm3b_train: StableLM-3B-4E1T's widths as
  gradient (4 layers: 8/4/4 launches) and train (all 32 layers, B=1,
  S=2048, 64/32/32 launches a step), every flash launch on wgmma, dQ and
  dK/dV on their head-dim-80 kernels; both also timed on the host's clock
  in turns against dQ and dK/dV on mma (`profile_path.d80_backward_on_mma`),
  the train step's turns after its 4 steps.
- gemma2b_gradient, gemma2b_train: Gemma-2B's widths as gradient (4
  layers: 8/4/4 launches) and train (all 18 layers, B=1, S=2048, 36/18/18
  launches a step), every flash launch on wgmma, dQ and dK/dV on their
  head-dim-256 kernels; both also timed on the host's clock in turns
  against dQ and dK/dV on mma (`profile_path.d256_backward_on_mma`), the
  train step's turns after its 4 steps.
- opt13b_fp16_gradient, opt13b_fp16_backward: OPT-1.3B's widths in fp16 as
  gradient (4 layers: 8/4/4 launches), and the loss's forward and backward
  (remat) at all 24 layers, B=1, S=2048, with no optimizer (AdamW's eps of
  1e-8 is 0 in fp16, and the JAX package's fp16 step, as the port's, gives
  NaN weights after its first update): 48/24/24 launches a call, every one
  on wgmma, dQ and dK/dV on their fp16 head-dim-64 kernels, a finite loss
  and finite gradients on the card, ms a call, tokens/s, MFU by the train
  phases' convention and peak memory; both also timed on the host's clock
  in turns against dQ and dK/dV on mma (`profile_path.fp16_backward_on_mma(64)`),
  the backward's turns after its 4 calls.
- openllama3b_fp16_gradient, openllama3b_fp16_backward: OpenLLaMA-3B's
  widths in its published dtype, fp16 (`profile_path.openllama_3b_fp16`),
  as OPT-1.3B's pair: gradient (4 layers: 8/4/4 launches) and the loss's
  forward and backward at all 26 layers with no optimizer (52/26/26 a
  call), every launch on wgmma, dQ and dK/dV on their fp16 head-dim-100
  kernels; both also timed on the host's clock in turns against dQ and
  dK/dV on simt (`profile_path.fp16_d100_backward_on_simt`).
- gptj6b_fp16_gradient, gptj6b_fp16_backward: GPT-J-6B's widths in its
  published dtype, fp16 (`profile_path.gptj_6b`: 4096 wide, 16 heads of
  256, FFN 16384, vocab 50400), as OPT-1.3B's pair: gradient (4 layers:
  8/4/4 launches) and the loss's forward and backward at all 28 layers
  with no optimizer (56/28/28 a call), every launch on wgmma, dQ and dK/dV
  on their fp16 head-dim-256 kernels; both also timed on the host's clock
  in turns against dQ and dK/dV on mma
  (`profile_path.fp16_backward_on_mma(256)`).
- neox20b_fp16_gradient, neox20b_fp16_backward: GPT-NeoX-20B's widths in
  its published dtype, fp16 (`profile_path.gpt_neox_20b`: 6144 wide, 64
  heads of 96, FFN 24576, vocab 50432), as OPT-1.3B's pair: gradient (4
  layers: 8/4/4 launches) and the loss's forward and backward with no
  optimizer at 22 of its 44 layers (`profile_path.NEOX20B_BACKWARD_LAYERS`:
  44 layers' fp16 weights and gradients, 108.8 GB, do not fit the card;
  44/22/22 a call), every launch on wgmma, dQ and dK/dV on their fp16
  head-dim-96 kernels; both also timed on the host's clock in turns against
  dQ and dK/dV on mma (`profile_path.fp16_backward_on_mma(96)`).
- opt27b_fp16_gradient, opt27b_fp16_backward: OPT-2.7B's widths in its
  published dtype, fp16 (`profile_path.opt_2_7b`: 2560 wide, 32 heads of
  80, FFN 10240, vocab 50272), as OPT-1.3B's pair: gradient (4 layers:
  8/4/4 launches) and the loss's forward and backward at all 32 layers
  with no optimizer (64/32/32 a call), every launch on wgmma, dQ and dK/dV
  on their fp16 head-dim-80 kernels; both also timed on the host's clock
  in turns against dQ and dK/dV on mma
  (`profile_path.fp16_backward_on_mma(80)`).
- opt27b_fp16_forward, openllama3b_fp16_forward, neox20b_fp16_forward,
  gptj6b_fp16_forward (run with the forwards above): OPT-2.7B's,
  OpenLLaMA-3B's, GPT-NeoX-20B's (44 layers, 64 heads of 96, 54 GB of
  weights) and GPT-J-6B's (28 layers, 16 heads of 256) widths in fp16
  (`profile_path.opt_2_7b`, `openllama_3b_fp16`, `gpt_neox_20b`,
  `gptj_6b`): as forward, all 32, 26, 44 and 28 flash_fwd launches on
  their fp16 wgmma kernels, also timed on the host's clock in turns against
  the forward on its old route (`profile_path.fp16_d80_forward_on_mma`,
  `fp16_d100_forward_on_simt`, `fp16_d96_forward_on_mma`,
  `fp16_d256_forward_on_mma`).

- moe_forward: B=1, S=2048: 16 flash_fwd launches, all on the wgmma route;
  logits and routing against the forward through the plain attention, end
  to end and layer by layer from the same input; each of these four
  bounds must reject each planted wrong attention (`planted_faults`);
  dropped share, forward ms, peak memory, parameters.
- moe_serving: as serving, with its own bound, which each planted wrong
  attention in the forward must exceed; beside the decode step's memory
  bound (every expert weight read once a step).
- moe_train: as train, with aux weight 0.02; MFU by active parameters
  beside the capacity-padded expert work.

The sharded training step (parallel/), after train:

- sharded_train: a world-1 NCCL process group on an in-process store, the
  mesh with every axis 1, and `build_llama_train_step(llama2_7b, mesh)` for
  train's steps, seed and tokens: the losses against train's, launches per
  step by route, step time and peak memory (within train's + 2 GB: the
  fsdp gather is per layer at use).
- ring: ring attention over sp=4 through the one-process rotation at
  S=8192 in chunks of 2048, MHA 32/32 and GQA 32/8: output and dQ/dK/dV
  against the plain attention over the whole sequence (rel. L2 and worst
  64-row tile), a bit-repeatable backward, 10/10/10 launches on the wgmma
  route (6 future chunks skipped), the ring's forward and forward+backward
  times beside one 8192-token causal flash_fwd and its bound.
- ulysses: Ulysses over sp=4 through the one-process exchange on the
  ring's shapes (GQA 32/8 on the grouped-KV branch): each rank's 8 query
  heads over the whole 8192 tokens, 4/4/4 launches on the wgmma route, the
  same comparisons, its times beside the ring's of the same call.

The pipelined step (parallel/pipeline.py), 4 stages in one process (no
bubble and no point-to-point transfer is measured there), 4 microbatches:

- pipeline_gradient: 7B width, 4 layers, B=4, S=2048, remat: the loss and
  every leaf's gradient against the one-device llama_loss's; planted wrong
  pipelines (stage blocks reversed, microbatches retired to wrong slots)
  must each break the gradient bound and one of them the loss bound too.
- pipeline_train: all 32 layers, B=4: the first loss against the
  one-device loss, a falling loss, 256/128/128 wgmma launches a step, step
  time, tokens/s, MFU and peak memory beside the peak reckoned before it.

The workload runtime's last modules, after pipeline_train:

- checkpoint (parallel/checkpoint.py): 7B width cut to 4 layers (1.07 B
  parameters, ~6.4 GB of bf16 state with AdamW's moments), B=1, S=2048,
  the one-device step: 4 steps on one batch, saved after steps 1 and 2
  with max_to_keep=1 into a temporary directory (free space checked
  first); restored into a fresh init_fn(3) for 2 more steps, whose last
  loss must equal the uninterrupted run's to the bit; restored again onto
  the world-1 NCCL mesh's template for one step, equal to the bit too; GB
  written, save and restore seconds and GB/s.
- multihost (parallel/multihost.py): initialize_multihost over a TCP
  rendezvous on 127.0.0.1 (world-1 NCCL), global_batch against batch_fn,
  one 4-layer 7B-width step through it equal to the one-device step's loss
  to the bit; then the YODA_* env path with no arguments.
- resnet (models/resnet.py): ResNet-50, 1000 classes, B=256, 224 x 224 x
  3, bf16, channels_last: train-mode and eval forwards and the
  forward+backward of a softmax cross-entropy, images/s, TF/s and MFU
  (from the conv and Dense shapes), peak memory; the bf16 logits and
  running statistics against the fp32 model on the same weights and
  batch, and the running statistics of two BatchNorms against the fp32
  biased-variance formula (in fp64).

Every flash launch of the checkpoint and multihost steps is on the wgmma
route.

The scheduling system, on the host, fed by the card's telemetry:

- telemetry (telemetry/sniffer.py, duty.py, nvml.py): the NVML sniffer's
  node against nvidia-smi (memory total equal, free within a slack, max SM
  clock, power limit, one chip a card) and CUDA's memory view; free memory
  again while 16 GiB are held; NVML's utilization through DutySamplerPool
  (>= 80 under ~2 s of the ring phase's causal 8192-token flash_fwd, <= 20
  two seconds after) and the probe sampler above its idle reading; `python
  -m yoda_scheduler_tpu_torch.cli sniff`'s CR (accelerator gpu, a chip for
  each card `nvidia-smi -L` lists); the snapshot's ms.
- scheduler (the engine copy): bench.py's huge_5000 cluster (5,000 fake
  nodes through the port's telemetry.fake) plus the live card as sniffed;
  a 60,000 MB one-card GPU pod binds on the live card and nowhere else,
  and with 40 GiB of the card held (re-sniffed, re-put) the same pod is
  refused; then bench.py's burst of 25,000 pods (5 a node, its four
  kinds, in an order from a seed): no chip held twice, no chip's memory
  overcommitted, two runs of the whole trace on the native planes (built
  here from the checkout's native/*.cc with g++; the phase fails if they
  do not build) placing alike, deciding cycles natively and binding what
  the numpy plane bound before, and a third run on the numpy plane placing
  as they do; bound pods, cycle p50 and p99, wall seconds and the data
  planes that ran.
- gpu_fleet (topology/gpus.py, plugins/gpulocality.py): NVML's product
  name of the card maps to its catalog model (h100-sxm5), and each field of
  that row equals NVML's reading (total memory, maximum SM clock, CUDA
  cores, active NVLink links, power limit; a difference names the field);
  the sniffed node carries the model. Then a fleet after the NVIDIA DGX
  SuperPOD (DGX H100) reference architecture, 32-node scalable units as
  InfiniBand leaves: 16 leaves x 32 HGX H100 SXM5 nodes, 64 A100 SXM4 80GB
  nodes on 2 leaves, 32 H100 PCIe nodes on 1 leaf, each model its own
  fabric, plus the live node, takes a burst from a seed (gangs of 2, 4, 8
  and 16 nodes x 8 cards pinned to h100-sxm5, whole-node pods, 1-4-card
  pods pinned to each model or to none, ~80% of the cards; first a pod
  pinned to h100-sxm5 asking memory only the live card has free), twice
  under deploy/gpu-profile.yaml (gpu-locality on) and once under the
  default profile: every pinned pod on its model, the live-card pod on
  the live node, with the plugin no gang across two leaves while one leaf
  had free nodes for all its members at its first reservation, no card
  held twice, no memory overcommitted, the two plugin runs alike; the
  gangs across leaves on and off, decisions by plane, each run's time,
  and (reported, not gated) the pods on H100 PCIe nodes whose cards sit in
  more than one bridged pair. The tier is the engine bench twin's
  `run_gpu_fleet` (bench.py).
- bench_engine (bench.py, tools/scale50k.py): the engine bench twins with
  the live card in their clusters: bench.py's burst headline (both
  profiles warmed, then five paired runs), `run_scale(125)` once and
  scale50k's smoke tier (the 5,000-node tier, then 12,504 nodes, one pod a
  node): no placement fault in any run, the native planes deciding every
  run of the yoda-tpu profile, and at least one pod of each such burst on
  the live card; the headline's latency, ratios, bound and bin-pack, the
  scale run's and the tier's wall time, binds/s and peak RSS.
- webhook (k8s/webhook.py, deploy/gpu-bind-authority-webhook.yaml,
  deploy/crd-tpunodemetrics.yaml, k8s/crdcheck.py): the live node's CR
  from NVML against the port's TpuNodeMetrics CRD (every value of its
  declared type, the model in the enum, nothing undeclared), published
  through the port's publisher into the port's fake API server, its status
  stored as written; the bind-authority webhook started as a subprocess
  from its manifest's command and args (plain HTTP: the two TLS flags
  dropped, a free port, the fake's address), registered with the fake in
  its vanilla posture; a bind of the live card allowed, a second bind of
  the same card refused with 409 ("denied the request"), a pod asking one
  MB more than the card has free refused on memory; 200 reviews over one
  kept-alive connection, half allowed and half denied, timed on the host
  clock (p50, p99); the webhook's own counts of reviews, allows and
  denials by reason.

The port's tools, and the workload's side of the scheduler's assignment:

- tune_attention (tools/tune_attention.py), right after phase 3: the
  route sweep in this process, forward and forward+backward at S = 2048,
  4096 and 8192 (H=16, D=128, B=8192/S, causal, bf16), every route
  `_routes` admits (wgmma, mma, simt) beside SDPA under its flash backend
  and the plain version, each candidate checked against the plain version
  at every S before any is timed, then timed in turns (A, ..., A, three
  rounds, as the tool's default); each row's median, spread, bound and
  share of it; the launches of each kernel in the sweep, by route (the
  kernels line counts the wgmma route's under tune_attention, as on every
  other path, and gives all three routes' beside it).
- bench_mfu (bench_mfu.py), right after tune_attention: the twin of the
  JAX package's bench_mfu.py through its own functions. The train step's
  MFU for four candidates in ascending size (d1024 L8 B8, d1024 L16 B8,
  d2048 L16 B4, Llama-2-7B B1, all S=2048: one warm step, 10 timed, MFU
  against the card's catalog peak); then every attention row (causal,
  H=16, D=128, B=8192/S at S = 2048, 4096, 8192, forward and the gradient
  with respect to q; GQA 16q/4kv and window=1024 at S=8192) checked
  against the plain version (tools/tune_attention's checks; GQA grouped
  against repeated) before any is timed, then timed as q-chained slopes
  beside the plain version and SDPA (default and flash backends, the
  default's choice named). Every candidate and row must give its
  numbers; every attention launch be on the wgmma route, and each train
  candidate's too (at head dim 128 and at the d1024 widths' 64).
- bench_generate (bench_generate.py): the twin of bench_generate.py at
  width 2048, 16 layers: prefill ms and decode tokens/s at B = 1 and 8,
  window None and 1024 (the ring cache, its decode first held against the
  linear cache's over 8 steps, a check that must reject two planted
  wrong rings), prompt 2048, 512 new tokens, one slope a cell, beside
  the weights' roofline; then the no-cache baseline at B=8 (16 flash_fwd
  a token, all on the wgmma route). Each prints its rows and then the
  twin's JSON line.
- visible (parallel/multihost.py), last: a child process given
  YODA_ASSIGNED_CHIPS="0,0,0" sees exactly one card, whose UUID is NVML's
  card 0's; "1,0,0" (past this host's one card) is refused by the helper;
  the helper refuses once CUDA has started, in this process and in a
  child that only asked torch.cuda.is_available().

Then a line listing every kernel of the path, and last the device
line. Full results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import random
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import torch

# the engine bench twin: its clusters, tiers and the engine's invariants
# (placement_faults) serve the scheduler, gpu_fleet and bench_engine phases
from yoda_scheduler_tpu_torch import bench as engine_bench
# the backend SDPA's default dispatch picks, named beside its time
# and the library's call (bench_mfu's, the flash backend forced as the
# route sweep forces it)
from yoda_scheduler_tpu_torch.bench_mfu import sdpa_default_backend, sdpa_fn
# the card's rates and the kernels' bounds, one copy with the route sweep
# (yoda_scheduler_tpu_torch/tools/tune_attention.py)
from yoda_scheduler_tpu_torch.ops.bounds import (H100_BF16_FLOPS, H100_HBM_BYTES,
                                                 attention_bound, backward_bounds,
                                                 visible_pairs)

# phase 2 tolerances, |kernel - plain| <= atol + rtol * |plain|:
# bf16 O: the plain version rounds the probabilities to bf16 before P.V and
#   the kernel rounds only its output, about one bf16 ulp at |O| < 4;
# fp32 O: summation order only (the plain products run in full fp32);
# LSE is fp32 on both sides; the kernel scales q before Q.K^T and the plain
#   version scales the scores after it.
# fp16 O: the same roundings one fp16 ulp deep, 8x finer than bf16's, so
#   bf16's bound over 8 (each about 2.6 ulps relative of its type).
TOL = {torch.bfloat16: dict(o=2e-2, lse=1e-3), torch.float16: dict(o=2.5e-3, lse=1e-3),
       torch.float32: dict(o=1e-4, lse=1e-4)}
# phases 3-4: relative L2 error of the logits against the plain path. Each
# of 32 bf16 layers rounds its attention differently in the two paths and
# the residual stream carries the differences on; two plain bf16 paths of 32
# layers at width 128 already differ by 2.4e-2 on the CPU. A wrong mask or
# index gives an error of order 1.
LOGITS_REL_L2 = 1e-1
# phase 3 tolerance, as phase 2's: the plain backward rounds P and dS to the
# input dtype where the kernels round them, so bf16 results differ by the
# order of fp32 sums, which moves a rounding by one bf16 ulp now and then;
# fp32 results differ by summation order only.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 2.5e-3, torch.float32: 1e-4}
# phases 2 and 3 also bound O, dQ, dK and dV each by its worst 64-row tile
# of one (batch, head), `tile_rel_l2`: O of a late row (|O| near
# sqrt(e/n) for n keys seen) and dK and dV of late keys are about as small
# as the atol above, so a tile that is a fifth wrong, such as one V tile
# missed or read twice, can pass it; this bound holds every tile to its own
# size (bf16: the route sweep's `FWD_TILE_REL_L2` and the variant tool's
# `variants.BWD_TILE_REL_L2`; fp32: summation order).
TILE_REL_L2_FP32 = 1e-4
TILE_REL_L2_FP16 = 1.25e-3  # bf16's 1e-2 over 8, as TOL's fp16 bounds
# phase 3's fp16 row under a large LSE cotangent (a z-loss on the LSE): dO
# of a model's size (x1e-5, Llama-2-7B width) beside g_lse x1e3, on the fp16
# wgmma kernels at head dim 128 through the kernels' autograd node, against
# the backward in fp32 on the same fp16 inputs. No fp16 gradient is nearer
# the fp32 one than that rounded to fp16 (dV of ~1e-5 lies on fp16's
# subnormal grid); each output must be finite and within twice that distance
# (the kernels' plain twins on the CPU, S=512-2048, read 1.1-1.4x). With the
# cotangent scale taken from dO alone, dQ and dK overflow to inf. The second
# row puts an attention sink at key 0 under an LSE cotangent of one sign (a
# z-loss's 2 c lse): the sink's dK, ~1.8e4, times the cotangent scale (256)
# lies past fp16's largest value, so it is finite only because the kernels
# multiply their sums by the inverse scale before rounding them to fp16.
FP16_LSE_COTANGENT = dict(b=1, h=32, s=2048, d=128, do_scale=1e-5, g_lse_scale=1e3)
FP16_SINK_COTANGENT = dict(FP16_LSE_COTANGENT, g_lse_scale=100.0, sink=True)
# the sink row again at OPT-1.3B's head dim, 64, at OpenLLaMA-3B's, 100, at
# GPT-J-6B's, 256, at GPT-NeoX-20B's, 96, and at OPT-2.7B's, 80, on the fp16
# wgmma kernels at each
FP16_SINK_COTANGENT_D64 = dict(FP16_SINK_COTANGENT, d=64)
FP16_SINK_COTANGENT_D100 = dict(FP16_SINK_COTANGENT, d=100)
FP16_SINK_COTANGENT_D256 = dict(FP16_SINK_COTANGENT, d=256)
FP16_SINK_COTANGENT_D96 = dict(FP16_SINK_COTANGENT, d=96)
FP16_SINK_COTANGENT_D80 = dict(FP16_SINK_COTANGENT, d=80)
FP16_ROUNDING_FACTOR = 2.0
BWD_G_LSE = {"gqa", "gqa_bshd", "cross_length", "ragged_300",  # shapes with a non-zero
             "gqa_d64", "ragged_d64", "gqa_d96", "gemma_d256",   # LSE cotangent
             "ragged_d40", "gqa_d80", "ragged_d80"}
# phase 6: relative L2 error of each leaf's gradient against the gradient
# through the plain attention. The two round at different places in bf16:
# autograd of the plain attention rounds the probabilities and their
# gradient dP to bf16 and keeps dS in fp32, the kernels keep dP in fp32 and
# round P and dS; every matmul of the backward then rounds its bf16 output,
# and 4 layers carry the differences on. A wrong mask or index moves the
# attention gradients by tens of percent.
GRAD_REL_L2 = 5e-2
TRAIN_STEPS = 4   # one warm-up step, then three timed
# MoE phases, against the same model through the plain attention. Set before
# the first card run from a CPU emulation (a kernel-like bf16 attention
# against the plain one, 16 MoE layers of 8 experts, top-2, widths 512 and
# 1024), not from a card run:
# - end to end, routing flips near ties reroute tokens, which reroutes
#   others through attention and capacity, so the two paths drift apart
#   layer by layer: logits rel. L2 0.12-0.16 and routing agreement
#   0.94-0.96 (layer 0 0.998, layer 15 0.87-0.91) for sound kernels; 1.04
#   and 0.44 for a non-causal kernel. Bounds 0.5 and 0.75.
# - layer by layer, both paths given the same input (the kernel path's):
#   a sound kernel moves a choice only near a tie, agreement >= 0.9956 and
#   layer output rel. L2 <= 0.013 in the emulation; a non-causal kernel
#   0.91 and 0.157. Bounds 0.98 and 0.05 for every layer.
# Each of the four bounds must also reject every planted wrong attention
# (`planted_faults`), read on the card in every run.
# moe_serving: prefill's logits at every prompt position (4 x 512, the plain
# cached attention) against llama_forward's (the kernel), as moe_forward's
# end-to-end comparison at a quarter of the tokens a row. With sound kernels
# the card read 0.130 (moe_forward, every position) and 0.1487 (prefill's
# last position). Bound 0.3, about twice those, chosen before any planted
# fault was read; the planted faults must exceed it.
MOE_SERVING_REL_L2 = 0.3
MOE_LOGITS_REL_L2 = 0.5
MOE_ROUTING_AGREE = 0.75
MOE_LAYER_ROUTING_AGREE = 0.98
MOE_LAYER_REL_L2 = 5e-2
MOE_FORWARD_LAYERS, MOE_TRAIN_LAYERS = 16, 4
# sharded_train: at world 1 every collective is skipped and each rank's
# hooks are the one-device ones, so the sharded step runs the one-device
# step's operations on the same inputs: its losses are expected equal to
# train's to the bit. The bound is relative and allows a sum's order to
# differ (a bf16 step's loss moves by ~1e-3 for a one-ulp change of its
# weights); the reading is reported as it is.
SHARDED_LOSS_REL = 1e-3
SHARDED_PEAK_SLACK_GB = 2.0
# ring: S=8192 over sp=4 (the whole sequence's causal attention as 4
# diagonal and 6 full 2048-token chunks); output and gradients against the
# plain attention, by relative L2 over the whole tensor and by the worst
# 64-row tile (phase 3's bound, variants.BWD_TILE_REL_L2): the ring merges
# fp32 partials and rounds once, the plain version rounds its
# probabilities to bf16 before P.V.
RING_SEQ, RING_SP = 8192, 4
RING_SHAPES = {"mha": (1, 32, 32, 128), "gqa": (1, 32, 8, 128)}  # b, h, kvh, d
# pipeline phases: 4 stages in one process, 4 microbatches of one row each.
# The loss against the one-device loss within 5e-3 absolute (the JAX
# package's test_loss_matches_plain_model bound); every gradient within
# GRAD_REL_L2 (phase 6's). With random weights the loss barely sees how the
# stages are wired (a wrong pairing of rows and targets moves it by the
# noise of 8188 random predictions, ~1e-2), the gradients do (order 1):
# each planted fault must break the gradient bound, and one the loss bound.
PIPE_PP, PIPE_MICROBATCHES, PIPE_BATCH, PIPE_SEQ = 4, 4, 4, 2048
PIPE_LOSS_ABS = 5e-3
PIPE_FAULTS = ("stage_order", "retire_shift", "retire_reversed")

# checkpoint and multihost: 7B width cut to 4 layers so that the state
# (1.07 B parameters and AdamW's bf16 moments, ~6.4 GB) writes in seconds;
# a resumed or rendezvoused step runs the same operations on the same
# values as the uninterrupted one-device step, so the losses must be equal
# to the bit (sharded_train already reads equal against train).
CKPT_LAYERS, CKPT_STEPS, CKPT_SAVES = 4, 4, (1, 2)
# resnet: B=256 at 224 x 224 (the JAX package's example pod trains at
# ImageNet size). The bf16 model against the fp32 model on the same weights
# and batch, both in this port on the card: each conv rounds its output to
# bf16 and every BatchNorm carries the differences on. A CPU estimate
# (B=8..64, 64-224 px, these weights), not a card reading: train-mode
# logits 0.011-0.033, eval 0.0026-0.0035, running statistics 0.004-0.006.
# Bounds about 3x those. The running statistics after one train forward
# against the biased-variance formula in fp64: fp32 sums only.
RESNET_BATCH, RESNET_IMAGE, RESNET_ITERS = 256, 224, 3
RESNET_REL_L2 = {"train": 0.1, "eval": 0.02, "stats": 0.02}
RESNET_STATS_FORMULA_REL = 1e-4
# telemetry: NVML's memory.total and free are what nvidia-smi reads (the
# same library, MiB floored), so totals must be equal and free memory, read
# a moment apart with nothing allocated between, within TELEMETRY_FREE_SLACK_MB.
# CUDA's own view (torch.cuda.mem_get_info) leaves out the GPU driver's
# reservation: its total may be lower than NVML's by up to
# TELEMETRY_CUDA_SLACK_MB, and its free memory differs by as much.
# A 16 GiB allocation must lower the sniffed free memory by at least
# 16 GiB less the free slack. The load is the ring phase's causal
# 8192-token flash_fwd (B=1, H=32, D=128, bf16: ~1 ms a launch), enqueued
# for TELEMETRY_LOAD_S: the host keeps the launch queue full, so NVML's
# utilization reads >= TELEMETRY_BUSY_PCT during it and <= TELEMETRY_IDLE_PCT
# TELEMETRY_SETTLE_S after it.
TELEMETRY_FREE_SLACK_MB, TELEMETRY_CUDA_SLACK_MB = 256, 1024
TELEMETRY_ALLOC_GIB, TELEMETRY_LOAD_S, TELEMETRY_SETTLE_S = 16, 2.0, 2.0
TELEMETRY_BUSY_PCT, TELEMETRY_IDLE_PCT = 80, 20
# scheduler: bench.py's huge_5000 cell (BENCH_SCALE5K.json): 625 x (one
# v4-32 slice of 4 hosts, 2 v4-8 hosts, 2 GPU nodes of 8 cards at 40,000
# MB) = 5,000 nodes (the twin's build_scale_nodes), 5 pods a node in
# bench.py's mix, plus this host's card as sniffed. A pod asking for LIVE_POD_MB of free memory a card fits
# only the live card (a fake GPU card has 40,000 MB); with LIVE_HOLD_GIB
# of the card held it fits nowhere.
SCHED_UNITS, SCHED_PODS_PER_NODE, SCHED_SEED = 625, 5, 13
LIVE_NODE, LIVE_POD_MB, LIVE_HOLD_GIB = "h100-live", 60_000, 40

# native planes: the scheduler phase's burst must bind what PR 9's numpy
# plane bound (the native plane places as the numpy plane does)
SCHED_BOUND = 20_161

# gpu_fleet: the engine bench twin's GPU fleet (bench.GPU_FLEET: a DGX
# SuperPOD's scalable units as IB leaves, and the live node) and its burst
# from bench.GPU_FLEET_SEED, through bench.run_gpu_fleet

# bench_engine: the burst headline's paired runs, the scale run's units
# (1,000 nodes) and scale50k's smoke tier (12,504 nodes)
ENGINE_BURST_RUNS, ENGINE_SCALE_UNITS = 5, 125
# and the outcomes each run must reach: the JAX bench's on the CPU
# (tests/test_torch_bench_engine.py), plus one pod on the live card where
# the yoda-tpu profile places it. The burst binds all 200 pods with its 5
# gangs whole on yoda-tpu, the reference emulation 195; run_scale(125) the
# JAX engine's 4,040 plus one; scale50k's 5,000-node leg its 20,232 plus
# one, and its 12,504-node tier every pod
ENGINE_BURST_BOUND, ENGINE_BURST_GANGS, ENGINE_BASELINE_BOUND = 200, 5, 195
ENGINE_SCALE_BOUND, ENGINE_5K_BOUND = 4_041, 20_233

# webhook: the port's bind-authority manifest and CRD (the smoke runs the
# manifest's command, without its two TLS flags), the webhook's time to
# answer /healthz once its feed has listed, and the reviews timed on the
# host clock, half allowed (no card claimed) and half denied (the live
# card, already claimed)
WEBHOOK_MANIFEST = "yoda_scheduler_tpu_torch/deploy/gpu-bind-authority-webhook.yaml"
WEBHOOK_START_LIMIT_S, WEBHOOK_REVIEWS = 60.0, 200

# tune_attention: the route sweep (tools/tune_attention.py) at the
# reference's sequence lengths, each candidate A, B, ..., B, A this many
# rounds (the tool's default); every route at every S fits the phase's
# share of the run (13.445723 s with one round on an H100, simt at S=8192
# included: 75 ms a forward+backward)
TUNE_SEQS, TUNE_REPEATS = (2048, 4096, 8192), 3

# bench_mfu and bench_generate: the twins' own shapes and plans. A decode
# slope spans ~400 steps, so the smoke takes one a cell where the twin takes
# the median of three (the attention rows keep the twin's readings)
BENCH_DECODE_REPEATS = 1
BENCH_MFU_ROWS = ("S2048", "S4096", "S8192", "gqa_16q_4kv", "window_1024")
BENCH_MFU_CANDIDATES = 4

# visible: a child process given the annotation of card 0 must see that
# card alone, by its NVML UUID; card 1, which this one-card host lacks,
# must be refused by the helper, not by CUDA
VISIBLE_CHILD = """
import json, sys, torch
from yoda_scheduler_tpu_torch.parallel import multihost
if sys.argv[1] == "cuda_first":
    torch.cuda.is_available()  # runs cuInit, not torch's CUDA state
out = {}
try:
    out["set"] = multihost.bind_assigned_cards()
except (ValueError, RuntimeError) as e:
    out["error"] = f"{type(e).__name__}: {e}"
else:
    out["count"] = torch.cuda.device_count()
    out["uuid0"] = str(torch.cuda.get_device_properties(0).uuid)
print(json.dumps(out))
"""

RESULTS: dict = {}


def emit(phase: str, **fields) -> None:
    RESULTS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of one call over `iters` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()))


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recording_routes(moe):
    """Collects (expert [B, S, k], dispatched [B, S, k]) of each MoE layer
    that runs inside the block, in order."""
    calls, orig = [], moe._top_k_dispatch

    def record(*args):
        out = orig(*args)
        calls.append((out[0], out[2] > 0))
        return out

    moe._top_k_dispatch = record
    try:
        yield calls
    finally:
        moe._top_k_dispatch = orig


def routing_agreement(a, b) -> float:
    """Share of (token, choice) decisions, expert and dispatched, that are
    equal in two runs of one layer."""
    (ea, da), (eb, db) = a, b
    return float(((ea == eb) & (da == db)).float().mean())


def planted_faults(attn) -> dict:
    """Wrong attentions, each a fault a kernel could have, for the MoE
    phases' comparisons to reject: the causal mask dropped, and every query
    head reading the next KV group's keys and values (a group-index fault)."""
    def kv_group_shift(q, k, v):
        return attn.flash_attention(q, k.roll(1, dims=1), v.roll(1, dims=1))

    kv_group_shift.handles_gqa = True
    return {"non_causal": functools.partial(attn.flash_attention, causal=False),
            "kv_group_shift": kv_group_shift}


def reset_launches(attn) -> None:
    for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv):
        attn._reset_counts(fn)


def read_launches(attn) -> dict:
    return {fn.__name__: fn.launches
            for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv)}


def read_routes(attn) -> dict:
    """Each wrapper's launches by route, the routes that launched."""
    return {fn.__name__: {r: n for r, n in fn.launches_by_route.items() if n}
            for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv)}


def ptxas_summary(log: str) -> dict:
    """{kernel (with its mangled template arguments): "N registers, S bytes
    spill stores, L bytes spill loads"} from nvcc's -Xptxas -v output;
    ptxas's performance notes (wgmma serialization, setmaxnreg) are kept
    under "notes"."""
    out, notes, kernel = {}, [], None
    for ln in log.splitlines():
        name = re.search(r"\d(flash_\w+?_kernel)(I\w*?EE)?", ln)
        if "Compiling entry" in ln and name:
            kernel = name.group(1) + (name.group(2) or "")
            out[kernel] = ""
        elif kernel and "spill stores" in ln:
            out[kernel] = ln.strip()
        elif kernel and "Used" in ln and "registers" in ln:
            used = re.search(r"Used (\d+) registers", ln).group(1)
            out[kernel] = f"{used} registers, {out[kernel]}"
        elif "Performance" in ln or "setmaxnreg" in ln:
            notes.append(ln.strip())
    return {**out, "notes": notes}


# the wgmma kernels of csrc/, as ptxas names them: each must build
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_wgmma96_kernel",
                 "flash_fwd_wgmma64_kernel", "flash_fwd_wgmma_f16_kernel",
                 "flash_fwd_wgmma80_kernel", "flash_fwd_wgmma100_kernel",
                 "flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_wgmma96_kernel",
                 "flash_bwd_dq_wgmma64_kernel", "flash_bwd_dkv_wgmma_kernel",
                 "flash_bwd_dkv_wgmma96_kernel", "flash_bwd_dkv_wgmma64_kernel",
                 "flash_bwd_dq_wgmma_f16_kernel", "flash_bwd_dkv_wgmma_f16_kernel",
                 "flash_bwd_dq_wgmma100_kernel", "flash_bwd_dkv_wgmma100_kernel",
                 "flash_fwd_wgmma256_kernel", "flash_fwd_wgmma64_f16_kernel",
                 "flash_bwd_dq_wgmma80_kernel", "flash_bwd_dkv_wgmma80_kernel",
                 "flash_bwd_dq_wgmma256_kernel", "flash_bwd_dkv_wgmma256_kernel",
                 "flash_bwd_dq_wgmma64_f16_kernel", "flash_bwd_dkv_wgmma64_f16_kernel",
                 "flash_fwd_wgmma80_f16_kernel", "flash_fwd_wgmma100_f16_kernel",
                 "flash_bwd_dq_wgmma100_f16_kernel", "flash_bwd_dkv_wgmma100_f16_kernel",
                 "flash_fwd_wgmma96_f16_kernel", "flash_fwd_wgmma256_f16_kernel",
                 "flash_bwd_dq_wgmma256_f16_kernel", "flash_bwd_dkv_wgmma256_f16_kernel",
                 "flash_bwd_dq_wgmma96_f16_kernel", "flash_bwd_dkv_wgmma96_f16_kernel",
                 "flash_bwd_dq_wgmma80_f16_kernel", "flash_bwd_dkv_wgmma80_f16_kernel")


def phase_build(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    names = ("flash_fwd", "flash_bwd")
    build.load(*names)
    info = {n: build.build_info.get(n, {}) for n in names}
    ptxas = {n: ptxas_summary(i.get("log", "")) for n, i in info.items()}
    # the wgmma kernels must fit their registers: no spills, no wgmma
    # serialised for want of registers (ptxas's C7512); the build keeps
    # ptxas's output beside each library, so a cached build is checked too
    wgmma = {k: v for p in ptxas.values() for k, v in p.items() if "wgmma" in k}
    notes = [n for p in ptxas.values() for n in p["notes"]]
    spill_free = (
        sorted(wgmma) == sorted(WGMMA_KERNELS)
        and all("0 bytes spill stores, 0 bytes spill loads" in v for v in wgmma.values())
        and not any("C7512" in n or "serialized" in n for n in notes))
    # reported, not gated: the simt and mma kernels at the widest padded
    # widths (256; 512, simt alone), whose sums are the largest
    widest = {w: {k: v for p in ptxas.values() for k, v in p.items()
                  if k != "notes" and f"Li{w}E" in k} for w in (256, 512)}
    emit("build", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0,
         nvcc_s={n: i.get("seconds") for n, i in info.items()}, ptxas=ptxas,
         wgmma_kernels_spill_free=spill_free, padded_256_kernels=widest[256],
         padded_512_kernels=widest[512])
    if not spill_free:
        raise SystemExit(f"the wgmma kernels {WGMMA_KERNELS} must build with no spills "
                         f"and no serialised wgmma: {wgmma}, notes {notes}")
    return smi


# (name, b, h, kvh, sq, sk, d, causal, window, dtype, layout, route):
# layout "bhsd" is contiguous [B, H, S, D]; "bshd" the model's transposed
# views of a contiguous [B, S, H, D]; "offset1" starts every tensor one
# element into its storage, off 16-byte alignment. route is the one
# `_route` must pick for these inputs, for every kernel (`shape_routes`).
SHAPES = [
    ("main", 1, 32, 32, 2048, 2048, 128, True, None, torch.bfloat16, "bhsd", "wgmma"),
    ("main_bshd", 1, 32, 32, 2048, 2048, 128, True, None, torch.bfloat16, "bshd",
     "wgmma"),
    ("gqa", 1, 32, 8, 2048, 2048, 128, True, None, torch.bfloat16, "bhsd", "wgmma"),
    ("gqa_bshd", 1, 32, 8, 2048, 2048, 128, True, None, torch.bfloat16, "bshd",
     "wgmma"),  # Mixtral-8x7B's attention as its model gives it to the kernels
    ("cross_length", 1, 32, 32, 256, 1024, 128, True, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("window_512", 1, 32, 32, 2048, 2048, 128, True, 512, torch.bfloat16, "bhsd",
     "wgmma"),
    ("non_causal", 1, 32, 32, 1024, 1024, 128, False, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("fp32_d64", 1, 16, 16, 1024, 1024, 64, True, None, torch.float32, "bhsd", "simt"),
    ("d1024_bshd", 8, 16, 16, 2048, 2048, 64, True, None, torch.bfloat16, "bshd",
     "wgmma"),  # bench_mfu's d1024 train candidates as their model gives them
    ("gqa_d64", 1, 16, 4, 2048, 2048, 64, True, None, torch.bfloat16, "bshd", "wgmma"),
    ("window_d64", 1, 16, 16, 2048, 2048, 64, True, 512, torch.bfloat16, "bhsd",
     "wgmma"),
    ("cross_length_d64", 1, 16, 16, 256, 1024, 64, True, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("non_causal_d64", 1, 16, 16, 1000, 1000, 64, False, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("ragged_d64", 2, 8, 4, 300, 300, 64, True, None, torch.bfloat16, "bshd", "wgmma"),
    ("ragged_300", 2, 8, 4, 300, 300, 128, True, None, torch.bfloat16, "bhsd", "wgmma"),
    # head dim 96 (Phi-3-mini's): every kernel on its wgmma kernel at 96;
    # cross-length, non-causal and ragged here, and Phi-3-mini's attention
    # with GQA and a window among the rows below
    ("cross_length_d96", 1, 32, 32, 256, 1024, 96, True, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("non_causal_d96", 1, 32, 32, 1000, 1000, 96, False, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("ragged_d96", 2, 8, 4, 300, 300, 96, True, None, torch.bfloat16, "bshd", "wgmma"),
    # fp16 at head dim 128 (Llama-2-7B in its published weights' dtype):
    # every kernel on its fp16 wgmma kernel; the model's
    # views, GQA 32/8, a window, a ragged sequence and cross-length here,
    # fp16_main among the rows below
    ("fp16_main_bshd", 1, 32, 32, 2048, 2048, 128, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_gqa_bshd", 1, 32, 8, 2048, 2048, 128, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_window_512", 1, 32, 32, 2048, 2048, 128, True, 512, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_ragged_300", 2, 8, 4, 300, 300, 128, True, None, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_cross_length", 1, 32, 32, 256, 1024, 128, True, None, torch.float16, "bhsd",
     "wgmma"),
    ("main_unaligned", 1, 32, 32, 2048, 2048, 128, True, None, torch.bfloat16,
     "offset1", "simt"),
    # head dims other than 32, 64 and 128, and fp16, on the simt and mma
    # kernels at their padded widths (at 80, 96, 100 and 256, and fp16 at
    # 64, 80, 96, 100, 128 and 256, on wgmma):
    # Phi-3-mini's attention (32 heads of 96, S=2048) as the model
    # gives it and contiguous, with GQA 32/8 and a window; 80 (2560 / 32,
    # StableLM-3B's and Phi-2's width), contiguous and as the model's views,
    # with GQA 32/8, a window, a ragged sequence, cross-length and
    # non-causal rows;
    # Gemma-2B's 8 query heads of 256 over one KV head; 40 on a ragged
    # sequence; 100 (OpenLLaMA-3B's), whose rows are not 16-byte aligned,
    # contiguous and as the model's views;
    # fp16 at the main shape and at d1024_bshd (the dtype of Llama-2's
    # published weights); simt at each padded width in fp32 and fp16; and
    # 320, past the mma kernels' 256, on simt's widest width (512)
    ("phi3_d96", 1, 32, 32, 2048, 2048, 96, True, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("phi3_d96_bshd", 1, 32, 32, 2048, 2048, 96, True, None, torch.bfloat16, "bshd",
     "wgmma"),
    ("gqa_d96", 1, 32, 8, 2048, 2048, 96, True, None, torch.bfloat16, "bshd", "wgmma"),
    ("window_d96", 1, 32, 32, 2048, 2048, 96, True, 512, torch.bfloat16, "bhsd",
     "wgmma"),
    ("d80", 1, 32, 32, 2048, 2048, 80, True, None, torch.bfloat16, "bhsd", "wgmma"),
    ("d80_bshd", 1, 32, 32, 2048, 2048, 80, True, None, torch.bfloat16, "bshd",
     "wgmma"),  # StableLM-3B-4E1T's attention as its model gives it
    ("gqa_d80", 1, 32, 8, 2048, 2048, 80, True, None, torch.bfloat16, "bshd", "wgmma"),
    ("window_d80", 1, 32, 32, 2048, 2048, 80, True, 512, torch.bfloat16, "bhsd",
     "wgmma"),
    ("ragged_d80", 2, 8, 4, 300, 300, 80, True, None, torch.bfloat16, "bshd", "wgmma"),
    ("cross_length_d80", 1, 32, 32, 256, 1024, 80, True, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("non_causal_d80", 1, 32, 32, 1000, 1000, 80, False, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("gemma_d256", 1, 8, 1, 2048, 2048, 256, True, None, torch.bfloat16, "bshd",
     "wgmma"),  # Gemma-2B's attention as its model gives it
    # head dim 256 on the wgmma kernels: Gemma-7B's 16 heads over 16,
    # Gemma-2B's 8 over 1 and Gemma-2-9B's 16 over 8 with a window (Gemma-2's
    # own is 4096; 512 bites at S=2048), ragged over one KV head,
    # cross-length and non-causal
    ("gemma7b_d256", 1, 16, 16, 2048, 2048, 256, True, None, torch.bfloat16, "bshd",
     "wgmma"),
    ("gemma2b_window_d256", 1, 8, 1, 2048, 2048, 256, True, 512, torch.bfloat16, "bshd",
     "wgmma"),
    ("gemma2_window_d256", 1, 16, 8, 2048, 2048, 256, True, 512, torch.bfloat16, "bshd",
     "wgmma"),
    ("ragged_d256", 2, 8, 1, 300, 300, 256, True, None, torch.bfloat16, "bshd", "wgmma"),
    ("cross_d256", 1, 8, 1, 256, 1024, 256, True, None, torch.bfloat16, "bhsd", "wgmma"),
    ("noncausal_d256", 1, 8, 1, 1000, 1000, 256, False, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("ragged_d40", 2, 8, 4, 300, 300, 40, True, None, torch.bfloat16, "bhsd", "mma"),
    ("unaligned_d100", 1, 32, 32, 1024, 1024, 100, True, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("d100_bshd", 1, 32, 32, 2048, 2048, 100, True, None, torch.bfloat16, "bshd",
     "wgmma"),  # OpenLLaMA-3B's attention as its model gives it
    ("fp16_main", 1, 32, 32, 2048, 2048, 128, True, None, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_d1024_bshd", 8, 16, 16, 2048, 2048, 64, True, None, torch.float16, "bshd",
     "wgmma"),
    # fp16 at head dim 64 on the fp16 wgmma kernels: OPT-1.3B's attention as
    # its model gives it, and a ragged GQA row
    ("opt13b_d64_bshd", 1, 32, 32, 2048, 2048, 64, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_ragged_d64", 2, 8, 4, 300, 300, 64, True, None, torch.float16, "bhsd",
     "wgmma"),
    # fp16 at head dims 80 and 100, the forward, dQ and dK/dV on their fp16
    # wgmma kernels: OPT-2.7B's attention and
    # OpenLLaMA-3B's in fp16 as their models give them (at 100 half of the
    # heads start 8 bytes off a 16-byte boundary), 200-byte rows contiguous,
    # and at each width GQA 32/8, a window, a ragged sequence, cross-length
    # and non-causal
    ("opt27b_d80_bshd", 1, 32, 32, 2048, 2048, 80, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_gqa_d80", 1, 32, 8, 2048, 2048, 80, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_window_d80", 1, 32, 32, 2048, 2048, 80, True, 512, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_ragged_d80", 2, 8, 4, 300, 300, 80, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_cross_length_d80", 1, 32, 32, 256, 1024, 80, True, None, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_non_causal_d80", 1, 32, 32, 1000, 1000, 80, False, None, torch.float16, "bhsd",
     "wgmma"),
    ("openllama3b_fp16_d100_bshd", 1, 32, 32, 2048, 2048, 100, True, None, torch.float16,
     "bshd", "wgmma"),
    ("fp16_unaligned_d100", 1, 32, 32, 1024, 1024, 100, True, None, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_gqa_d100", 1, 32, 8, 2048, 2048, 100, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_window_d100", 1, 32, 32, 2048, 2048, 100, True, 512, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_ragged_d100", 2, 8, 4, 300, 300, 100, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_cross_length_d100", 1, 32, 32, 256, 1024, 100, True, None, torch.float16,
     "bhsd", "wgmma"),
    ("fp16_non_causal_d100", 1, 32, 32, 1000, 1000, 100, False, None, torch.float16,
     "bhsd", "wgmma"),
    # fp16 at head dims 96 and 256, the forward, dQ and dK/dV on their fp16
    # wgmma kernels: GPT-NeoX-20B's attention (64 heads of 96) and GPT-J-6B's
    # (16 heads of 256) as their models give them, and at each width GQA, a
    # window, a ragged sequence, cross-length and non-causal
    ("neox20b_fp16_d96_bshd", 1, 64, 64, 2048, 2048, 96, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_gqa_d96", 1, 32, 8, 2048, 2048, 96, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_window_d96", 1, 32, 32, 2048, 2048, 96, True, 512, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_ragged_d96", 2, 8, 4, 300, 300, 96, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_cross_length_d96", 1, 32, 32, 256, 1024, 96, True, None, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_non_causal_d96", 1, 32, 32, 1000, 1000, 96, False, None, torch.float16, "bhsd",
     "wgmma"),
    ("gptj6b_fp16_d256_bshd", 1, 16, 16, 2048, 2048, 256, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_gqa_d256", 1, 16, 8, 2048, 2048, 256, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_window_d256", 1, 16, 16, 2048, 2048, 256, True, 512, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_ragged_d256", 2, 8, 1, 300, 300, 256, True, None, torch.float16, "bshd",
     "wgmma"),
    ("fp16_cross_length_d256", 1, 8, 1, 256, 1024, 256, True, None, torch.float16, "bhsd",
     "wgmma"),
    ("fp16_non_causal_d256", 1, 8, 1, 1000, 1000, 256, False, None, torch.float16, "bhsd",
     "wgmma"),
    ("fp32_d40", 1, 8, 8, 512, 512, 40, True, None, torch.float32, "bhsd", "simt"),
    ("fp16_unaligned_d80", 1, 8, 4, 512, 512, 80, True, 128, torch.float16, "offset1",
     "simt"),
    ("fp32_d256", 1, 4, 2, 300, 300, 256, True, None, torch.float32, "bhsd", "simt"),
    ("fp32_d320", 1, 8, 4, 512, 512, 320, True, None, torch.float32, "bhsd", "simt"),
    ("bf16_d320", 1, 8, 8, 300, 300, 320, True, None, torch.bfloat16, "bshd", "simt"),
]
# timed in turns at TURN_SHAPES: each kernel on those of these routes it
# takes, and SDPA's default backend after each turn; the short fp16 rows
# too, where launches are near their bound's few microseconds
ROUTE_TURNS = ("mma", "wgmma", "wgmma", "mma")
TURN_SHAPES = ("main", "d1024_bshd", "phi3_d96_bshd", "fp16_main", "fp16_ragged_300",
               "fp16_cross_length")
# the forward alone timed in turns against the route it took before its
# wgmma kernel (mma at 80, 256 and in fp16 at 64, 80, 96 and 256, simt at
# 100 in bf16 and fp16), SDPA's default after each turn (cuDNN at 80, flash
# at 100)
FWD_TURN_SHAPES = ("d80", "d80_bshd", "unaligned_d100", "d100_bshd", "gemma_d256",
                   "fp16_d1024_bshd", "opt27b_d80_bshd", "openllama3b_fp16_d100_bshd",
                   "neox20b_fp16_d96_bshd", "gptj6b_fp16_d256_bshd")
# dQ and dK/dV timed in turns against the route they took before their
# wgmma kernels (mma at 80, 256 and in fp16 at 64, 80, 96 and 256, simt at
# 100 in bf16 and fp16), with SDPA's whole backward after each turn under
# the backend named here:
# its default (cuDNN), which the padded-width queue's factors are read
# against, or at 100 its flash backend
BWD_TURN_SHAPES = {"d80": "default", "d80_bshd": "default", "unaligned_d100": "flash",
                   "d100_bshd": "flash", "gemma_d256": "default",
                   "fp16_d1024_bshd": "default", "opt13b_d64_bshd": "default",
                   "openllama3b_fp16_d100_bshd": "flash", "fp16_unaligned_d100": "flash",
                   "gptj6b_fp16_d256_bshd": "default", "neox20b_fp16_d96_bshd": "default",
                   "opt27b_d80_bshd": "default"}
D64_SHAPE = "d1024_bshd"  # the head-dim-64 row of the kernels line
# the rows at the new head dims and fp16: every route `_routes` admits is
# held against the plain version there, and SDPA's default backend is timed
# where its inputs are bf16 or fp16 rows that are 16-byte aligned (cuDNN's
# backward fails on the rows that start one element into their storage)
WIDE_SHAPES = ("phi3_d96", "phi3_d96_bshd", "gqa_d96", "window_d96", "d80", "d80_bshd",
               "gqa_d80", "window_d80", "ragged_d80", "cross_length_d80", "non_causal_d80",
               "gemma_d256", "gemma7b_d256", "gemma2b_window_d256", "gemma2_window_d256",
               "ragged_d256", "cross_d256", "noncausal_d256", "ragged_d40", "unaligned_d100",
               "d100_bshd", "fp16_main", "fp16_main_bshd", "fp16_gqa_bshd",
               "fp16_window_512", "fp16_ragged_300", "fp16_cross_length", "fp16_d1024_bshd",
               "opt13b_d64_bshd", "fp16_ragged_d64", "opt27b_d80_bshd", "fp16_gqa_d80",
               "fp16_window_d80", "fp16_ragged_d80", "fp16_cross_length_d80",
               "fp16_non_causal_d80", "openllama3b_fp16_d100_bshd", "fp16_unaligned_d100",
               "fp16_gqa_d100", "fp16_window_d100", "fp16_ragged_d100",
               "fp16_cross_length_d100", "fp16_non_causal_d100", "neox20b_fp16_d96_bshd",
               "fp16_gqa_d96", "fp16_window_d96", "fp16_ragged_d96", "fp16_cross_length_d96",
               "fp16_non_causal_d96", "gptj6b_fp16_d256_bshd", "fp16_gqa_d256",
               "fp16_window_d256", "fp16_ragged_d256", "fp16_cross_length_d256",
               "fp16_non_causal_d256", "fp32_d40", "fp16_unaligned_d80", "fp32_d256", "fp32_d320", "bf16_d320")
# the kernels line's head_dims entry: the rows of each new width and dtype
HEAD_DIM_ROWS = ("d80", "d80_bshd", "phi3_d96_bshd", "gemma_d256", "gemma7b_d256",
                 "unaligned_d100", "d100_bshd", "fp16_main", "fp16_d1024_bshd",
                 "opt13b_d64_bshd", "opt27b_d80_bshd", "openllama3b_fp16_d100_bshd",
                 "fp16_unaligned_d100", "neox20b_fp16_d96_bshd", "gptj6b_fp16_d256_bshd",
                 "bf16_d320")
# a head dim past the kernels' widest padded width (512, simt's): every
# wrapper refuses it on every route, with no launch
REFUSED_HEAD_DIM = 520


def shape_routes(route: str) -> dict:
    """Each kernel's route at a SHAPES row: `route`, for all three kernels
    (the wgmma route of each takes head dims 64, 80, 96, 100, 128 and 256 in
    bf16 and in fp16)."""
    return dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), route)


def step_routes(route, layers: int) -> dict:
    """Each kernel's launches by route over `layers` layers of train steps
    (remat): per layer the forward twice and each backward kernel once, each
    kernel on its route of `shape_routes(route)`."""
    routes = shape_routes(route)
    return {name: {routes[name]: per_layer * layers}
            for name, per_layer in (("flash_fwd", 2), ("flash_bwd_dq", 1),
                                    ("flash_bwd_dkv", 1))}


def rand_inputs(gen, dtype, layout, *shapes):
    """Normal tensors of `shapes` ([B, H, S, D]) on the card in `layout`."""
    out = []
    offset = 1 if layout == "offset1" else 0
    for shape in shapes:
        n = math.prod(shape)
        x = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)[offset:]
        if layout == "bshd":
            b, h, s, d = shape
            out.append(x.view(b, s, h, d).transpose(1, 2))
        else:
            out.append(x.view(shape))
    return out


def timed_against_library(name: str, dtype, layout: str) -> bool:
    """Whether a SHAPES row times SDPA's default backend beside the kernel:
    on half-precision rows whose rows are aligned (cuDNN's backward fails on
    the offset ones)."""
    if name in ("main", "main_bshd", D64_SHAPE):
        return True
    return name in WIDE_SHAPES and dtype != torch.float32 and layout != "offset1"


# the fp32 row past the flash backends' widths: SDPA's memory-efficient
# backend alone is the library's call there (its flash and cuDNN backends
# take no fp32)
EFFICIENT_SDPA_SHAPE = "fp32_d320"


def efficient_sdpa_time(tune, q, k, v, mask, do=None) -> tuple:
    """bench_mfu's SDPA call under the memory-efficient backend alone, on K
    and V repeated to q's heads before it is timed (that backend takes no
    grouped KV): (ms, error, the row's `sdpa` entry) of its forward, or with
    `do` of its backward alone."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call(q, k, v):
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return sdpa_fn(q, k, v, mask=mask)

    kr, vr = (t.repeat_interleave(q.shape[1] // k.shape[1], dim=1) for t in (k, v))
    fn = ((lambda: call(q, kr, vr)) if do is None
          else tune._backward_alone(call, q, kr, vr, do))
    ms, error = library_time(lambda: cuda_time_ms(fn, 20))
    key = "ms" if do is None else "backward_ms"
    return ms, error, {"backend": "EFFICIENT_ATTENTION",
                       "kv_repeated": k.shape[1] != q.shape[1], key: ms, "error": error}


def library_time(fn) -> tuple[float | None, str | None]:
    """(ms, None) for one SDPA yardstick, or (None, the error) where the
    library's call fails on the card: the row records the failure."""
    try:
        return fn(), None
    except RuntimeError as e:
        return None, f"{type(e).__name__}: {str(e)[:300]}"


def window_mask(sq: int, sk: int, window: int | None):
    """The causal (and windowed) mask as SDPA's boolean attn_mask, for the
    library's call on a windowed row."""
    if window is None:
        return None
    qi = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
    ki = torch.arange(sk, device="cuda")[None, :]
    return (ki <= qi) & (ki > qi - window)


def check_refusals(attn) -> dict:
    """Every wrapper, on every route, refuses head dim REFUSED_HEAD_DIM (past
    the widest padded width) with the limit in its message and launches
    nothing: {kernel: the message}."""
    d = REFUSED_HEAD_DIM
    q = torch.zeros((1, 2, 64, d), dtype=torch.bfloat16, device="cuda")
    lse = torch.zeros((1, 2, 64), device="cuda")
    out = {}
    for fn, args in ((attn.flash_fwd, (q, q, q)),
                     (attn.flash_bwd_dq, (q, q, q, q, lse, lse)),
                     (attn.flash_bwd_dkv, (q, q, q, q, lse, lse))):
        before = (fn.launches, dict(fn.launches_by_route))
        for route in (None, "simt", "mma", "wgmma"):
            try:
                fn(*args, route=route)
            except ValueError as e:
                out[fn.__name__] = str(e)
                if f"1 to {attn.KERNEL_MAX_HEAD_DIM}" not in str(e):
                    raise SystemExit(f"{fn.__name__} refused head dim {d} without "
                                     f"naming the limit: {e}")
            else:
                raise SystemExit(f"{fn.__name__} took head dim {d} on route {route}")
        if (fn.launches, fn.launches_by_route) != before:
            raise SystemExit(f"{fn.__name__} launched while refusing head dim {d}")
    torch.cuda.synchronize()
    return out


def phase_kernel(attn, variants, tune):
    tile_bound = {torch.bfloat16: tune.FWD_TILE_REL_L2, torch.float16: TILE_REL_L2_FP16,
                  torch.float32: TILE_REL_L2_FP32}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, max_err = [], 0.0
    for name, b, h, kvh, sq, sk, d, causal, window, dtype, layout, want in SHAPES:
        q, k, v = rand_inputs(gen, dtype, layout, (b, h, sq, d), (b, kvh, sk, d),
                              (b, kvh, sk, d))
        route, want = attn._route("flash_fwd", q, k, v), shape_routes(want)["flash_fwd"]
        if route != want:
            raise SystemExit(f"{name} takes the {route} route, expected {want}")
        o, lse = attn.flash_fwd(q, k, v, causal, window)
        torch.cuda.synchronize()
        ro, rlse = attn.reference_attention_with_lse(q, k, v, causal, window)
        tol = TOL[dtype]

        def agrees(o, lse):
            """(tile_rel_l2 of O, ok): within TOL elementwise and within the
            tile bound."""
            tile = variants.tile_rel_l2(o, ro)
            return tile, (bool(torch.isfinite(o).all()) and tile <= tile_bound[dtype]
                          and torch.allclose(o.float(), ro.float(), atol=tol["o"],
                                             rtol=tol["o"])
                          and torch.allclose(lse, rlse, atol=tol["lse"], rtol=tol["lse"]))

        err_o = float((o.float() - ro.float()).abs().max())
        err_lse = float((lse - rlse).abs().max())
        tile_o, ok = agrees(o, lse)
        ms = cuda_time_ms(lambda: attn.flash_fwd(q, k, v, causal, window), 20)
        plain_ms = cuda_time_ms(
            lambda: attn.reference_attention_with_lse(q, k, v, causal, window), 5)
        library_ms, library_error, sdpa, route_tile = None, None, None, None
        turns, library_turns = None, None
        mask = window_mask(sq, sk, window)
        if timed_against_library(name, dtype, layout):
            # the yardstick, timed here and used nowhere in the port
            library_ms, library_error = library_time(
                lambda: cuda_time_ms(lambda: sdpa_fn(q, k, v, mask=mask), 20))
        if name == D64_SHAPE:
            sdpa = {"default_backend": sdpa_default_backend(q, k, v),
                    "default_ms": library_ms,
                    "flash_ms": cuda_time_ms(lambda: sdpa_fn(q, k, v, flash=True), 20)}
        if name in WIDE_SHAPES:
            sdpa = ({"default_backend": sdpa_default_backend(q, k, v, mask=mask),
                     "default_ms": library_ms, "error": library_error}
                    if timed_against_library(name, dtype, layout) else None)
            # every other route that takes these inputs against the plain
            # version too
            route_tile = {}
            for r in attn._routes("flash_fwd", q, k, v):
                if r != route:
                    route_tile[f"{r}_o"], agree = agrees(
                        *attn.flash_fwd(q, k, v, causal, window, route=r))
                    ok = ok and agree
        if name == EFFICIENT_SDPA_SHAPE:
            library_ms, library_error, sdpa = efficient_sdpa_time(tune, q, k, v, mask)
        if name in TURN_SHAPES or name in FWD_TURN_SHAPES:
            # the route before wgmma (mma; simt at 100) against the plain
            # version too, then in turns
            old = attn._routes("flash_fwd", q, k, v)[-2]
            route_tile = route_tile or {}
            route_tile[f"{old}_o"], agree = agrees(
                *attn.flash_fwd(q, k, v, causal, window, route=old))
            ok = ok and agree
            # and the library's call after each turn, so that the factor
            # over it is read within these turns too
            order = (old, "wgmma", "wgmma", old)
            turns, library_turns = {r: [] for r in order}, []
            for r in order:
                turns[r].append(cuda_time_ms(
                    lambda: attn.flash_fwd(q, k, v, causal, window, route=r), 20))
                library_turns.append(cuda_time_ms(lambda: sdpa_fn(q, k, v, mask=mask), 20))
        bound_ms, bound_by = attention_bound(b, h, kvh, sq, sk, d, causal,
                                             window, dtype)
        flops = 4 * b * h * d * visible_pairs(sq, sk, causal, window)
        row = dict(shape=name, route=route, layout=layout, b=b, h=h, kvh=kvh,
                   sq=sq, sk=sk, d=d, causal=causal, window=window,
                   dtype=str(dtype).split(".")[1],
                   max_abs_err_o=err_o, max_abs_err_lse=err_lse, atol=tol,
                   tile_rel_l2_o=tile_o, tile_rel_l2_bound=tile_bound[dtype],
                   route_tile_rel_l2=route_tile, ok=ok, ms=ms, tflops=flops / ms / 1e9,
                   share_of_bound=bound_ms / ms, plain_ms=plain_ms,
                   library_ms=library_ms, sdpa=sdpa, route_turns_ms=turns,
                   library_turns_ms=library_turns, bound_ms=bound_ms, bound_by=bound_by)
        print(json.dumps({"phase": "kernel", **row}), flush=True)
        rows.append(row)
        max_err = max(max_err, err_o)
        if not ok:
            raise SystemExit(f"flash_fwd disagrees with its plain version at {name}")
    refused = check_refusals(attn)
    print(json.dumps({"phase": "kernel", "shape": f"refused_d{REFUSED_HEAD_DIM}",
                      "refusals": refused, "ok": True}), flush=True)
    RESULTS["kernel"] = rows
    RESULTS["kernel_refusals"] = refused
    return rows, max_err


def sdpa_backward_ms(tune, q, k, v, do, flash: bool = False, mask=None) -> float:
    """The library yardstick: the backward alone of bench_mfu's SDPA call
    (its default dispatch, or its flash backend), from one graph built once
    and differentiated again and again. Timed here only; the port never
    calls it."""
    return cuda_time_ms(tune._backward_alone(
        functools.partial(sdpa_fn, flash=flash, mask=mask), q, k, v, do), 20)


def phase_backward(attn, variants, tune):
    tile_bound = {torch.bfloat16: variants.BWD_TILE_REL_L2, torch.float16: TILE_REL_L2_FP16,
                  torch.float32: TILE_REL_L2_FP32}

    def agrees(got, ref_t, dtype):
        """(tile_rel_l2, ok): within BWD_TOL elementwise and within the tile
        bound."""
        tile = variants.tile_rel_l2(got, ref_t)
        tol = BWD_TOL[dtype]
        return tile, (bool(torch.isfinite(got).all()) and tile <= tile_bound[dtype]
                      and torch.allclose(got.float(), ref_t.float(), atol=tol, rtol=tol))

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, max_err = [], {"dq": 0.0, "dkv": 0.0}
    for name, b, h, kvh, sq, sk, d, causal, window, dtype, layout, want in SHAPES:
        q, k, v, do = rand_inputs(gen, dtype, layout, (b, h, sq, d), (b, kvh, sk, d),
                                  (b, kvh, sk, d), (b, h, sq, d))
        # dO in the layout of q: each backward kernel takes its own route
        want = shape_routes(want)
        routes = {n: attn._route(n, q, k, v, do) for n in ("flash_bwd_dq", "flash_bwd_dkv")}
        if any(routes[n] != want[n] for n in routes):
            raise SystemExit(f"{name}: the backward takes the routes {routes}, "
                             f"expected {want}")
        o, lse = attn.flash_fwd(q, k, v, causal, window)
        g_lse = (torch.randn((b, h, sq), generator=gen, device="cuda")
                 if name in BWD_G_LSE else None)
        delta = attn.backward_delta(o, do, g_lse).contiguous()
        args = (q, k, v, do, lse, delta, causal, window)
        reset_launches(attn)
        runs = []
        for _ in range(2):
            dq = attn.flash_bwd_dq(*args)
            dk, dv = attn.flash_bwd_dkv(*args)
            runs.append((dq, attn.group_sum(dk, kvh), attn.group_sum(dv, kvh)))
        torch.cuda.synchronize()
        launched = read_routes(attn)
        if any(launched[n] != {want[n]: 2} for n in ("flash_bwd_dq", "flash_bwd_dkv")):
            raise SystemExit(f"{name}: the backward launched {launched}, expected "
                             f"2 launches of each kernel on {want}")
        repeatable = all(torch.equal(a, b_) for a, b_ in zip(*runs))
        ref = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
        errs, ok = {}, repeatable
        for nm, got, ref_t in zip(("dq", "dk", "dv"), runs[0], ref):
            errs[nm] = float((got.float() - ref_t.float()).abs().max())
            errs[nm + "_rel_l2"] = rel_l2(got, ref_t)
            errs[nm + "_tile_rel_l2"], agree = agrees(got, ref_t, dtype)
            ok = ok and agree
        turns, library_turns, route_tile = None, None, None
        mask = window_mask(sq, sk, window)
        kernels = {"dq": attn.flash_bwd_dq, "dkv": attn.flash_bwd_dkv}
        taken = {key: attn._routes(fn.__name__, q, k, v, do) for key, fn in kernels.items()}

        def held(routes):
            """Each kernel on each of `routes` it takes, but its own route,
            against the plain backward: {route_output: tile_rel_l2}, ok."""
            tiles, agree_all = {}, True
            for r in routes:
                got = {}
                if r in taken["dq"] and r != want["flash_bwd_dq"]:
                    got["dq"] = attn.flash_bwd_dq(*args, route=r)
                if r in taken["dkv"] and r != want["flash_bwd_dkv"]:
                    got["dk"], got["dv"] = (attn.group_sum(t, kvh)
                                            for t in attn.flash_bwd_dkv(*args, route=r))
                for nm, ref_t in zip(("dq", "dk", "dv"), ref):
                    if nm in got:
                        tiles[f"{r}_{nm}"], agree = agrees(got[nm], ref_t, dtype)
                        agree_all = agree_all and agree
            return tiles, agree_all

        if name in WIDE_SHAPES:
            # every other route that takes these inputs against the plain
            # backward too
            route_tile, agree = held(taken["dkv"])
            ok = ok and agree
        if name in TURN_SHAPES:
            # each route against the plain backward too, then in turns
            tiles, agree = held(ROUTE_TURNS[:2])
            route_tile = {**(route_tile or {}), **tiles}
            ok = ok and agree
            # and SDPA's backward after each turn
            turns = {key: {r: [] for r in ROUTE_TURNS if r in taken[key]} for key in kernels}
            library_turns = []
            for r in ROUTE_TURNS:
                for key, fn in kernels.items():
                    if r in taken[key]:
                        turns[key][r].append(cuda_time_ms(lambda: fn(*args, route=r), 20))
                library_turns.append(sdpa_backward_ms(tune, q, k, v, do, mask=mask))
        if name in BWD_TURN_SHAPES:
            # both kernels against the route before their wgmma kernels, in
            # turns, and SDPA's whole backward after each under the row's
            # backend
            own = want["flash_bwd_dq"]
            old = taken["dq"][-2]
            order = (old, own, own, old)
            backend = BWD_TURN_SHAPES[name]
            turns = {key: {r: [] for r in order} for key in kernels}
            library_turns, library_error = [], None
            for r in order:
                for key, fn in kernels.items():
                    turns[key][r].append(cuda_time_ms(lambda: fn(*args, route=r), 20))
                ms, library_error = library_time(lambda: sdpa_backward_ms(
                    tune, q, k, v, do, flash=backend == "flash", mask=mask))
                library_turns.append(ms)
            turns["dq_plus_dkv"] = {r: [a + b for a, b in zip(turns["dq"][r], turns["dkv"][r])]
                                    for r in turns["dq"]}
            turns["library_backend"] = backend
            turns["library_error"] = library_error
        del runs, ref
        ms_dq = cuda_time_ms(lambda: attn.flash_bwd_dq(*args), 20)
        ms_dkv = cuda_time_ms(lambda: attn.flash_bwd_dkv(*args), 20)
        plain_ms = cuda_time_ms(lambda: attn.flash_backward_reference(
            q, k, v, o, lse, do, causal, window, g_lse), 3)
        library_ms, library_error, sdpa = None, None, None
        timed = name in TURN_SHAPES or (name in WIDE_SHAPES
                                        and timed_against_library(name, dtype, layout))
        if timed:
            library_ms, library_error = library_time(
                lambda: sdpa_backward_ms(tune, q, k, v, do, mask=mask))
        if name in WIDE_SHAPES and timed:
            sdpa = {"default_backend": sdpa_default_backend(q, k, v, mask=mask),
                    "default_backward_ms": library_ms, "error": library_error}
        if name == EFFICIENT_SDPA_SHAPE:
            library_ms, library_error, sdpa = efficient_sdpa_time(tune, q, k, v, mask, do)
        if name == D64_SHAPE:
            sdpa = {"default_backend": sdpa_default_backend(q, k, v),
                    "default_backward_ms": library_ms,
                    "flash_backward_ms": sdpa_backward_ms(tune, q, k, v, do, flash=True)}
        bounds = backward_bounds(b, h, kvh, sq, sk, d, causal, window, dtype)
        pairs = visible_pairs(sq, sk, causal, window)
        row = dict(shape=name, routes=want, layout=layout, b=b, h=h,
                   kvh=kvh, sq=sq, sk=sk, d=d, causal=causal, window=window,
                   dtype=str(dtype).split(".")[1], g_lse=g_lse is not None,
                   max_abs_err=errs, atol=BWD_TOL[dtype],
                   tile_rel_l2_bound=tile_bound[dtype], route_tile_rel_l2=route_tile,
                   bit_repeatable=repeatable, ok=ok,
                   dq_ms=ms_dq, dkv_ms=ms_dkv,
                   dq_tflops=6 * b * h * d * pairs / ms_dq / 1e9,
                   dkv_tflops=8 * b * h * d * pairs / ms_dkv / 1e9,
                   dq_share_of_bound=bounds["dq"][0] / ms_dq,
                   dkv_share_of_bound=bounds["dkv"][0] / ms_dkv,
                   route_turns_ms=turns, library_turns_ms=library_turns,
                   plain_ms=plain_ms, library_ms=library_ms,
                   sdpa=sdpa, dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1],
                   dkv_bound_ms=bounds["dkv"][0], dkv_bound_by=bounds["dkv"][1])
        print(json.dumps({"phase": "backward", **row}), flush=True)
        rows.append(row)
        max_err["dq"] = max(max_err["dq"], errs["dq"])
        max_err["dkv"] = max(max_err["dkv"], errs["dk"], errs["dv"])
        if not ok:
            raise SystemExit(f"flash_bwd_dq/dkv disagree with the plain backward "
                             f"or are not repeatable at {name}")
    for case in (FP16_LSE_COTANGENT, FP16_SINK_COTANGENT, FP16_SINK_COTANGENT_D64,
                 FP16_SINK_COTANGENT_D100, FP16_SINK_COTANGENT_D256,
                 FP16_SINK_COTANGENT_D96, FP16_SINK_COTANGENT_D80):
        row = fp16_lse_cotangent_row(attn, **case)
        print(json.dumps({"phase": "backward", **row}), flush=True)
        rows.append(row)
        if not row["ok"]:
            raise SystemExit(f"the fp16 backward under a large LSE cotangent: {row}")
    RESULTS["backward"] = rows
    return rows, max_err


def fp16_lse_cotangent_row(attn, b, h, s, d, do_scale, g_lse_scale, sink=False,
                           seed=7) -> dict:
    """The fp16 backward through the kernels' autograd node (the cotangent
    scale of `_FlashFwd.backward`, then dQ and dK/dV, each once on the fp16
    wgmma route at head dim `d`, 128, 64, 100, 256 or 96) with dO of `do_scale` beside an LSE
    cotangent of `g_lse_scale`, against the backward in fp32 on the same
    fp16 inputs: each output finite and within FP16_ROUNDING_FACTOR of the
    distance of the fp32 backward's own rounding to fp16. `sink`: key 0 is
    an attention sink (every component 2, q's components of mean 1) and the
    LSE cotangent is `g_lse_scale` everywhere, of one sign."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
               for _ in range(3))
    do = (torch.randn((b, h, s, d), generator=gen, device="cuda") * do_scale).half()
    g_lse = torch.randn((b, h, s), generator=gen, device="cuda") * g_lse_scale
    if sink:
        q += 1.0
        k[:, :, 0] = 2.0
        g_lse.fill_(g_lse_scale)
    q, k, v = (t.half().requires_grad_(True) for t in (q, k, v))
    reset_launches(attn)
    o, lse = attn.flash_attention_with_lse(q, k, v)
    torch.autograd.backward([o, lse], [do, g_lse])
    torch.cuda.synchronize()
    routes = read_routes(attn)
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    of, lf = attn.reference_attention_with_lse(qf, kf, vf)
    ref = attn.flash_backward_reference(qf, kf, vf, of, lf, do.float(), g_lse=g_lse)
    ok = routes == dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                                 {"wgmma": 1})
    errs = {}
    for name, t, r in zip(("dq", "dk", "dv"), (q, k, v), ref):
        finite = bool(torch.isfinite(t.grad).all())
        errs[name] = dict(rel_l2=rel_l2(t.grad, r) if finite else None,
                          fp16_rounding_rel_l2=rel_l2(r.half(), r), finite=finite,
                          max_abs=float(r.abs().max()))
        ok = ok and finite and errs[name]["rel_l2"] <= (
            FP16_ROUNDING_FACTOR * errs[name]["fp16_rounding_rel_l2"])
    return dict(shape="fp16_sink_lse_cotangent" if sink else "fp16_large_lse_cotangent",
                b=b, h=h, sq=s, sk=s, d=d,
                dtype="float16", do_scale=do_scale, g_lse_scale=g_lse_scale,
                launches_by_route=routes, errors=errs, bound=FP16_ROUNDING_FACTOR, ok=ok)


def phase_forward(attn, llama, cfg=None, phase="forward", config="llama2_7b",
                  route="wgmma", turns=None):
    """llama_forward at B=1, S=2048 over all of `cfg`'s layers (Llama-2-7B
    by default): one flash_fwd launch a layer, every one on the forward's
    route of `shape_routes(route)`, and the logits against the forward
    through the plain attention. With `turns` ({name: route set}, the
    routes `_route` picks first: `route_turns`) the forward is also timed in
    turns against another route set."""
    cfg = cfg or llama.LlamaConfig.llama2_7b()
    route = shape_routes(route)["flash_fwd"]
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_llama(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    with torch.no_grad():
        reset_launches(attn)
        logits = llama.llama_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launches, routes = attn.flash_fwd.launches, read_routes(attn)["flash_fwd"]
        if launches != cfg.n_layers or routes != {route: cfg.n_layers}:
            raise SystemExit(f"{phase}: llama_forward launched flash_fwd {routes}, "
                             f"expected {cfg.n_layers} on {route}")
        ref = llama.llama_forward(params, tokens, cfg,
                                  attn_impl=attn.reference_attention)
        err = rel_l2(logits, ref)
        if (tuple(logits.shape) != (1, 2048, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all()) or err > LOGITS_REL_L2):
            raise SystemExit(f"{phase}: logits wrong: shape {tuple(logits.shape)}, "
                             f"rel L2 {err}")
        del ref
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            llama.llama_forward(params, tokens, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        timed = (route_turns(attn, turns, lambda: llama.llama_forward(params, tokens, cfg))
                 if turns else None)
    emit(phase, config=config, layers=cfg.n_layers, batch=1, seq=2048,
         dtype=cfg.dtype, head_dim=cfg.head_dim, init_s=init_s,
         flash_fwd_launches=launches, launches_by_route=routes,
         logits_rel_l2_vs_plain=err, bound=LOGITS_REL_L2, forward_ms=times,
         forward_ms_median=statistics.median(times), peak_mem_gb=peak,
         forward_turns=timed)
    return cfg, params, launches, routes


def phase_moe_forward(attn, llama, train, moe, cfg):
    """Mixtral-8x7B width, 16 layers, B=1, S=2048: the kernel path against
    the plain attention path, end to end and layer by layer."""
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_llama(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in train.param_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    plain = attn.reference_attention
    with torch.no_grad():
        reset_launches(attn)
        with recording_routes(moe) as routes:
            logits = llama.llama_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launches, by_route = read_launches(attn), read_routes(attn)
        want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if launches != want or by_route["flash_fwd"] != {"wgmma": cfg.n_layers}:
            raise SystemExit(f"moe_forward launched {by_route}, expected {want} "
                             f"with every flash_fwd on the wgmma route")
        with recording_routes(moe) as plain_routes:
            ref = llama.llama_forward(params, tokens, cfg, attn_impl=plain)
        err = rel_l2(logits, ref)
        agree = [routing_agreement(a, b) for a, b in zip(routes, plain_routes)]
        dropped = statistics.mean(float((~d).float().mean()) for _, d in routes)
        faults = planted_faults(attn)
        planted = {}
        for name, impl in faults.items():
            with recording_routes(moe) as fr:
                bad = llama.llama_forward(params, tokens, cfg, attn_impl=impl)
            planted[name] = dict(
                logits_rel_l2=rel_l2(bad, ref),
                routing_agree=statistics.mean(
                    routing_agreement(a, b) for a, b in zip(fr, plain_routes)),
                layer_routing_agree=[], layer_rel_l2=[])
        del ref, bad
        # layer by layer: every path from the kernel path's input
        x = params["embed"][tokens]
        layer_agree, layer_err = [], []
        for layer in params["layers"]:
            with recording_routes(moe) as rk:
                y, _ = llama.transformer_layer(x, layer, cfg, attn.flash_attention)
            with recording_routes(moe) as rp:
                y_plain, _ = llama.transformer_layer(x, layer, cfg, plain)
            layer_agree.append(routing_agreement(rk[0], rp[0]))
            layer_err.append(rel_l2(y, y_plain))
            for name, impl in faults.items():
                with recording_routes(moe) as rf:
                    y_bad, _ = llama.transformer_layer(x, layer, cfg, impl)
                planted[name]["layer_routing_agree"].append(routing_agreement(rf[0], rp[0]))
                planted[name]["layer_rel_l2"].append(rel_l2(y_bad, y_plain))
            x = y
        del x, y, y_plain, y_bad
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            llama.llama_forward(params, tokens, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    agree_all = statistics.mean(agree)

    def rejected_by(logits_err, routing, layer_routing, layer_rel):
        """The bounds that these readings break."""
        return [n for n, broken in (
            ("logits_rel_l2", logits_err > MOE_LOGITS_REL_L2),
            ("routing_agree", routing < MOE_ROUTING_AGREE),
            ("layer_routing_agree", min(layer_routing) < MOE_LAYER_ROUTING_AGREE),
            ("layer_rel_l2", max(layer_rel) > MOE_LAYER_REL_L2)) if broken]

    for r in planted.values():
        r["rejected_by"] = rejected_by(r["logits_rel_l2"], r["routing_agree"],
                                       r["layer_routing_agree"], r["layer_rel_l2"])
    emit("moe_forward", config="mixtral_8x7b widths", layers=cfg.n_layers, batch=1,
         seq=2048, dtype=cfg.dtype, experts=cfg.num_experts, top_k=cfg.experts_per_token,
         capacity=moe.expert_capacity(2048, cfg.num_experts, cfg.experts_per_token,
                                      cfg.expert_capacity_factor),
         params=n_params, init_s=init_s, launches=launches, launches_by_route=by_route,
         logits_rel_l2_vs_plain=err, bound=MOE_LOGITS_REL_L2,
         routing_agree=agree_all, routing_agree_bound=MOE_ROUTING_AGREE,
         routing_agree_by_layer=agree, dropped_share=dropped,
         layer_routing_agree_min=min(layer_agree),
         layer_routing_agree_bound=MOE_LAYER_ROUTING_AGREE,
         layer_rel_l2_max=max(layer_err), layer_rel_l2_bound=MOE_LAYER_REL_L2,
         layer_routing_agree=layer_agree, layer_rel_l2=layer_err, planted=planted,
         forward_ms=times, forward_ms_median=statistics.median(times),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if (tuple(logits.shape) != (1, 2048, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())
            or rejected_by(err, agree_all, layer_agree, layer_err)):
        raise SystemExit(f"moe_forward disagrees with the plain attention path: logits "
                         f"rel L2 {err}, routing agreement {agree_all}, by layer "
                         f"{min(layer_agree)}, layer rel L2 {max(layer_err)}")
    # each bound on its own must reject each planted fault
    passed = {n: r["rejected_by"] for n, r in planted.items() if len(r["rejected_by"]) < 4}
    if passed:
        raise SystemExit(f"moe_forward: a bound lets a planted fault pass (the bounds "
                         f"that reject it): {passed}")
    return cfg, params, launches["flash_fwd"]


def phase_serving(cfg, params, llama, gen_mod, phase="serving",
                  bound=LOGITS_REL_L2, planted=None, **extra):
    """4 requests, 512-token prompts, 64 greedy tokens, twice; `extra` goes
    into the phase's line. Prefill's logits at every prompt position (the
    cache walk prefill runs, whose last row prefill returns) must agree with
    llama_forward's within `bound`; each of `planted` ({name: attn_impl}),
    put in the forward in place of the kernel, must break it."""
    b, plen, new = 4, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                            device="cuda")
    with torch.no_grad():
        cache = gen_mod.KVCache.zeros(cfg, b, plen + new, device="cuda")
        gen_mod.prefill(params, prompts, cache, cfg)  # warm-up
        prefill_ms = []
        for _ in range(3):
            cache = gen_mod.KVCache.zeros(cfg, b, plen + new, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = gen_mod.prefill(params, prompts, cache, cfg)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        cache = gen_mod.KVCache.zeros(cfg, b, plen + new, device="cuda")
        walk, cache = gen_mod._forward_with_cache(
            params, prompts, gen_mod._positions(0, b, plen, prompts.device), cache, cfg)
        del cache
        fwd = llama.llama_forward(params, prompts, cfg)
        err, err_last = rel_l2(walk, fwd), rel_l2(last, fwd[:, -1])
        first_agree = int((last.argmax(-1) == fwd[:, -1].argmax(-1)).sum())
        del fwd
        planted_err = {
            name: rel_l2(walk, llama.llama_forward(params, prompts, cfg, attn_impl=impl))
            for name, impl in (planted or {}).items()}
    if planted:
        extra["planted_rel_l2_vs_prefill"] = planted_err
    if not torch.equal(walk[:, -1], last):
        raise SystemExit(f"{phase}: prefill's last logits differ from its cache walk's")
    if err > bound:
        raise SystemExit(f"{phase}: prefill logits disagree with llama_forward: "
                         f"rel L2 {err}")
    if any(e <= bound for e in planted_err.values()):
        raise SystemExit(f"{phase}: a planted fault passes the bound {bound}: "
                         f"{planted_err}")
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = gen_mod.generate(params, prompts, cfg, new)
        torch.cuda.synchronize()
        runs.append((toks, (time.perf_counter() - t0) * 1e3))
    (toks, gen_ms), (toks2, gen_ms2) = runs
    if tuple(toks.shape) != (b, new) or not torch.equal(toks, toks2):
        raise SystemExit(f"{phase}: greedy generation is not repeatable")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise SystemExit(f"{phase}: generated token out of the vocabulary")
    sampled = [gen_mod.generate(params, prompts[:1], cfg, new, temperature=0.8,
                                generator=torch.Generator(device="cuda").manual_seed(7))
               for _ in range(2)]
    if not torch.equal(*sampled):
        raise SystemExit(f"{phase}: sampling is not deterministic per seed")
    p_ms = statistics.median(prefill_ms)
    steps = new - 1  # the last token needs no forward
    decode_ms = statistics.median([gen_ms, gen_ms2]) - p_ms
    emit(phase, requests=b, prompt_tokens=plen, new_tokens=new,
         prefill_ms=prefill_ms, prefill_ms_median=p_ms,
         prefill_logits_rel_l2_vs_forward=err, bound=bound,
         prefill_last_logits_rel_l2_vs_forward=err_last,
         first_token_argmax_agree=f"{first_agree}/{b}",
         generate_ms=[gen_ms, gen_ms2], decode_steps=steps,
         decode_ms_per_step=decode_ms / steps,
         decode_tokens_per_s=b * steps / (decode_ms / 1e3),
         greedy_repeatable=True, sampled_deterministic=True,
         sampled_tokens=sampled[0].shape[1], **extra)


# calls a turn of `route_turns`
TURN_CALLS = 3


def route_turns(attn, sets, call, setup=lambda: None) -> dict:
    """`call()` timed on the host's clock around a synchronised call (after
    `setup()`), TURN_CALLS calls a turn, in turns A, B, B, A over the two
    route sets of `sets` ({name: a context manager factory within which the
    kernels take that set's routes}, A first): {name: {"ms": each turn's
    calls, "turn_median_ms", "median_ms": over all its calls,
    "launches_by_route": one call's}}. The two sets must launch different
    routes."""
    a, b = sets
    out = {name: {"ms": [], "launches_by_route": None} for name in sets}
    for name in (a, b, b, a):
        calls = []
        with sets[name]():
            reset_launches(attn)
            for _ in range(TURN_CALLS):
                setup()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                calls.append((time.perf_counter() - t0) * 1e3)
            per_call = {fn: {r: n // TURN_CALLS for r, n in routes.items()}
                        for fn, routes in read_routes(attn).items()}
        if out[name]["launches_by_route"] not in (None, per_call):
            raise SystemExit(f"route turns: the set {name} launched {per_call}, "
                             f"then {out[name]['launches_by_route']}")
        out[name]["launches_by_route"] = per_call
        out[name]["ms"].append(calls)
    for row in out.values():
        row["turn_median_ms"] = [statistics.median(c) for c in row["ms"]]
        row["median_ms"] = statistics.median(x for c in row["ms"] for x in c)
    if out[a]["launches_by_route"] == out[b]["launches_by_route"]:
        raise SystemExit(f"route turns: {a} and {b} launched the same routes")
    return out


def gradient_turns(attn, llama, cfg, params, leaves, tokens, sets) -> dict:
    """The loss's forward and backward through the kernels (remat) in turns
    over the route sets of `sets` (`route_turns`), the leaves' gradients
    cleared before each call."""
    def clear():
        for t in leaves:
            t.grad = None

    out = route_turns(attn, sets, lambda: llama.llama_loss(
        params, tokens, cfg, remat=True).backward(), setup=clear)
    clear()
    return out


def phase_gradient(attn, llama, train, cfg=None, phase="gradient",
                   config="llama2_7b width, 4 layers", route="wgmma", turns=None):
    """The loss's gradient at `cfg`'s widths cut to 4 layers (Llama-2-7B by
    default) through the kernels, each kernel's launches on its route of
    `shape_routes(route)`, against the gradient through the plain
    attention, every leaf. With `turns` ({name: route set}, the routes
    `_route` picks first: `gradient_turns`) the kernels' forward and
    backward are also timed in turns against another route set. Returns the
    kernels' launches by route."""
    cfg = dataclasses.replace(cfg or llama.LlamaConfig.llama2_7b(), n_layers=4)
    free_memory()
    params = llama.init_llama(cfg, seed=0, device="cuda")
    leaves = train.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    grads, losses = {}, {}
    for name, impl in (("kernels", None), ("plain", attn.reference_attention)):
        reset_launches(attn)
        loss = llama.llama_loss(params, tokens, cfg, attn_impl=impl, remat=True)
        loss.backward()
        torch.cuda.synchronize()
        if name == "kernels":
            launches, routes = read_launches(attn), read_routes(attn)
        losses[name] = float(loss.detach())
        grads[name] = [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
    want = step_routes(route, cfg.n_layers)
    if routes != want:
        raise SystemExit(f"{phase}: the 4-layer gradient launched {routes}, expected "
                         f"{want}")
    errs = [rel_l2(a, b) for a, b in zip(grads["kernels"], grads["plain"])]
    finite = all(bool(torch.isfinite(g).all()) for g in grads["kernels"])
    del grads
    names = (["embed"] + [f"layers.{i}.{n}" for i, layer in enumerate(params["layers"])
                          for n in layer] + ["final_norm", "lm_head"])
    worst = max(range(len(errs)), key=errs.__getitem__)
    timed = (gradient_turns(attn, llama, cfg, params, leaves, tokens, turns)
             if turns else None)
    emit(phase, config=config, batch=1, seq=2048, head_dim=cfg.head_dim,
         dtype=cfg.dtype, launches=launches, launches_by_route=routes,
         loss_kernels=losses["kernels"],
         loss_plain=losses["plain"], grad_rel_l2_max=errs[worst],
         grad_rel_l2_worst_leaf=names[worst],
         grad_rel_l2={n: e for n, e in zip(names, errs)}, bound=GRAD_REL_L2,
         fwd_bwd_turns=timed)
    if not finite or errs[worst] > GRAD_REL_L2:
        raise SystemExit(f"{phase}: gradient through the kernels disagrees with the "
                         f"plain attention: rel L2 {errs[worst]} at {names[worst]}")
    del params, leaves
    return routes


def phase_train(attn, train, moe, cfg, phase="train", config=None, route="wgmma",
                turns=None, llama=None):
    """4 train steps at B=1, S=2048 on one batch (remat, AdamW lr 3e-4),
    each kernel's launches on its route of `shape_routes(route)`
    (`step_routes`). With `llama` (the models' module) a call is instead
    the loss's forward and backward (`llama.llama_loss`, remat) with the
    leaves' gradients cleared first and no optimizer: its loss and
    gradients must be finite where a train step's loss must fall. With
    `turns` ({name: route set}, the routes `_route` picks first:
    `route_turns`) more calls are then timed in turns against another route
    set. MFU counts each token's active parameters: all but the experts,
    and k/E of the experts (bench_mfu.py's 6N + 6 L d S convention)."""
    free_memory()
    b, s = 1, 2048
    torch.cuda.reset_peak_memory_stats()
    if llama is None:
        init_fn, step_fn, _ = train.build_llama_train_step(cfg, device="cuda")
    t0 = time.perf_counter()
    if llama is None:
        params, opt_state = init_fn(0)
    else:
        params, opt_state = llama.init_llama(cfg, seed=0, device="cuda"), None
    leaves = train.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")

    def call():
        if llama is None:
            return step_fn(params, opt_state, tokens)[2]
        for t in leaves:
            t.grad = None
        loss = llama.llama_loss(params, tokens, cfg, remat=True)
        loss.backward()
        return loss

    want = step_routes(route, cfg.n_layers)
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        reset_launches(attn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches, routes = read_launches(attn), read_routes(attn)
        if routes != want:
            raise SystemExit(f"{phase}: a call launched {routes}, expected {want}")
        losses.append(loss.detach())
    losses = [float(x) for x in losses]
    grads = [t.grad for t in leaves] if llama else []
    finite = (all(math.isfinite(x) for x in losses)
              and all(g is not None and bool(torch.isfinite(g).all()) for g in grads))
    tensors = (leaves + [loss] + grads
               + ([t for st in opt_state.state.values() for t in st.values()
                   if isinstance(t, torch.Tensor)] if opt_state else []))
    on_card = all(t is not None and t.is_cuda for t in tensors)
    del grads, tensors  # the turns' calls make their own gradients
    timed = route_turns(attn, turns, call) if turns else None
    n_params = sum(t.numel() for t in leaves)
    step_ms = statistics.median(times[1:])
    tokens_per_s = b * s / (step_ms / 1e3)
    n_active, moe_fields = n_params, {}
    if cfg.is_moe:
        n_expert = sum(t.numel() for layer in params["layers"]
                       for n, t in layer.items() if n.startswith("we_"))
        n_active = n_params - n_expert + n_expert * cfg.experts_per_token // cfg.num_experts
        cap = moe.expert_capacity(s, cfg.num_experts, cfg.experts_per_token,
                                  cfg.expert_capacity_factor)
        # gate, up and down over every capacity slot: forward, recompute and
        # the backward's two products
        padded = 4 * cfg.n_layers * 3 * 2 * cfg.num_experts * b * cap * cfg.dim * cfg.ffn_dim
        moe_fields = dict(moe_aux_weight=cfg.moe_aux_weight, capacity=cap,
                          expert_params=n_expert, active_params=n_active,
                          expert_tflop_per_step_capacity_padded=padded / 1e12,
                          expert_tflops_per_s_capacity_padded=padded / 1e9 / step_ms)
    # bench_mfu.py's convention: 6N + 6 L d S flops a token, remat not counted
    flops_per_token = 6 * n_active + 6 * cfg.n_layers * cfg.dim * s
    mfu = flops_per_token * tokens_per_s / H100_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit(phase, config=config or ("mixtral_8x7b widths" if cfg.is_moe else "llama2_7b"),
         layers=cfg.n_layers, batch=b, seq=s, head_dim=cfg.head_dim,
         dtype=cfg.dtype, remat=True,
         optimizer="AdamW lr 3e-4 wd 1e-4 (fused)" if llama is None else None,
         params=n_params, init_s=init_s, launches_per_step=launches,
         launches_by_route=routes,
         losses=losses, step_ms=times, step_ms_median=step_ms,
         tokens_per_s=tokens_per_s, model_tflops_per_s=flops_per_token * tokens_per_s / 1e12,
         mfu=mfu, peak_mem_gb=peak_gb, finite=finite, all_on_card=on_card,
         step_turns=timed, **moe_fields)
    # every later step's loss below the first: AdamW at 3e-4 with no
    # warm-up overshoots after its first large drop on one batch
    if llama is None and not all(math.isfinite(x) and x < losses[0] for x in losses[1:]):
        raise SystemExit(f"{phase}: training loss not finite and falling: {losses}")
    if not finite:
        raise SystemExit(f"{phase}: the loss or a gradient is not finite: {losses}")
    if not on_card:
        raise SystemExit(f"{phase}: a parameter, gradient, optimizer state or the loss "
                         f"left the card")
    return launches, routes


def phase_sharded_train(attn, train, mesh_mod, cfg, phase="sharded_train"):
    """The 7B step through a world-1 NCCL mesh: train's steps, seed and
    tokens; losses against train's, launches, step time, peak memory."""
    import torch.distributed as dist

    free_memory()
    b, s = 1, 2048
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        torch.cuda.reset_peak_memory_stats()
        mesh = mesh_mod.make_mesh({a: 1 for a in mesh_mod.AXIS_ORDER}, device="cuda")
        init_fn, step_fn, batch_fn = train.build_llama_train_step(cfg, mesh)
        params, opt_state = init_fn(0)
        gen = torch.Generator(device="cuda").manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
        want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
                "flash_bwd_dkv": cfg.n_layers}
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            reset_launches(attn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, loss = step_fn(params, opt_state, batch_fn(tokens))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches, routes = read_launches(attn), read_routes(attn)
            if routes != {n: {"wgmma": c} for n, c in want.items()}:
                raise SystemExit(f"{phase}: a step launched {routes}, expected {want} "
                                 f"on the wgmma route")
            losses.append(loss)
        losses = [float(x) for x in losses]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del params, opt_state
    finally:
        dist.destroy_process_group()
    ref = RESULTS["train"]
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref["losses"])]
    step_ms = statistics.median(times[1:])
    emit(phase, config="llama2_7b", mesh={a: 1 for a in mesh_mod.AXIS_ORDER},
         backend="nccl", world=1, layers=cfg.n_layers, batch=b, seq=s,
         launches_per_step=launches, launches_by_route=routes, losses=losses,
         train_losses=ref["losses"], loss_rel_vs_train=rel,
         loss_equal_to_the_bit=losses == ref["losses"], bound=SHARDED_LOSS_REL,
         step_ms=times, step_ms_median=step_ms, train_step_ms_median=ref["step_ms_median"],
         tokens_per_s=b * s / (step_ms / 1e3), peak_mem_gb=peak_gb,
         train_peak_mem_gb=ref["peak_mem_gb"], peak_bound_gb=ref["peak_mem_gb"]
         + SHARDED_PEAK_SLACK_GB)
    if max(rel) > SHARDED_LOSS_REL:
        raise SystemExit(f"{phase}: losses {losses} differ from train's {ref['losses']}")
    if peak_gb > ref["peak_mem_gb"] + SHARDED_PEAK_SLACK_GB:
        raise SystemExit(f"{phase}: peak memory {peak_gb} GB over train's "
                         f"{ref['peak_mem_gb']} + {SHARDED_PEAK_SLACK_GB}")
    return launches


def plain_by_heads(attn, q, k, v, do, heads: int = 8):
    """The plain causal attention over the whole sequence and its plain
    backward, a block of query heads (and their kv heads) at a time: (o,
    dq, dk, dv)."""
    h, kvh = q.shape[1], k.shape[1]
    outs = []
    for i in range(0, h, heads):
        j, m = i * kvh // h, (i + heads) * kvh // h
        qb, kb, vb, dob = q[:, i:i + heads], k[:, j:m], v[:, j:m], do[:, i:i + heads]
        o, lse = attn.reference_attention_with_lse(qb, kb, vb)
        outs.append((o, *attn.flash_backward_reference(qb, kb, vb, o, lse, dob)))
        del lse
    return [torch.cat(parts, 1) for parts in zip(*outs)]


def sp_attention_rows(attn, variants, phase, attend, per_rank, seed, extra):
    """The body of the `ring` and `ulysses` phases: for each of RING_SHAPES
    at S=8192, `attend(q, k, v)` (a sequence-parallel scheme over sp=4 in
    one process) and its gradient through the kernels against the plain
    attention over the whole sequence (rel. L2 and worst 64-row tile),
    `per_rank` launches of each kernel on the wgmma route, a bit-repeatable
    backward, the scheme's forward and forward+backward times beside one
    causal flash_fwd over the whole sequence and the bounds; `extra(shape)`
    adds the scheme's own fields. -> (rows, launches of the first shape)."""
    free_memory()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, launches_out = [], None
    for name, (b, h, kvh, d) in RING_SHAPES.items():
        q, k, v, do = rand_inputs(gen, torch.bfloat16, "bhsd", (b, h, RING_SEQ, d),
                                  (b, kvh, RING_SEQ, d), (b, kvh, RING_SEQ, d),
                                  (b, h, RING_SEQ, d))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def fwd_bwd():
            out = attend(*leaves)
            grads = torch.autograd.grad(out, leaves, do)
            return out.detach(), grads

        reset_launches(attn)
        out, grads = fwd_bwd()
        torch.cuda.synchronize()
        launches, routes = read_launches(attn), read_routes(attn)
        want = {n: {"wgmma": per_rank} for n in launches}
        if routes != want:
            raise SystemExit(f"{phase} {name}: launched {routes}, expected {want}")
        _, grads2 = fwd_bwd()
        repeatable = all(torch.equal(a, b_) for a, b_ in zip(grads, grads2))
        del grads2
        plain = plain_by_heads(attn, q, k, v, do)
        errs = {}
        for nm, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), plain):
            errs[nm] = dict(rel_l2=rel_l2(got, ref), tile_rel_l2=variants.tile_rel_l2(got, ref),
                            max_abs=float((got.float() - ref.float()).abs().max()),
                            finite=bool(torch.isfinite(got).all()))
        # one causal flash_fwd over the whole sequence, beside the scheme
        o1, _ = attn.flash_fwd(q, k, v, True, None)
        one_err = dict(rel_l2=rel_l2(o1, plain[0]),
                       tile_rel_l2=variants.tile_rel_l2(o1, plain[0]))
        del plain, o1, out, grads
        with torch.no_grad():
            fwd_ms = cuda_time_ms(lambda: attend(q, k, v), 5)
        fwd_bwd_ms = cuda_time_ms(fwd_bwd, 5)
        one_fwd_ms = cuda_time_ms(lambda: attn.flash_fwd(q, k, v, True, None), 10)
        bound_ms, bound_by = attention_bound(b, h, kvh, RING_SEQ, RING_SEQ, d, True,
                                             None, torch.bfloat16)
        bwd_bounds = backward_bounds(b, h, kvh, RING_SEQ, RING_SEQ, d, True, None,
                                     torch.bfloat16)
        ok = (repeatable and all(e["finite"] and e["rel_l2"] <= variants.BWD_TILE_REL_L2
                                 and e["tile_rel_l2"] <= variants.BWD_TILE_REL_L2
                                 for e in errs.values())
              and one_err["tile_rel_l2"] <= variants.BWD_TILE_REL_L2)
        row = dict(shape=name, b=b, h=h, kvh=kvh, seq=RING_SEQ, d=d, sp=RING_SP,
                   **extra(name), launches=launches,
                   launches_by_route=routes, errors_vs_plain=errs,
                   bound=variants.BWD_TILE_REL_L2, bit_repeatable=repeatable,
                   one_flash_fwd_8192_vs_plain=one_err, ok=ok,
                   **{f"{phase}_fwd_ms": fwd_ms, f"{phase}_fwd_bwd_ms": fwd_bwd_ms},
                   one_flash_fwd_8192_ms=one_fwd_ms, one_flash_fwd_8192_bound_ms=bound_ms,
                   one_flash_fwd_8192_bound_by=bound_by,
                   backward_bound_ms=bwd_bounds["dq"][0] + bwd_bounds["dkv"][0])
        print(json.dumps({"phase": phase, **row}), flush=True)
        rows.append(row)
        if launches_out is None:
            launches_out = launches
        if not ok:
            raise SystemExit(f"{phase} {name}: disagrees with the plain attention or is "
                             f"not repeatable: {errs}, {one_err}")
        del q, k, v, do, leaves
        free_memory()
    RESULTS[phase] = rows
    return rows, launches_out


def phase_ring(attn, ring, variants):
    """Ring attention over sp=4 through the one-process rotation at S=8192:
    the kernels inside the ring against the plain attention, launches and
    times."""
    chunks = RING_SP * (RING_SP + 1) // 2
    _, launches = sp_attention_rows(
        attn, variants, "ring", lambda q, k, v: ring.ring_attention_emulated(q, k, v,
                                                                             sp=RING_SP),
        chunks, 8, lambda name: dict(chunk=RING_SEQ // RING_SP, chunks_computed=chunks,
                                     chunks_skipped=RING_SP * RING_SP - chunks))
    return launches


def phase_ulysses(attn, ulysses, variants):
    """Ulysses over sp=4 through the one-process exchange at S=8192, on the
    ring's shapes: each rank attends H/4 query heads over the whole
    sequence (GQA 32/8: its 2 kv heads, the grouped-KV exchange), one
    launch of each kernel a rank; beside the ring's times of this call."""
    ring_rows = {r["shape"]: r for r in RESULTS["ring"]}

    def extra(name):
        b, h, kvh, d = RING_SHAPES[name]
        return dict(heads_per_rank=h // RING_SP, kv_heads_per_rank=kvh // RING_SP,
                    ring_fwd_ms=ring_rows[name]["ring_fwd_ms"],
                    ring_fwd_bwd_ms=ring_rows[name]["ring_fwd_bwd_ms"])

    _, launches = sp_attention_rows(
        attn, variants, "ulysses",
        lambda q, k, v: ulysses.ulysses_attention_emulated(q, k, v, sp=RING_SP),
        RING_SP, 11, extra)
    return launches


@contextlib.contextmanager
def planted_pipeline_fault(pipeline, name: str):
    """A wrong pipeline for the pipeline phases' bounds to reject:
    "stage_order" runs the stage blocks in the reverse order (stage s runs
    block P - 1 - s); "retire_shift" and "retire_reversed" retire the
    microbatches to the wrong slots (slot m + 1, slot M - 1 - m)."""
    blocks, run = pipeline._stage_blocks, pipeline._pipeline

    def reversed_blocks(layers, pp):
        return dict(zip(range(pp), reversed(list(blocks(layers, pp).values()))))

    def misretired(sched, x_mb):
        y_mb, aux = run(sched, x_mb)
        return (y_mb.roll(1, 0) if name == "retire_shift" else y_mb.flip(0)), aux

    if name == "stage_order":
        pipeline._stage_blocks = reversed_blocks
    else:
        pipeline._pipeline = misretired
    try:
        yield
    finally:
        pipeline._stage_blocks, pipeline._pipeline = blocks, run


def pipeline_launches(layers: int, microbatches: int) -> dict:
    """Kernel launches of one remat step: each layer's forward on every
    microbatch, again in the backward, and one of each backward kernel."""
    n = layers * microbatches
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def phase_pipeline_gradient(attn, llama, train, pipeline):
    """7B width, 4 layers, pp=4 stages in one process, M=4, B=4, S=2048,
    remat: the pipelined loss and every leaf's gradient against the
    one-device llama_loss's at the same weights and tokens; each planted
    fault must break the gradient bound, and one of them the loss bound too."""
    free_memory()
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=4)
    params = llama.init_llama(cfg, seed=0, device="cuda")
    leaves = train.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_BATCH, PIPE_SEQ), generator=gen,
                           device="cuda")

    def loss_and_grads(fn):
        loss = fn()
        loss.backward()
        torch.cuda.synchronize()
        grads = [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
        return float(loss.detach()), grads

    def pipelined():
        return pipeline.pipelined_llama_loss(params, tokens, cfg, pp=PIPE_PP,
                                             num_microbatches=PIPE_MICROBATCHES, remat=True)

    loss_one, grads_one = loss_and_grads(
        lambda: llama.llama_loss(params, tokens, cfg, remat=True))
    reset_launches(attn)
    loss_pp, grads_pp = loss_and_grads(pipelined)
    launches, routes = read_launches(attn), read_routes(attn)
    want = pipeline_launches(cfg.n_layers, PIPE_MICROBATCHES)
    if routes != {n: {"wgmma": c} for n, c in want.items()}:
        raise SystemExit(f"pipeline_gradient launched {routes}, expected {want} on wgmma")
    names = (["embed"] + [f"layers.{i}.{n}" for i, layer in enumerate(params["layers"])
                          for n in layer] + ["final_norm", "lm_head"])

    def readings(loss, grads):
        errs = [rel_l2(a, b) for a, b in zip(grads, grads_one)]
        worst = max(range(len(errs)), key=errs.__getitem__)
        return dict(loss=loss, loss_abs_err=abs(loss - loss_one),
                    grad_rel_l2_max=errs[worst], grad_rel_l2_worst_leaf=names[worst],
                    finite=all(bool(torch.isfinite(g).all()) for g in grads),
                    rejected_by=[n for n, broken in (
                        ("loss", abs(loss - loss_one) > PIPE_LOSS_ABS),
                        ("gradient", errs[worst] > GRAD_REL_L2)) if broken]), errs

    sound, errs = readings(loss_pp, grads_pp)
    del grads_pp
    planted = {}
    for name in PIPE_FAULTS:
        with planted_pipeline_fault(pipeline, name):
            planted[name] = readings(*loss_and_grads(pipelined))[0]
    emit("pipeline_gradient", config="llama2_7b width, 4 layers", pp=PIPE_PP,
         microbatches=PIPE_MICROBATCHES, batch=PIPE_BATCH, seq=PIPE_SEQ, dtype=cfg.dtype,
         remat=True, one_process=True, launches=launches, launches_by_route=routes,
         loss_one_device=loss_one, **sound, loss_bound=PIPE_LOSS_ABS,
         grad_bound=GRAD_REL_L2, grad_rel_l2={n: e for n, e in zip(names, errs)},
         planted=planted)
    if sound["rejected_by"] or not sound["finite"]:
        raise SystemExit(f"pipeline_gradient: the pipelined loss or gradient disagrees "
                         f"with the one-device step: {sound}")
    if any("gradient" not in r["rejected_by"] for r in planted.values()) or not any(
            len(r["rejected_by"]) == 2 for r in planted.values()):
        raise SystemExit(f"pipeline_gradient: a planted fault passes the gradient bound, "
                         f"or none breaks both bounds: {planted}")
    del params, leaves, grads_one


def phase_pipeline_train(attn, llama, train, pipeline):
    """All 32 layers at 7B width, pp=4 stages in one process, M=4, B=4,
    S=2048, remat, AdamW: the first loss against the one-device loss at the
    same weights and tokens, a falling loss, launches, step time, tokens/s,
    MFU and peak memory beside its reckoning."""
    free_memory()
    cfg = llama.LlamaConfig.llama2_7b()
    b, s = PIPE_BATCH, PIPE_SEQ
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn, batch_fn = pipeline.build_pipelined_llama_train_step(
        cfg, pp=PIPE_PP, num_microbatches=PIPE_MICROBATCHES, device="cuda")
    params, opt_state = init_fn(0)
    n_params = sum(t.numel() for t in train.param_leaves(params))
    # the peak, reckoned before the first step: parameters, gradients and
    # AdamW's two moments in bf16 (8 bytes a parameter); each layer's input
    # on every microbatch (remat's checkpoints); the logits of the whole
    # batch in fp32, their log-softmax and their gradient
    reckoned = dict(state_gb=8 * n_params / 1e9,
                    checkpoints_gb=cfg.n_layers * b * s * cfg.dim * 2 / 1e9,
                    logits_gb=3 * b * s * cfg.vocab_size * 4 / 1e9)
    reckoned["total_gb"] = sum(reckoned.values())
    print(json.dumps({"phase": "pipeline_train", "reckoned_peak": reckoned}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(10)
    tokens = batch_fn(torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                    device="cuda"))
    with torch.no_grad():
        loss_one = float(llama.llama_loss(params, tokens, cfg))
    want = pipeline_launches(cfg.n_layers, PIPE_MICROBATCHES)
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        reset_launches(attn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches, routes = read_launches(attn), read_routes(attn)
        if routes != {n: {"wgmma": c} for n, c in want.items()}:
            raise SystemExit(f"pipeline_train: a step launched {routes}, expected {want} "
                             f"on the wgmma route")
        losses.append(loss)
    losses = [float(x) for x in losses]
    step_ms = statistics.median(times[1:])
    tokens_per_s = b * s / (step_ms / 1e3)
    flops_per_token = 6 * n_params + 6 * cfg.n_layers * cfg.dim * s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("pipeline_train", config="llama2_7b", layers=cfg.n_layers, pp=PIPE_PP,
         microbatches=PIPE_MICROBATCHES, batch=b, seq=s, dtype=cfg.dtype, remat=True,
         optimizer="AdamW lr 3e-4 wd 1e-4 (fused)", params=n_params,
         one_process=("every stage in one process: no bubble and no point-to-point "
                      "transfer is measured"),
         launches_per_step=launches, launches_by_route=routes, losses=losses,
         loss_one_device=loss_one, first_loss_abs_err=abs(losses[0] - loss_one),
         loss_bound=PIPE_LOSS_ABS, step_ms=times, step_ms_median=step_ms,
         tokens_per_s=tokens_per_s, model_tflops_per_s=flops_per_token * tokens_per_s / 1e12,
         mfu=flops_per_token * tokens_per_s / H100_BF16_FLOPS, peak_mem_gb=peak_gb,
         reckoned_peak_gb=reckoned["total_gb"])
    if abs(losses[0] - loss_one) > PIPE_LOSS_ABS:
        raise SystemExit(f"pipeline_train: first loss {losses[0]} against the one-device "
                         f"{loss_one}")
    if not all(math.isfinite(x) and x < losses[0] for x in losses[1:]):
        raise SystemExit(f"pipeline_train: training loss not finite and falling: {losses}")
    del params, opt_state
    return launches


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _state_bytes(params, opt_state, train) -> int:
    leaves = train.param_leaves(params)
    moments = [t for p in leaves for t in opt_state.state[p].values()
               if isinstance(t, torch.Tensor) and t.dim()]
    return sum(t.numel() * t.element_size() for t in leaves + moments)


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _ckpt_step(attn, step_fn, params, opt_state, tokens, phase, want):
    """One step, the launch counts set to 0 before it; every flash launch
    must be on the wgmma route. -> (params, opt_state, loss as a float,
    launches)."""
    reset_launches(attn)
    params, opt_state, loss = step_fn(params, opt_state, tokens)
    torch.cuda.synchronize()
    routes = read_routes(attn)
    if routes != {n: {"wgmma": c} for n, c in want.items()}:
        raise SystemExit(f"{phase}: a step launched {routes}, expected {want} on the "
                         f"wgmma route")
    return params, opt_state, float(loss), read_launches(attn)


def phase_checkpoint(attn, llama, train, mesh_mod, checkpoint):
    """Save, resume and restore onto a mesh at 7B width, 4 layers: the
    resumed losses equal to the uninterrupted run's to the bit."""
    import torch.distributed as dist

    free_memory()
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=CKPT_LAYERS)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    init_fn, step_fn, _ = train.build_llama_train_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    run = functools.partial(_ckpt_step, attn, step_fn, tokens=tokens, phase="checkpoint",
                            want=want)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = checkpoint.TrainCheckpointer(tmp, max_to_keep=1)
        params, opt_state = init_fn(0)
        losses, save_s = [], []
        for i in range(CKPT_STEPS):
            if i == CKPT_SAVES[0]:
                state_gb = _state_bytes(params, opt_state, train) / 1e9
                free_gb = shutil.disk_usage(tmp).free / 1e9
                # two checkpoints exist for a moment: the new, then the old goes
                if free_gb < 2.2 * state_gb:
                    raise SystemExit(f"checkpoint: {free_gb:.1f} GB free under {tmp}; "
                                     f"the phase needs {2.2 * state_gb:.1f} GB for two "
                                     f"{state_gb:.2f} GB checkpoints")
            if i in CKPT_SAVES:
                t0 = time.perf_counter()
                ckpt.save(i, params, opt_state)
                save_s.append(time.perf_counter() - t0)
                if i == CKPT_SAVES[-1]:
                    written = _dir_bytes(Path(tmp) / str(i))
            params, opt_state, loss, _ = run(params, opt_state)
            losses.append(loss)
        kept = ckpt.all_steps()
        del params, opt_state
        free_memory()
        template = init_fn(3)
        t0 = time.perf_counter()
        step, params, opt_state = ckpt.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resumed = []
        for _ in range(CKPT_STEPS - step):
            params, opt_state, loss, launches = run(params, opt_state)
            resumed.append(loss)
        del params, opt_state, template
        free_memory()
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = mesh_mod.make_mesh({a: 1 for a in mesh_mod.AXIS_ORDER}, device="cuda")
            init_m, step_m, batch_m = train.build_llama_train_step(cfg, mesh)
            template = init_m(3)
            t0 = time.perf_counter()
            _, params, opt_state = checkpoint.TrainCheckpointer(tmp, mesh=mesh).restore(
                template)
            torch.cuda.synchronize()
            mesh_restore_s = time.perf_counter() - t0
            mesh_loss = _ckpt_step(attn, step_m, params, opt_state, batch_m(tokens),
                                   "checkpoint", want)[2]
            del params, opt_state, template
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gb = written / 1e9
    emit("checkpoint", config=f"llama2_7b width, {cfg.n_layers} layers", batch=1, seq=2048,
         dtype=cfg.dtype, state_gb=state_gb, free_disk_gb=free_gb, max_to_keep=1,
         saved_steps=list(CKPT_SAVES), kept_steps=kept,
         older_step_removed=kept == [CKPT_SAVES[-1]], gb_written_per_save=gb,
         save_s=save_s, save_gb_per_s=[gb / t for t in save_s], restore_s=restore_s,
         restore_gb_per_s=gb / restore_s, mesh_restore_s=mesh_restore_s,
         restored_step=step, launches_per_step=launches, losses=losses,
         resumed_losses=resumed, resumed_equal_to_the_bit=resumed[-1] == losses[-1],
         mesh_restored_loss=mesh_loss,
         mesh_restored_equal_to_the_bit=mesh_loss == losses[step])
    if kept != [CKPT_SAVES[-1]] or step != CKPT_SAVES[-1]:
        raise SystemExit(f"checkpoint: kept steps {kept}, restored step {step}")
    if not all(math.isfinite(x) for x in losses + resumed + [mesh_loss]):
        raise SystemExit(f"checkpoint: losses not finite: {losses} {resumed} {mesh_loss}")
    if resumed != losses[step:]:
        raise SystemExit(f"checkpoint: the resumed losses {resumed} differ from the "
                         f"uninterrupted run's {losses[step:]}")
    if mesh_loss != losses[step]:
        raise SystemExit(f"checkpoint: the mesh-restored step's loss {mesh_loss} differs "
                         f"from {losses[step]}")
    return losses, launches


def phase_multihost(attn, llama, train, mesh_mod, multihost, one_device_loss):
    """initialize_multihost over a TCP rendezvous (world-1 NCCL) and its env
    path; global_batch against batch_fn; one 4-layer 7B-width step through
    the group equal to the one-device step's loss."""
    import torch.distributed as dist

    free_memory()
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=CKPT_LAYERS)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    coordinator = f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    joined = multihost.initialize_multihost(coordinator=coordinator, num_processes=1,
                                            process_id=0)
    rendezvous_s = time.perf_counter() - t0
    try:
        group = dict(world=dist.get_world_size(), rank=dist.get_rank(),
                     backend=str(dist.get_backend()))
        second_call = multihost.initialize_multihost(coordinator=coordinator,
                                                     num_processes=1, process_id=0)
        mesh = mesh_mod.make_mesh({a: 1 for a in mesh_mod.AXIS_ORDER}, device="cuda")
        init_fn, step_fn, batch_fn = train.build_llama_train_step(cfg, mesh)
        piece = multihost.global_batch(tokens, batch_fn)
        batch_equal = torch.equal(piece, batch_fn(tokens))
        _, _, loss, launches = _ckpt_step(attn, step_fn, *init_fn(0), piece, "multihost",
                                          want)
    finally:
        dist.destroy_process_group()
    env = {"YODA_COORDINATOR": f"127.0.0.1:{_free_port()}", "YODA_NUM_PROCESSES": "1",
           "YODA_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        env_joined = multihost.initialize_multihost()
        env_group = dict(world=dist.get_world_size(), rank=dist.get_rank(),
                         backend=str(dist.get_backend()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    emit("multihost", coordinator=coordinator, joined=joined, rendezvous_s=rendezvous_s,
         group=group, second_call_returns=second_call, global_batch_equals_batch_fn=batch_equal,
         config=f"llama2_7b width, {cfg.n_layers} layers", launches_per_step=launches,
         loss=loss, one_device_loss=one_device_loss,
         loss_equal_to_the_bit=loss == one_device_loss, env_path_joined=env_joined,
         env_path_group=env_group)
    expected = dict(world=1, rank=0, backend="nccl")
    if not (joined and env_joined and group == expected and env_group == expected):
        raise SystemExit(f"multihost: the rendezvous gave {joined} {group}, the env path "
                         f"{env_joined} {env_group}")
    if second_call is not False or not batch_equal:
        raise SystemExit(f"multihost: second call {second_call}, global_batch equal to "
                         f"batch_fn {batch_equal}")
    if loss != one_device_loss:
        raise SystemExit(f"multihost: loss {loss} against the one-device {one_device_loss}")
    if dist.is_initialized():
        raise SystemExit("multihost: a process group outlived the phase")
    return launches


def resnet_macs(resnet, model, image: int) -> int:
    """Multiply-adds of one image's forward, from each conv's and the Dense
    layer's shapes (output positions x out channels x in channels x k x k;
    in x out)."""
    macs = []

    def count(mod, _inp, out):
        if isinstance(mod, resnet.Conv):
            macs.append(out[0].numel() * mod.weight[0].numel())
        else:
            macs.append(mod.weight.numel())

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (resnet.Conv, resnet.Dense))]
    try:
        with torch.no_grad():
            model(torch.zeros(1, image, image, 3, device="cuda"), train=False)
    finally:
        for h in hooks:
            h.remove()
    return sum(macs)


def phase_resnet(resnet):
    """ResNet-50 at B=256, 224 x 224, bf16, channels_last: train-mode and
    eval forwards and a softmax cross-entropy's forward+backward, timed;
    checked against the fp32 model and the biased-variance formula."""
    import torch.nn.functional as F

    free_memory()
    b, image = RESNET_BATCH, RESNET_IMAGE
    torch.cuda.reset_peak_memory_stats()
    model = resnet.ResNet50(1000, torch.bfloat16, device="cuda")
    init_fn, apply_fn = resnet.resnet_forward_fn(model=model)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(b, image, image, 3, generator=gen, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    variables = init_fn(0, x)
    # BatchNorm scales and biases drawn from the seed, the last of each
    # block small (as a trained ResNet's are), so that every conv reaches
    # the logits (Flax's init starts those scales at zero)
    for name, t in variables["params"].items():
        if name.endswith(".scale"):
            u = torch.rand(t.shape, generator=gen, device="cuda")
            t.copy_(u * 0.5 if ".bn3." in name else u + 0.5)
        elif name.endswith(".bias") and not name.startswith("fc"):
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.1)
    params = variables["params"]
    for t in params.values():
        t.requires_grad_(True)

    # one train forward: the stats of two BatchNorms against the formula
    captured = {}
    bns = {"bn": model.bn, "blocks.15.bn3": model.blocks[-1].bn3}
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, name=name: captured.__setitem__(name, inp[0].detach()))
        for name, m in bns.items()]
    with torch.no_grad():
        logits, mutated = apply_fn(variables, x, train=True)
    for h in hooks:
        h.remove()
    formula = {}
    for name, m in bns.items():
        v = captured.pop(name).double()
        mean, var = v.mean((0, 2, 3)), v.var((0, 2, 3), unbiased=False)
        old_m, old_v = (variables["batch_stats"][f"{name}.{k}"].double() for k in ("mean", "var"))
        for k, want in (("mean", m.momentum * old_m + (1 - m.momentum) * mean),
                        ("var", m.momentum * old_v + (1 - m.momentum) * var)):
            formula[f"{name}.{k}"] = rel_l2(mutated["batch_stats"][f"{name}.{k}"].double(),
                                            want)
    del captured

    def train_step():
        out, _ = apply_fn(variables, x, train=True)
        F.cross_entropy(out, labels).backward()
        for t in params.values():
            t.grad = None

    def eval_forward():
        with torch.no_grad():
            apply_fn(variables, x, train=False)

    out, _ = apply_fn(variables, x, train=True)
    F.cross_entropy(out, labels).backward()
    grads_ok = all(t.grad is not None and t.grad.is_cuda and bool(torch.isfinite(t.grad).all())
                   for t in params.values())
    for t in params.values():
        t.grad = None
    del out
    train_ms = cuda_time_ms(train_step, RESNET_ITERS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval_ms = cuda_time_ms(eval_forward, RESNET_ITERS)
    with torch.no_grad():
        eval_logits = apply_fn(variables, x, train=False)
        # the fp32 model on the same weights and batch
        _, apply32 = resnet.resnet_forward_fn(
            model=resnet.ResNet50(1000, torch.float32, device="cuda"))
        logits32, mutated32 = apply32(variables, x, train=True)
        eval32 = apply32(variables, x, train=False)
    stats_err = max(rel_l2(mutated["batch_stats"][n], mutated32["batch_stats"][n])
                    for n in mutated32["batch_stats"])
    errs = {"train": rel_l2(logits, logits32), "eval": rel_l2(eval_logits, eval32),
            "stats": stats_err}
    tensors = [logits, eval_logits, *mutated["batch_stats"].values(), *params.values()]
    finite = all(bool(torch.isfinite(t).all()) for t in tensors)
    on_card = all(t.is_cuda for t in tensors)
    macs = resnet_macs(resnet, model, image)
    train_flops = 3 * 2 * macs * b  # forward, and the backward's two products
    emit("resnet", config="ResNet-50, 1000 classes", batch=b, image=[image, image, 3],
         dtype="bfloat16", memory_format="channels_last", logits_dtype=str(logits.dtype),
         gmacs_per_image_forward=macs / 1e9,
         flops_reckoning="2 x (conv: output positions x out x in x k x k; Dense: in x "
                         "out) a forward; 3x that a training pass",
         train_ms=train_ms, train_images_per_s=b / (train_ms / 1e3),
         train_tflops_per_s=train_flops / train_ms / 1e9,
         mfu=train_flops / (train_ms / 1e3) / H100_BF16_FLOPS,
         eval_ms=eval_ms, eval_images_per_s=b / (eval_ms / 1e3),
         eval_tflops_per_s=2 * macs * b / eval_ms / 1e9, peak_mem_gb=peak_gb,
         rel_l2_vs_fp32=errs, bounds=RESNET_REL_L2,
         running_stats_vs_formula=formula, formula_bound=RESNET_STATS_FORMULA_REL,
         finite=finite, grads_finite_on_card=grads_ok, all_on_card=on_card)
    if not (finite and grads_ok and on_card and logits.dtype == torch.float32):
        raise SystemExit(f"resnet: finite {finite}, gradients {grads_ok}, on the card "
                         f"{on_card}, logits {logits.dtype}")
    if any(errs[k] > RESNET_REL_L2[k] for k in errs):
        raise SystemExit(f"resnet: bf16 against fp32 {errs}, bounds {RESNET_REL_L2}")
    if max(formula.values()) > RESNET_STATS_FORMULA_REL:
        raise SystemExit(f"resnet: running statistics against the formula {formula}")


def nvidia_smi(*fields: str) -> list[list[str]]:
    """One row a card of `nvidia-smi --query-gpu=...`, without units."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return [[f.strip() for f in ln.split(",")] for ln in out.strip().splitlines()]


def phase_telemetry(attn, smi: str):
    """The port's NVML sniffer against nvidia-smi and CUDA, its free memory
    under a 16 GiB allocation, NVML's duty and the probe sampler's under
    the flash kernel's load and after it, and `cli sniff`'s CR."""
    from yoda_scheduler_tpu_torch.telemetry import duty, nvml, sniffer
    from yoda_scheduler_tpu_torch.topology.gpus import model_of_nvml_name

    free_memory()
    # this process's CUDA context exists before any reading is compared
    cuda_free, cuda_total = torch.cuda.mem_get_info(0)
    cards = nvidia_smi("name", "memory.total", "memory.free", "clocks.max.sm", "power.limit")
    listed = sum(ln.startswith("GPU ") for ln in subprocess.run(
        ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60,
        check=True).stdout.splitlines())
    t0 = time.perf_counter()
    node = sniffer.local_node_metrics()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    # one card visible: NVML's index 0 is CUDA's device 0
    chip = node.chips[0]
    name, smi_total, smi_free, smi_clock, smi_power = cards[0]
    read = dict(
        chips=node.chip_count, smi_cards=len(cards), smi_listed=listed,
        hbm_total_mb=chip.hbm_total_mb, smi_total_mb=int(smi_total),
        hbm_free_mb=chip.hbm_free_mb, smi_free_mb=int(smi_free),
        cuda_total_mb=cuda_total // 2**20, cuda_free_mb=cuda_free // 2**20,
        clock_mhz=chip.clock_mhz, smi_max_sm_clock_mhz=int(smi_clock),
        power_w=chip.power_w, smi_power_limit_w=float(smi_power),
        core_count=chip.core_count, ici_bandwidth_gbps=chip.ici_bandwidth_gbps,
        accelerator=node.accelerator, model=node.tpu_generation)
    checks = {
        "one_chip_a_card": node.chip_count == len(cards) == listed,
        "gpu_node": node.accelerator == "gpu" and node.tpu_generation == (
            model_of_nvml_name(name) or ""),
        "total_equals_nvidia_smi": chip.hbm_total_mb == int(smi_total),
        "free_near_nvidia_smi": abs(chip.hbm_free_mb - int(smi_free)) <= TELEMETRY_FREE_SLACK_MB,
        "cuda_total_within_reservation":
            0 <= chip.hbm_total_mb - cuda_total // 2**20 <= TELEMETRY_CUDA_SLACK_MB,
        "cuda_free_near": abs(chip.hbm_free_mb - cuda_free // 2**20) <= TELEMETRY_CUDA_SLACK_MB,
        "max_sm_clock_equals_nvidia_smi": chip.clock_mhz == int(smi_clock),
        "power_limit_equals_nvidia_smi": chip.power_w == int(float(smi_power)),
        "cores_and_link": chip.core_count > 0 and chip.ici_bandwidth_gbps > 0,
    }

    # free memory under a 16 GiB allocation
    hold = torch.empty(TELEMETRY_ALLOC_GIB << 30, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    held_free = sniffer.local_node_metrics().chips[0].hbm_free_mb
    del hold
    free_memory()
    drop_mb = chip.hbm_free_mb - held_free
    checks["free_drops_by_the_allocation"] = (
        drop_mb >= (TELEMETRY_ALLOC_GIB << 10) - TELEMETRY_FREE_SLACK_MB)

    # duty: NVML through the pool, and the probe sampler, under the load
    gen = torch.Generator(device="cuda").manual_seed(14)
    b, h, _, d = RING_SHAPES["mha"]
    q, k, v = (torch.randn(b, h, RING_SEQ, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    (card,) = [c for c in nvml.devices() if c.index == 0]
    pool = duty.DutySamplerPool()
    sampler = duty.DutyCycleSampler(0, period_s=0.1).start()
    try:
        # the probe's estimate is an EWMA of samples: its highest reading
        # over an idle second against its highest over the load
        idle_probe = []
        for _ in range(20):
            time.sleep(0.05)
            idle_probe.append(sampler.duty_pct)
        idle_nvml = pool.duty_of(card)
        reset_launches(attn)
        busy_nvml, busy_probe, launches = [], [], 0
        t0 = time.perf_counter()
        with torch.no_grad():
            while (elapsed := time.perf_counter() - t0) < TELEMETRY_LOAD_S:
                out = attn.flash_attention(q, k, v)
                launches += 1
                if launches % 50 == 0:
                    busy_probe.append(sampler.duty_pct)
                    if elapsed > TELEMETRY_LOAD_S / 2:
                        busy_nvml.append(pool.duty_of(card))
        busy_nvml.append(pool.duty_of(card))
        torch.cuda.synchronize()
        drained_s = time.perf_counter() - t0
        load_launches, load_routes = read_launches(attn), read_routes(attn)
        time.sleep(2 * sampler.period_s)  # the probe that waited on the load lands
        busy_probe.append(sampler.duty_pct)
        time.sleep(TELEMETRY_SETTLE_S)
        after_nvml = pool.duty_of(card)
    finally:
        stopped = sampler.stop() and pool.stop()
    with torch.no_grad():
        repeat_equal = torch.equal(out, attn.flash_attention(q, k, v))
    finite = bool(torch.isfinite(out.float()).all())
    del q, k, v, out
    checks.update({
        "load_on_the_wgmma_route": load_routes == {"flash_fwd": {"wgmma": launches},
                                                   "flash_bwd_dq": {}, "flash_bwd_dkv": {}},
        "nvml_busy_under_load": min(busy_nvml) >= TELEMETRY_BUSY_PCT,
        "probe_above_its_idle": max(busy_probe) > max(idle_probe),
        "nvml_idle_after": after_nvml <= TELEMETRY_IDLE_PCT,
        "sampler_joined": stopped,
        "load_output_finite_and_repeatable": finite and repeat_equal,
    })

    # the CLI's one-shot CR, as the sniffer DaemonSet's container runs it
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "yoda_scheduler_tpu_torch.cli", "sniff",
                          "--node-name", LIVE_NODE], capture_output=True, text=True,
                         timeout=120, cwd=str(Path(__file__).resolve().parent))
    cli_s = time.perf_counter() - t0
    cr = json.loads(res.stdout) if res.returncode == 0 else {}
    status = cr.get("status", {})
    checks["cli_sniff_cr"] = (
        res.returncode == 0 and cr.get("kind") == "TpuNodeMetrics"
        and cr.get("metadata", {}).get("name") == LIVE_NODE
        and status.get("accelerator") == "gpu" and len(status.get("chips", [])) == listed
        and status["chips"][0]["hbm_total_mb"] == int(smi_total))
    emit("telemetry", nvidia_smi=smi, card=name, snapshot_ms=snapshot_ms, read=read,
         free_mb_holding_16gib=held_free, free_drop_mb=drop_mb,
         load=dict(shape=dict(b=b, h=h, seq=RING_SEQ, d=d, causal=True, dtype="bfloat16"),
                   host_s=TELEMETRY_LOAD_S, drained_s=drained_s, launches=load_launches,
                   launches_by_route=load_routes),
         duty_nvml=dict(idle=idle_nvml, busy=busy_nvml, after=after_nvml),
         duty_probe=dict(idle=idle_probe, busy=busy_probe),
         cli_sniff=dict(rc=res.returncode, s=cli_s, stderr=res.stderr[-2000:],
                        chips=len(status.get("chips", [])),
                        accelerator=status.get("accelerator")),
         checks=checks)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"telemetry: failed {failed}")
    return load_launches


def burst_specs(n: int, seed: int) -> list[tuple[str, dict]]:
    """bench.py's scale burst (`_run_scale_nogc`): an equal mix of one-chip
    TPU pods, two-chip TPU pods at 4,000 MB, one-card GPU pods at 10,000 MB
    and plain pods at 1,000 MB, in an order shuffled from `seed`."""
    kinds = {"tpu-1c": {"scv/number": "1", "tpu/accelerator": "tpu"},
             "tpu-2c": {"scv/number": "2", "tpu/accelerator": "tpu", "scv/memory": "4000"},
             "gpu": {"scv/number": "1", "tpu/accelerator": "gpu", "scv/memory": "10000"},
             "plain": {"scv/memory": "1000"}}
    names = list(kinds)
    specs = [(f"p{i}", dict(kinds[names[i % 4]])) for i in range(n)]
    random.Random(seed).shuffle(specs)
    return specs


placement_faults, plane_counts = engine_bench.placement_faults, engine_bench.plane_counts


def build_native_planes() -> float:
    """Build the engine's native planes from this checkout (g++); raises,
    failing the phase, if they do not build or load. -> seconds."""
    t0 = time.perf_counter()
    engine_bench.build_native_planes()
    return time.perf_counter() - t0


def schedule_trace(live_at, units: int, seed: int, native: bool = True) -> dict:
    """One run of the scheduler phase's trace on the port's engine (a
    HybridClock, as bench.py): the 5,000-node cluster and the live node
    `live_at(0)`; a LIVE_POD_MB pod, which must bind on the live node; it
    leaves, the live node is re-put as `live_at(1)` and the same pod must
    stay unschedulable; the node is re-put as `live_at(2)` and the burst
    runs. -> the outcomes, placements and the engine's readings."""
    import copy

    from yoda_scheduler_tpu_torch import scheduler
    from yoda_scheduler_tpu_torch.scheduler.core import HybridClock
    from yoda_scheduler_tpu_torch.utils import Pod

    store = engine_bench.build_scale_nodes(units)
    store.put(copy.deepcopy(live_at(0)))
    cluster = scheduler.FakeCluster(store)
    cluster.add_nodes_from_telemetry()
    # bench.py's scale configuration
    config = scheduler.SchedulerConfig(max_attempts=8, telemetry_max_age_s=1e9,
                                       pod_hinted_backoff_s=30.0, native_plane=native)
    sched = scheduler.Scheduler(cluster, config, clock=HybridClock())
    want = {"tpu/accelerator": "gpu", "scv/number": "1", "scv/memory": str(LIVE_POD_MB)}
    live_pod = Pod("live-card", labels=dict(want))
    sched.submit(live_pod)
    sched.run_until_idle(max_cycles=100)
    first = (live_pod.phase.value, live_pod.node, sorted(live_pod.assigned_chips()))
    cluster.evict(live_pod)
    sched.forget(live_pod.key)
    store.put(copy.deepcopy(live_at(1)))
    held_pod = Pod("live-card-held", labels=dict(want))
    sched.submit(held_pod)
    sched.run_until_idle(max_cycles=100)
    held = (held_pod.phase.value, held_pod.node)
    store.put(copy.deepcopy(live_at(2)))
    n_nodes = len(cluster.node_names())
    pods = [Pod(name, labels=labels)
            for name, labels in burst_specs(SCHED_PODS_PER_NODE * (n_nodes - 1), seed)]
    sched.metrics.histograms.pop("cycle_latency_ms", None)
    t0 = time.perf_counter()
    for p in pods:
        sched.submit(p)
    cycles = sched.run_until_idle(max_cycles=4 * len(pods))
    wall_s = time.perf_counter() - t0
    cyc = sched.metrics.histogram("cycle_latency_ms")
    planes = plane_counts(sched)
    bound = [p for p in pods if p.phase.value == "Bound"]
    return dict(
        nodes=n_nodes, pods=len(pods), live_first=first, live_held=held,
        bound=len(bound), on_live_node=sum(p.node == LIVE_NODE for p in bound),
        cycles=cycles, wall_s=wall_s, cycle_p50_ms=cyc.quantile(0.5),
        cycle_p99_ms=cyc.quantile(0.99), planes=planes,
        native_plane_active=sched.metrics.gauges.get("native_plane_active", 0.0) == 1.0,
        faults=placement_faults(pods, cluster),
        placements={p.name: (p.phase.value, p.node, sorted(p.assigned_chips())) for p in pods})


def phase_scheduler(smi: str):
    """The port's engine on this card's host at bench.py's 5,000-node scale
    with the live card as sniffed: the card decides where a 60,000 MB pod
    goes, and refuses it while 40 GiB of it is held; the burst's
    invariants, two runs of the same trace placing alike."""
    from yoda_scheduler_tpu_torch.telemetry import sniffer

    free_memory()
    live = [sniffer.local_node_metrics(LIVE_NODE)]

    def live_at(step):
        """Run 1 sniffs the card at each step (holding LIVE_HOLD_GIB for
        step 1); run 2 replays the same snapshots."""
        if step < len(live):
            return live[step]
        hold = (torch.empty(LIVE_HOLD_GIB << 30, dtype=torch.uint8, device="cuda")
                if step == 1 else None)
        torch.cuda.synchronize()
        live.append(sniffer.local_node_metrics(LIVE_NODE))
        del hold
        free_memory()
        return live[step]

    native_build_s = build_native_planes()
    runs = [schedule_trace(live_at, SCHED_UNITS, SCHED_SEED, native=native)
            for native in (True, True, False)]
    first, second, numpy_run = runs
    free_mb = [m.chips[0].hbm_free_mb for m in live]
    same = first["placements"] == second["placements"]
    checks = {
        "native_plane_decides": all(r["native_plane_active"] and r["planes"].get("native", 0) > 0
                                    for r in (first, second)),
        "native_places_as_numpy": (first["placements"] == numpy_run["placements"]
                                   and not numpy_run["native_plane_active"]),
        "binds_as_before": first["bound"] == SCHED_BOUND,
        "live_pod_binds_on_the_live_card": first["live_first"][:2] == ("Bound", LIVE_NODE),
        "live_pod_refused_while_held": first["live_held"][0] != "Bound",
        "live_card_has_room_then_none": free_mb[0] >= LIVE_POD_MB > free_mb[1],
        "no_placement_fault": not any(r["faults"] for r in runs),
        "runs_place_alike": same and all(first[k] == second[k] for k in
                                         ("live_first", "live_held", "bound")),
        "burst_binds": first["bound"] > 0,
    }
    emit("scheduler", nvidia_smi=smi, config="bench.py huge_5000 (BENCH_SCALE5K.json) + "
         "the live card", seed=SCHED_SEED, native_build_s=native_build_s,
         run_planes=["native", "native", "numpy"], live_free_mb=free_mb,
         live_pod_mb=LIVE_POD_MB, hold_gib=LIVE_HOLD_GIB,
         runs=[{k: v for k, v in r.items() if k != "placements"} for r in runs],
         placements_equal=same, checks=checks)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"scheduler: failed {failed}")


def phase_tune_attention(attn, tune, smi: str):
    """The route sweep of tools/tune_attention.py in this process: forward
    and forward+backward at TUNE_SEQS, on every route `_routes` admits,
    beside SDPA (flash backend) and the plain version; every candidate
    checked before any is timed. One line a row, then the phase."""
    free_memory()
    reset_launches(attn)
    t0 = time.perf_counter()
    keys = ("s", "direction", "candidate", "ms", "spread_ms", "bound_ms",
            "share_of_bound", "tflops", "dq_ms", "dkv_ms", "backward_ms",
            "tile_rel_l2_o", "worst_tile", "ok")

    def show(row):
        print(json.dumps({"phase": "tune_attention",
                          **{k: row[k] for k in keys if k in row}}), flush=True)

    try:
        rows = [row for bwd in (False, True) for row in
                tune.sweep(TUNE_SEQS, tune.ROUTES, bwd, TUNE_REPEATS, emit=show)]
    except tune.CheckFailed as e:
        raise SystemExit(f"tune_attention: {e}") from None
    torch.cuda.synchronize()
    launches, routes = read_launches(attn), read_routes(attn)
    emit("tune_attention", nvidia_smi=smi, seqs=list(TUNE_SEQS), repeats=TUNE_REPEATS,
         shape="H=16, D=128, B=8192/S, causal, bf16", seconds=time.perf_counter() - t0,
         launches=launches, launches_by_route=routes, rows=rows)
    idle = [n for n, c in launches.items() if not c]
    if idle or not all(r["ok"] for r in rows):
        raise SystemExit(f"tune_attention: kernels never launched {idle}, or a row "
                         f"not ok")
    return routes


def _bench_checkpoint(bench_util):
    """The twins' checkpoint, kept in memory: a smoke reuses no section."""
    return bench_util.make_checkpoint("CHIP_SMOKE_BENCH_CKPT", "off", lambda msg: None)


def _only_wgmma(routes: dict) -> bool:
    return all(set(by_route) <= {"wgmma"} for by_route in routes.values())


def bench_train_routes(bench_mfu) -> dict:
    """Each kernel's launches by route over bench_mfu's train candidates:
    per layer a step, the forward twice (remat) and each backward kernel
    once, for the warm step and the timed ones; every kernel on the wgmma
    route, at head dim 128 and at the reference's d1024 widths' 64
    (`shape_routes`)."""
    return step_routes("wgmma", (1 + bench_mfu.CARD_TRAIN_STEPS) * sum(
        cfg.n_layers for cfg, _, _ in bench_mfu.train_candidates(True)))


def planted_rings(gen_mod) -> dict:
    """Wrong folds of a prefilled cache into the ring, for the rolling
    check to reject: the prompt's keys and values lost; the oldest window
    of the prompt kept in place of the newest; every prompt key one slot
    late, so that the first decode step overwrites the newest prompt key
    where it should overwrite the oldest (one key short at every step);
    every prompt slot labelled one position too old, so that the window
    mask drops the oldest key it should keep (1,023 keys where 1,024 are
    due, at every step). A ring of `window` slots cannot hold a key too
    many: a label one too new is overwritten by the first step."""
    fold = gen_mod.RollingKVCache.from_prefill

    def prompt_lost(cache, window):
        ring = fold(cache, window)
        ring.k.zero_()
        ring.v.zero_()
        return ring

    def oldest_window(cache, window):
        oldest = gen_mod.KVCache(k=cache.k, v=cache.v, length=window)
        return dataclasses.replace(fold(oldest, window), next_pos=cache.length)

    def slot_shifted(cache, window):
        ring = fold(cache, window)
        return dataclasses.replace(ring, k=ring.k.roll(1, dims=2), v=ring.v.roll(1, dims=2),
                                   slot_pos=ring.slot_pos.roll(1))

    def window_one_short(cache, window):
        ring = fold(cache, window)
        return dataclasses.replace(ring, slot_pos=torch.where(
            ring.slot_pos >= 0, ring.slot_pos - 1, ring.slot_pos))

    return {"prompt_lost": prompt_lost, "oldest_window": oldest_window,
            "slot_shifted": slot_shifted, "window_one_short": window_one_short}


def phase_bench_mfu(attn, bench_util, bench_mfu, tune, smi: str):
    """The twin of bench_mfu.py: the train candidates (d1024 L8 B8, d1024 L16
    B8, d2048 L16 B4, 7B B1, all S=2048), then every attention row checked
    against the plain version and then timed; one line a candidate and a
    row, then the twin's JSON line. Every candidate and row must give its
    numbers; every attention launch be on the wgmma route, and the train
    launches on the route each candidate's head dim takes
    (`bench_train_routes`)."""
    free_memory()
    t0 = time.perf_counter()
    card = bench_util.detect_card()
    peak = bench_mfu.peak_flops(card.name)
    ckpt = _bench_checkpoint(bench_util)
    reset_launches(attn)
    train = bench_mfu.llama_train_bench(True, ckpt, "cuda", peak)
    torch.cuda.synchronize()
    train_launches, train_routes = read_launches(attn), read_routes(attn)
    free_memory()
    try:
        checks = bench_mfu.check_attention()
    except tune.CheckFailed as e:
        raise SystemExit(f"bench_mfu: {e}") from None
    reset_launches(attn)
    attention = bench_mfu.time_attention(True, ckpt, peak, "cuda")
    torch.cuda.synchronize()
    attn_launches, attn_routes = read_launches(attn), read_routes(attn)
    free_memory()
    for attempt in train["attempts"]:
        print(json.dumps({"phase": "bench_mfu", "train": attempt}), flush=True)
    for name, row in attention.items():
        print(json.dumps({"phase": "bench_mfu", "row": name, **row}), flush=True)
    print(json.dumps(bench_mfu.result(train, attention, card, smi, "cuda")), flush=True)
    # a row's every time is a number, but the window row's flash library
    # call, which SDPA's flash backend cannot make (it takes no mask)
    unmeasured = [f"{name}.{key}" for name, row in attention.items()
                  for key, value in row.items()
                  if key.endswith("_ms") and (name, key) != ("window_1024", "sdpa_flash_fwd_ms")
                  and not isinstance(value, float)]
    no_mfu = [a for a in train["attempts"] if not isinstance(a.get("mfu_pct"), float)]
    emit("bench_mfu", nvidia_smi=smi, card=card.name,
         catalog_model=card.model.name if card.model else None,
         peak_tflops=peak / 1e12 if peak else None, readings=bench_mfu.READINGS,
         seconds=time.perf_counter() - t0, checks=checks,
         launches={"train": train_launches, "attention": attn_launches},
         launches_by_route={"train": train_routes, "attention": attn_routes},
         attempts=train["attempts"], rows=sorted(attention))
    idle = [f"{path}.{n}" for path, counts in (("train", train_launches),
                                               ("attention", attn_launches))
            for n, c in counts.items() if not c]
    skipped = [name for name, row in attention.items() if "skipped" in row]
    if (len(train["attempts"]) != BENCH_MFU_CANDIDATES or no_mfu or unmeasured or skipped
            or sorted(attention) != sorted(BENCH_MFU_ROWS)):
        raise SystemExit(f"bench_mfu: a candidate or row without its numbers: "
                         f"{no_mfu or train['attempts']}, {unmeasured}, {skipped}, "
                         f"{sorted(attention)}")
    want_train = bench_train_routes(bench_mfu)
    if idle or train_routes != want_train or not _only_wgmma(attn_routes):
        raise SystemExit(f"bench_mfu: kernels never launched {idle}, or launches off their "
                         f"routes: train {train_routes} (expected {want_train}), attention "
                         f"{attn_routes} (expected wgmma alone)")
    return {"bench_mfu_train": train_routes, "bench_mfu_attention": attn_routes}


def phase_bench_generate(attn, bench_util, bench_generate, llama, gen_mod, smi: str):
    """The twin of bench_generate.py at width 2048: prefill and decode of
    the four cells (B 1 and 8, window None and 1024 through the ring
    cache, each windowed cell's rolling decode first held against the
    linear one), then the no-cache baseline at B=8 (one flash_fwd a layer
    a token); one line a cell, then the twin's JSON line. Every cell and
    the baseline must give tokens/s, every flash launch be on the wgmma
    route, and the rolling check reject each planted wrong ring
    (`planted_rings`)."""
    free_memory()
    t0 = time.perf_counter()
    card = bench_util.detect_card()
    bw = bench_generate.hbm_gbps(card.name)
    config = bench_generate.serving_config(True)
    prompt_len = bench_generate.run_shape(True)[0]
    params = llama.init_llama(config, seed=0, device="cuda")
    param_bytes, n_params = bench_generate.weight_bytes(params)
    ckpt = _bench_checkpoint(bench_util)
    reset_launches(attn)
    try:
        cells = bench_generate.run_cells(params, config, True, ckpt, bw, param_bytes,
                                         repeats=BENCH_DECODE_REPEATS)
    except bench_generate.RollingMismatch as e:
        raise SystemExit(f"bench_generate: {e}") from None
    torch.cuda.synchronize()
    cell_launches = read_launches(attn)
    windowed = dataclasses.replace(config, sliding_window=bench_generate.run_shape(True)[2])
    prompt = bench_generate.make_prompt(1, 1, prompt_len, config.vocab_size,
                                        params["embed"].device)
    planted = {name: bench_generate.rolling_check(params, windowed, prompt, fold=fold)
               ["max_rel_l2"] for name, fold in planted_rings(gen_mod).items()}
    # the same in the cells' bf16, for the record: why the check runs in fp32
    planted_bf16 = {name: bench_generate.rolling_check(params, windowed, prompt, fold=fold,
                                                       dtype=config.dtype)["max_rel_l2"]
                    for name, fold in {"sound": None, **planted_rings(gen_mod)}.items()}
    reset_launches(attn)
    baseline = bench_generate.no_cache_baseline(params, config, 8, prompt_len,
                                                repeats=BENCH_DECODE_REPEATS)
    torch.cuda.synchronize()
    nc_launches, nc_routes = read_launches(attn), read_routes(attn)
    del params
    free_memory()
    for cell in cells:
        print(json.dumps({"phase": "bench_generate", **cell}), flush=True)
    print(json.dumps(bench_generate.result(cells, baseline, n_params, card, smi, "cuda")),
          flush=True)
    # the no-cache generation's forwards: one warm token, then 2 and 4
    # tokens `repeats` times each, a launch a layer a token
    want = config.n_layers * (1 + 6 * BENCH_DECODE_REPEATS)
    emit("bench_generate", nvidia_smi=smi, card=card.name, memory_gbps=bw,
         params=n_params, weight_gb=param_bytes / 1e9, repeats=BENCH_DECODE_REPEATS,
         seconds=time.perf_counter() - t0, cells=cells, no_cache_baseline=baseline,
         rolling_bound=bench_generate.ROLLING_REL_L2, planted_rings_rel_l2=planted,
         rings_rel_l2_bf16=planted_bf16,
         launches={"cells": cell_launches, "no_cache": nc_launches},
         launches_by_route={"no_cache": nc_routes})
    no_number = [c for c in cells if not isinstance(c.get("decode_tokens_per_sec"), float)]
    unchecked = [c for c in cells if c["window"] and not (c.get("rolling_check") or {}).get("ok")]
    if no_number or unchecked or not isinstance(baseline.get("tokens_per_sec"), float):
        raise SystemExit(f"bench_generate: a cell or the baseline without its numbers, or "
                         f"an unchecked ring: {no_number}, {unchecked}, {baseline}")
    if not all(err > bench_generate.ROLLING_REL_L2 for err in planted.values()):
        raise SystemExit(f"bench_generate: the rolling check's bound "
                         f"{bench_generate.ROLLING_REL_L2} let a planted wrong ring "
                         f"through: {planted}")
    if nc_launches != {"flash_fwd": want, "flash_bwd_dq": 0, "flash_bwd_dkv": 0} \
            or not _only_wgmma(nc_routes):
        raise SystemExit(f"bench_generate: the no-cache baseline launched {nc_routes}, "
                         f"expected {want} flash_fwd on the wgmma route")
    return {"bench_generate_no_cache": nc_routes}


def phase_visible(smi: str):
    """The scheduler's assignment reaches a workload: a child process with
    YODA_ASSIGNED_CHIPS="0,0,0" sees one card, NVML's card 0 by UUID;
    "1,0,0" is refused by the helper as past NVML's count; the helper
    refuses to run once CUDA has started, in this process (torch's CUDA
    state) and in a child that only asked torch.cuda.is_available()."""
    from yoda_scheduler_tpu_torch.parallel import multihost
    from yoda_scheduler_tpu_torch.telemetry import nvml

    root = str(Path(__file__).resolve().parent)
    uuid0 = [c for c in nvml.devices() if c.index == 0][0].uuid()

    def child(chips, mode="plain"):
        env = {**os.environ, multihost.ASSIGNED_ENV: chips,
               "PYTHONPATH": os.pathsep.join(filter(None, (root, os.environ.get(
                   "PYTHONPATH"))))}
        env.pop("CUDA_VISIBLE_DEVICES", None)
        res = subprocess.run([sys.executable, "-c", VISIBLE_CHILD, mode], env=env,
                             cwd=root, capture_output=True, text=True, timeout=300)
        if res.returncode:
            raise SystemExit(f"visible: the child failed: {res.stderr[-2000:]}")
        return json.loads(res.stdout.strip().splitlines()[-1])

    def bare(u):
        return u.lower().removeprefix("gpu-")

    one, past, late = child("0,0,0"), child("1,0,0"), child("0,0,0", "cuda_first")
    try:
        multihost.bind_assigned_cards({multihost.ASSIGNED_ENV: "0,0,0"})
        here = None
    except RuntimeError as e:
        here = str(e)
    checks = {
        "one_card_visible": one.get("count") == 1,
        "visible_set_is_the_uuid": one.get("set") == uuid0,
        "cuda0_is_nvml_card0": bare(one.get("uuid0", "")) == bare(uuid0),
        "card_past_the_count_refused_by_the_helper": past.get("error", "").startswith(
            "ValueError") and "NVML counts 1" in past.get("error", ""),
        "refused_after_is_available": late.get("error", "").startswith("RuntimeError"),
        "refused_in_this_process": here is not None,
    }
    emit("visible", nvidia_smi=smi, nvml_uuid0=uuid0, assigned_0=one, assigned_1=past,
         after_is_available=late, this_process=here, checks=checks)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"visible: failed {failed}")


# each field of the live card against its catalog row: (field, NVML reading
# of the card, the row's value)
def live_card_fields(card, chip, model) -> dict:
    return {
        "hbm_mb": (chip.hbm_total_mb, model.hbm_mb),
        "max_sm_clock_mhz": (chip.clock_mhz, model.max_sm_clock_mhz),
        "cuda_cores": (chip.core_count, model.cuda_cores),
        "links": (card.nvlink_active_links(), model.links),
        "power_w": (chip.power_w, model.power_w),
    }


def phase_gpu_fleet(smi: str):
    """The GPU catalog against the live card, and the engine on a DGX
    SuperPOD-sized GPU fleet with the live node: model-pinned pods, gangs
    and gpu-locality (two runs on, one with the default profile)."""
    from yoda_scheduler_tpu_torch.telemetry import nvml, sniffer
    from yoda_scheduler_tpu_torch.topology import gpus

    free_memory()
    native_build_s = build_native_planes()
    (card,) = [c for c in nvml.devices() if c.index == 0]
    product = card.name()
    live = sniffer.local_node_metrics(LIVE_NODE)
    model_name = gpus.model_of_nvml_name(product)
    fields = (live_card_fields(card, live.chips[0], gpus.gpu_model(model_name))
              if model_name else {})
    differ = [f for f, (read, row) in fields.items() if read != row]
    fleet = engine_bench.run_gpu_fleet(live)
    runs = fleet["runs"]
    on, on2, off = runs
    checks = {
        "nvml_name_maps_to_h100_sxm5": model_name == "h100-sxm5",
        "catalog_row_equals_nvml": bool(fields) and not differ,
        "sniffed_node_is_h100_sxm5": live.tpu_generation == "h100-sxm5",
        "live_pod_on_the_live_node": all(r["live"] == ("Bound", LIVE_NODE) for r in runs),
        "pinned_pods_on_their_model": not any(r["off_model"] for r in runs),
        "no_gang_spans_leaves_with_room": not on["spanning_with_room"]
                                          and not on2["spanning_with_room"],
        "no_placement_fault": not any(r["faults"] for r in runs),
        "locality_runs_place_alike": fleet["locality_runs_place_alike"],
        "native_plane_decides": all(r["native_plane_active"] and r["planes"].get("native", 0)
                                    for r in runs),
        "burst_binds": all(r["bound"] > 0 and r["gangs_bound"] > 0 for r in runs),
    }
    emit("gpu_fleet", nvidia_smi=smi, card=product, model=model_name,
         live_card=dict(fields), fields_differing=differ, native_build_s=native_build_s,
         **fleet, checks=checks)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"gpu_fleet: failed {failed}"
                         + (f"; fields differing from NVML: {differ}" if differ else ""))


def phase_bench_engine(smi: str):
    """The engine bench twins on this card's host with the live card in
    their clusters: bench.py's burst headline, run_scale(125) once and
    scale50k's smoke tier, each run free of placement faults, binding the
    pods it must (ENGINE_*) and, on the yoda-tpu profile, decided on the
    native planes."""
    from yoda_scheduler_tpu_torch.tools import scale50k

    free_memory()
    native_build_s = build_native_planes()
    live = engine_bench.live_node()
    t0 = time.perf_counter()
    burst = engine_bench.burst_headline(live, runs=ENGINE_BURST_RUNS)
    burst_s = time.perf_counter() - t0
    scale = engine_bench.run_scale(ENGINE_SCALE_UNITS, live=live)
    t0 = time.perf_counter()
    tier = scale50k.run(smoke=True, live=live)
    tier_s = time.perf_counter() - t0
    ours_all, ref_all = burst["ours_all"], burst["reference_all"]
    native_runs = ours_all + [scale, tier["tier"]]
    checks = {
        "no_placement_fault": not any(r["placement_faults"]
                                      for r in native_runs + ref_all),
        "native_plane_active": all(r["native_plane_active"] for r in native_runs),
        "burst_binds_on_the_live_card": all(r["on_live_node"] >= 1 for r in ours_all),
        "burst_outcomes": (all(r["bound"] == ENGINE_BURST_BOUND
                               and r["gangs_complete"] == ENGINE_BURST_GANGS
                               for r in ours_all)
                           and all(r["bound"] == ENGINE_BASELINE_BOUND for r in ref_all)),
        "scale_binds_its_count": (scale["bound"] == ENGINE_SCALE_BOUND
                                  and scale["on_live_node"] == 1),
        "tier_binds_every_pod": (tier["tier"]["bound"] == tier["pods"]
                                 and tier["ref_5k"]["bound"] == ENGINE_5K_BOUND),
    }
    ours, ref = burst["ours"], burst["reference"]
    headline = {k: ours[k] for k in ("p50_ms", "p99_ms", "cycle_compute_p50_ms", "bound",
                                     "bin_pack_util_pct", "gangs_complete", "on_live_node")}
    keys = ("nodes", "pods", "bound", "wall_s", "cycle_compute_p50_ms",
            "cycle_compute_p99_ms", "p50_ms", "native_scans", "on_live_node")
    emit("bench_engine", nvidia_smi=smi, native_build_s=native_build_s,
         live_node=engine_bench.live_summary(live, pods_on_it=ours["on_live_node"]),
         burst=dict(headline, vs_baseline=burst["vs_baseline"],
                    vs_baseline_range=burst["vs_baseline_range"],
                    vs_baseline_cycle_compute=burst["vs_baseline_cycle_compute"],
                    baseline_p50_ms=ref["p50_ms"], baseline_bound=ref["bound"],
                    baseline_bin_pack_util_pct=ref["bin_pack_util_pct"],
                    p50_ms_runs=[r["p50_ms"] for r in ours_all],
                    baseline_p50_ms_runs=[r["p50_ms"] for r in ref_all],
                    # the compute ratio is the median-p50 runs' quotient:
                    # every run's compute p50, to read its spread
                    cycle_compute_p50_ms_runs=[r["cycle_compute_p50_ms"] for r in ours_all],
                    baseline_cycle_compute_p50_ms_runs=[r["cycle_compute_p50_ms"]
                                                        for r in ref_all],
                    wall_s=burst_s),
         scale={k: scale[k] for k in keys},
         # (the tier's peak_rss_mb is this whole process's here, not the tier's)
         scale50k_smoke=dict({k: tier[k] for k in (
             "nodes", "pods", "wall_s", "binds_per_s", "cycle_compute_per_pod_p50_ms",
             "cycle_compute_flat_vs_5k", "ref_5k")},
             bound=tier["tier"]["bound"], tier_s=tier_s),
         faults=[f for r in native_runs + ref_all for f in r["placement_faults"]][:20],
         checks=checks)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"bench_engine: failed {failed}")


def _prometheus(text: str, prefix: str = "yoda_tpu_") -> dict:
    """{name or name{labels}: value} of a Prometheus text exposition, each
    name without the engine's `prefix`."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            key, _, value = ln.rpartition(" ")
            out[key.removeprefix(prefix)] = float(value)
    return out


def phase_webhook(smi: str):
    """The bind-authority webhook on this card's host: the live node's CR
    (NVML through the port's sniffer) checked against the port's CRD and
    published through the port's publisher into the port's fake API
    server; the webhook started from its manifest's command and args as a
    subprocess over plain HTTP and registered with the fake; then a bind
    of the live card allowed, a second bind of the same card refused with
    409, a pod asking more memory than the card has free refused, and
    WEBHOOK_REVIEWS reviews timed on the host clock."""
    import http.client

    import yaml

    from yoda_scheduler_tpu_torch.k8s import crdcheck
    from yoda_scheduler_tpu_torch.k8s.client import ApiError, KubeClient
    from yoda_scheduler_tpu_torch.k8s.fake_apiserver import FakeApiServer
    from yoda_scheduler_tpu_torch.telemetry import sniffer
    from yoda_scheduler_tpu_torch.telemetry.publisher import CrPublisher
    from yoda_scheduler_tpu_torch.utils import Pod

    root = Path(__file__).resolve().parent
    live = sniffer.local_node_metrics(LIVE_NODE)
    cr = json.loads(json.dumps(live.to_cr()))  # the wire form
    crd = crdcheck.load_crd()
    enum = crdcheck.schema_of(crd)["properties"]["status"]["properties"][
        "tpu_generation"]["enum"]
    faults = crdcheck.check_cr(cr, crd)
    card0 = cr["status"]["chips"][0]
    hungry_mb = card0["hbm_free_mb"] + 1

    (dep,) = [d for d in yaml.safe_load_all((root / WEBHOOK_MANIFEST).read_text())
              if d and d["kind"] == "Deployment"]
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    port = _free_port()
    # the manifest's command, with a free port, no TLS (this machine may
    # lack openssl; the CPU tests run it over HTTPS) and the fake's address
    args = [f"--port={port}" if a.startswith("--port=") else a for a in c["args"]
            if not a.startswith(("--tls-cert=", "--tls-key="))]
    base = f"http://127.0.0.1:{port}"
    binds, timed, proc = {}, [], None
    with FakeApiServer() as api, tempfile.TemporaryFile("w+") as out:
        api.state.add_node(LIVE_NODE)
        client = KubeClient(api.url, max_retries=0)
        CrPublisher(client).publish(live)
        stored = api.state.objects["metrics"].get(LIVE_NODE, {})
        for name, labels in (("first", {}), ("second", {}),
                             ("hungry", {"scv/memory": str(hungry_mb)})):
            api.state.add_pod({"metadata": {"name": name, "namespace": "default",
                                            "labels": labels}})
        cmd = [sys.executable if c["command"][0] == "python3" else c["command"][0],
               *c["command"][1:], *args, f"--apiserver={api.url}"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=str(root), stdout=out, stderr=subprocess.STDOUT)
        try:
            health = None
            while health is None and time.perf_counter() - t0 < WEBHOOK_START_LIMIT_S:
                if proc.poll() is not None:
                    break
                with contextlib.suppress(OSError):  # refused, or 503 until the feed lists
                    with urllib.request.urlopen(f"{base}/healthz", timeout=2.0) as r:
                        health = json.loads(r.read())
                if health is None:
                    time.sleep(0.1)
            start_s = time.perf_counter() - t0
            if health is None:
                out.seek(0)
                raise SystemExit(f"webhook: no /healthz within {WEBHOOK_START_LIMIT_S} s "
                                 f"(rc {proc.poll()}): {out.read()[-2000:]}")
            api.state.set_webhook(f"{base}/validate")
            for name in ("first", "second", "hungry"):
                try:
                    client.bind(Pod(name), LIVE_NODE, [(0, 0, 0)])
                    binds[name] = dict(allowed=True)
                except ApiError as e:
                    binds[name] = dict(allowed=False, status=e.status, message=str(e)[-300:])
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            for i in range(WEBHOOK_REVIEWS):
                ann = {"tpu/assigned-chips": "0,0,0"} if i % 2 else {}
                doc = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                       "request": {"uid": f"r-{i}", "object": {
                           "kind": "Binding", "target": {"name": LIVE_NODE},
                           "metadata": {"name": f"probe-{i}", "namespace": "default",
                                        "annotations": ann}}}}
                t1 = time.perf_counter()
                conn.request("POST", "/validate", json.dumps(doc),
                             {"Content-Type": "application/json"})
                resp = json.loads(conn.getresponse().read())["response"]
                timed.append(((time.perf_counter() - t1) * 1e3, resp["uid"] == f"r-{i}"
                              and resp["allowed"] == (i % 2 == 0)))
            conn.close()
            with urllib.request.urlopen(f"{base}/metrics", timeout=5.0) as r:
                counts = _prometheus(r.read().decode())
            calls, denials = api.state.webhook_calls, api.state.webhook_denials
            bound_first = (api.state.pod("first") or {}).get("spec", {}).get("nodeName")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)

    ms = [t for t, _ in timed]
    q = statistics.quantiles(ms, n=100)
    half = WEBHOOK_REVIEWS // 2
    by_reason = {k.split('"')[1]: int(v) for k, v in counts.items()
                 if k.startswith("webhook_denials_total{")}
    checks = {
        "live_cr_passes_the_crd": not faults,
        "tpu_generation_in_the_enum": cr["status"]["tpu_generation"] in enum,
        "crd_has_no_status_subresource": not crdcheck.has_status_subresource(crd),
        "published_status_as_written": stored.get("status", {}).get("chips")
                                       == cr["status"]["chips"],
        "webhook_ready": bool(health and health.get("ok")
                              and health.get("nodes_with_metrics") == 1),
        "first_bind_allowed": binds["first"] == dict(allowed=True) and bound_first == LIVE_NODE,
        "second_bind_409": not binds["second"]["allowed"] and binds["second"]["status"] == 409
                           and "denied the request" in binds["second"]["message"],
        "memory_bind_denied": not binds["hungry"]["allowed"]
                              and "HBM oversubscription" in binds["hungry"]["message"],
        "reviews_answered": len(timed) == WEBHOOK_REVIEWS and all(ok for _, ok in timed),
        "counts": (int(counts.get("webhook_reviews_total", 0)) == 3 + WEBHOOK_REVIEWS
                   and int(counts.get("webhook_allows_total", 0)) == 1 + half
                   and by_reason == {"chip_claim": 1 + half, "hbm": 1}
                   and (calls, denials) == (3, 2)),
    }
    emit("webhook", nvidia_smi=smi, manifest=WEBHOOK_MANIFEST, command=cmd[1:],
         live_cr=dict(tpu_generation=cr["status"]["tpu_generation"],
                      chips=len(cr["status"]["chips"]), card0=card0, faults=faults),
         start_s=start_s, health=health, binds=binds, hungry_mb=hungry_mb,
         reviews=dict(n=len(ms), p50_ms=q[49], p99_ms=q[98], max_ms=max(ms),
                      mean_ms=statistics.fmean(ms)),
         counts=dict(reviews=counts.get("webhook_reviews_total"),
                     allows=counts.get("webhook_allows_total"),
                     denials_by_reason=by_reason),
         apiserver=dict(webhook_calls=calls, webhook_denials=denials), checks=checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"webhook: failed {failed}" + (f"; CRD faults {faults}" if faults
                                                          else ""))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from yoda_scheduler_tpu_torch.models import llama, moe, resnet
    from yoda_scheduler_tpu_torch.ops import _build, attention as attn, variants
    from yoda_scheduler_tpu_torch.parallel import mesh as mesh_mod, pipeline, ring, train
    from yoda_scheduler_tpu_torch.parallel import checkpoint, multihost, ulysses
    from yoda_scheduler_tpu_torch.tools import tune_attention as tune
    from yoda_scheduler_tpu_torch import bench_generate, bench_mfu, bench_util
    # Mixtral-8x7B's widths from its config.json, in the port's config fields,
    # and Phi-3-mini's, OpenLLaMA-3B's, StableLM-3B-4E1T's, Gemma-2B's,
    # OPT-1.3B's, OPT-2.7B's, GPT-NeoX-20B's and GPT-J-6B's, from theirs
    from yoda_scheduler_tpu_torch.profile_path import (
        d80_backward_on_mma, d80_forward_on_mma, d100_backward_on_simt,
        d100_forward_on_simt, d256_backward_on_mma, d256_forward_on_mma,
        fp16_backward_on_mma, fp16_d64_forward_on_mma, fp16_d80_forward_on_mma,
        fp16_d96_forward_on_mma, fp16_d100_backward_on_simt, fp16_d100_forward_on_simt,
        fp16_d256_forward_on_mma, gemma_2b, gpt_neox_20b, gptj_6b, mixtral_8x7b,
        NEOX20B_BACKWARD_LAYERS,
        openllama_3b, openllama_3b_fp16, opt_1_3b, opt_2_7b, phi3_mini, stablelm_3b_4e1t)

    gen_mod = importlib.import_module("yoda_scheduler_tpu_torch.models.generate")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_build(_build)
    rows, max_err = phase_kernel(attn, variants, tune)
    bwd_rows, bwd_err = phase_backward(attn, variants, tune)
    tune_routes = phase_tune_attention(attn, tune, smi)
    bench_routes = phase_bench_mfu(attn, bench_util, bench_mfu, tune, smi)
    bench_routes.update(phase_bench_generate(attn, bench_util, bench_generate, llama,
                                               gen_mod, smi))
    cfg, params, fwd_launches, _ = phase_forward(attn, llama)
    phase_serving(cfg, params, llama, gen_mod)
    del params
    mcfg, mparams, moe_fwd_launches = phase_moe_forward(
        attn, llama, train, moe, mixtral_8x7b(MOE_FORWARD_LAYERS))
    # every expert weight is read once a decode step: the step's memory bound
    expert_bytes = sum(t.numel() * t.element_size() for layer in mparams["layers"]
                       for n, t in layer.items() if n.startswith("we_"))
    phase_serving(mcfg, mparams, llama, gen_mod, phase="moe_serving",
                  bound=MOE_SERVING_REL_L2, planted=planted_faults(attn),
                  expert_weight_gb=expert_bytes / 1e9,
                  decode_step_bound_ms_expert_reads=expert_bytes / H100_HBM_BYTES * 1e3)
    del mparams
    free_memory()
    phase_gradient(attn, llama, train)
    step_launches, _ = phase_train(attn, train, moe, llama.LlamaConfig.llama2_7b())
    sharded_launches = phase_sharded_train(attn, train, mesh_mod,
                                           llama.LlamaConfig.llama2_7b())
    moe_step_launches, _ = phase_train(attn, train, moe, mixtral_8x7b(MOE_TRAIN_LAYERS),
                                       phase="moe_train")
    # head dim 96 (Phi-3-mini's widths) and fp16 (Llama-2-7B in the dtype of
    # its published weights): every flash launch on wgmma
    phi3, phi3_name = phi3_mini(), "phi3_mini_4k widths"
    phi3_fwd_routes = phase_forward(attn, llama, phi3, phase="phi3_forward",
                                    config=phi3_name)[3]
    phase_gradient(attn, llama, train, phi3, phase="phi3_gradient",
                   config=f"{phi3_name}, 4 layers")
    # each kernel's launches by route in the last phi3 step
    phi3_step_routes = phase_train(attn, train, moe, phi3, phase="phi3_train",
                                   config=phi3_name)[1]
    fp16 = dataclasses.replace(llama.LlamaConfig.llama2_7b(), dtype="float16")
    fp16_fwd_routes = phase_forward(attn, llama, fp16, phase="fp16_forward",
                                    config="llama2_7b fp16")[3]
    # timed in turns against the same with dQ and dK/dV on mma
    fp16_grad_routes = phase_gradient(
        attn, llama, train, fp16, phase="fp16_gradient",
        config="llama2_7b fp16 width, 4 layers",
        turns={"wgmma": contextlib.nullcontext,
               "backward_on_mma": functools.partial(fp16_backward_on_mma, 128)})
    # head dims 100 and 80 (OpenLLaMA-3B's and StableLM-3B's widths), 256
    # (Gemma-2B's), 64 in fp16 (OPT-1.3B's), 80 in fp16 (OPT-2.7B's), 100
    # in fp16 (OpenLLaMA-3B's in its published dtype), 96 in fp16
    # (GPT-NeoX-20B's, 54 GB of weights: phase_forward frees the card first)
    # and 256 in fp16 (GPT-J-6B's): every forward launch on wgmma, timed in
    # turns against the forward on the route it took before its wgmma kernel
    new_width_routes = {}
    for phase, width_cfg, name, old in (
            ("openllama3b_forward", openllama_3b(), "open_llama_3b widths",
             ("forward_on_simt", d100_forward_on_simt)),
            ("stablelm3b_forward", stablelm_3b_4e1t(), "stablelm_3b_4e1t widths",
             ("forward_on_mma", d80_forward_on_mma)),
            ("gemma2b_forward", gemma_2b(), "gemma_2b widths",
             ("forward_on_mma", d256_forward_on_mma)),
            ("opt13b_fp16_forward", opt_1_3b(), "opt_1_3b widths, fp16",
             ("forward_on_mma", fp16_d64_forward_on_mma)),
            ("opt27b_fp16_forward", opt_2_7b(), "opt_2_7b widths, fp16",
             ("forward_on_mma", fp16_d80_forward_on_mma)),
            ("openllama3b_fp16_forward", openllama_3b_fp16(), "open_llama_3b widths, fp16",
             ("forward_on_simt", fp16_d100_forward_on_simt)),
            ("neox20b_fp16_forward", gpt_neox_20b(), "gpt_neox_20b widths, fp16",
             ("forward_on_mma", fp16_d96_forward_on_mma)),
            ("gptj6b_fp16_forward", gptj_6b(), "gpt_j_6b widths, fp16",
             ("forward_on_mma", fp16_d256_forward_on_mma))):
        new_width_routes[phase] = phase_forward(
            attn, llama, width_cfg, phase=phase, config=name,
            turns={"wgmma": contextlib.nullcontext, old[0]: old[1]})[3]
    # OpenLLaMA-3B's gradient and train step: dQ and dK/dV on their
    # head-dim-100 wgmma kernels, timed in turns against both on simt
    d100_turns = {"wgmma": contextlib.nullcontext, "backward_on_simt": d100_backward_on_simt}
    openllama_grad_routes = phase_gradient(
        attn, llama, train, openllama_3b(), phase="openllama3b_gradient",
        config="open_llama_3b widths, 4 layers", turns=d100_turns)
    openllama_step_routes = phase_train(attn, train, moe, openllama_3b(),
                                        phase="openllama3b_train",
                                        config="open_llama_3b widths", turns=d100_turns)[1]
    # StableLM-3B-4E1T's gradient and train step: dQ and dK/dV on their
    # head-dim-80 wgmma kernels, timed in turns against both on mma
    d80_turns = {"wgmma": contextlib.nullcontext, "backward_on_mma": d80_backward_on_mma}
    stablelm_grad_routes = phase_gradient(
        attn, llama, train, stablelm_3b_4e1t(), phase="stablelm3b_gradient",
        config="stablelm_3b_4e1t widths, 4 layers", turns=d80_turns)
    stablelm_step_routes = phase_train(attn, train, moe, stablelm_3b_4e1t(),
                                       phase="stablelm3b_train",
                                       config="stablelm_3b_4e1t widths", turns=d80_turns)[1]
    # Gemma-2B's gradient and train step: dQ and dK/dV on their head-dim-256
    # wgmma kernels, timed in turns against both on mma
    d256_turns = {"wgmma": contextlib.nullcontext, "backward_on_mma": d256_backward_on_mma}
    gemma_grad_routes = phase_gradient(
        attn, llama, train, gemma_2b(), phase="gemma2b_gradient",
        config="gemma_2b widths, 4 layers", turns=d256_turns)
    gemma_step_routes = phase_train(attn, train, moe, gemma_2b(), phase="gemma2b_train",
                                    config="gemma_2b widths", turns=d256_turns)[1]
    # OPT-1.3B's gradient and its loss's backward at all 24 layers (fp16; no
    # optimizer step, whose eps is 0 in fp16): dQ and dK/dV on their fp16
    # head-dim-64 wgmma kernels, timed in turns against both on mma
    fp16_turns = {"wgmma": contextlib.nullcontext,
                  "backward_on_mma": functools.partial(fp16_backward_on_mma, 64)}
    opt_grad_routes = phase_gradient(
        attn, llama, train, opt_1_3b(), phase="opt13b_fp16_gradient",
        config="opt_1_3b widths, fp16, 4 layers", turns=fp16_turns)
    opt_bwd_routes = phase_train(attn, train, moe, opt_1_3b(), phase="opt13b_fp16_backward",
                                 config="opt_1_3b widths, fp16", turns=fp16_turns,
                                 llama=llama)[1]
    # OpenLLaMA-3B's gradient and its loss's backward at all 26 layers in its
    # published dtype, fp16 (no optimizer step): dQ and dK/dV on their fp16
    # head-dim-100 wgmma kernels, timed in turns against both on simt
    fp16_d100_turns = {"wgmma": contextlib.nullcontext,
                       "backward_on_simt": fp16_d100_backward_on_simt}
    openllama_fp16_grad_routes = phase_gradient(
        attn, llama, train, openllama_3b_fp16(), phase="openllama3b_fp16_gradient",
        config="open_llama_3b widths, fp16, 4 layers", turns=fp16_d100_turns)
    openllama_fp16_bwd_routes = phase_train(
        attn, train, moe, openllama_3b_fp16(), phase="openllama3b_fp16_backward",
        config="open_llama_3b widths, fp16", turns=fp16_d100_turns, llama=llama)[1]
    # GPT-J-6B's gradient and its loss's backward at all 28 layers in its
    # published dtype, fp16 (no optimizer step): dQ and dK/dV on their fp16
    # head-dim-256 wgmma kernels, timed in turns against both on mma
    fp16_d256_turns = {"wgmma": contextlib.nullcontext,
                       "backward_on_mma": functools.partial(fp16_backward_on_mma, 256)}
    gptj_grad_routes = phase_gradient(
        attn, llama, train, gptj_6b(), phase="gptj6b_fp16_gradient",
        config="gpt_j_6b widths, fp16, 4 layers", turns=fp16_d256_turns)
    gptj_bwd_routes = phase_train(
        attn, train, moe, gptj_6b(), phase="gptj6b_fp16_backward",
        config="gpt_j_6b widths, fp16", turns=fp16_d256_turns, llama=llama)[1]
    # GPT-NeoX-20B's gradient and its loss's backward in its published dtype,
    # fp16 (no optimizer step), the backward at 22 of its 44 layers (44
    # layers' fp16 weights and gradients, 108.8 GB, do not fit the card): dQ
    # and dK/dV on their fp16 head-dim-96 wgmma kernels, timed in turns
    # against both on mma
    fp16_d96_turns = {"wgmma": contextlib.nullcontext,
                      "backward_on_mma": functools.partial(fp16_backward_on_mma, 96)}
    neox_grad_routes = phase_gradient(
        attn, llama, train, gpt_neox_20b(), phase="neox20b_fp16_gradient",
        config="gpt_neox_20b widths, fp16, 4 layers", turns=fp16_d96_turns)
    neox_bwd_routes = phase_train(
        attn, train, moe, gpt_neox_20b(NEOX20B_BACKWARD_LAYERS),
        phase="neox20b_fp16_backward",
        config=f"gpt_neox_20b widths, fp16, {NEOX20B_BACKWARD_LAYERS} of 44 layers "
               f"(44 layers' fp16 weights and gradients, 108.8 GB, do not fit)",
        turns=fp16_d96_turns, llama=llama)[1]
    # OPT-2.7B's gradient and its loss's backward at all 32 layers in its
    # published dtype, fp16 (no optimizer step): dQ and dK/dV on their fp16
    # head-dim-80 wgmma kernels, timed in turns against both on mma
    fp16_d80_turns = {"wgmma": contextlib.nullcontext,
                      "backward_on_mma": functools.partial(fp16_backward_on_mma, 80)}
    opt27b_grad_routes = phase_gradient(
        attn, llama, train, opt_2_7b(), phase="opt27b_fp16_gradient",
        config="opt_2_7b widths, fp16, 4 layers", turns=fp16_d80_turns)
    opt27b_bwd_routes = phase_train(
        attn, train, moe, opt_2_7b(), phase="opt27b_fp16_backward",
        config="opt_2_7b widths, fp16", turns=fp16_d80_turns, llama=llama)[1]
    free_memory()
    ring_launches = phase_ring(attn, ring, variants)
    ulysses_launches = phase_ulysses(attn, ulysses, variants)
    phase_pipeline_gradient(attn, llama, train, pipeline)
    pipe_launches = phase_pipeline_train(attn, llama, train, pipeline)
    ckpt_losses, resumed_launches = phase_checkpoint(attn, llama, train, mesh_mod,
                                                     checkpoint)
    multihost_launches = phase_multihost(attn, llama, train, mesh_mod, multihost,
                                         ckpt_losses[0])
    phase_resnet(resnet)
    telemetry_launches = phase_telemetry(attn, smi)
    phase_scheduler(smi)
    phase_gpu_fleet(smi)
    phase_bench_engine(smi)
    phase_webhook(smi)
    phase_visible(smi)

    main_row, bwd_main = rows[0], bwd_rows[0]
    d64_row = next(r for r in rows if r["shape"] == D64_SHAPE)
    d64_bwd = next(r for r in bwd_rows if r["shape"] == D64_SHAPE)
    # each kernel at head dim 64 (bench_mfu's d1024 widths): its route,
    # time, bound, share of it and the library's time there
    d64 = {"flash_fwd": {
        "kernel_route": d64_row["route"], "ms": d64_row["ms"],
        "bound_ms": d64_row["bound_ms"], "bound_by": d64_row["bound_by"],
        "share_of_bound": d64_row["share_of_bound"], "plain_ms": d64_row["plain_ms"],
        "route_turns_ms": d64_row["route_turns_ms"], "library_ms": d64_row["library_ms"],
        "sdpa": d64_row["sdpa"]}}
    for name, key in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")):
        d64[name] = {
            "kernel_route": d64_bwd["routes"][name], "ms": d64_bwd[f"{key}_ms"],
            "bound_ms": d64_bwd[f"{key}_bound_ms"], "bound_by": d64_bwd[f"{key}_bound_by"],
            "share_of_bound": d64_bwd[f"{key}_share_of_bound"],
            "plain_ms": d64_bwd["plain_ms"],
            "route_turns_ms": (d64_bwd["route_turns_ms"] or {}).get(key),
            "library_ms": d64_bwd["library_ms"], "sdpa": d64_bwd["sdpa"]}
    # each kernel at the head dims and dtype this slice added: its route,
    # time, bound, share of it, the plain version's and the library's time
    wide = {n: {} for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for row in (r for r in rows if r["shape"] in HEAD_DIM_ROWS):
        wide["flash_fwd"][row["shape"]] = {
            "d": row["d"], "dtype": row["dtype"], "kernel_route": row["route"],
            "ms": row["ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "share_of_bound": row["share_of_bound"], "plain_ms": row["plain_ms"],
            "library_ms": row["library_ms"], "sdpa": row["sdpa"]}
    for row in (r for r in bwd_rows if r["shape"] in HEAD_DIM_ROWS):
        for name, key in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")):
            wide[name][row["shape"]] = {
                "d": row["d"], "dtype": row["dtype"], "kernel_route": row["routes"][name],
                "ms": row[f"{key}_ms"], "bound_ms": row[f"{key}_bound_ms"],
                "bound_by": row[f"{key}_bound_by"],
                "share_of_bound": row[f"{key}_share_of_bound"],
                "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
                "sdpa": row["sdpa"],
                "route_turns_ms": (row["route_turns_ms"] or {}).get(key),
                "library_turns_ms": row["library_turns_ms"]}
    src = "yoda_scheduler_tpu_torch/ops/csrc/"
    kernels = {"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
        "replaces": "yoda_scheduler_tpu/ops/attention.py:68",
        "kernel_route": main_row["route"], "tflops": main_row["tflops"],
        "share_of_bound": main_row["share_of_bound"],
        "route_turns_ms": main_row["route_turns_ms"],
        "launches": step_launches["flash_fwd"],
        "launches_by_path": {"forward": fwd_launches,
                             "train_step": step_launches["flash_fwd"],
                             "sharded_train_step": sharded_launches["flash_fwd"],
                             "moe_forward": moe_fwd_launches,
                             "moe_train_step": moe_step_launches["flash_fwd"],
                             "ring_fwd_bwd": ring_launches["flash_fwd"],
                             "ulysses_fwd_bwd": ulysses_launches["flash_fwd"],
                             "pipeline_train_step": pipe_launches["flash_fwd"],
                             "checkpoint_resumed_step": resumed_launches["flash_fwd"],
                             "multihost_step": multihost_launches["flash_fwd"],
                             "telemetry_load": telemetry_launches["flash_fwd"],
                             "phi3_forward": phi3_fwd_routes,
                             "phi3_train_step": phi3_step_routes["flash_fwd"],
                             "fp16_forward": fp16_fwd_routes,
                             **new_width_routes,
                             "openllama3b_gradient": openllama_grad_routes["flash_fwd"],
                             "openllama3b_train_step": openllama_step_routes["flash_fwd"],
                             "stablelm3b_gradient": stablelm_grad_routes["flash_fwd"],
                             "stablelm3b_train_step": stablelm_step_routes["flash_fwd"],
                             "gemma2b_gradient": gemma_grad_routes["flash_fwd"],
                             "gemma2b_train_step": gemma_step_routes["flash_fwd"],
                             "opt13b_fp16_gradient": opt_grad_routes["flash_fwd"],
                             "opt13b_fp16_backward": opt_bwd_routes["flash_fwd"],
                             "openllama3b_fp16_gradient":
                                 openllama_fp16_grad_routes["flash_fwd"],
                             "openllama3b_fp16_backward":
                                 openllama_fp16_bwd_routes["flash_fwd"],
                             "gptj6b_fp16_gradient": gptj_grad_routes["flash_fwd"],
                             "gptj6b_fp16_backward": gptj_bwd_routes["flash_fwd"],
                             "neox20b_fp16_gradient": neox_grad_routes["flash_fwd"],
                             "neox20b_fp16_backward": neox_bwd_routes["flash_fwd"],
                             "opt27b_fp16_gradient": opt27b_grad_routes["flash_fwd"],
                             "opt27b_fp16_backward": opt27b_bwd_routes["flash_fwd"],
                             "tune_attention": tune_routes["flash_fwd"].get("wgmma", 0),
                             **{path: routes["flash_fwd"].get("wgmma", 0)
                                for path, routes in bench_routes.items()}},
        "tune_attention_launches_by_route": tune_routes["flash_fwd"],
        "bench_mfu_train_launches_by_route": bench_routes["bench_mfu_train"]["flash_fwd"],
        "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "head_dim_64": d64["flash_fwd"],
        "head_dims": wide["flash_fwd"]}] + [{
        "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
        "replaces": f"yoda_scheduler_tpu/ops/attention.py:{line}",
        "kernel_route": bwd_main["routes"][name], "tflops": bwd_main[f"{key}_tflops"],
        "share_of_bound": bwd_main[f"{key}_share_of_bound"],
        "route_turns_ms": bwd_main["route_turns_ms"][key],
        "launches": step_launches[name],
        "launches_by_path": {"train_step": step_launches[name],
                             "sharded_train_step": sharded_launches[name],
                             "moe_train_step": moe_step_launches[name],
                             "ring_fwd_bwd": ring_launches[name],
                             "ulysses_fwd_bwd": ulysses_launches[name],
                             "pipeline_train_step": pipe_launches[name],
                             "checkpoint_resumed_step": resumed_launches[name],
                             "multihost_step": multihost_launches[name],
                             "phi3_train_step": phi3_step_routes[name],
                             "fp16_gradient": fp16_grad_routes[name],
                             "openllama3b_gradient": openllama_grad_routes[name],
                             "openllama3b_train_step": openllama_step_routes[name],
                             "stablelm3b_gradient": stablelm_grad_routes[name],
                             "stablelm3b_train_step": stablelm_step_routes[name],
                             "gemma2b_gradient": gemma_grad_routes[name],
                             "gemma2b_train_step": gemma_step_routes[name],
                             "opt13b_fp16_gradient": opt_grad_routes[name],
                             "opt13b_fp16_backward": opt_bwd_routes[name],
                             "openllama3b_fp16_gradient": openllama_fp16_grad_routes[name],
                             "openllama3b_fp16_backward": openllama_fp16_bwd_routes[name],
                             "gptj6b_fp16_gradient": gptj_grad_routes[name],
                             "gptj6b_fp16_backward": gptj_bwd_routes[name],
                             "neox20b_fp16_gradient": neox_grad_routes[name],
                             "neox20b_fp16_backward": neox_bwd_routes[name],
                             "opt27b_fp16_gradient": opt27b_grad_routes[name],
                             "opt27b_fp16_backward": opt27b_bwd_routes[name],
                             "tune_attention": tune_routes[name].get("wgmma", 0),
                             **{path: routes[name].get("wgmma", 0)
                                for path, routes in bench_routes.items()
                                if path != "bench_generate_no_cache"}},
        "tune_attention_launches_by_route": tune_routes[name],
        "bench_mfu_train_launches_by_route": bench_routes["bench_mfu_train"][name],
        "max_abs_err": bwd_err[key], "ms": bwd_main[f"{key}_ms"],
        "plain_ms": bwd_main["plain_ms"], "bound_ms": bwd_main[f"{key}_bound_ms"],
        "bound_by": bwd_main[f"{key}_bound_by"],
        "library_ms": bwd_main["library_ms"], "head_dim_64": d64[name],
        "head_dims": wide[name]}
        for name, key, line in (("flash_bwd_dq", "dq", 219),
                                ("flash_bwd_dkv", "dkv", 270))]}
    RESULTS["kernels"] = kernels
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
