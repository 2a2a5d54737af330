#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and
check it.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure makes the exit code nonzero:

1. the card (``nvidia-smi`` name and power limit); build the Hopper
   kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all in parallel) and time the build; ptxas's registers and
   spills per kernel, and the ``HGMMA`` instructions in each K7 kernel's
   SASS and in K8's (``cuobjdump -sass``: nonzero in each of the twelve
   K7 kernels, bf16 and float32 at each tile width pair, (64, 64), (96,
   96), (128, 128), (256, 256), MLA's (192, 128) and (192, 192), in K8's
   two bf16 kernels, N 64 and 128, and in its float32 kernel, which takes
   both, with no spills in any of them); each width pair of
   ``WIDTH_PAIRS`` and each K8 width in each dtype runs on one of those
   instances (hd 80 on the hd-96 one, printed per pair with its HGMMA
   count); each ``launch_plan``'s shared memory equals what its kernel
   asks for, hd 80's and (192, 128)'s included, and so do the VJPs'
   plans (K7's dQ and dK/dV kernels at every pair, K8's at its widths);
2. each forward kernel (K1 gather-scale-segment-sum, K2 segment-sum, K3
   GAT attention) at the full-width shapes of the GraphSAGE-Reddit
   serving path plus edge cases: max abs error against its plain PyTorch
   version (bound 1e-4 · max|plain|), bitwise repeatability, and the
   median over 25 timed launches (CUDA events around one launch queued
   behind a device sleep, L2 flushed before each) of the kernel, the
   plain version and, where one PyTorch call computes the same function,
   that call; beside the least time the card could take (bytes over
   3.35 TB/s, or flops over 67 TFLOP/s fp32) and, for K1, K3 and K4,
   the gather bound (every listed edge's row, the output and the indices
   over 3.35 TB/s: what a graph whose sources lie anywhere allows);
3. serve GraphSAGE at Reddit's widths (602 → 256 → 41, fanouts 10/25,
   232 965 nodes) through ``repro_torch.launch.serve_gnn``: 128
   requests, throughput, p50/p99, the sample/forward span split; K1 must
   launch twice per forward; one bucket-64 batch of SAGE, GIN and GAT
   each on the card agrees with the CPU to 1e-4; ``torch.profiler``
   splits one SAGE forward's device time by kernel and copy;
4. serve GIN (602 → 256 → 41) and GAT (602 → 256 → 40: its output layer
   splits the classes over 4 heads, and 41 does not split) at Reddit's
   widths and fanouts, 64 requests each; each forward launches exactly
   its kernels (GIN: K2 twice and K5, its Scatter, twice; GAT: K3
   twice);
5. the training kernels at every shape the full-batch trainers feed
   them, checked and timed as in phase 2, over the whole graph: K1 (F
   602, 256, 41) and its transpose over the src-grouped layout (F 256,
   41, and 4 heads x 64 and x 10 with the column it also sums in GAT's
   VJP), K2 (602, 256; either layout), K5 (602 wide over the src layout,
   as GIN's Scatter walks it, and over the dst layout; 256 wide), K3 (4 x
   64, 4 x 10) and K6 (1 x 256, the single-head dcoef; 4 x 64 and 4 x
   10) on GAT's 40-class graph, each K6 case with a gather bound beside
   its byte bound; the dcoef path of the reference's ``_fused_bwd``: K1's
   Function over the whole graph with a coefficient that requires grad,
   exactly one K1 and one K6 launch, dcoef against the CPU within 1e-4;
   K4 on the int8 rows of a batch-1024
   block, K3's VJP (its destination pass, then K1 over the src layout)
   at both layers; and each autograd Function's gradients (K1, K2, the
   Scatter gather, K3) against autograd through the plain versions;
6. full-batch training at Reddit's widths through
   ``repro_torch.launch.train_gnn``: GCN, SAGE, GIN (602 → 256 → 41) and
   GAT (→ 40), ``TRAIN_EPOCHS`` (5) epochs each: the loss is finite and
   falls, every step
   launches exactly the kernels of its design and nothing plain, a second
   run from the same init ends in bitwise-equal parameters, one step's
   gradients on the card agree with the same step on the CPU (in
   float64) to 1e-4 of the model's largest gradient; ms per epoch, peak
   device memory, a ``torch.profiler`` split of one GCN step and of one
   GAT step by kernel, matrix product and copy (alone in a profiling
   session, and after a profiled warm-up step), and CUDA-event times of
   GCN's two large products;
7. mini-batch GraphSAGE at Reddit's widths: ``--batch 1024 --epochs 1
   --cache degree`` with ``--wire-codec fp32`` and then ``int8
   --use-kernel``, each for 30 of the epoch's 227 steps (``train_gnn.run``'s
   ``steps_per_epoch``; wire rows into K4); K4 launches once per int8
   step and never under fp32; step time, cache hit ratio, fetched MiB and the loss trend;
11. (run after phase 7) locality reordering, the dataset registry, the
   importance and layer-wise samplers and a changing graph, at Reddit's
   widths: (a) for each reorder policy (none, degree, bfs, rcm) the 41-
   and 40-class graphs packed (host seconds, ``locality_report``), then
   phase 5's whole-graph cases of K1 (602, 256, 41), K1ᵀ (256), K3 and
   its VJP (4 x 64) and K5 (602, src layout) on them, checked and timed
   as in phase 5, one line a policy beside phase 5's times; (b)
   full-batch SAGE under ``--reorder bfs`` and GAT under ``rcm``: phase 6's
   launches, each epoch's loss within 1e-4 (relative) of phase 6's, and
   phase 6's predictions but for near ties; (c) SAGE served under
   ``--reorder bfs``: every request answered in the workload's original
   ids, K1 twice a forward; (d) SAGE served with ``--update-stream`` (a
   stream of 1 000 synthesized events written to ``chiprun_out/``): every
   event folded, then the updated server against a cold one built on the
   folded graph within 1e-5; (e) mini-batch SAGE with ``--sampler
   importance`` (over 6 batches of nodes), ``fastgcn`` and
   ``ladies`` (``MB_STEPS`` steps each): falling loss, K1's launches as phase 7's
   fp32 run, K1's plan searches and host time a launch; (f) ``train_gnn
   --dataset pubmed-like`` (GCN) and ``serve_gnn --dataset reddit-like``
   (SAGE);
12. (run after phase 11) phase 3's SAGE served through the replicated
   tier (``serve_gnn --replicas``, ``repro_torch.serving.ReplicaRouter``):
   (a) 2 replicas under ``least_queue`` and ``round_robin``, 256 requests
   at 2 000 req/s, then 32 of the nodes phase 3 served asked of the same
   router, within 1e-5 of phase 3's largest logit; (b) ``--replicas 1
   --autoscale --rate 8000``, 512 requests: at least one scale-up; (c)
   ``--hot-swap-every 64 --ckpt-dir`` then a second run resuming the
   saved version, the restored weights bitwise equal to the saved ones
   and 32 nodes' answers under them bitwise equal; (d) ``--update-stream``
   on phase 11(d)'s stream, every event folded, a replica against a cold
   server on the folded graph within 1e-5.  In every run: zero drops and
   torn batches, K1 twice a forward across the fleet (warmups and reaped
   replicas included); req/s, p50 and p99 are virtual-clock numbers (the
   replicas run one after another on the card, so N replicas model N
   cards);
8. K7 (flash attention) and K8 (the Mamba2 SSD chunk state) against their
   plain versions, checked and timed as in phase 2 (K7's bf16 outputs,
   from the tensor-core route, element by element within one bf16 ulp
   of the plain value, 2**-7 of it, plus 2**-8 of the plain version on
   |v| for P rounded to bf16, plus 1e-5 of the largest, with the worst
   excess over the bound without the P term printed beside; bound by
   bytes or by flops over the tensor-core peak of the inputs' type, 989
   TFLOP/s in bf16, 495 TFLOP/s in TF32 for float32; the
   library yardsticks are ``scaled_dot_product_attention`` and the
   reference's einsum): first hd 64, 96, 128 and 256, a non-causal call
   and a window of 40, and hd 80 (Zamba2-2.7B's heads, on the hd-96
   tiles) causal, non-causal and with a window of 40 (untimed), then K7
   at Phi-3-mini's prefill (8 x 1024, 32 x 96, causal) in bf16 and
   float32 (the TF32 split route),
   with G 5 at hd 128, a window of 256, Sq < Skv and Sq 1, each also in
   float32 (1e-4 of the largest value), and at phase 13's three prefill
   shapes (8 x 1024: Qwen2.5-14B 40 / 8 x 128, Gemma-7B 16 / 16 x 256,
   GLM-4-9B 32 / 2 x 128; timed in bf16, checked in float32), and at
   Zamba2-2.7B's (8 x 1024, 32 / 32 x 80, timed in both dtypes, its
   bound counting 80 columns); K8 at Mamba2-780m's prefill (32
   chunks of 256, 48 x 64, N 128) in bf16 (the tensor-core route, 1e-4
   of the largest value) with G 1 and 2 and in float32 (the TF32
   tensor-core route), and in both dtypes at ragged chunks of 100 and 7
   positions and over 160 chunks; K8 at Zamba2-2.7B's widths (80 x 64, N
   64: the bf16 route's N 64 kernel; the float32 route), timed in both
   dtypes; float32 (8 x 32, N 24, timed) and bf16 (the reduced configs'
   8 x 32, N 16, chunk 16, timed; a chunk of 300) off the tensor-core
   tile on the CUDA-core route, each case's route printed and every
   launch counted under its route's counter; the calls K7 does not
   compute raise on the card; the raw K7 and K8 wrappers refuse an input
   that requires grad (naming their autograd Functions), which ``ops``
   runs instead, and under no_grad ``ops`` runs the forward alone;
9. serve Phi-3-mini-3.8B at its published widths in bf16: (a) the
   serving launcher ``repro_torch.launch.serve`` (8 x 16 prompt tokens
   through the decode-only loop, 16 generated), tok/s and peak memory, no
   K7 launch; (b) ``prefill`` of 8 x 1024 tokens and 8 decode steps in
   its cache (grown by 32 slots), exactly 32 K7 launches (bf16 route;
   the float32 prefill below, 32 of the float32 route), finite logits,
   prefill against the decode-only loop at full depth over the prompts'
   first 64 (Phi-3) or 128 (Mamba2) positions (``LM_CMP_BY_ARCH``,
   through a prefill of that
   length) in float32 (two prompts, within 1e-3 of the largest logit;
   Mamba2 3e-3) and in bf16 (all 8, RMS ratio bound), prefill and
   decode tok/s, peak memory; (c)
   a ``torch.profiler`` split of one prefill and of one decode step (K7,
   matrix products, elementwise work) as the active step after a
   profiled warm-up step; (d) a 2-layer float32 cut at full width on the
   card and on the CPU: forward, prefill and decode logits within 1e-4
   of the largest;
10. serve Mamba2-780m the same way, with exactly 48 K8 launches per
   prefill (bf16 route; its float32 prefill, 48 of the float32 route);
13. serve Qwen2.5-14B, Gemma-7B and GLM-4-9B one after another (each
   freed before the next) at their published widths and full depth in
   bf16, random weights: a prefill of 8 x 1024 with exactly one K7 launch
   (bf16 route) a layer, 8 decode steps in its grown cache, finite
   logits, tok/s and peak memory; float32 prefill against the decode-only
   loop over 2 x 128 tokens on a 4-layer cut at full width (1e-3 of the
   largest logit, K7's float32 route once a layer); a 2-layer float32 cut
   on the card and the CPU as in 9(d).  Full depth in float32 is left
   out: Qwen2.5-14B's float32 weights (about 59 GB) do not fit beside
   the rest;
15. (run after 13, before 14) serve Zamba2-2.7B (the hybrid family: 54
   Mamba2 layers in 9 groups of 6, each followed by one shared attention
   block with heads 80 wide) at its published widths: (a) float32 on a
   12-layer cut (two groups) through ``launch/prefill_gap.py --layers
   12``: prefill against the decode-only loop over 2 x 512 tokens within
   3e-3 of the largest logit (Mamba2's bound; the reference's own two
   paths at a CPU-sized cut printed beside), exactly 12 launches of K8's
   float32 route and 2 of K7's, and its ``--flip`` control above the
   bound; (b) bf16 at full depth, random weights: a prefill of 8 x 1024
   with exactly 54 K8 launches (bf16 route: the N 64 tensor-core kernel)
   and 9 K7 launches (bf16 route at hd 80), 8 decode steps in its grown
   nested cache launching neither, finite logits, tok/s and peak memory;
   (c) a 2-layer float32 cut with ``attn_every`` 1 (two applications of
   the shared block) on the card and the CPU as in 9(d);
16. (run after 15, before 17) serve Granite-MoE-1B-A400M (the moe family:
   24 layers, d 1024, 16 / 8 x 64 heads, 32 experts, top 8, GShard
   capacity factor 1.25) at its published widths: (a) the serving
   launcher's decode-only loop, 8 x 16 prompt tokens + 16, no K7 launch;
   (b) bf16 at full depth, random weights: a prefill of 8 x 1024 with
   exactly 24 K7 launches (bf16 route), 8 decode steps in its grown
   cache launching none, finite logits, tok/s and peak memory; (c)
   float32 on a 6-layer cut through ``launch/prefill_gap.py --layers 6
   --capacity-factor 8.0`` (drop-free on both sides) over 2 x 128 tokens
   within 1e-3 of the largest logit, K7's float32 route once a layer,
   its ``--flip`` control above the bound; (d) ``torch.profiler`` splits
   of one prefill and one decode step by the moe module's functions
   (router, dispatch, expert products, combine) and kernel kind; (e) a
   2-layer float32 cut at factor 1.25 on the card and the CPU as in 9(d),
   the card routing by the CPU's expert choices (``ForcedRoutes``), and
   every token whose own choice on the card differs (a flip) within the
   two sides' router-logit difference of a tie; (f) (inside phase 14's
   world) one Granite MoE block at full width, 8 x 1024 tokens in
   float32, through
   ``core/parallel.moe_expert_parallel`` with 8 experts a rank: within
   1e-5 of the single card's ``moe_block_gathered``, every rank's output
   bitwise equal, ms and bytes a rank;
18. (run after 16, before 17) serve DeepSeek-V3 (the mla_moe family:
   MLA with q_lora 1536, kv_lora 512, 128 heads of q/k 192 = 128 + 64
   rotary and v 128; 256 experts of width 2 048, top 8, one shared
   expert; the first 3 layers dense, FFN 18 432; vocab 129 280) at its
   published widths: (a) K7 at (192, 128) against its plain version in
   bf16 (element by element, as phase 8) and float32 (1e-4 of the
   largest value) at the prefill shape (8 x 1024, 128 / 128 heads,
   causal), Sq 64 against Skv 1056 and a window of 256, each timed beside
   its bound and ``scaled_dot_product_attention``'s time (the backend it
   picks named from its kernels), and at small ragged shapes; (b) bf16 on
   a cut of the 3 dense and 2 MoE layers (5 of 61, about 53 GB; the
   published depth does not fit a card), weights drawn on the card: a
   prefill of 8 x 1024 at factor 1.25 with exactly one K7 launch (bf16
   route) a layer, 8 decode steps (the absorbed latent attention) in its
   grown latent cache launching none, tok/s and peak memory, and a
   ``torch.profiler`` split of the prefill (MLA projections, K7, the
   moe module's functions, the rest); (c) float32 prefill against the
   decode-only loop through ``launch/prefill_gap.py --layers 2`` (1 dense
   + 1 MoE layer) over 2 x 128 tokens at the drop-free factor 32, within
   1e-3 of the largest logit, K7's float32 route once a layer, its
   ``--flip`` control (the last token changed) above 0.1; (d) the first
   dense MLA block at full
   width in float32 (weights drawn on the CPU), 1 x 256 tokens, on the
   card and the CPU within 1e-4 of the largest output; (e) the serving
   launcher's decode-only loop at ``--reduced``, no K7 launch;
19. (run after 18, before 17) serve Whisper-tiny (the encdec family: 4
   encoder + 4 decoder layers, d 384, 6 / 6 x 64 heads, LayerNorm, GELU,
   learned positions) and Qwen2-VL-7B (the vlm family: 28 layers, d
   3584, 28 / 4 x 128, M-RoPE sections (16, 24, 24)) at their published
   widths, their frontends stubbed as in the reference: (a) K7 against
   its plain version in bf16 (element by element) and float32 (1e-4 of
   the largest value) at Whisper's encoder (8 x 1500 frames, non-causal),
   its cross attention from a 224-token prompt and from one decode token
   (Sq 224 and 1 against Skv 1500, non-causal, q_offset 0) and Qwen2-VL's
   prefill (8 x 1024, causal), each timed beside its bound and SDPA's
   time; (b) Whisper-tiny in bf16, 1 500 frame embeddings (its 30-s
   window after the conv stem) and a 224-token prompt, B 8: exactly 12
   K7 launches a prefill (4 encoder, 4 causal decoder, 4 cross), then 32
   decode steps in its grown self cache (the cross cache kept) with
   exactly 4 K7 launches each (cross attention), finite logits, tok/s,
   peak memory, cache bytes; (c) Qwen2-VL-7B in bf16 at full depth (~7.6
   B parameters), 8 x 1024 embeddings at Qwen2-VL's M-RoPE image layout
   (128 text, a 24 x 32 grid of merged patches, 128 text): exactly 28 K7
   launches a prefill, 8 decode steps on the generated tokens'
   embeddings launching none, a ``torch.profiler`` split of the prefill
   by kind; (d) float32 prefill against the decode-only loop through
   ``launch/prefill_gap.py`` over 2 x 128 positions (Whisper at full
   depth with 1 500 frames, its loop's cross cache from a prefill over
   the first token; Qwen2-VL on a 4-layer cut at text-style positions),
   within 1e-3 of the largest logit, K7's float32 route the expected
   number of times, the ``--flip`` control (the last position changed)
   above 100x the gap and the bound; (e) Whisper's first encoder block,
   its first decoder block (self and cross attention) and Qwen2-VL's
   first block under the image layout, float32, card against CPU within
   1e-4 of the largest output;
20. (run after 19, before 17) the transformer trainer
   (``repro_torch.launch.train``) with K7's and K8's VJPs
   (``csrc/flash_attention_bwd.cu``, ``csrc/ssd_chunk_bwd.cu``): (a)
   K7 with lse written against lse null at every width pair in both
   dtypes (outputs bitwise equal, lse within 1e-4), K7's forward at
   (192, 192) timed, then the ``FlashAttention`` Function's gradients
   (K7 with lse, the dQ kernel, the dK/dV kernel) against autograd
   through the plain version at every width pair in bf16 (element by
   element: one bf16 ulp plus the term the bf16 output's D moves, plus
   1e-5 of the largest) and float32 (1e-4 of the largest), at the
   training shapes (Qwen2.5-14B 4 x 1024, 40 / 8 x 128; Granite's hd 64,
   Zamba2's hd 80, Phi-3's 96, Gemma's 256, (192, 192), (192, 128);
   timed, each kernel and the pair, beside their bounds, the plain VJP
   and SDPA's backward), a window of 256, non-causal 64 x 64, Whisper's
   224 x 1500 cross attention and ragged tiles; ``SSDChunkState``'s
   (dx, ddt, dA, dBm) at Mamba2's, Zamba2's and the reduced widths,
   G 2 and a ragged chunk, against autograd through the plain version
   on float32 leaves; every VJP bitwise repeatable; (b) Qwen2.5-14B at
   full width on a 4-layer cut, B 4 x S 1024, 6 steps: exactly 4 K7
   launches and 4 of each backward kernel a step, finite losses and grad
   norms, the loss falling, ms a step, tok/s, peak memory, a profile
   split; (c) Mamba2-780m at full depth, B 2 x S 1024, 4 steps: exactly
   48 K8 and 48 K8-VJP launches a step, the rest as (b); (d) one step each of
   Phi-3-mini, Gemma-7B, GLM-4-9B, Granite-MoE (2-layer cuts) and
   Zamba2-2.7B (6 layers) at full width with exact K7 / K8 and VJP
   launches; (e) every trained family's reduced config, float32, card
   against CPU: losses and gradients under AdamW, parameters after 3
   SGD steps, within 1e-4; (f) ``train_lm_100m`` (100 steps; its loss
   falls, the unigram-entropy floor beside) and ``whisper_vlm_smoke``.
   The launcher and the examples train without per-layer recompute, as
   the reference's do (``remat=False``); (e) calls ``make_train_step``
   with its default, the reference's ``remat=True``, so there each layer
   runs its forward again in the backward, K7 and K8 included;
21. (started after 20; its children run side by side with 17's, and
   it ends after 17, before 14) the sharding-plan dry run
   (``repro_torch.launch.dryrun``) in two child processes, each with a
   time limit: Whisper-tiny x ``train_4k`` and DeepSeek-V3 x
   ``train_4k`` on the 16x16 mesh over a fake process group, one line a
   combination (per-device bytes, FLOPs, collective bytes, the dominant
   roofline term; plan estimates against the H100's datasheet, not
   times); each must report ``OK``, each child must report
   ``torch.cuda.is_initialized()`` false, and this process's
   ``torch.cuda.memory_allocated()`` and ``max_memory_allocated()`` must
   not move from 21's start to its end (17 runs child processes only);
22. (started with 21's children, ended after 21, before 14) the port's
   linter over the port: ``python -m repro_torch.analysis --json`` in a
   child process (it reads sources only: no card, no kernel build), which
   must exit 0 with no finding; the ``.py`` and ``.cu`` / ``.cuh`` files
   it checked, its justified suppressions and its seconds; then, on the
   card, each raw kernel wrapper (K1-K8 and the VJPs of K3, K7 and K8)
   given a CUDA input that requires grad, grad enabled, raises
   ``NotImplementedError`` naming its autograd Function (or saying that
   nothing differentiates it) and launches nothing;
17. (run inside 21, before 14) the port's four examples as ``python -m
   repro_torch.examples.<name>`` on the card, each exiting 0, with their
   seconds (``serve_batched``, ``serve_gnn`` and ``quickstart`` side by
   side, then ``distributed_gnn``: three runs in a world of 8 ranks,
   three in a world of 4);
14. (run last) distributed full-graph GCN at Reddit's widths (602 → 256
   → 41, hash partitioner) with 4 ranks sharing the card: one spawned
   world (``train_gnn.run_world``: gloo, CUDA tensors staged through
   pinned host buffers) runs every job in turn: (a) ``--devices 4 --mode
   pull`` (twice: bitwise equal), ``push``, ``stale`` and ``hysync`` (S 3),
   ``TRAIN_EPOCHS`` AdamW epochs each: pull against phase 6's GCN, the other modes
   against pull (the first 4 losses within 1e-4, the parameters within
   ``DIST_ADAMW_PARAM_TOL``), beside float32's own error (phase 6's run
   and pull against the same GCN in float64 through the plain versions
   on the card) and two wrong paths (pull with its gathered rows in
   bf16, pull without one rank's gradient), which must exceed the
   bound; every synchronous mode and async S 0 under 5 SGD steps
   against the card's single-card GCN within 1e-5; every rank's
   parameters bitwise equal; (b) every rank launches K1 and K1ᵀ exactly
   once an epoch each at 256 and at 41 columns (the wrapper counts by
   width), nothing else (rank 0 one K1 more at each width for
   ``--fullgraph``'s accuracy); (c) ``parameter_server_update`` against
   ``allreduce_update`` within 1e-5; (d) ``--fullgraph`` at S 0, 1, 4
   (fp32) and S 1 (int8): bytes per step fall with S, int8 moves
   at most 0.35 of fp32's within 5 % of its loss, every rank's ghost
   planes bitwise equal; phase 11(d)'s 1 000 events folded over 5
   epochs; (e) ms an epoch split into the collectives (staging + gloo
   wait) and the rest, CUDA-event spans, bytes a rank an epoch; K1 and
   K1ᵀ at rank 0's pull (N_pad → n_local) and push (n_local → N_pad)
   shapes against their bounds and ``torch.sparse.mm``.

The last lines are the card's ``nvidia-smi`` line, one
``{"kernels": [...]}`` JSON line, and
``{"ok": true, "device": {...}}``.  Exits nonzero, printing no result,
when CUDA is not available.  A deadline (``DEADLINE_S``, below the
1 200 s a run may take) stops a run that overruns or hangs: it prints
the phase in progress, the seconds of every phase so far and every
thread's stack, stops the processes the run started and exits nonzero
(``arm_deadline``).
"""
from __future__ import annotations

import faulthandler
import functools
import json
import os
import re
import shutil
import subprocess
import signal
import sys
import threading
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12           # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12          # TF32 tensor cores, dense
# launches a timed median takes (cut from 25 to 7 for the 900 s budget,
# PERF.md section 7)
REPS = 7
# GraphSAGE at Reddit's published widths (Hamilton et al. 2017 regime,
# hidden 256 as in PyG's examples/reddit.py); fanouts innermost first
NODES, CLASSES, FEAT, HIDDEN, FANOUTS = 232965, 41, 602, 256, (10, 25)
BUCKET = 64
# GAT reshapes its output layer's classes into 4 heads: 40 is the class
# count nearest Reddit's 41 that splits (4 x 10)
GAT_HEADS, GAT_CLASSES = 4, 40
# each served path: (arch, classes, its kernel launches per forward)
SERVED = (("sage", CLASSES, {"gather_scale_segment_sum": 2}),
          ("gin", CLASSES, {"segment_sum": 2, "gather_rows": 2}),
          ("gat", GAT_CLASSES, {"gat_attention": 2}))
# full-batch epochs: phase 6's runs and everything held to them (11b's
# packed runs, 14's distributed modes, faults, P3 and mini-batch parity
# runs); cut from 10 to 5 for time (PERF.md section 7)
TRAIN_EPOCHS = 5
# the kernel launches of one full-batch training step (2 layers), by
# design: a backward runs only what needs_input_grad asks for (layer 0's
# input features carry no gradient, so SAGE and GIN skip that transpose)
STEP_LAUNCHES = {
    "gcn": {"gather_scale_segment_sum": 2, "gather_scale_segment_sum_t": 2},
    "sage": {"gather_scale_segment_sum": 2, "gather_scale_segment_sum_t": 1},
    "gin": {"gather_rows": 3, "segment_sum": 3},
    "gat": {"gat_attention": 2, "gat_attention_backward": 2,
            "gather_scale_segment_sum_t": 2},
}
# the launches of the forward that measures the final accuracy
EVAL_LAUNCHES = {"gcn": {"gather_scale_segment_sum": 2},
                 "sage": {"gather_scale_segment_sum": 2},
                 "gin": {"gather_rows": 2, "segment_sum": 2},
                 "gat": {"gat_attention": 2}}
MB_BATCH = 1024
# phase 7's runs and phase 11(e)'s layer-wise samplers: a fixed number of
# steps (reduced from the epoch's 227 for time: int8's steps are 0.37-0.46
# s of host encoding; cut to 60, then 40, then 30 as phases 16-18 came,
# then 15 for phase 20, then 10, PERF.md section 7): the mean of the last
# 5 losses still falls below that of the first 5
MB_STEPS = 10

failures: list = []
# seconds each phase took, by name (written to chiprun_out/chip_smoke.json
# and printed before the last lines)
PHASE_SECONDS: dict = {}
# the script's start, for its seconds outside the phases (start-up, the
# graphs between phases)
T_START = time.perf_counter()
# the phases in progress, outermost first, with their start times: what
# the deadline names when it fires
CURRENT_PHASE: list = []
# a run stops itself this many seconds after main() starts, below the
# 1 200 s it may take; the stack dump without the GIL follows
# DEADLINE_BACKSTOP_S later (a thread blocked in a CUDA call holding it)
DEADLINE_S = 1120.0
DEADLINE_BACKSTOP_S = 15.0
# phase 6's trained SAGE and GAT with their graphs: phase 11b compares
# the packed runs' predictions with them
TRAINED: dict = {}
# phase 3's cached run's logits by node: phase 12a asks the router for
# the same nodes
PHASE3_LOGITS: dict = {}


def phase(name):
    """Run one phase; record (not swallow) its failure so later phases
    still report, and the run still exits nonzero."""
    def wrap(fn):
        def run(*a, **kw):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            CURRENT_PHASE.append((name, t0))
            try:
                return fn(*a, **kw)
            except Exception:
                failures.append(name)
                traceback.print_exc()
                print(f"FAILED: {name}", flush=True)
                return None
            finally:
                CURRENT_PHASE.remove((name, t0))
                secs = time.perf_counter() - t0
                PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + secs
                print(f"   ({secs:.1f} s)", flush=True)
        return run
    return wrap


def _child_pids(pid: int) -> list:
    """Every descendant of ``pid``, children first, from /proc (empty
    where the kernel lists no children)."""
    out = []
    try:
        tasks = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tasks:
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                kids = [int(c) for c in f.read().split()]
        except (OSError, ValueError):
            continue
        for c in kids:
            out.append(c)
            out.extend(_child_pids(c))
    return out


def _deadline_fired(seconds: float) -> None:
    """The deadline: name the phase in progress and the seconds so far,
    dump every thread's stack, kill the processes this run started, and
    exit nonzero without the result lines."""
    now = time.perf_counter()
    running = [f"{name} ({now - t0:.1f} s in)" for name, t0 in CURRENT_PHASE]
    print(f"DEADLINE: chip_smoke.py ran out of its {seconds:.0f} s; phase in "
          f"progress: {'; '.join(running) or 'none (between phases)'}",
          flush=True)
    print("phase seconds so far: " + json.dumps(
        {k.split(" ")[0]: round(v, 1) for k, v in PHASE_SECONDS.items()}),
        flush=True)
    faulthandler.dump_traceback(file=sys.stdout, all_threads=True)
    sys.stdout.flush()
    for pid in _child_pids(os.getpid()):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    os._exit(1)


def arm_deadline(seconds: float = DEADLINE_S,
                 backstop: float = DEADLINE_BACKSTOP_S):
    """Stop the run ``seconds`` from now (``_deadline_fired``, on a timer
    thread); ``backstop`` seconds later faulthandler dumps every stack and
    exits nonzero on its own thread, without the GIL, in case a thread
    holds it in a call that never returns.  Returns the timer (``cancel``
    it, and ``faulthandler.cancel_dump_traceback_later()``, to disarm)."""
    timer = threading.Timer(seconds, _deadline_fired, args=(seconds,))
    timer.daemon = True
    timer.start()
    faulthandler.dump_traceback_later(seconds + backstop, exit=True,
                                      file=sys.stdout)
    return timer


def require(ok: bool, what: str) -> None:
    """A check of the run (not an ``assert``: it holds under -O too)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and checking helpers
# ---------------------------------------------------------------------------

def median_ms(torch, fn, flush) -> float:
    """Median device time of one call, L2 cold.  A ~1 ms device sleep
    queued before the start event keeps the card busy while the host
    enqueues the call, so host launch overhead stays out of the reading
    (a call that synchronises inside still shows its idle gaps)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_: float, flops: float, peak: float = FP32_FLOPS_PER_S
          ) -> tuple:
    """The least time for the work: bytes over the memory rate or flops
    over ``peak`` (the card's rate for the inputs' type), the larger."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_case(torch, label, kernel, plain, args, *, timed=False,
               library=None, bytes_=0.0, flops=0.0, flush=None, rel=1e-4,
               elem_rel=None, elem_abs=None, peak=FP32_FLOPS_PER_S,
               gather_bytes=None):
    """Kernel vs plain on the same inputs: the max abs error within
    ``rel`` of the plain version's largest value, or, with ``elem_rel``,
    each element within ``elem_rel`` of its plain value plus its own
    ``elem_abs`` (a tensor of the output's shape) plus ``rel`` of the
    largest; optionally timed.  ``gather_bytes``, for a gather over a
    layout, are the bytes of every listed edge's row (not only the
    distinct ones) plus the output and the indices: over 3.35 TB/s they
    give ``gather_bound_ms``, the rate a scattered graph allows.  Returns
    the measurement dict and records a failure on disagreement."""
    out1 = kernel(*args)
    out2 = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    diff = (out1.float() - ref.float()).abs()
    err = diff.max().item() if ref.numel() else 0.0
    scale = ref.float().abs().max().item() if ref.numel() else 0.0
    excess_without_abs = None
    if elem_rel is not None and ref.numel():
        # how far the worst element lies outside its own bound
        over = diff - elem_rel * ref.float().abs()
        if elem_abs is not None:
            excess_without_abs = max(over.max().item(), 0.0)
            over = over - elem_abs
        err = max(over.max().item(), 0.0)
    bitwise = torch.equal(out1, out2)
    finite = bool(torch.isfinite(out1).all())
    ok = finite and bitwise and err <= rel * scale
    res = {"case": label, "shape": list(out1.shape),
           "max_abs_err": diff.max().item() if ref.numel() else 0.0,
           "max_abs_ref": scale, "bound_rel": rel,
           "bitwise_repeatable": bitwise, "ok": ok}
    if elem_rel is not None:
        res["bound_elem_rel"] = elem_rel
        res["max_excess"] = err
    if excess_without_abs is not None:
        res["max_excess_without_elem_abs"] = excess_without_abs
    if timed:
        res["ms"] = median_ms(torch, lambda: kernel(*args), flush)
        res["plain_ms"] = median_ms(torch, lambda: plain(*args), flush)
        res["library_ms"] = (median_ms(torch, library, flush)
                             if library is not None else None)
        res["bound_ms"], res["bound_by"] = bound(bytes_, flops, peak)
        if gather_bytes is not None:
            res["gather_bound_ms"] = gather_bytes / HBM_BYTES_PER_S * 1e3
    print("   " + json.dumps(res), flush=True)
    if not ok:
        failures.append(f"{label}: err {err} (max|ref| {scale}, "
                        f"elementwise {elem_rel}), "
                        f"bitwise {bitwise}, finite {finite}")
    return res


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def kernel_name(mangled: str) -> str:
    """``flash_fwd_wgmma_kernel[96]`` for a mangled kernel name: the
    last of its nested names (read length by length, so a name may hold
    digits, as ``flash_fwd_tf32_kernel`` does) and its integer template
    arguments."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") \
        else 0
    name = None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if not name or not name.endswith("_kernel"):
        return mangled
    args = re.findall(r"Li(\d+)E", mangled[i:]) if mangled[i:i + 1] == "I" \
        else []
    # a leading type argument (bf16 or float32) names the instance too
    if mangled[i:i + 1] == "I":
        first = mangled[i + 1:]
        dtype = ("bf16" if first.startswith("13__nv_bfloat16") else
                 "f32" if first.startswith("f") else None)
        args = ([dtype] if dtype else []) + args
    return name + (f"[{','.join(args)}]" if args else "")


def sass_counts(path, opcode: str) -> dict:
    """Instructions of SASS opcode ``opcode`` (any modifiers), per kernel
    of a built library (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            counts[fn] = 0
        elif fn and re.search(r"\b" + opcode + r"\b", line):
            counts[fn] += 1
    return counts


@phase("1. card and kernel build")
def phase_build(torch, results):
    from repro_torch.kernels import build
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    out_dir, seconds, logs, nvcc_seconds = build.build()
    print(f"   kernels built in {seconds:.1f} s -> {out_dir}")
    # each source's nvcc in parallel: the build takes the slowest one's
    print("   nvcc seconds per library: " + json.dumps(
        {k: round(v, 1) for k, v in sorted(nvcc_seconds.items())}),
        flush=True)
    ptxas: dict = {}
    for name, log in logs.items():
        fn = name
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = kernel_name(m.group(1))
            elif ("registers" in line or "spill" in line
                  or "wgmma" in line.lower()):
                print(f"   ptxas {name} {fn}: {line.strip()}")
                ptxas.setdefault(fn, []).append(line.strip())
    # every K7 kernel (bf16 and float32, six tile width pairs each), K8's
    # bf16 kernels (N 64 and 128) and its float32 kernel (both widths, 64
    # state columns a block), K7's VJP (dq and dk/dv at six tile width
    # pairs, bf16 and float32) and K8's VJP tile kernel (N 64 and 128,
    # bf16 and float32) run on the tensor cores: their SASS holds HGMMA,
    # and ptxas spills nothing in them
    # (one cuobjdump a library, side by side)
    from concurrent.futures import ThreadPoolExecutor
    libs = ("flash_attention", "ssd_chunk", "flash_attention_bwd",
            "flash_attention_bwd_tf32", "ssd_chunk_bwd")
    with ThreadPoolExecutor(len(libs)) as pool:
        counted = list(pool.map(lambda lib: sass_counts(
            out_dir / f"lib{lib}.so", "HGMMA"), libs))
    hgmma = {}
    for c in counted:
        hgmma.update(c)
    print("   HGMMA instructions per K7 and K8 kernel and VJP kernel "
          "(cuobjdump -sass): " + json.dumps(hgmma), flush=True)
    results["build"] = {"seconds": seconds, "nvcc_seconds": nvcc_seconds,
                        "ptxas": ptxas, "hgmma": hgmma}
    tc = {k: n for k, n in hgmma.items()
          if k.startswith(("flash_fwd", "ssd_state_wgmma", "ssd_state_tf32",
                           "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma",
                           "flash_bwd_dq_tf32", "flash_bwd_dkdv_tf32",
                           "ssd_bwd_wgmma"))}
    require(len(tc) == 43 and all(tc.values()),
            f"HGMMA in each of the twelve K7 kernels, K8's two bf16 kernels "
            f"and its float32 kernel, the twelve bf16 and twelve float32 "
            f"K7 VJP kernels and K8's four VJP tile kernels: {tc}")
    spills = {k: v for k, v in ptxas.items() if k in tc and any(
        re.search(r"[1-9]\d* bytes spill", line) for line in v)}
    require(not spills, f"no ptxas spills in the tensor-core kernels: "
            f"{spills}")
    # each launch_plan states the shared memory its kernel asks for, and
    # each width pair runs on a built instance (hd 80 on the hd-96 one)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    smem, instances = {}, {}
    for hd, hd_v in fa.WIDTH_PAIRS:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros(1, 1, 64, hd, dtype=dtype)
            v = torch.zeros(1, 1, 64, hd_v, dtype=dtype)
            plan = fa.launch_plan(q, q, v, v)
            inst = (f"{plan['kernel']}[{plan['tile_width']},"
                    f"{plan['tile_width_v']}]")
            instances[f"({hd}, {hd_v}), {dtype}"] = (inst,
                                                     hgmma.get(inst, 0))
            smem[f"flash_attention[{hd}, {hd_v}, {dtype}]"] = (
                plan["smem_bytes"],
                build.library("flash_attention").flash_attention_smem(
                    hd, hd_v, int(dtype == torch.bfloat16)))
    print("   K7 instance (HGMMA count) per width pair: "
          + json.dumps(instances), flush=True)
    results["build"]["k7_instances"] = instances
    require(all(i in tc and i not in spills for i, _ in instances.values()),
            f"every width pair runs on a built tensor-core instance with "
            f"HGMMA and no spills: {instances}")
    k8 = {}
    for N in sc.TC_NS:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.zeros(1, 256, 1, sc.TC_P, dtype=dtype)
            Bm = torch.zeros(1, 256, 1, N, dtype=dtype)
            plan = sc.launch_plan(x, Bm)
            inst = plan["kernel"] + (f"[{N}]" if dtype == torch.bfloat16
                                     else "")
            k8[f"N {N}, {dtype}"] = (inst, hgmma.get(inst, 0))
            smem[f"ssd_chunk_state[{N}, {dtype}]"] = (
                plan["smem_bytes"],
                build.library("ssd_chunk").ssd_chunk_state_smem(
                    N, int(dtype == torch.bfloat16)))
    print("   K8 instance (HGMMA count) per state width and dtype: "
          + json.dumps(k8), flush=True)
    results["build"]["k8_instances"] = k8
    require(all(i in tc and i not in spills for i, _ in k8.values()),
            f"every K8 width runs on a built tensor-core instance with "
            f"HGMMA and no spills: {k8}")
    # the VJPs' plans: K7's two kernels at every width pair in both dtypes
    # (the tensor-core instance each runs on, hd 80 on the hd-96 one, and
    # its library's shared memory beside the plan's), K8's at each width it
    # takes at Mamba2's, Zamba2's and the reduced configs' training shapes,
    # in both dtypes
    for hd, hd_v in fa.WIDTH_PAIRS:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros(1, 1, 64, hd, dtype=dtype)
            plan = fa.bwd_launch_plan(q, q, torch.zeros(1, 1, 64, hd_v,
                                                        dtype=dtype))
            lib_bwd = build.library(plan["library"])
            for which, key in ((0, "smem_dq"), (1, "smem_dkdv")):
                smem[f"{plan['library']}[{hd}, {hd_v}, {key}]"] = (
                    plan[key],
                    getattr(lib_bwd, f"{plan['library']}_smem")(hd, hd_v,
                                                                which))
            for kern in plan["kernels"]:
                inst = (f"{kern}[{plan['tile_width']},"
                        f"{plan['tile_width_v']}]")
                instances[f"VJP ({hd}, {hd_v}) {kern}"] = (
                    inst, hgmma.get(inst, 0))
    for (P, N), (C, L, H) in (((64, 128), (8, 256, 48)),
                              ((64, 64), (8, 256, 80)),
                              ((32, 16), (64, 16, 16))):
        for dtype in (torch.bfloat16, torch.float32):
            plan = sc.bwd_launch_plan(torch.zeros(C, L, H, P, dtype=dtype),
                                      torch.zeros(C, L, 1, N, dtype=dtype))
            bf = int(dtype == torch.bfloat16)
            smem[f"ssd_chunk_state_bwd[{P}, {N}, RB "
                 f"{plan['heads_a_block']}, {dtype}]"] = (
                plan["smem_bytes"], build.library(
                    "ssd_chunk_bwd").ssd_chunk_state_bwd_smem(
                        P, N, plan["heads_a_block"], bf))
            if plan["route"] == "wgmma":
                inst = f"{plan['kernels'][0]}[{'bf16' if bf else 'f32'},{N}]"
                k8[f"VJP N {N}, {dtype}"] = (inst, hgmma.get(inst, 0))
    print("   K7 and K8 VJP instances (HGMMA count): " + json.dumps(
        {k: v for k, v in {**instances, **k8}.items()
         if k.startswith("VJP")}), flush=True)
    require(all(i in tc and i not in spills
                for key, (i, _) in {**instances, **k8}.items()
                if key.startswith("VJP")),
            f"every K7 VJP pair and K8 VJP width runs on a built "
            f"tensor-core instance with HGMMA and no spills: "
            f"{instances} {k8}")
    results["build"]["smem_plan_vs_library"] = smem
    require(all(a == b for a, b in smem.values()),
            f"launch_plan's shared memory is the kernel's: {smem}")


def reddit_graph(classes=CLASSES):
    """The graph ``train_gnn``/``serve_gnn`` make at Reddit's widths,
    through their ``load_graph``: the launches of later phases at these
    widths reuse it (made once a process, ~7 s on the card's host)."""
    import argparse

    from repro_torch.launch.train_gnn import load_graph
    return load_graph(argparse.Namespace(dataset=None, nodes=NODES,
                                         classes=classes, feat_dim=FEAT,
                                         seed=0))


def sampled_blocks(g, fanouts, seed=0):
    """One bucket-64 batch of the serving sampler: (inner, outer) blocks
    and the input features of the inner block's sources."""
    from repro_torch.serving.sampler import ServingSampler
    seeds = np.random.default_rng(seed).choice(g.num_nodes, BUCKET,
                                               replace=False)
    mb = ServingSampler(g, fanouts, seed=seed).sample(seeds)
    ids = mb.input_nodes
    x = np.where((ids >= 0)[:, None], g.features[np.maximum(ids, 0)], 0.0)
    return mb.blocks, x.astype(np.float32)


def _dev_graph(torch, block, dev, *, all_valid=False, seed=0):
    """DeviceGraph of a sampled block, or of the same shapes with every
    edge slot valid and random sources (Reddit's degree ~492 fills every
    fanout slot)."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.core.sampling import Block
    if all_valid:
        rng = np.random.default_rng(seed)
        E, D, S = len(block.edge_mask), block.num_dst, block.num_src
        block = Block(block.src_nodes, block.dst_nodes,
                      rng.integers(0, S, E).astype(np.int32),
                      (np.arange(E) // (E // D)).astype(np.int32),
                      np.ones(E, bool))
    return DeviceGraph.from_block(block, dev)


def _tiny_graph(dev, num_src, num_dst, E, masked):
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.core.sampling import Block
    return DeviceGraph.from_block(Block(
        np.arange(num_src), np.arange(num_dst), np.zeros(E, np.int32),
        np.zeros(E, np.int32), np.zeros(E, bool) if masked
        else np.ones(E, bool)), dev)


def _distinct_src(g) -> int:
    """Source rows the listed (valid) edges read, each counted once."""
    return int(g.edge_src[g.order.long()].unique().numel())


class Checker:
    """Kernel-against-plain checks on the card (``check_case``), with the
    bytes and operations of each case's bound and its one-call library
    counterpart where PyTorch has one; inputs from one CPU generator."""

    def __init__(self, torch, seed):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device="cpu").manual_seed(seed)
        self.flush = torch.empty(64 * 2**20 // 4, device=self.dev)  # > L2

    def randn(self, *shape):
        return self.torch.randn(shape, generator=self.gen).to(self.dev)

    def k1(self, label, h, idx, coef, order, row_ptr, num_out, *,
           transpose=False, timed=True, col=None):
        """K1 ``out[d] = sum coef_e h[idx_e]`` over a grouped layout; over
        the src layout (gathering through ``edge_dst``) it is the
        transpose.  ``coef`` (E,) or (E, heads).  With a column ``col``
        of ``coef``'s shape, the launch also sums it per head (the GAT
        VJP's source pass): its sum is checked apart, and the timed launch
        makes both."""
        torch = self.torch
        from repro_torch.kernels import segment_sum as ss
        nnz, F = int(order.numel()), h.shape[1]
        heads = 1 if coef.dim() == 1 else coef.shape[1]
        cols = idx[order.long()].long()
        U = int(cols.unique().numel())
        library = None
        if heads == 1:
            A = torch.sparse_csr_tensor(row_ptr.long(), cols,
                                        coef[order.long()],
                                        size=(num_out, h.shape[0]))
            library = lambda: torch.sparse.mm(A, h)
        kernel = functools.partial(ss.gather_scale_segment_sum_cuda,
                                   transpose=transpose)
        plain = ss.gather_scale_segment_sum_plain
        args = (h, idx, coef, order, row_ptr, num_out)
        col_bytes = 0
        if col is not None:
            col_bytes = 4 * heads * (nnz + num_out)
            check_case(torch, label + ", its column sum",
                       lambda *a: kernel(*a, col=col)[1],
                       lambda *a: plain(*a, col=col)[1], args)
            kernel = functools.partial(kernel, col=col)
            plain = functools.partial(plain, col=col)
            kernel_out = lambda *a: kernel(*a)[0]
            plain_out = lambda *a: plain(*a)[0]
        else:
            kernel_out, plain_out = kernel, plain
        idx_bytes = (8 + 4 * heads) * nnz + col_bytes
        return check_case(
            torch, label, kernel_out, plain_out, args, timed=timed,
            library=library,
            bytes_=4 * (U * F + num_out * F) + idx_bytes, flops=2 * nnz * F,
            flush=self.flush,
            gather_bytes=4 * (nnz * F + num_out * F) + idx_bytes)

    def k2(self, label, msgs, seg, order, row_ptr, num_out, *, timed=True):
        """K2 ``out[d] = sum msgs[e]`` over the layout grouped by ``seg``;
        the library call adds every edge's row (masked rows are zero)."""
        torch = self.torch
        from repro_torch.kernels import segment_sum as ss
        nnz, F = int(order.numel()), msgs.shape[1]
        idx = seg.long()
        return check_case(
            torch, label, ss.segment_sum_cuda, ss.segment_sum_plain,
            (msgs, order, row_ptr, num_out), timed=timed,
            library=lambda: torch.zeros((num_out, F), device=self.dev
                                        ).index_add_(0, idx, msgs),
            bytes_=4 * (nnz * F + num_out * F) + 8 * nnz, flops=nnz * F,
            flush=self.flush)

    def k3(self, label, g, heads, hd, *, timed=True):
        """K3 over ``g``'s dst layout with random projections."""
        from repro_torch.kernels import gat_fused
        S, D = g.num_src, g.num_dst
        hs, es, ed = (self.randn(S, heads * hd), self.randn(S, heads),
                      self.randn(D, heads))
        nnz, U = int(g.order.numel()), _distinct_src(g)
        return check_case(
            self.torch, label, gat_fused.gat_attention_cuda,
            gat_fused.gat_attention_plain,
            (hs, es, ed, g.edge_src, g.order, g.row_ptr, D), timed=timed,
            bytes_=(4 * (U * heads * hd + D * heads * hd + U * heads
                         + D * heads) + 12 * nnz),
            flops=nnz * heads * (8 + 2 * hd), flush=self.flush,
            gather_bytes=(4 * (nnz * heads * hd + D * heads * hd
                               + nnz * heads + D * heads) + 12 * nnz))

    def k5(self, label, rows, seg, order, num_edges, *, timed=True):
        """K5 ``out[e] = rows[seg_e]`` on the listed edges."""
        torch = self.torch
        from repro_torch.kernels import segment_sum as ss
        nnz, F = int(order.numel()), rows.shape[1]
        U = int(seg[order.long()].unique().numel())
        idx = seg.long()
        return check_case(
            torch, label, ss.gather_rows_cuda, ss.gather_rows_plain,
            (rows, seg, order, num_edges), timed=timed,
            library=lambda: torch.index_select(rows, 0, idx),
            bytes_=4 * (U * F + nnz * F) + 8 * nnz, flush=self.flush)


@phase("2. kernels vs plain versions")
def phase_kernels(torch, blocks, x_np, results):
    c = Checker(torch, seed=0)
    dev = c.dev
    inner, outer = blocks

    def k1(g, h, label, timed=False):
        return c.k1(label, h, g.edge_src, g.edge_mask.to(torch.float32),
                    g.order, g.row_ptr, g.num_dst, timed=timed)

    def k2(g, F, label, timed=False):
        msgs = c.randn(g.edge_src.numel(), F) * \
            g.edge_mask[:, None].to(torch.float32)
        return c.k2(label, msgs, g.edge_dst, g.order, g.row_ptr, g.num_dst,
                    timed=timed)

    def k5(g, rows, label, timed=False):
        return c.k5(label, rows, g.edge_src, g.order, g.edge_src.numel(),
                    timed=timed)

    g_in, g_out = _dev_graph(torch, inner, dev), _dev_graph(torch, outer, dev)
    g_full = _dev_graph(torch, inner, dev, all_valid=True)
    x = torch.from_numpy(x_np).to(dev)
    h1 = c.randn(g_out.num_src, HIDDEN)
    print(f"   inner block: {g_in.num_dst} dst, {g_in.num_src} src, "
          f"{g_in.edge_src.numel()} slots, {g_in.order.numel()} valid; "
          f"outer: {g_out.num_dst} dst, {g_out.num_src} src, "
          f"{g_out.edge_src.numel()} slots, {g_out.order.numel()} valid")
    results["gather_scale_segment_sum"] = k1(
        g_in, x, "K1 inner sampled (18304x602 -> 1664)", timed=True)
    results["gather_scale_segment_sum.outer"] = k1(
        g_out, h1, "K1 outer sampled (1664x256 -> 64)", timed=True)
    results["gather_scale_segment_sum.full"] = k1(
        g_full, x, "K1 inner, every slot valid", timed=True)
    results["segment_sum"] = k2(g_in, FEAT, "K2 GIN layer 0 sampled "
                                "(16640x602 -> 1664)", timed=True)
    results["segment_sum.full"] = k2(g_full, FEAT, "K2 every slot valid",
                                     timed=True)
    results["gat_attention"] = c.k3("K3 inner sampled (18304x4x64 -> 1664)",
                                    g_in, 4, HIDDEN // 4)
    results["gat_attention.full"] = c.k3("K3 every slot valid", g_full, 4,
                                         HIDDEN // 4)
    # GIN's Scatter (K5) on the served blocks: 602-wide rows take the
    # float2 path, 256-wide rows the float4 path
    results["gather_rows.serve"] = k5(
        g_in, x, "K5 GIN layer 0 sampled Scatter (16640 x 602)", timed=True)
    results["gather_rows.serve.outer"] = k5(
        g_out, h1, "K5 GIN layer 1 sampled Scatter (1600 x 256)", timed=True)
    # the other shapes the served paths feed the kernels: GIN's layer 1
    # (F 256: float4 loads), GAT's 40-class output layer (4 x 10), and
    # the launcher's default widths (F 32 and 64, 4 x 16, 4 x 1)
    k2(g_out, HIDDEN, "K2 GIN layer 1 sampled (1600x256 -> 64)")
    c.k3("K3 outer, 4 heads of width 10", g_out, GAT_HEADS,
         GAT_CLASSES // GAT_HEADS, timed=False)
    k2(g_in, 32, "K2 inner, F=32")
    k2(g_out, 64, "K2 outer, F=64")
    c.k3("K3 inner, 4 heads of width 16", g_in, 4, 16, timed=False)
    c.k3("K3 outer, 4 heads of width 1", g_out, 4, 1, timed=False)
    for E, masked, what in [(0, False, "E=0"), (40, True, "all masked")]:
        tg = _tiny_graph(dev, 30, 20, E, masked)
        k1(tg, c.randn(30, 37), f"K1 {what}")
        k2(tg, 5, f"K2 {what}")
        c.k3(f"K3 {what}", tg, 4, 3, timed=False)
        k5(tg, c.randn(30, 6), f"K5 {what}")
    # empty destinations: every pad dst slot of the sampled blocks
    empty = int((g_in.row_ptr[1:] == g_in.row_ptr[:-1]).sum())
    print(f"   empty destinations in the inner block: {empty}")


def span_totals(telemetry) -> dict:
    out = {}
    for name in ("serve.batch", "serve.sample", "serve.forward"):
        durs = [e["dur"] for e in telemetry.get_registry().tracer.events
                if e["name"] == name]
        out[name] = {"count": len(durs), "total_s": float(np.sum(durs)),
                     "median_ms": float(np.median(durs)) * 1e3
                     if durs else 0.0}
    return out


@phase("3. serve GraphSAGE at Reddit widths")
def phase_serve(torch, results):
    from repro_torch.core import telemetry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    telemetry.set_enabled(True)
    telemetry.get_registry().reset()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_gnn.main([
        "--arch", "sage", "--nodes", str(NODES), "--classes", str(CLASSES),
        "--feat-dim", str(FEAT), "--hidden", str(HIDDEN), "--fanouts",
        *map(str, FANOUTS), "--requests", "128", "--device", "cuda"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    spans = span_totals(telemetry)
    telemetry.set_enabled(False)
    base = res["no_cache"]
    forwards = res["forward_calls"] + base["forward_calls"]
    summary = {k: res[k] for k in ("served", "batches", "throughput_rps",
                                   "p50_ms", "p99_ms", "jit_entries",
                                   "embedding_hit_ratio",
                                   "feature_bytes", "wire_bytes")}
    summary["no_cache"] = {k: base[k] for k in (
        "served", "batches", "throughput_rps", "p50_ms", "p99_ms")}
    summary.update(forward_calls=forwards, launches=counts, spans=spans,
                   wall_s=wall)
    print("   serve: " + json.dumps(summary), flush=True)
    results["serve"] = summary
    results["launches.sage"] = counts
    PHASE3_LOGITS.update({r.node_id: r.logits for r in res["responses"]})
    require(res["served"] == 128 and base["served"] == 128,
            "every request served")
    require(res["all_logits_finite"] and base["all_logits_finite"],
            "finite logits")
    require(counts["gather_scale_segment_sum"] == 2 * forwards,
            f"K1 launched twice per forward: {counts}, {forwards} forwards")


@phase("3b. one full-width batch of each served arch on the card vs the CPU")
def phase_cpu_parity(torch, blocks, x_np):
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    rng = np.random.default_rng(1)
    inner, outer = blocks
    cached = rng.standard_normal((outer.num_src, HIDDEN)).astype(np.float32)
    fresh = rng.random(outer.num_src) < 0.3
    for arch, classes, _ in SERVED:
        cfg = GM.GNNConfig(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
                           num_classes=classes, num_layers=2)
        outs = {}
        for dev in ("cuda", "cpu"):
            model = GM.init_gnn(cfg, torch.Generator().manual_seed(5),
                                device=dev)
            with torch.inference_mode():
                logits, h = GM.forward_blocks_cached(
                    cfg, model, [DeviceGraph.from_block(inner, dev)],
                    DeviceGraph.from_block(outer, dev),
                    torch.from_numpy(x_np).to(dev),
                    torch.from_numpy(cached).to(dev),
                    torch.from_numpy(fresh).to(dev))
            outs[dev] = (logits.cpu().numpy(), h.cpu().numpy())
        for i, what in enumerate(("logits", "hidden")):
            a, b = outs["cuda"][i], outs["cpu"][i]
            err = float(np.abs(a - b).max())
            scale = float(np.abs(b).max())
            print(f"   {arch} {what} {a.shape}: max abs err cuda vs cpu "
                  f"{err:.3e} (max|cpu| {scale:.3e})")
            require(bool(np.isfinite(a).all())
                    and err <= 1e-4 * max(scale, 1.0),
                    f"{arch} {what}: cuda agrees with cpu")


def dev_us(e) -> float:
    """Self device time of a profiler row, in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_active_step(torch, step):
    """``torch.profiler`` over ``step`` as the active step of a profile
    that first records one warm-up step (a profile that starts right
    before the step loses its first device work); the profile runs twice,
    since the first pays CUPTI's start-up."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                step()
                torch.cuda.synchronize()
                prof.step()
    return prof


def device_rows(prof) -> list:
    """Device-side rows of a profile, largest first: CPU ops carry their
    children's device time too, and GPU ranges of user annotations overlap
    the kernels inside them."""
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    return sorted(rows, key=dev_us, reverse=True)


@phase("3c. where one serving forward spends device time")
def phase_profile(torch, blocks, x_np, results):
    """One bucket-64 forward as ``serve_batch`` runs it (host arrays to
    the card, forward, logits back): its wall time, the host-to-card copy
    of the input rows alone, and under ``torch.profiler`` (as the active
    step after a profiled warm-up step) the device time by kernel and the
    kernels' share of the step."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    cfg = GM.GNNConfig(arch="sage", feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=CLASSES, num_layers=2)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(5), device="cuda")
    inner, outer = blocks
    cached = np.zeros((outer.num_src, HIDDEN), np.float32)
    fresh = np.zeros(outer.num_src, bool)

    def step():
        dev = torch.device("cuda")
        with torch.inference_mode():
            logits, _ = GM.forward_blocks_cached(
                cfg, model, [DeviceGraph.from_block(inner, dev)],
                DeviceGraph.from_block(outer, dev),
                torch.from_numpy(x_np).to(dev),
                torch.from_numpy(cached).to(dev),
                torch.from_numpy(fresh).to(dev))
            return logits.cpu()

    def median_wall_ms(fn):
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    wall_ms = median_wall_ms(step)
    copy_ms = median_wall_ms(lambda: torch.from_numpy(x_np).to("cuda"))
    # device-side kernels only (the profiler stretches pageable copies,
    # timed by the host clock above instead), profiled as the active step
    # after a profiled warm-up step: a profile that starts right before
    # the step loses its first device work
    prof = profile_active_step(torch, step)
    rows = [e for e in device_rows(prof)
            if not e.key.startswith(("Memcpy", "Memset"))]
    kernels_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"   step wall {wall_ms:.3f} ms (median of 5); input rows "
          f"{x_np.nbytes / 2**20:.1f} MiB host -> card {copy_ms:.3f} ms "
          f"({x_np.nbytes / copy_ms / 1e6:.1f} GB/s); kernels "
          f"{kernels_ms:.3f} ms of device time ({kernels_ms / wall_ms:.2%} "
          f"of the step), {sum(e.count for e in rows)} kernel launches",
          flush=True)
    for e in rows[:8]:
        print(f"   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<3d} {e.key[:90]}")
    results["profile.serve"] = {
        "wall_ms": wall_ms, "copy_ms": copy_ms, "kernels_ms": kernels_ms,
        "kernels": [{"kernel": e.key, "count": e.count,
                     "ms": dev_us(e) / 1e3} for e in rows]}


@phase("4. serve GIN and GAT at Reddit widths")
def phase_gin_gat(torch, results):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    for arch, classes, per_forward in SERVED[1:]:
        ops.reset_launch_counts()
        res = serve_gnn.main([
            "--arch", arch, "--nodes", str(NODES), "--classes", str(classes),
            "--feat-dim", str(FEAT), "--hidden", str(HIDDEN), "--fanouts",
            *map(str, FANOUTS), "--requests", "64", "--device", "cuda"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        base = res["no_cache"]
        forwards = res["forward_calls"] + base["forward_calls"]
        summary = {"served": res["served"], "forward_calls": forwards,
                   "launches": counts, "no_cache": {
                       k: base[k] for k in ("throughput_rps", "p50_ms",
                                            "p99_ms")}}
        summary.update({k: res[k] for k in ("throughput_rps", "p50_ms",
                                            "p99_ms")})
        print(f"   {arch} 602->256->{classes}: " + json.dumps(summary),
              flush=True)
        results[f"serve.{arch}"] = summary
        results[f"launches.{arch}"] = counts
        require(res["served"] == 64 and base["served"] == 64,
                f"{arch}: every request served")
        require(res["all_logits_finite"] and base["all_logits_finite"],
                f"{arch}: finite logits")
        want = {k: n * forwards for k, n in per_forward.items()}
        require({k: v for k, v in counts.items() if v} == want,
                f"{arch}: launches {counts} for {forwards} forwards, "
                f"expected {want}")


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------

def check_grads(torch, label, fn, plain, inputs, cot):
    """Gradients of ``fn`` (an autograd Function through the kernels)
    against autograd through the plain version, on the same inputs and
    output cotangent: within 1e-4 · max|ref| per input, and bitwise
    repeatable."""
    def grads(f):
        ins = [t.detach().clone().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(f(*ins), ins, cot)
    g1, g2, ref = grads(fn), grads(fn), grads(plain)
    torch.cuda.synchronize()
    res = {"case": label, "inputs": []}
    ok = True
    for a, b, r in zip(g1, g2, ref):
        err = (a - r).abs().max().item() if r.numel() else 0.0
        scale = r.abs().max().item() if r.numel() else 0.0
        bitwise = torch.equal(a, b)
        good = bitwise and bool(torch.isfinite(a).all()) and \
            err <= 1e-4 * scale
        res["inputs"].append({"shape": list(a.shape), "max_abs_err": err,
                              "max_abs_ref": scale, "bitwise": bitwise})
        ok = ok and good
    res["ok"] = ok
    print("   " + json.dumps(res), flush=True)
    if not ok:
        failures.append(f"{label}: gradients {res['inputs']}")
    return res


def median_bwd_ms(torch, out, inputs, cot, flush) -> float:
    """Median device time of one backward through a kept graph."""
    return median_ms(torch, lambda: torch.autograd.grad(
        out, inputs, cot, retain_graph=True), flush)


def minibatch_block(torch, g, dev):
    """The inner block of one ``--batch 1024``, fanouts 5/5 mini-batch of
    the training sampler, and its int8 wire rows (``fetch_masked_wire``
    through a degree cache, as the trainer fetches them)."""
    from repro_torch.core import caching as CA
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.core.sampling import NeighborSampler
    seeds = np.random.default_rng(2).choice(g.num_nodes, MB_BATCH,
                                            replace=False)
    mb = NeighborSampler(g, [5, 5], seed=2).sample(seeds)
    store = CA.FeatureStore(g, CA.degree_cache(g, g.num_nodes // 10),
                            codec="int8")
    src = mb.blocks[0].src_nodes
    wire = store.fetch_masked_wire(src, src >= 0)
    q, mn, scale = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in wire)
    return DeviceGraph.from_block(mb.blocks[0], dev), q, mn, scale


def gat_backward_case(torch, c, dg, heads, hd, *, timed):
    """The GAT backward (its destination pass, then K1 over the src
    layout with an (E, heads) coefficient and column) from the forward's
    saved ``(m, l)``, against autograd through the plain forward; timed,
    its plain version is that autograd backward."""
    from repro_torch.kernels import gat_fused as gf
    N, E, nnz = dg.num_src, dg.edge_src.numel(), int(dg.order.numel())
    src, dst, order, row_ptr = dg.edge_src, dg.edge_dst, dg.order, dg.row_ptr
    F = heads * hd
    hs, es, ed, gout = (c.randn(N, F), c.randn(N, heads), c.randn(N, heads),
                        c.randn(N, F))
    _, m, l = gf.gat_attention_cuda(hs, es, ed, src, order, row_ptr, N,
                                    stats=True)
    bwd_args = (gout, hs, es, ed, m, l, src, dst, order, row_ptr,
                dg.src_layout)
    b1 = gf.gat_attention_backward(*bwd_args)
    b2 = gf.gat_attention_backward(*bwd_args)
    ins = [t.detach().clone().requires_grad_(True) for t in (hs, es, ed)]
    out_p = gf.gat_attention_plain(*ins, src, order, row_ptr, N)
    refs = torch.autograd.grad(out_p, ins, gout, retain_graph=True)
    errs = [(a - r).abs().max().item() for a, r in zip(b1, refs)]
    scales = [r.abs().max().item() for r in refs]
    bitwise = all(torch.equal(a, b) for a, b in zip(b1, b2))
    res = {"case": f"GAT backward, {heads} x {hd} ({E} edges)",
           "max_abs_err": max(errs), "max_abs_ref": max(scales),
           "errs": errs, "bitwise_repeatable": bitwise}
    if timed:
        # read g, hs, es, ed, m, l, the edge lists and both layouts once;
        # write dhs, des, ded once
        res["ms"] = median_ms(torch, lambda: gf.gat_attention_backward(
            *bwd_args), c.flush)
        res["plain_ms"] = median_bwd_ms(torch, out_p, ins, gout, c.flush)
        res["library_ms"] = None
        res["bound_ms"], res["bound_by"] = bound(
            4 * (3 * N * F + 6 * N * heads) + 8 * E + 8 * nnz + 8 * (N + 1),
            nnz * (4 * F + 20 * heads))
    res["ok"] = bitwise and all(e <= 1e-4 * s for e, s in zip(errs, scales))
    print("   " + json.dumps(res), flush=True)
    if not res["ok"]:
        failures.append(f"GAT backward {heads} x {hd}: errs {errs}, "
                        f"bitwise {bitwise}")
    return res, (hs, es, ed, gout)


@phase("5. training kernels and autograd Functions vs plain versions")
def phase_train_kernels(torch, g, g_gat, results):
    """``g`` is the 41-class graph GCN, SAGE and GIN train on, ``g_gat``
    the 40-class graph GAT trains on."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.kernels import gat_fused as gf
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss
    c = Checker(torch, seed=5)
    dev, flush, randn = c.dev, c.flush, c.randn
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    N, E = g.num_nodes, dg.edge_src.numel()
    src, dst, order, row_ptr = dg.edge_src, dg.edge_dst, dg.order, dg.row_ptr
    order_s, row_ptr_s = dg.src_layout
    nnz = int(order.numel())
    U_src, U_dst = int(src.unique().numel()), int(dst.unique().numel())
    print(f"   full graph: {N} nodes, {E} edges ({nnz} listed), "
          f"{U_src} distinct sources, {U_dst} distinct destinations")

    coef = torch.rsqrt(dg.out_deg)[src.long()] * \
        torch.rsqrt(dg.in_deg)[dst.long()]
    mask = dg.edge_mask.to(torch.float32)
    # the forward kernels over the whole graph's dst layout: SAGE's layer
    # 0 (602 wide, the mask as coefficient), GCN's layer 0 and SAGE's
    # layer 1 (256), GCN's layer 1 (41)
    results["k1.full.602"] = c.k1(
        f"K1 full graph, SAGE layer 0 (F {FEAT})", randn(N, FEAT), src, mask,
        order, row_ptr, N)
    for F in (HIDDEN, CLASSES):
        results[f"k1.full.{F}"] = c.k1(
            f"K1 full graph, F {F}", randn(N, F), src, coef, order,
            row_ptr, N)
    # the transposes: K1 over the src layout, gathering through edge_dst,
    # at GCN's widths and with the GAT backward's (E, 4) coefficients
    for F in (HIDDEN, CLASSES):
        results[f"k1_transpose.{F}"] = c.k1(
            f"K1 over the src layout, GCN F={F} ({N} sources)",
            randn(N, F), dst, coef, order_s, row_ptr_s, N, transpose=True)
    # GAT's kernels on its own graph
    dga = DeviceGraph.from_graph(g_gat, dev, src_layout=True)
    Ea, nnz_a = dga.edge_src.numel(), int(dga.order.numel())
    print(f"   GAT's graph: {g_gat.num_nodes} nodes, {Ea} edges ({nnz_a} "
          f"listed)")
    # the GAT VJP's source pass: alpha as the coefficient, dpre as the
    # column summed beside; and K1 alone at those shapes
    emask = dga.edge_mask[:, None].to(torch.float32)
    alpha = torch.rand((Ea, GAT_HEADS), generator=c.gen).to(dev) * emask
    dpre = randn(Ea, GAT_HEADS) * emask
    for F in (HIDDEN, GAT_CLASSES):
        w = f"4x{F // GAT_HEADS}"
        g_rows = randn(N, F)
        results[f"k1_transpose.{w}"] = c.k1(
            f"K1 over the src layout, 4 heads x {F // GAT_HEADS}", g_rows,
            dga.edge_dst, alpha, *dga.src_layout, N, transpose=True)
        results[f"k1_transpose_col.{w}"] = c.k1(
            f"K1 over the src layout, 4 heads x {F // GAT_HEADS}, with a "
            f"column", g_rows, dga.edge_dst, alpha, *dga.src_layout, N,
            transpose=True, col=dpre)
    # K2: GIN's layer-0 and layer-1 sums, the Scatter's transpose (src
    # layout)
    for F in (FEAT, HIDDEN):
        results[f"segment_sum.full.{F}"] = c.k2(
            f"K2 full graph, GIN ({E} x {F} -> {N})",
            randn(E, F) * mask[:, None], dst, order, row_ptr, N)
    results["segment_sum.src.256"] = c.k2(
        f"K2 over the src layout ({E} x {HIDDEN} -> {N})",
        randn(E, HIDDEN) * mask[:, None], src, order_s, row_ptr_s, N)
    # K5: GIN's layer-0 Scatter (602 wide: float2 loads) through
    # edge_src, walking the src layout as GatherRows does; its layer-1
    # Scatter of the destinations and K2's backward (256 wide: float4
    # loads) over the dst layout
    results["gather_rows.602"] = c.k5(
        f"K5 gather ({E} x {FEAT}, src layout)", randn(N, FEAT), src,
        order_s, E)
    # the same gather walking the dst layout, as GatherRows did before it
    # took the layout grouped by its index: rows read out of turn
    results["gather_rows.602.dst"] = c.k5(
        f"K5 gather ({E} x {FEAT}, dst layout)", randn(N, FEAT), src,
        order, E)
    results["gather_rows"] = c.k5(
        f"K5 gather ({E} x {HIDDEN})", randn(N, HIDDEN), dst, order, E)
    # K3 over the whole graph at GAT's two layers
    for heads, hd in ((GAT_HEADS, HIDDEN // GAT_HEADS),
                      (GAT_HEADS, GAT_CLASSES // GAT_HEADS)):
        results[f"gat_attention.full.{heads}x{hd}"] = c.k3(
            f"K3 GAT's full graph, {heads} x {hd}", dga, heads, hd)
    # K6 over the dst layout: the reference's single-head edge dot (K1's
    # dcoef), and per head at GAT's two widths (its multi-head path, which
    # no trainer launches); its gather bound counts every listed edge's a
    # row and each destination's b row once
    for heads, hd, gr in ((1, HIDDEN, dg), (GAT_HEADS, HIDDEN // GAT_HEADS,
                                            dga),
                          (GAT_HEADS, GAT_CLASSES // GAT_HEADS, dga)):
        F = heads * hd
        a, b = randn(N, F), randn(N, F)
        o, gs, rp = gr.order, gr.edge_src, gr.row_ptr
        n_l = int(o.numel())
        us = int(gs[o.long()].unique().numel())
        ud = int((rp[1:] > rp[:-1]).sum())
        idx_bytes = 8 * n_l + 4 * (N + 1)
        lib = None
        if heads == 1:
            S_csr = torch.sparse_csr_tensor(
                rp.long(), gs[o.long()].long(),
                torch.ones(n_l, device=dev), size=(N, N))
            lib = lambda: torch.sparse.sampled_addmm(S_csr, b, a.t(),
                                                     beta=0.0)
        plan = ss.edge_dot_plan(heads, hd, 16)
        print(f"   K6 {heads} x {hd}: plan {json.dumps(plan)}")
        results[f"edge_dot.{heads}x{hd}"] = check_case(
            torch, f"K6 edge dot, {heads} x {hd} ({gs.numel()} edges)",
            ss.edge_dot_cuda, ss.edge_dot_plain,
            (a, b, gs, o, rp, heads), timed=True, library=lib,
            bytes_=4 * (us * F + ud * F + n_l * heads) + idx_bytes,
            flops=2 * n_l * F, flush=flush,
            gather_bytes=4 * (n_l * F + ud * F + n_l * heads) + idx_bytes)
    results["edge_dot"] = results[f"edge_dot.1x{HIDDEN}"]
    # the reference's _fused_bwd dcoef: K1's Function over the whole graph
    # with a coefficient that requires grad (h does not: the backward runs
    # K6 alone), exactly one K6 launch, dcoef against the CPU's
    h_in, cf = randn(N, HIDDEN), coef.clone().requires_grad_()
    g_out = randn(N, HIDDEN)

    def dcoef(dev_):
        c_ = cf.detach().to(dev_).requires_grad_()
        out = ops.GatherScaleSegmentSum.apply(
            h_in.to(dev_), src.to(dev_), dst.to(dev_), c_, order.to(dev_),
            row_ptr.to(dev_), None, N)
        return torch.autograd.grad(out, c_, g_out.to(dev_))[0]
    ops.reset_launch_counts()
    dc = dcoef(dev)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    results["launches.k6_dcoef"] = counts
    dc_cpu = dcoef("cpu")
    err = (dc.cpu() - dc_cpu).abs().max().item()
    top = dc_cpu.abs().max().item()
    res = {"case": "K1 Function's dcoef (K6 over the whole graph)",
           "launches": counts, "max_abs_err_vs_cpu": err,
           "max_abs_cpu": top, "ok": err <= 1e-4 * top and counts == {
               "gather_scale_segment_sum": 1, "edge_dot": 1}}
    print("   " + json.dumps(res), flush=True)
    results["k6_dcoef"] = res
    require(res["ok"], f"the dcoef path launches K1 and K6 once each and "
            f"agrees with the CPU within 1e-4: {res}")

    blk, q, mn, scale = minibatch_block(torch, g, dev)
    bnnz = int(blk.order.numel())
    bU = _distinct_src(blk)
    print(f"   batch-{MB_BATCH} inner block: {blk.num_src} x {FEAT} uint8 "
          f"rows -> {blk.num_dst}, {blk.edge_src.numel()} slots, {bnnz} "
          f"valid")
    results["gather_scale_segment_sum_q"] = check_case(
        torch, f"K4 int8-in ({blk.num_src} x {FEAT} -> {blk.num_dst})",
        ss.gather_scale_segment_sum_q_cuda,
        ss.gather_scale_segment_sum_q_plain,
        (q, mn, scale, blk.edge_src, blk.edge_mask.to(torch.float32),
         blk.order, blk.row_ptr, blk.num_dst), timed=True,
        bytes_=bU * FEAT + 8 * bU + 4 * blk.num_dst * FEAT + 12 * bnnz,
        flops=4 * bnnz * FEAT, flush=flush,
        gather_bytes=bnnz * FEAT + 8 * bnnz + 4 * blk.num_dst * FEAT
        + 12 * bnnz)

    # the GAT backward at both layers' shapes, each timed
    results["gat_backward"], (hs, es, ed, gout) = gat_backward_case(
        torch, c, dga, GAT_HEADS, HIDDEN // GAT_HEADS, timed=True)
    results[f"gat_backward.{GAT_HEADS}x{GAT_CLASSES // GAT_HEADS}"], _ = \
        gat_backward_case(torch, c, dga, GAT_HEADS,
                          GAT_CLASSES // GAT_HEADS, timed=True)

    # each autograd Function against autograd through its plain version
    h, cf = randn(N, HIDDEN), coef.clone()
    check_grads(torch, "K1 Function (dh by K1 transpose, dcoef by K6)",
                lambda h, c: ops.GatherScaleSegmentSum.apply(
                    h, src, dst, c, order, row_ptr, dg.src_layout, N),
                lambda h, c: ss.gather_scale_segment_sum_plain(
                    h, src, c, order, row_ptr, N), [h, cf], randn(N, HIDDEN))
    check_grads(torch, "K2 Function (dmsgs by K5)",
                lambda m: ops.SegmentSum.apply(m, dst, order, row_ptr, N),
                lambda m: ss.segment_sum_plain(m, order, row_ptr, N),
                [randn(E, HIDDEN)], randn(N, HIDDEN))
    check_grads(torch, "Scatter gather Function (dx by K2 over src layout)",
                lambda x: ops.GatherRows.apply(x, src, order, dg.src_layout),
                lambda x: ss.gather_rows_plain(x, src, order, E),
                [randn(N, HIDDEN)], randn(E, HIDDEN))
    check_grads(torch, "K3 Function (the GAT VJP)",
                lambda a, b, c: ops.GatAttention.apply(
                    a, b, c, dga.edge_src, dga.edge_dst, dga.order,
                    dga.row_ptr, dga.src_layout, N),
                lambda a, b, c: gf.gat_attention_plain(
                    a, b, c, dga.edge_src, dga.order, dga.row_ptr, N),
                [hs, es, ed], gout)


def train_args(arch, classes, extra=()):
    return ["--arch", arch, "--nodes", str(NODES), "--classes", str(classes),
            "--feat-dim", str(FEAT), "--hidden", str(HIDDEN), "--device",
            "cuda", *extra]


def _expected(arch, epochs):
    want = {k: v * epochs for k, v in STEP_LAUNCHES[arch].items()}
    for k, v in EVAL_LAUNCHES[arch].items():
        want[k] = want.get(k, 0) + v
    return want


def _params_equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))


@phase("6. full-batch training at Reddit widths")
def phase_fullbatch(torch, results):
    from repro_torch.kernels import ops
    from repro_torch.launch import train_gnn
    for arch in ("gcn", "sage", "gin", "gat"):
        classes = GAT_CLASSES if arch == "gat" else CLASSES
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_gnn.main(train_args(arch, classes, [
            "--epochs", str(TRAIN_EPOCHS)]))
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = res["losses"]
        summary = {"losses": losses, "epoch_ms": [s * 1e3 for s in
                                                  res["epoch_s"]],
                   "median_epoch_ms": float(np.median(res["epoch_s"][1:]))
                   * 1e3, "setup_s": res["setup_s"],
                   "accuracy": res["accuracy"], "launches": counts,
                   "max_memory_allocated": peak, "wall_s": wall}
        print(f"   {arch} 602->256->{classes}: " + json.dumps(summary),
              flush=True)
        results[f"train.{arch}"] = summary
        results[f"launches.train.{arch}"] = counts
        require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
                f"{arch}: finite, falling loss {losses}")
        want = _expected(arch, TRAIN_EPOCHS)
        require(counts == want, f"{arch}: launches {counts}, by design "
                f"{want}")
        _repeat_and_cpu_step(torch, arch, classes, res, results)
        if arch in ("gcn", "sage", "gat"):
            TRAINED[arch] = (res["model"], res["graph"])   # phases 11b, 14
        if arch in ("gcn", "gat"):
            _profile_step(torch, arch, classes, res["graph"], results)


def _repeat_and_cpu_step(torch, arch, classes, res, results):
    """A second run from the same init, through the train step itself,
    must end in bitwise-equal parameters; then one step's gradients on
    the card against the same step on the CPU."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW
    g = res["graph"]
    cfg = GM.GNNConfig(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=classes)
    dev = torch.device("cuda")
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    x = torch.from_numpy(g.features).to(dev)
    y = torch.from_numpy(g.labels).to(dev)
    mask = torch.ones(y.shape, device=dev)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    step = GM.make_fullgraph_train_step(
        cfg, AdamW(model.parameters(), lr=1e-2, weight_decay=0.0))
    for _ in range(TRAIN_EPOCHS):
        step(model, dg, x, y, mask)
    torch.cuda.synchronize()
    same = _params_equal(torch, model, res["model"])
    print(f"   {arch}: second run from the same init bitwise equal: {same}",
          flush=True)
    require(same, f"{arch}: two runs end in bitwise-equal parameters")

    grads = {}
    for d in ("cuda", "cpu"):
        m = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=d)
        gd, xd = dg, x
        if d == "cpu":
            # the CPU step runs in float64, so its own rounding (sums over
            # 232 965 rows in another order) drops out of the comparison
            m = m.double()
            gd = DeviceGraph.from_graph(g, "cpu", src_layout=True)
            xd = x.cpu().double()
        loss = GM.nll_loss(GM.forward_full(cfg, m, gd, xd), y.to(d))
        loss.backward()
        grads[d] = [p.grad.detach().cpu().double() for p in m.parameters()]
    # held to 1e-4 of the model's largest gradient: a float32 sum over
    # 232 965 rows can miss its own parameter's max by about 1e-4
    # (SAGE's and GIN's layer-0 weights), the errors are printed per
    # parameter
    top = max(b.abs().max().item() for b in grads["cpu"])
    errs = []
    for (name, _), a, b in zip(m.named_parameters(), grads["cuda"],
                               grads["cpu"]):
        err = (a - b).abs().max().item()
        errs.append({"param": name, "err": err,
                     "max_abs_cpu": b.abs().max().item()})
        require(err <= 1e-4 * top, f"{arch} {name}: gradient cuda vs cpu "
                f"{err}, model's max |grad| {top}")
    print(f"   {arch}: one step's gradients, cuda vs cpu (float64; model's "
          f"max |grad| {top:.6g}): " + json.dumps(errs), flush=True)
    results[f"train.{arch}"]["grad_cuda_vs_cpu"] = errs


# the port's kernels by name, as the profiler lists them
PORT_KERNELS = ("gss_lanes_kernel", "segmented_rows", "gather_rows_kernel",
                "edge_dot_lanes_kernel", "gat_forward_kernel",
                "gat_backward_dst_kernel")


def _profile_step(torch, arch, classes, g, results):
    """One full-batch training step of ``arch`` under ``torch.profiler``:
    device time split into the port's kernels (each kernel by name: a
    template's instances, such as one kernel at two widths, are listed
    apart), matrix products, copies and the rest (elementwise, the
    optimizer).  The step is profiled twice: alone in a profiling
    session, and as the active step of a session that first profiles one
    warm-up step (``torch.profiler.schedule``): alone, the session misses
    the step's first device work.  For GCN, beside it, CUDA-event times of
    the step's two 602-wide products (the forward ``x @ w`` and the
    weight gradient ``x^T @ dh``), each 72 GFLOP."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW
    dev = torch.device("cuda")
    cfg = GM.GNNConfig(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=classes)
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    x = torch.from_numpy(g.features).to(dev)
    y = torch.from_numpy(g.labels).to(dev)
    mask = torch.ones(y.shape, device=dev)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    step = GM.make_fullgraph_train_step(
        cfg, AdamW(model.parameters(), lr=1e-2, weight_decay=0.0))
    for _ in range(3):
        step(model, dg, x, y, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step(model, dg, x, y, mask))
    wall_ms = (time.perf_counter() - t0) * 1e3

    def kind(key):
        k = key.lower()
        if any(n in k for n in PORT_KERNELS):
            return "port kernels"
        if any(n in k for n in ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                                "sm80_", "ampere_", "volta_", "matmul",
                                "nvjet", "splitk")):
            return "matrix products"
        if k.startswith(("memcpy", "memset")):
            return "copies"
        return "other"

    profiles = {}
    for label, warmup in (("alone", 0), ("after a warm-up step", 1)):
        for _ in range(2):         # the first session pays CUPTI's start-up
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=warmup, active=1,
                                           repeat=1) if warmup else None
                         ) as prof:
                for _ in range(warmup + 1):
                    float(step(model, dg, x, y, mask))
                    prof.step()
        # device-side kernels and copies; GPU ranges of user annotations
        # (the optimizer's step) overlap the kernels inside them
        rows = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and dev_us(e) > 0
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer.")]
        split = {"port kernels": 0.0, "matrix products": 0.0, "copies": 0.0,
                 "other": 0.0}
        for e in rows:
            split[kind(e.key)] += dev_us(e) / 1e3
        total = sum(split.values())
        listing = [{"kernel": e.key, "kind": kind(e.key), "count": e.count,
                    "ms": dev_us(e) / 1e3}
                   for e in sorted(rows, key=dev_us, reverse=True)]
        print(f"   {arch} step profiled {label}: wall {wall_ms:.3f} ms, "
              f"device {total:.3f} ms ({total / wall_ms:.2%} busy), "
              f"{sum(e.count for e in rows)} device events; split (ms): "
              + json.dumps(split), flush=True)
        # every port kernel, then the largest of the rest
        shown = [r for r in listing if r["kind"] == "port kernels"]
        shown += [r for r in listing if r["kind"] != "port kernels"][:10]
        for r in shown:
            print(f"   {r['ms']:9.3f} ms  x{r['count']:<3d} {r['kind']:15s} "
                  f"{r['kernel'][:80]}")
        profiles[label] = {"device_ms": total, "split_ms": split,
                           "kernels": listing}
    results[f"profile.{arch}"] = {"wall_ms": wall_ms, "profiles": profiles}
    if arch != "gcn":
        return
    flush = torch.empty(64 * 2**20 // 4, device=dev)
    w0 = model[0].w.detach()
    dh0 = torch.randn((g.num_nodes, HIDDEN),
                      generator=torch.Generator().manual_seed(3)).to(dev)
    gflop = 2 * g.num_nodes * FEAT * HIDDEN / 1e9
    fwd_ms = median_ms(torch, lambda: x @ w0, flush)
    wgrad_ms = median_ms(torch, lambda: x.t() @ dh0, flush)
    print(f"   layer-0 products by CUDA events: x @ w {fwd_ms:.3f} ms, "
          f"x^T @ dh {wgrad_ms:.3f} ms ({gflop:.1f} GFLOP each: "
          f"{gflop / fwd_ms:.1f} and {gflop / wgrad_ms:.1f} TFLOP/s)",
          flush=True)
    results["profile.gcn"].update(x_w_ms=fwd_ms, xT_dh_ms=wgrad_ms,
                                  gflop_each=gflop)


@phase("7. mini-batch GraphSAGE at Reddit widths, fp32 and int8")
def phase_minibatch(torch, results):
    from repro_torch.kernels import ops
    from repro_torch.launch import train_gnn
    for codec in ("fp32", "int8"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        # each run takes MB_STEPS steps of its epoch
        res = train_gnn.run(train_gnn.parse_args(train_args(
            "sage", CLASSES, [
                "--minibatch", "--batch", str(MB_BATCH), "--epochs", "1",
                "--cache", "degree", "--wire-codec", codec,
                *(["--use-kernel"] if codec == "int8" else [])])),
            steps_per_epoch=MB_STEPS)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        losses, steps = res["losses"], res["steps"]
        summary = {"steps": steps, "wall_s": time.perf_counter() - t0,
                   "median_step_ms": float(np.median(res["step_s"])) * 1e3,
                   "p90_step_ms": float(np.percentile(res["step_s"], 90))
                   * 1e3,
                   "cache_hit_ratio": res["cache_hit_ratio"],
                   "fetched_mib": res["fetched_bytes"] / 2**20,
                   "loss_first5": float(np.mean(losses[:5])),
                   "loss_last5": float(np.mean(losses[-5:])),
                   "launches": counts}
        print(f"   minibatch sage {codec}: " + json.dumps(summary),
              flush=True)
        results[f"minibatch.{codec}"] = summary
        results[f"launches.minibatch.{codec}"] = counts
        require(bool(np.isfinite(losses).all())
                and summary["loss_last5"] < summary["loss_first5"],
                f"{codec}: finite, falling loss")
        k4 = counts.get("gather_scale_segment_sum_q", 0)
        require(k4 == (steps if codec == "int8" else 0),
                f"{codec}: K4 launched {k4} times in {steps} steps")
        # layer 0 (K4 under int8) and layer 1 forward, layer 1 backward
        want = {"gather_scale_segment_sum": steps * (1 if codec == "int8"
                                                     else 2),
                "gather_scale_segment_sum_t": steps}
        if codec == "int8":
            want["gather_scale_segment_sum_q"] = steps
        require(counts == want, f"{codec}: launches {counts}, by design "
                f"{want}")


# ---------------------------------------------------------------------------
# phase 11: locality reordering, the dataset registry, the importance and
# layer-wise samplers and serving a changing graph, at Reddit's widths
# ---------------------------------------------------------------------------

REORDER_POLICIES = ("none", "degree", "bfs", "rcm")
# the phase-5 cases phase 11(a) repeats over each packed graph, under
# phase 5's keys
REORDER_CASES = ("k1.full.602", f"k1.full.{HIDDEN}", f"k1.full.{CLASSES}",
                 f"k1_transpose.{HIDDEN}",
                 f"gat_attention.full.{GAT_HEADS}x{HIDDEN // GAT_HEADS}",
                 "gat_backward", "gather_rows.602")
# the events of phase 11(d)'s stream (half feature rows, the rest edge
# additions and removals; cut from 2 000 for the 900 s budget)
UPDATE_EVENTS = 1000
# ImportanceSampler walks 8 x 2 steps in Python per destination (about
# 0.9-2.8 s a batch of 1024 on a CPU core): phase 11(e) runs it one epoch
# over 6 batches of nodes (a 16th of the nodes before phase 20, a 32nd, 7
# batches, before the 900 s budget), at the same widths and degree: the
# first 5 batches' mean loss and the last 5's still differ
IMPORTANCE_NODES = 6 * MB_BATCH


def packed(g):
    """Each policy's packing of ``g``, with the host seconds it took and
    its ``locality_report``."""
    from repro_torch.core.reordering import locality_report, reorder_graph
    for policy in REORDER_POLICIES:
        t0 = time.perf_counter()
        gp, _, _ = reorder_graph(g, policy)
        secs = time.perf_counter() - t0
        yield policy, gp, {"seconds": secs, **locality_report(gp)}


def reorder_cases(torch, c, g, g_gat) -> dict:
    """Phase 5's whole-graph cases of the gathers over ``g`` (41 classes)
    and ``g_gat`` (40), as packed: K1 at 602 (SAGE layer 0), 256 and 41,
    K1ᵀ at 256, K3 and its VJP at 4 x 64, K5 at 602 over the src layout.
    K5's and the VJP's results gain a ``gather_bound_ms``: every listed
    edge's row (the VJP: hs in its destination pass, g in its source
    pass), the outputs and the indices over 3.35 TB/s."""
    from repro_torch.core.abstraction import DeviceGraph
    dev, randn = c.dev, c.randn
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    N, E = g.num_nodes, dg.edge_src.numel()
    src, dst, order, row_ptr = dg.edge_src, dg.edge_dst, dg.order, dg.row_ptr
    order_s, row_ptr_s = dg.src_layout
    nnz = int(order.numel())
    coef = torch.rsqrt(dg.out_deg)[src.long()] * \
        torch.rsqrt(dg.in_deg)[dst.long()]
    out = {"k1.full.602": c.k1(
        f"K1 full graph, SAGE layer 0 (F {FEAT})", randn(N, FEAT), src,
        dg.edge_mask.to(torch.float32), order, row_ptr, N)}
    for F in (HIDDEN, CLASSES):
        out[f"k1.full.{F}"] = c.k1(f"K1 full graph, F {F}", randn(N, F), src,
                                   coef, order, row_ptr, N)
    out[f"k1_transpose.{HIDDEN}"] = c.k1(
        f"K1 over the src layout, GCN F={HIDDEN}", randn(N, HIDDEN), dst,
        coef, order_s, row_ptr_s, N, transpose=True)
    r = c.k5(f"K5 gather ({E} x {FEAT}, src layout)", randn(N, FEAT), src,
             order_s, E)
    r["gather_bound_ms"] = (4 * 2 * nnz * FEAT + 8 * nnz) / HBM_BYTES_PER_S \
        * 1e3
    out["gather_rows.602"] = r
    dga = DeviceGraph.from_graph(g_gat, dev, src_layout=True)
    hd = HIDDEN // GAT_HEADS
    out[f"gat_attention.full.{GAT_HEADS}x{hd}"] = c.k3(
        f"K3 GAT's full graph, 4 x {hd}", dga, GAT_HEADS, hd)
    r, _ = gat_backward_case(torch, c, dga, GAT_HEADS, hd, timed=True)
    na, Ea, Na = int(dga.order.numel()), dga.edge_src.numel(), dga.num_src
    r["gather_bound_ms"] = (4 * (2 * na * HIDDEN + 2 * Na * HIDDEN
                                 + 6 * Na * GAT_HEADS) + 16 * na + 8 * Ea) \
        / HBM_BYTES_PER_S * 1e3
    out["gat_backward"] = r
    return out


@phase("11a. the gathers over the graph as each reorder policy packs it")
def phase_reorder_kernels(torch, g, g_gat, results):
    """For each policy, ``g`` (41 classes) and ``g_gat`` (40) packed
    by ``reorder_graph`` (its host seconds and ``locality_report``
    printed), then :func:`reorder_cases` on them, each case held against
    its plain version within phase 5's bounds and timed as there (25
    launches, L2 flushed), beside phase 5's time of the unpacked graph
    from this process."""
    out = {}
    for (policy, gp, rep), (_, gap, rep_gat) in zip(packed(g),
                                                    packed(g_gat)):
        print(f"   reorder={policy}: {rep['seconds']:.2f} s (GAT's graph "
              f"{rep_gat['seconds']:.2f} s); " + json.dumps(rep), flush=True)
        cases = reorder_cases(torch, Checker(torch, seed=5), gp, gap)
        line = []
        for key in REORDER_CASES:
            r, base = cases[key], results.get(key, {}).get("ms")
            share = r["gather_bound_ms"] / r["ms"]
            line.append(f"{key} {r['ms']:.5g} ms ["
                        + ("not run" if base is None else f"{base:.5g}")
                        + f"] {share:.0%} of gather bound")
        print(f"   {policy}: " + "; ".join(line), flush=True)
        out[policy] = {"locality": rep, "locality_gat": rep_gat,
                       "cases": cases}
    results["reorder.kernels"] = out


def final_logits(torch, arch, classes, model, g):
    """``model``'s logits over all of ``g`` on the card, on the host."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    cfg = GM.GNNConfig(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=classes)
    dev = torch.device("cuda")
    with torch.no_grad():
        return GM.forward_full(cfg, model, DeviceGraph.from_graph(g, dev),
                               torch.from_numpy(g.features).to(dev)
                               ).cpu().numpy()


@phase("11b. full-batch SAGE and GAT over the packed graph")
def phase_reorder_train(torch, results):
    """SAGE full-batch through ``train_gnn --reorder bfs`` and GAT through
    ``--reorder rcm`` (each arch under both policies before phase 20 came,
    cut for time): launches as phase 6's and each epoch's loss within 1e-4
    (relative) of phase 6's unpacked run of the same arch (training is
    invariant under the relabelling up to summation order).  The trained
    models' predictions, mapped back to the original ids, agree with phase
    6's model's except on near ties: a node whose class differs has a top-2
    margin in phase 6's logits within 1e-3 of their largest value (float32
    sums in another order, amplified by ten AdamW epochs, can flip those).
    The accuracy difference is printed in nodes."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train_gnn
    for arch, policy in (("sage", "bfs"), ("gat", "rcm")):
        classes = GAT_CLASSES if arch == "gat" else CLASSES
        base = results[f"train.{arch}"]
        logits0 = final_logits(torch, arch, classes, *TRAINED[arch])
        pred0 = logits0.argmax(1)
        top2 = np.sort(logits0, 1)[:, -2:]
        margin0 = top2[:, 1] - top2[:, 0]
        ops.reset_launch_counts()
        res = train_gnn.main(train_args(arch, classes, [
            "--epochs", str(TRAIN_EPOCHS), "--reorder", policy]))
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(res["losses"], base["losses"]))
        logits = final_logits(torch, arch, classes, res["model"],
                              res["graph"])[res["reorder"]["inv"]]
        flipped = logits.argmax(1) != pred0
        near = 1e-3 * float(np.abs(logits0).max())
        summary = {
            "losses": res["losses"], "max_rel_loss_diff": rel,
            "accuracy": res["accuracy"],
            "accuracy_diff_nodes": round(abs(res["accuracy"]
                                             - base["accuracy"]) * NODES),
            "max_abs_logit_diff": float(np.abs(logits - logits0).max()),
            "predictions_differing": int(flipped.sum()),
            "their_max_margin": float(margin0[flipped].max())
            if flipped.any() else 0.0, "near_tie_bound": near,
            "median_epoch_ms": float(np.median(res["epoch_s"][1:]))
            * 1e3, "unpacked_median_epoch_ms": base["median_epoch_ms"],
            "reorder_s": res["reorder"]["seconds"], "launches": counts}
        print(f"   {arch} --reorder {policy}: " + json.dumps(summary),
              flush=True)
        results[f"reorder.train.{arch}.{policy}"] = summary
        want = _expected(arch, TRAIN_EPOCHS)
        require(counts == want, f"{arch} {policy}: launches {counts}, "
                f"by design {want}")
        require(len(res["losses"]) == len(base["losses"])
                and rel <= 1e-4, f"{arch} {policy}: losses within 1e-4 "
                f"of the unpacked run ({rel})")
        require(summary["their_max_margin"] <= near,
                f"{arch} {policy}: predictions that differ from the "
                f"unpacked run's are near ties ({summary})")


def serve_args(extra=()):
    return ["--arch", "sage", "--nodes", str(NODES), "--classes",
            str(CLASSES), "--feat-dim", str(FEAT), "--hidden", str(HIDDEN),
            "--fanouts", *map(str, FANOUTS), "--device", "cuda", *extra]


@phase("11c. serve GraphSAGE over the bfs-packed graph")
def phase_reorder_serve(torch, results):
    """``serve_gnn --reorder bfs --requests 128``: every request answered
    in the workload's original ids, in its order, K1 twice a forward;
    p50 and req/s beside phase 3's unpacked run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    from repro_torch.serving import poisson_workload
    ops.reset_launch_counts()
    res = serve_gnn.main(serve_args(["--requests", "128", "--reorder",
                                     "bfs"]))
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    base = res["no_cache"]
    forwards = res["forward_calls"] + base["forward_calls"]
    # the launcher's workload, as its clients sent it
    sent = [r.node_id for r in poisson_workload(128, np.arange(NODES),
                                                2000.0, seed=1)]
    summary = {k: res[k] for k in ("served", "throughput_rps", "p50_ms",
                                   "p99_ms", "embedding_hit_ratio")}
    summary.update(no_cache={k: base[k] for k in (
        "served", "throughput_rps", "p50_ms", "p99_ms")},
        reorder_s=res["reorder"]["seconds"] if "reorder" in res else None,
        launches=counts, forward_calls=forwards,
        unpacked=results.get("serve", "not run"))
    print("   serve --reorder bfs: " + json.dumps(summary, default=str),
          flush=True)
    print("   (SAGE serving is host-bound: PERF.md §7 records 1 599 to "
          "1 999 req/s for unchanged code on different machines)")
    results["reorder.serve"] = summary
    for name, r in (("cached", res), ("no-cache", base)):
        require(r["served"] == 128 and r["all_logits_finite"],
                f"{name}: every request answered, finite logits")
        require([q.node_id for q in r["responses"]] == sent,
                f"{name}: responses in the workload's original ids")
    require(counts == {"gather_scale_segment_sum": 2 * forwards},
            f"K1 twice a forward: {counts}, {forwards} forwards")


@phase("11d. serve GraphSAGE over a changing graph")
def phase_update_stream(torch, g, results):
    """A stream of :data:`UPDATE_EVENTS` events from ``synthesize_updates``
    on ``g`` (the 41-class graph), written to ``chiprun_out/``, served by
    ``serve_gnn --update-stream`` (128 requests, staleness 4, so cached
    rows outside a fold's frontier stay servable): its folds, events,
    touched nodes and invalidated rows; then a cold server built on
    ``log.apply(g)`` with the same weights answers a fixed set of seeds
    (the touched nodes first) as the updated server does, within 1e-5."""
    from repro_torch.core.updates import load_update_stream, synthesize_updates
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    from repro_torch.serving import GNNInferenceServer
    from repro_torch.serving.batcher import MicroBatch
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", "updates.jsonl")
    n_events = synthesize_updates(g, UPDATE_EVENTS, seed=11).to_jsonl(path)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_gnn.main(serve_args(["--requests", "128", "--staleness", "4",
                                     "--update-stream", path]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    forwards = res["forward_calls"] + res["no_cache"]["forward_calls"]
    folds = res["folds"]
    summary = {"events_in_stream": n_events, "folds": len(folds),
               "events": sum(f["events"] for f in folds),
               "touched_nodes": sum(f["touched_nodes"] for f in folds),
               "invalidated_rows": sum(f["invalidated_rows"] for f in folds),
               "update_seq": res["update_seq"],
               "no_cache_update_seq": res["no_cache"]["update_seq"],
               "served": res["served"], "throughput_rps":
               res["throughput_rps"], "p50_ms": res["p50_ms"],
               "p99_ms": res["p99_ms"], "launches": counts, "wall_s": wall}
    print("   serve --update-stream: " + json.dumps(summary), flush=True)
    require(res["served"] == 128 and res["no_cache"]["served"] == 128
            and res["all_logits_finite"], "every request answered, finite")
    require(res["update_seq"] == n_events
            and res["no_cache"]["update_seq"] == n_events
            and summary["events"] == n_events, "every event folded")
    require(counts == {"gather_scale_segment_sum": 2 * forwards},
            f"K1 twice a forward: {counts}, {forwards} forwards")

    srv = res["server"]
    log = load_update_stream(path)
    t0 = time.perf_counter()
    cold = GNNInferenceServer(
        log.apply(g), srv.cfg, srv.params, fanouts=list(FANOUTS),
        buckets=srv.batcher.buckets, cache_policy="degree",
        cache_capacity=int(NODES * 0.2), max_staleness=4, seed=0)
    cold.warmup()
    cold_s = time.perf_counter() - t0
    touched = log.delta(0).nodes
    rng = np.random.default_rng(12)
    others = np.setdiff1d(rng.choice(NODES, 256, replace=False), touched)
    seeds = np.concatenate([touched[:128], others[:128]])
    worst, top = 0.0, 0.0
    for start in range(0, len(seeds), BUCKET):
        ids = np.full(BUCKET, -1, np.int64)
        chunk = seeds[start:start + BUCKET]
        ids[:len(chunk)] = chunk
        a = srv.serve_batch(MicroBatch([], ids, BUCKET, 0.0))[:len(chunk)]
        b = cold.serve_batch(MicroBatch([], ids, BUCKET, 0.0))[:len(chunk)]
        worst = max(worst, float(np.abs(a - b).max()))
        top = max(top, float(np.abs(b).max()))
    summary.update(delta_vs_cold_max_abs=worst, cold_max_abs=top,
                   cold_build_s=cold_s, seeds=len(seeds))
    print(f"   updated server vs a cold one on log.apply(g), {len(seeds)} "
          f"seeds ({min(128, len(touched))} touched): max |diff| "
          f"{worst:.3e} (max |logit| {top:.3e}); cold build "
          f"{cold_s:.1f} s", flush=True)
    results["update_stream"] = summary
    require(worst <= 1e-5, f"updated server within 1e-5 of a cold rebuild "
            f"({worst})")


def timed_k1_host(torch):
    """Wrap K1's CUDA wrapper to keep each call's host seconds; returns
    the list and a function that restores the wrapper."""
    from repro_torch.kernels import segment_sum as ss
    saved, host = ss.gather_scale_segment_sum_cuda, []

    def call(*args, **kw):
        t0 = time.perf_counter()
        out = saved(*args, **kw)
        host.append(time.perf_counter() - t0)
        return out
    ss.gather_scale_segment_sum_cuda = call

    def restore():
        ss.gather_scale_segment_sum_cuda = saved
    return host, restore


@phase("11e. mini-batch GraphSAGE with the new samplers")
def phase_samplers(torch, results):
    """``train_gnn --minibatch --sampler importance|fastgcn|ladies``, SAGE
    602 → 256 → 41, batch 1024, one epoch (importance over
    :data:`IMPORTANCE_NODES` nodes; the layer-wise samplers
    :data:`MB_STEPS` steps of theirs): finite, falling loss and K1's
    launches as phase 7's fp32 run (two forward, one transpose a step).
    The layer-wise blocks change E every step; K1's plan search is
    memoised per shape and not per E, so its searches during a run stay
    as few as the shapes, and each launch's host time is that of a launch
    (both read here)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.launch import train_gnn
    for sampler in ("importance", "fastgcn", "ladies"):
        nodes = IMPORTANCE_NODES if sampler == "importance" else NODES
        ops.reset_launch_counts()
        searches = ss._gss_plan.cache_info().misses
        host, restore = timed_k1_host(torch)
        t0 = time.perf_counter()
        try:
            args = train_args("sage", CLASSES, [
                "--minibatch", "--sampler", sampler, "--batch",
                str(MB_BATCH), "--epochs", "1", "--cache", "degree"])
            args[args.index("--nodes") + 1] = str(nodes)
            res = train_gnn.run(train_gnn.parse_args(args),
                                steps_per_epoch=0 if sampler == "importance"
                                else MB_STEPS)
        finally:
            restore()
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        losses, steps = res["losses"], res["steps"]
        summary = {"nodes": nodes, "steps": steps,
                   "wall_s": time.perf_counter() - t0,
                   "median_step_ms": float(np.median(res["step_s"])) * 1e3,
                   "loss_first5": float(np.mean(losses[:5])),
                   "loss_last5": float(np.mean(losses[-5:])),
                   "launches": counts,
                   "k1_plan_searches": ss._gss_plan.cache_info().misses
                   - searches,
                   "k1_host_us_median": float(np.median(host)) * 1e6,
                   "k1_host_us_max_after_first_10":
                   float(np.max(host[10:])) * 1e6 if len(host) > 10
                   else None}
        print(f"   minibatch sage --sampler {sampler}: "
              + json.dumps(summary), flush=True)
        results[f"sampler.{sampler}"] = summary
        require(bool(np.isfinite(losses).all())
                and summary["loss_last5"] < summary["loss_first5"],
                f"{sampler}: finite, falling loss")
        want = {"gather_scale_segment_sum": 2 * steps,
                "gather_scale_segment_sum_t": steps}
        require(counts == want, f"{sampler}: launches {counts}, by design "
                f"{want}")
        require(summary["k1_plan_searches"] <= 4,
                f"{sampler}: {summary['k1_plan_searches']} K1 plan searches "
                f"in {steps} steps")


@phase("11f. each launcher over a named dataset")
def phase_datasets(torch, results):
    """``train_gnn --dataset pubmed-like`` (GCN full-batch, 10 epochs) and
    ``serve_gnn --dataset reddit-like`` (SAGE, 64 requests): a path
    check, launches as designed."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn, train_gnn
    ops.reset_launch_counts()
    res = train_gnn.main(["--arch", "gcn", "--dataset", "pubmed-like",
                          "--hidden", str(HIDDEN), "--epochs",
                          str(TRAIN_EPOCHS), "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    losses = res["losses"]
    summary = {"train": {"losses": losses, "accuracy": res["accuracy"],
                         "median_epoch_ms": float(np.median(
                             res["epoch_s"][1:])) * 1e3,
                         "launches": counts}}
    require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
            f"pubmed-like: finite, falling loss {losses}")
    want = _expected("gcn", TRAIN_EPOCHS)
    require(counts == want, f"pubmed-like: launches {counts}, by design "
            f"{want}")
    ops.reset_launch_counts()
    res = serve_gnn.main(["--arch", "sage", "--dataset", "reddit-like",
                          "--hidden", str(HIDDEN), "--requests", "64",
                          "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    forwards = res["forward_calls"] + res["no_cache"]["forward_calls"]
    summary["serve"] = {k: res[k] for k in ("served", "throughput_rps",
                                            "p50_ms", "p99_ms")}
    summary["serve"]["launches"] = counts
    print("   datasets: " + json.dumps(summary), flush=True)
    results["datasets"] = summary
    require(res["served"] == 64 and res["all_logits_finite"],
            "reddit-like: every request answered, finite logits")
    require(counts == {"gather_scale_segment_sum": 2 * forwards},
            f"reddit-like: K1 twice a forward: {counts}")


# ---------------------------------------------------------------------------
# replicated serving: phase 3's SAGE behind the router
# ---------------------------------------------------------------------------

def router_run(torch, label, extra):
    """``serve_gnn`` in replicated mode on phase 3's graph and model (the
    launch counts set to 0 just before): every request answered once,
    finite, zero drops and zero torn batches; req/s, p50 and p99 printed
    as the virtual-clock numbers they are.  Returns the launcher's
    result and a JSON-able summary."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_gnn.main(serve_args(extra))
    torch.cuda.synchronize()
    n = int(extra[extra.index("--requests") + 1])
    summary = {k: res[k] for k in (
        "served", "dropped", "torn_batches", "throughput_rps", "p50_ms",
        "p99_ms", "replicas_peak", "replicas_final", "hot_swaps",
        "version_counts", "scale_events", "params_version",
        "forward_calls")}
    # the router's req/s divides by the host's wall time of its run, in
    # which the replicas computed one after another on this card; on the
    # virtual clock, where N replicas model N cards, the run spans first
    # arrival to last answer
    span = (max(r.done_s for r in res["responses"])
            - min(r.arrival_s for r in res["responses"]))
    summary.update(virtual_rps=n / span,
                   embedding_hit_ratio=res.get("embedding_hit_ratio"),
                   wall_s=time.perf_counter() - t0)
    print(f"   {label}: virtual clock (N replicas model N cards): "
          f"{summary['virtual_rps']:.1f} req/s, p50 {summary['p50_ms']:.3f} "
          f"ms, p99 {summary['p99_ms']:.3f} ms; wall (the replicas in turn "
          f"on this card): {summary['throughput_rps']:.1f} req/s "
          + json.dumps(summary), flush=True)
    require(res["served"] == n and res["dropped"] == 0
            and sum(res["version_counts"].values()) == n,
            f"{label}: every request served once, none dropped")
    require(res["torn_batches"] == 0, f"{label}: no torn batch")
    require(res["all_logits_finite"], f"{label}: finite logits")
    return res, summary


def require_k1_per_forward(torch, label, forwards):
    """K1 launched exactly twice per forward since the last reset, and no
    other kernel."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    require(counts == {"gather_scale_segment_sum": 2 * forwards},
            f"{label}: K1 twice a forward: {counts}, {forwards} forwards")
    return counts


@phase("12a. replicated SAGE serving: 2 replicas, both dispatch policies")
def phase_replicas(torch, results):
    """``--replicas 2`` under ``least_queue`` and ``round_robin``, 256
    requests at 2 000 req/s; then 32 of the nodes phase 3 served, asked of
    the same router (version 0): within 1e-5 of phase 3's largest logit.
    K1 twice a forward across the fleet, warmups included."""
    from repro_torch.serving import InferenceRequest
    nodes = sorted(PHASE3_LOGITS)[:32]
    require(len(nodes) == 32, f"phase 3 served 32 nodes ({len(nodes)})")
    for policy in ("least_queue", "round_robin"):
        label = f"--replicas 2 --router-policy {policy}"
        res, summary = router_run(torch, label, [
            "--requests", "256", "--replicas", "2", "--router-policy",
            policy])
        router = res["router"]
        wl = [InferenceRequest(i, n, 0.0) for i, n in enumerate(nodes)]
        router.run(wl)
        worst = max(float(np.abs(r.logits - PHASE3_LOGITS[r.node_id]).max())
                    for r in wl)
        top = max(float(np.abs(PHASE3_LOGITS[n]).max()) for n in nodes)
        summary.update(
            dispatched={r.rid: r.served for r in router.replicas},
            vs_phase3_max_abs=worst, phase3_max_abs=top,
            launches=require_k1_per_forward(torch, label,
                                            router.forward_calls))
        print(f"   32 of phase 3's nodes through the router at version "
              f"{router.version}: max |diff| {worst:.3e} (max |logit| "
              f"{top:.3e})", flush=True)
        results[f"replicas.{policy}"] = summary
        require(all(r.params_version == 0 for r in wl),
                "answered at version 0")
        require(worst <= 1e-5 * top, f"{label}: within 1e-5 of phase 3's "
                f"largest logit ({worst})")


@phase("12b. replicated SAGE serving: autoscaling from one replica")
def phase_autoscale(torch, results):
    res, summary = router_run(torch, "--replicas 1 --autoscale", [
        "--requests", "512", "--replicas", "1", "--autoscale", "--rate",
        "8000"])
    stats = res["router"].stats
    summary.update(scale_actions=[e["action"] for e in stats.scale_events],
                   launches=require_k1_per_forward(
                       torch, "autoscale", res["router"].forward_calls))
    print(f"   replicas: peak {stats.replicas_peak}, final "
          f"{stats.replicas_final}; actions {summary['scale_actions']}",
          flush=True)
    results["replicas.autoscale"] = summary
    require("up" in summary["scale_actions"], "at least one scale-up")


@phase("12c. rolling hot swaps, a checkpoint and a resume")
def phase_hot_swap(torch, results):
    """``--replicas 2 --hot-swap-every 64 --ckpt-dir``, then a second run
    on the same directory: it resumes the saved version; the same 32 nodes
    served in one batch (by a server without a cache, so both answers are
    computed alike) under the weights before the save and under the
    restored ones are bitwise equal."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.serving import GNNInferenceServer
    from repro_torch.serving.batcher import MicroBatch
    ckpt = os.path.join(ROOT, "chiprun_out", f"ckpt_{os.getpid()}")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        first, s1 = router_run(torch, "--hot-swap-every 64 --ckpt-dir", [
            "--requests", "256", "--replicas", "2", "--hot-swap-every",
            "64", "--ckpt-dir", ckpt])
        saved = first["params_version"]
        s1["launches"] = require_k1_per_forward(
            torch, "hot swaps", first["router"].forward_calls)
        require(first["hot_swaps"] >= 1 and saved == first["hot_swaps"],
                f"hot swaps happened: {s1}")
        require(latest_step(ckpt) == saved, f"step {saved} saved")
        second, s2 = router_run(torch, "resumed from --ckpt-dir", [
            "--requests", "256", "--replicas", "2", "--ckpt-dir", ckpt])
        r1, r2 = first["router"], second["router"]
        versions = {int(v) for v in second["version_counts"]}
        require(r2.version == saved and versions <= {0, saved},
                f"the second run resumed version {saved}: {s2}")
        sd1, sd2 = r1.params.state_dict(), r2.params.state_dict()
        require(list(sd1) == list(sd2)
                and all(torch.equal(sd1[k], sd2[k]) for k in sd1),
                "restored weights bitwise equal to the saved ones")
        ids = np.full(BUCKET, -1, np.int64)
        ids[:32] = sorted(PHASE3_LOGITS)[:32]
        answers, forwards = [], r2.forward_calls
        for router in (r1, r2):
            srv = GNNInferenceServer(
                router.g, router.cfg, router.params, fanouts=list(FANOUTS),
                buckets=[BUCKET], cache_policy="none", seed=0)
            answers.append(srv.serve_batch(MicroBatch([], ids, BUCKET, 0.0))
                           [:32])
            forwards += srv.forward_calls
        same = bool(np.array_equal(answers[0], answers[1]))
        results["replicas.hot_swap"] = {
            "first": s1, "second": s2, "restored_bitwise": same,
            "launches": require_k1_per_forward(torch, "resume", forwards)}
        print(f"   version {saved} saved and resumed; 32 nodes under the "
              f"restored weights bitwise equal: {same}", flush=True)
        require(same, "answers under the restored weights bitwise equal")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


@phase("12d. replicated SAGE serving over a changing graph")
def phase_replica_updates(torch, g, results):
    """``--replicas 2 --update-stream`` on phase 11(d)'s stream (128
    requests, staleness 4): every event folded into the fleet's graph,
    then a replica of the updated router against a cold server built on
    ``log.apply(g)`` with the same weights, within 1e-5."""
    from repro_torch.core.updates import load_update_stream, synthesize_updates
    from repro_torch.serving import GNNInferenceServer
    from repro_torch.serving.batcher import MicroBatch
    path = os.path.join(ROOT, "chiprun_out", "updates.jsonl")
    if not os.path.exists(path):          # phase 11(d) did not write it
        synthesize_updates(g, UPDATE_EVENTS, seed=11).to_jsonl(path)
    log = load_update_stream(path)
    res, summary = router_run(torch, "--replicas 2 --update-stream", [
        "--requests", "128", "--replicas", "2", "--staleness", "4",
        "--update-stream", path])
    router = res["router"]
    require(res["update_seq"] == log.last_seq,
            f"every event folded ({res['update_seq']} of {log.last_seq})")
    cold = GNNInferenceServer(
        log.apply(g), router.cfg, router.params, fanouts=list(FANOUTS),
        buckets=[BUCKET], cache_policy="degree",
        cache_capacity=int(NODES * 0.2), max_staleness=4, seed=0)
    cold.warmup()
    touched = log.delta(0).nodes
    rng = np.random.default_rng(12)
    others = np.setdiff1d(rng.choice(NODES, 256, replace=False), touched)
    seeds = np.concatenate([touched[:128], others[:128]])
    srv = router.replicas[0].server
    worst, top = 0.0, 0.0
    for start in range(0, len(seeds), BUCKET):
        ids = np.full(BUCKET, -1, np.int64)
        chunk = seeds[start:start + BUCKET]
        ids[:len(chunk)] = chunk
        a = srv.serve_batch(MicroBatch([], ids, BUCKET, 0.0))[:len(chunk)]
        b = cold.serve_batch(MicroBatch([], ids, BUCKET, 0.0))[:len(chunk)]
        worst = max(worst, float(np.abs(a - b).max()))
        top = max(top, float(np.abs(b).max()))
    summary.update(update_seq=res["update_seq"], delta_vs_cold_max_abs=worst,
                   cold_max_abs=top, launches=require_k1_per_forward(
                       torch, "update stream", router.forward_calls
                       + cold.forward_calls))
    print(f"   the updated fleet vs a cold server on log.apply(g), "
          f"{len(seeds)} seeds: max |diff| {worst:.3e} (max |logit| "
          f"{top:.3e})", flush=True)
    results["replicas.update_stream"] = summary
    require(worst <= 1e-5, f"updated fleet within 1e-5 of a cold rebuild "
            f"({worst})")


# ---------------------------------------------------------------------------
# transformer serving: Phi-3-mini-3.8B (dense, K7) and Mamba2-780m (ssm,
# K8) at their published widths, bf16 as their configs state
# ---------------------------------------------------------------------------

PHI3, MAMBA2, ZAMBA2 = "phi3-mini-3.8b", "mamba2-780m", "zamba2-2.7b"
# phase 13's dense configs: QKV bias and G 5 (Qwen2.5-14B, 40 / 8 x 128),
# GeGLU with tied, scaled embeddings at hd 256 (Gemma-7B, 16 / 16 x 256),
# partial rotary and G 16 (GLM-4-9B, 32 / 2 x 128)
ZOO = ("qwen2.5-14b", "gemma-7b", "glm4-9b")
# phase 13's float32 prefill against the decode-only loop runs on a cut of
# this many layers at full width (Qwen2.5-14B's float32 weights at full
# depth, about 59 GB, do not fit beside the rest)
ZOO_FP32_LAYERS = 4
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1024, 32
# the serving launcher's decode-only loop (9(a), 10(a), 16(a), 18(e)):
# prompt tokens and generated tokens a sequence (cut from 64 + 32 for
# time, PERF.md section 7: each token is one host-bound step of the loop)
SERVE_PROMPT, SERVE_GEN = 16, 16
# the decode steps timed after each full-depth bf16 prefill (9(b), 10(b),
# 13, 15, 16, 18, 19(b); cut from LM_GEN's 32 for time, PERF.md section
# 7); the caches keep room for LM_GEN, whose last position the kernel
# cases at decode shapes (Skv LM_PROMPT + LM_GEN) stand for
LM_DECODE = 8
# phases 15 and 16 hold prefill against the decode-only loop over the
# first LM_CMP_PROMPT positions of their prompts, through a prefill of
# that length: two of Zamba2's 256-position SSD chunks, so the state
# passed between chunks is checked, and four of K7's 128-key tiles, at
# half the decode steps of the whole prompt
LM_CMP_PROMPT = 512
# phase 13 compares over 128 positions (one of K7's bf16 key tiles, four
# of its float32 ones), phase 10 over 128 (half of Mamba2's SSD chunk:
# phase 15 checks the state passed between chunks, phase 8 K7's walk over
# many tiles), phase 9 over 64 (two float32 key tiles), for time (cut
# from 1024 to 512, 256 and 128 as phases 15-18 came, then 13's and 9's
# halved again for the 900 s budget, PERF.md section 7)
LM_CMP_BY_ARCH = {PHI3: 64, MAMBA2: 128, **{a: 128 for a in ZOO}}
# the configs phases 9 and 10 serve: empty, the published ones (32 and 48
# layers, one K7 or K8 launch each per prefill).  A rehearsal off the card
# puts small configs here and cuts LM_BATCH, LM_PROMPT, LM_GEN; the
# launcher in (a) then serves its --reduced config.
LM_CONFIGS: dict = {}
LM_KERNEL = {PHI3: "flash_attention", MAMBA2: "ssd_chunk_state"}
# the counter of the same kernel's float32 launches (K7's TF32 split route,
# K8's CUDA-core route)
LM_KERNEL_FP32 = {PHI3: "flash_attention_fp32",
                  MAMBA2: "ssd_chunk_state_fp32"}
# prefill tok/s of PR 14's first full run (PERF.md section 5: K8 still on
# the CUDA cores), printed beside this run's for comparison
EARLIER_PREFILL_TOK_S = {PHI3: 42294.0, MAMBA2: 26610.0}
# K7's bf16 outputs: both sides round one float32 result to bf16, so an
# element may differ by one bf16 ulp, at most 2**-7 of its plain value,
# plus the float32 sums' own difference (far below 1e-5 of the largest
# value); the kernel also rounds P to bf16 (unit roundoff 2**-8) for the
# PV product, as the TPU kernel's default-precision dot and FlashAttention
# do, which moves an output by at most 2**-8 * sum_j p_j |v_j| / l, that
# is 2**-8 times the plain version on |v|.  A dropped key tile moves a
# late row by several percent of its value, many ulps
BF16_ULP_REL, BF16_ATOL_REL, BF16_P_REL = 2.0 ** -7, 1e-5, 2.0 ** -8
# prefill against the decode-only loop at the last prompt position, full
# depth.  float32: max abs gap within LM_FP32_REL of the largest logit.
# Phi-3's paths differ by 3.0e-6 of it on the card; Mamba2's by 2.8e-4 to
# 5.2e-4 on the card and 3.9e-4 on the host's CPU (no kernel there), and
# the reference's own two paths at Mamba2's full width grow alike with
# depth (7.3e-6 at 2 layers, 9.0e-5 at 12, 4.3e-4 at 24, on the CPU:
# tests/test_torch_reference_gap.py), so that gap is the algorithms'
# float32 roundoff, not the port's.  The control, the decode loop reading
# the last or the 8th last token changed, moves the logits by 1.3-1.45 of
# the largest (launch/prefill_gap.py --flip; a token 64 back no longer
# shows: the random weights' SSM forgets within tens of positions).
# Mamba2's limit sits about 6x above its largest sound reading and far
# below the control; Phi-3's is 1e-3.  bf16: random weights amplify bf16 roundoff through the depth:
# the reference's own two paths differ by an RMS ratio |a - b| / |b| of
# 0.017 (Phi-3) and 0.30 (Mamba2), each about as far from the float32
# result, where an unrelated output gives about 1.4; the bounds are 2-6x
# the reference's.
LM_FP32_REL = {PHI3: 1e-3, MAMBA2: 3e-3, ZAMBA2: 3e-3}
LM_BF16_RMS = {PHI3: 0.1, MAMBA2: 0.6}
# the 2-layer float32 cut on the card and the CPU: (batch, tokens); Mamba2
# takes two SSD chunks of 256; the attention models four of K7's float32
# 32-key tiles (cut from 256 for time: the CPU side took 20-27 s at
# phase 13's widths, PERF.md section 7)
LM_CUT = {PHI3: (2, 128), MAMBA2: (2, 512), ZAMBA2: (2, 512),
          **{a: (2, 128) for a in ZOO}}
# phase 15: Zamba2-2.7B's float32 prefill against the decode-only loop on
# a cut of this many layers at full width (two groups of 6, so two
# applications of the shared block); Zamba2's paths hold Mamba2's bound
ZAMBA2_FP32_LAYERS = 12
# the reference's own two paths (prefill against its decode-only loop,
# float32, max_abs_rel) at Zamba2-2.7B's full width, 12 layers, 2 x 512
# tokens, measured on a CPU (tests/test_torch_reference_gap.py --arch
# zamba2-2.7b --full-width --layers 12 --prompt-len 512; the port's own
# two paths there: 1.580693408653665e-4), printed beside the card's: the
# bound sits 20x above it
ZAMBA2_REFERENCE_GAP = {"layers 12": 1.4749537658159388e-4}


def k7_case(torch, c, label, B, H, K, Sq, Skv, hd, *, hd_v=None, window=0,
            causal=True, dtype=None, timed=True):
    """K7 on (B, S, H, hd) tensors passed as (B, H, S, hd) views, as the
    model passes them (v ``hd_v`` wide, by default ``hd``), against its
    plain version; the library call is ``scaled_dot_product_attention``
    with the same mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    dtype = dtype or torch.bfloat16
    hd_v = hd_v or hd
    q = c.randn(B, Sq, H, hd).to(dtype).transpose(1, 2)
    k = c.randn(B, Skv, K, hd).to(dtype).transpose(1, 2)
    v = c.randn(B, Skv, K, hd_v).to(dtype).transpose(1, 2)
    qpos = torch.arange(Sq, device=c.dev)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=c.dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=c.dev)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    pairs = int(mask.sum())
    sdpa_kw = ({} if not causal and not window else
               {"is_causal": True} if causal and not window and Sq == Skv
               else {"attn_mask": mask})
    bf16 = dtype == torch.bfloat16
    p_term = (BF16_P_REL * fa.flash_attention_plain(
        q.float(), k.float(), v.float().abs(), causal=causal, window=window)
        if bf16 else None)
    return check_case(
        torch, label, functools.partial(fa.flash_attention_cuda,
                                        causal=causal, window=window),
        functools.partial(fa.flash_attention_plain, causal=causal,
                          window=window), (q, k, v), timed=timed,
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=H != K, **sdpa_kw),
        bytes_=q.element_size() * (B * H * Sq * (hd + hd_v)
                                   + B * K * Skv * (hd + hd_v)),
        flops=2.0 * B * H * pairs * (hd + hd_v), flush=c.flush,
        rel=BF16_ATOL_REL if bf16 else 1e-4,
        elem_rel=BF16_ULP_REL if bf16 else None, elem_abs=p_term,
        peak=BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)


def k8_case(torch, c, label, C, L, H, P, G, N, *, dtype=None, timed=True,
            route=None):
    """K8 on the views the model passes (x and Bm slices of one (C, L,
    conv_dim) tensor; dt and A in float32) against its plain version
    (1e-4 of the largest value in every route); the library call is the
    reference's einsum on its precomputed operands.  float32's bound
    takes its flops at the TF32 tensor-core rate, as K7's does.  The
    case's launches must all count under its route's counter, and the
    route must be ``route`` (by default the tensor-core one of its
    dtype)."""
    from repro_torch.kernels import ssd_chunk as sc
    dtype = dtype or torch.bfloat16
    route = route or ("wgmma" if dtype == torch.bfloat16 else "wgmma_tf32")
    xBC = c.randn(C, L, H * P + 2 * G * N).to(dtype)
    x = xBC[..., :H * P].reshape(C, L, H, P)
    Bm = xBC[..., H * P:H * P + G * N].reshape(C, L, G, N)
    dt = torch.nn.functional.softplus(c.randn(C, L, H))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=c.dev)
    Bh = Bm.repeat_interleave(H // G, dim=2).float()
    cum = torch.cumsum(dt * A, dim=1)
    decay = torch.exp(cum[:, -1:, :] - cum)
    xdt = x.float() * dt[..., None]
    plan = sc.launch_plan(x, Bm)
    print(f"   {label}: route {plan['route']}, {plan['kernel']}, counter "
          f"{plan['counter']}")
    require(plan["route"] == route, f"{label} takes the {route} route")
    before = dict(sc.launches)
    res = check_case(
        torch, label, sc.ssd_chunk_state_cuda, sc.ssd_chunk_state_plain,
        (x, dt, A, Bm), timed=timed,
        library=lambda: torch.einsum("blhn,blh,blhp->bhpn", Bh, decay, xdt),
        bytes_=(x.element_size() * (C * L * H * P + C * L * G * N)
                + 4 * (C * L * H + H + C * H * P * N)),
        flops=2.0 * C * H * L * P * N + 4.0 * C * L * H, flush=c.flush,
        peak=BF16_FLOPS_PER_S if dtype == torch.bfloat16
        else TF32_FLOPS_PER_S)
    moved = {k: n - before[k] for k, n in sc.launches.items()
             if n != before[k]}
    require(list(moved) == [plan["counter"]],
            f"{label}: every launch counted under {plan['counter']}: {moved}")
    res["route"] = plan["route"]
    return res


@phase("8. K7 flash attention and K8 SSD chunk state vs plain versions")
def phase_lm_kernels(torch, results):
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import layers as TL
    c = Checker(torch, seed=8)
    S, Bsz, Sd = LM_PROMPT, LM_BATCH, LM_PROMPT + LM_GEN
    cases = (
        ("", (f"K7 Phi-3-mini prefill (B {Bsz}, S {S}, 32 x 96, causal)",
              Bsz, 32, 32, S, S, 96), {}),
        (".gqa", (f"K7 G 5, hd 128 (Qwen2.5-14B's 40/8 heads; B 2, S {S})",
                  2, 40, 8, S, S, 128), {}),
        (".window", ("K7 Phi-3-mini prefill shape, window 256", Bsz, 32, 32,
                     S, S, 96), {"window": 256}),
        (".sq_lt_skv", (f"K7 Sq 64 < Skv {Sd}, queries at the end", Bsz, 32,
                        32, 64, Sd, 96), {}),
        (".sq1", (f"K7 Sq 1, Skv {Sd}", Bsz, 32, 32, 1, Sd, 96), {}))
    # every head width the kernel takes, a non-causal call, ragged query
    # and key tiles
    untimed = (
        (("K7 hd 64, G 4, S 200", 2, 8, 2, 200, 200, 64), {}),
        (("K7 hd 96, S 200", 2, 4, 4, 200, 200, 96), {}),
        (("K7 hd 128, G 2, S 200", 2, 4, 2, 200, 200, 128), {}),
        (("K7 hd 256 (Gemma-7B's heads), S 300", 1, 16, 16, 300, 300, 256),
         {}),
        (("K7 non-causal, Sq 48 < Skv 96, hd 64", 2, 4, 4, 48, 96, 64),
         {"causal": False}),
        (("K7 window 40, S 130", 1, 4, 2, 130, 130, 96), {"window": 40}),
        # hd 80 (Zamba2-2.7B's heads) on the hd-96 tiles: TMA's zero fill
        # past column 80 and the store's clipping, at each mask
        (("K7 hd 80, G 2, S 200", 2, 8, 4, 200, 200, 80), {}),
        (("K7 hd 80, non-causal, Sq 48 < Skv 96", 2, 4, 4, 48, 96, 80),
         {"causal": False}),
        (("K7 hd 80, window 40, S 130", 1, 4, 2, 130, 130, 80),
         {"window": 40}))
    # the head widths first: a wgmma descriptor or swizzle that does not
    # match its TMA map shows as wrong values at one width
    for args, kw in untimed:
        for name, dtype in (("bf16", torch.bfloat16),
                            ("float32", torch.float32)):
            k7_case(torch, c, f"{args[0]}, {name}", *args[1:], **kw,
                    dtype=dtype, timed=False)
    for key, args, kw in cases:
        results["flash_attention" + key] = k7_case(
            torch, c, args[0] + ", bf16", *args[1:], **kw)
    results["flash_attention_fp32"] = k7_case(
        torch, c, cases[0][1][0] + ", float32", *cases[0][1][1:],
        dtype=torch.float32)
    # the prefill shapes of phase 13's configs, timed in bf16 (the route
    # their served prefill takes) and checked in float32 (their cut's)
    for arch in ZOO:
        cfg = LM_CONFIGS.get(arch) or get_config(arch)
        shape = (Bsz, cfg.num_heads, cfg.num_kv_heads, S, S,
                 cfg.resolved_head_dim)
        label = (f"K7 {cfg.name} prefill (B {Bsz}, S {S}, {shape[1]} / "
                 f"{shape[2]} x {shape[5]}, causal)")
        results[f"flash_attention.{arch}"] = k7_case(
            torch, c, label + ", bf16", *shape)
        k7_case(torch, c, label + ", float32", *shape, dtype=torch.float32,
                timed=False)
    # Zamba2-2.7B's prefill (32 / 32 x 80, the shared block's attention),
    # timed in both dtypes: bf16 is its served prefill's route, float32
    # its 12-layer cut's (phase 15); the bound counts 80 columns
    zcfg = LM_CONFIGS.get(ZAMBA2) or get_config(ZAMBA2)
    zshape = (Bsz, zcfg.num_heads, zcfg.num_kv_heads, S, S,
              zcfg.resolved_head_dim)
    zlabel = (f"K7 {zcfg.name} prefill (B {Bsz}, S {S}, {zshape[1]} / "
              f"{zshape[2]} x {zshape[5]}, causal)")
    results[f"flash_attention.{ZAMBA2}"] = k7_case(
        torch, c, zlabel + ", bf16", *zshape)
    results[f"flash_attention_fp32.{ZAMBA2}"] = k7_case(
        torch, c, zlabel + ", float32", *zshape, dtype=torch.float32)
    # Granite-MoE-1B-A400M's prefill (16 / 8 x 64), timed in both dtypes:
    # bf16 is its served prefill's route, float32 its parity run's (16c)
    gcfg = LM_CONFIGS.get(GRANITE) or get_config(GRANITE)
    gshape = (Bsz, gcfg.num_heads, gcfg.num_kv_heads, S, S,
              gcfg.resolved_head_dim)
    glabel = (f"K7 {gcfg.name} prefill (B {Bsz}, S {S}, {gshape[1]} / "
              f"{gshape[2]} x {gshape[5]}, causal)")
    results[f"flash_attention.{GRANITE}"] = k7_case(
        torch, c, glabel + ", bf16", *gshape)
    results[f"flash_attention_fp32.{GRANITE}"] = k7_case(
        torch, c, glabel + ", float32", *gshape, dtype=torch.float32)
    # every case in both dtypes: float32 holds the CUDA-core kernel to
    # 1e-4 of the largest value at each head width and mask
    for _, args, kw in cases[1:]:
        k7_case(torch, c, args[0] + ", float32", *args[1:], **kw,
                dtype=torch.float32, timed=False)
    C = Bsz * S // 256
    results["ssd_chunk_state"] = k8_case(
        torch, c, f"K8 Mamba2-780m prefill ({C} chunks x 256, 48 x 64, N "
        f"128, G 1, bf16)", C, 256, 48, 64, 1, 128)
    results["ssd_chunk_state.g2"] = k8_case(
        torch, c, "K8 Mamba2 prefill shape, G 2", C, 256, 48, 64, 2, 128)
    # float32 at the tile on the TF32 tensor-core route: Mamba2's and
    # Zamba2-2.7B's widths timed (phase 10's and phase 15's float32
    # prefills), then ragged chunks, G 2 and more chunks than SMs
    f32 = torch.float32
    results["ssd_chunk_state_fp32"] = k8_case(
        torch, c, "K8 Mamba2 prefill shape, G 1, float32", C, 256, 48, 64, 1,
        128, dtype=f32)
    results["ssd_chunk_state_fp32.n64"] = k8_case(
        torch, c, f"K8 Zamba2-2.7B widths ({C} chunks x 256, 80 x 64, N 64, "
        f"G 1, float32)", C, 256, 80, 64, 1, 64, dtype=f32)
    for G in (1, 2):
        k8_case(torch, c, f"K8 float32, L 100, 48 x 64, N 128, G {G}", 6,
                100, 48, 64, G, 128, dtype=f32, timed=False)
    k8_case(torch, c, "K8 float32, L 7", 3, 7, 48, 64, 1, 128, dtype=f32,
            timed=False)
    k8_case(torch, c, "K8 float32, 160 chunks x 256 (a block walks 24 "
            "heads)", 160, 256, 48, 64, 1, 128, dtype=f32, timed=False)
    k8_case(torch, c, "K8 float32, L 100, 8 x 64, N 64, G 2", 6, 100, 8, 64,
            2, 64, dtype=f32, timed=False)
    k8_case(torch, c, "K8 float32, N 64, 160 chunks x 256, 64 x 64 (a block "
            "walks 32 heads, the most it takes)", 160, 256, 64, 64, 1, 64,
            dtype=f32, timed=False)
    # float32 off the tile stays on the CUDA-core kernel, counted apart
    results["ssd_chunk_state_fp32_cuda_core"] = k8_case(
        torch, c, "K8 float32, L 100, 8 x 32, N 24, G 2", 6, 100, 8, 32, 2,
        24, dtype=f32, route="cuda_core")
    # and at the reduced configs' widths (8 x 32, N 16, chunk 16), timed
    # beside the reference's einsum
    results["ssd_chunk_state_fp32_cuda_core.reduced"] = k8_case(
        torch, c, "K8 float32, L 16, 8 x 32, N 16, G 2 (the reduced "
        "configs)", 6, 16, 8, 32, 2, 16, dtype=f32, route="cuda_core")
    # ragged chunks in bf16 (positions past L arrive as zeros), and more
    # chunks than SMs (a block then walks 16 heads, the most it takes)
    for G in (1, 2):
        k8_case(torch, c, f"K8 bf16, L 100, 48 x 64, N 128, G {G}", 6, 100,
                48, 64, G, 128, timed=False)
    k8_case(torch, c, "K8 bf16, L 7", 3, 7, 48, 64, 1, 128, timed=False)
    k8_case(torch, c, "K8 bf16, 160 chunks x 256", 160, 256, 48, 64, 1,
            128, timed=False)
    # N 64 on the tensor cores: Zamba2-2.7B's SSM widths (80 heads x 64,
    # state 64, chunk 256) at the same prefill, then ragged
    results["ssd_chunk_state.n64"] = k8_case(
        torch, c, f"K8 Zamba2-2.7B widths ({C} chunks x 256, 80 x 64, N 64, "
        f"G 1, bf16)", C, 256, 80, 64, 1, 64)
    k8_case(torch, c, "K8 bf16, L 100, 8 x 64, N 64, G 2", 6, 100, 8, 64, 2,
            64, timed=False)
    k8_case(torch, c, "K8 bf16, N 64, 160 chunks x 256, 64 x 64 (a block "
            "walks 32 heads, the most it takes at N 64)", 160, 256, 64, 64,
            1, 64, timed=False)
    # bf16 off the tensor-core tile goes to the CUDA-core kernel: the
    # reduced configs' widths (8 x 32, N 16, chunk 16; timed) and a chunk
    # of 300
    results["ssd_chunk_state_bf16_cuda_core"] = k8_case(
        torch, c, "K8 bf16, L 16, 8 x 32, N 16, G 2", 6, 16, 8, 32, 2, 16,
        route="cuda_core")
    k8_case(torch, c, "K8 bf16, L 300, 8 x 64, N 128, G 1", 3, 300, 8, 64,
            1, 128, timed=False, route="cuda_core")
    # the calls K7 does not compute raise on the card, naming the ROADMAP
    # item, and never run the plain version
    q, kv = c.randn(1, 4, 2, 64), c.randn(1, 8, 2, 64)
    for what, kw in (("q_offset != Skv - Sq", {"q_offset": 0}),
                     ("kv_valid_len", {"q_offset": 4, "kv_valid_len": 6})):
        try:
            TL.attention(q, kv, kv, causal=True, **kw)
        except NotImplementedError as e:
            print(f"   attention with {what} on the card refused: {e}")
        else:
            raise RuntimeError(f"check failed: attention with {what} ran "
                               f"on the card")
    # the raw K7 and K8 wrappers are forward only: an input that requires
    # grad (grad enabled) raises, naming the autograd Function, which ops
    # runs instead (phase 20 checks its gradients); under no_grad ops runs
    # the forward alone
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    q = c.randn(1, 4, 128, 64).to(torch.bfloat16).requires_grad_()
    x = c.randn(2, 64, 4, 64).requires_grad_()
    dt, A_, Bm = c.randn(2, 64, 4).abs(), -c.randn(4).abs(), c.randn(2, 64, 1,
                                                                     64)
    for what, raw, call, fn in (
            ("K7", lambda: fa.flash_attention_cuda(q, q, q),
             lambda: ops.flash_attention(q, q, q), "FlashAttention"),
            ("K8", lambda: sc.ssd_chunk_state_cuda(x, dt, A_, Bm),
             lambda: ops.ssd_chunk_state(x, dt, A_, Bm), "SSDChunkState")):
        try:
            raw()
        except NotImplementedError as e:
            require(fn in str(e), f"{what}'s refusal names {fn}: {e}")
            print(f"   raw {what} on an input that requires grad refused: "
                  f"{e}")
        else:
            raise RuntimeError(f"check failed: raw {what} ran on an input "
                               f"that requires grad")
        require(call().grad_fn is not None and fn in type(
            call().grad_fn).__name__, f"ops runs {what} through {fn}")
        with torch.no_grad():
            require(not call().requires_grad, f"{what} runs under no_grad")


def _with_room(torch, cache, n):
    """prefill's cache (the prompt's S positions, as the reference's) with
    ``n`` zero slots more for the decode steps that follow, wherever it
    holds keys and values (the hybrid's nested ``attn``) or latents
    (mla_moe's ``{"c", "kr"}`` of each stack); an SSM cache holds no
    positions, and encdec's cross cache keeps the encoder's (zero slots
    there would add exp(0 - m) terms to every cross softmax)."""
    if "cross" in cache:
        return {"self": _with_room(torch, cache["self"], n),
                "cross": cache["cross"]}
    if "k" not in cache and "c" not in cache:
        return {k: _with_room(torch, c, n) if isinstance(c, dict) else c
                for k, c in cache.items()}
    return {k: torch.cat([c, c.new_zeros(c.shape[:2] + (n,) + c.shape[3:])],
                         dim=2) for k, c in cache.items()}


def cache_bytes(cache) -> int:
    """The bytes of a cache's tensors, nested dicts walked."""
    return sum(cache_bytes(c) if isinstance(c, dict)
               else c.numel() * c.element_size() for c in cache.values())


def kernel_kind(key: str) -> str:
    """A device kernel's kind by its name: the port's K7 or K8, a matrix
    product, a copy, or elementwise work and reductions."""
    k = key.lower()
    if any(n in k for n in ("flash_fwd_wgmma_kernel",
                            "flash_fwd_tf32_kernel", "ssd_state_kernel",
                            "ssd_state_wgmma_kernel",
                            "ssd_state_tf32_kernel")):
        return "port kernel"
    if any(n in k for n in ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                            "sm80_", "ampere_", "matmul", "nvjet",
                            "splitk")):
        return "matrix products"
    if k.startswith(("memcpy", "memset")):
        return "copies"
    return "elementwise and reductions"


def lm_profile(torch, label, step, wall_s) -> dict:
    """Device time of one ``step`` by kind (:func:`kernel_kind`), as the
    active step after a profiled warm-up step, beside the step's wall
    time ``wall_s``."""
    rows = device_rows(profile_active_step(torch, step))
    split = {}
    for e in rows:
        kind = kernel_kind(e.key)
        split[kind] = split.get(kind, 0.0) + dev_us(e) / 1e3
    total = sum(split.values())
    print(f"   (c) {label} profiled: device {total:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall ({total / (wall_s * 1e3):.2%} busy); "
          f"split (ms): " + json.dumps(split), flush=True)
    for e in rows[:10]:
        print(f"   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{kernel_kind(e.key)[:12]:12s} {e.key[:80]}")
    return {"device_ms": total, "wall_ms": wall_s * 1e3, "split_ms": split,
            "kernels": [{"kernel": e.key, "count": e.count,
                         "ms": dev_us(e) / 1e3} for e in rows[:40]]}


def _to_cuda(tree):
    """A copy of a param tree (dicts, lists, tensors) on the card."""
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


def lm_cut_parity(torch, cfg, arch) -> dict:
    """(d) A 2-layer float32 cut at full width, the same weights and tokens
    on the card and on the CPU: forward, prefill and two decode steps
    agree within 1e-4 of the largest CPU logit."""
    from repro_torch.models.transformer import model as M
    cut = cfg.replace(num_layers=2, param_dtype="float32",
                      compute_dtype="float32")
    B, S = LM_CUT[arch]
    cpu = M.init_params(cut, torch.Generator().manual_seed(3), device="cpu")
    dev = _to_cuda(cpu)
    tok = torch.randint(0, cut.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(4))
    outs = {}
    for name, params, t in (("cpu", cpu, tok), ("cuda", dev, tok.cuda())):
        with torch.inference_mode():
            lg = [M.forward(cut, params, {"tokens": t})]
            last, cache = M.prefill(cut, params, {"tokens": t})
            cache = _with_room(torch, cache, 2)
            lg.append(last)
            for i in range(2):
                last, cache = M.decode_step(cut, params, cache,
                                            {"token": t[:, i:i + 1],
                                             "pos": S + i})
                lg.append(last)
        outs[name] = [x.float().cpu() for x in lg]
    res = {}
    for what, a, b in zip(("forward", "prefill", "decode 1", "decode 2"),
                          outs["cuda"], outs["cpu"]):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        res[what] = {"max_abs_err": err, "max_abs_cpu": scale}
        require(bool(torch.isfinite(a).all()) and err <= 1e-4 * scale,
                f"2-layer float32 cut, {what}: card vs CPU {err} (max|cpu| "
                f"{scale})")
    print(f"   2-layer float32 cut ({B} x {S}), card vs CPU: "
          + json.dumps(res), flush=True)
    return res


def lm_phase(torch, arch, results):
    """One model's serving checks: (a) the serving launcher's decode-only
    loop; (b) prefill of LM_BATCH x LM_PROMPT tokens and LM_GEN decode
    steps from its cache with exactly one K7 (Phi-3) or K8 (Mamba2)
    launch per layer, and prefill against the decode-only loop at full
    depth over the prompts' first LM_CMP_BY_ARCH positions, in float32
    (two prompts) and in bf16 (all LM_BATCH); (c) a profile of one
    prefill; (d) a 2-layer float32 cut on the card and on the CPU."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.prefill_gap import decode_loop, gap
    from repro_torch.models.transformer import model as M
    dev = torch.device("cuda")
    cfg = LM_CONFIGS.get(arch) or get_config(arch)
    V, key, nl = cfg.vocab_size, LM_KERNEL[arch], cfg.num_layers
    out: dict = {}

    # (a) the reference's serving loop, through the launcher
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.run(["--arch", arch, "--batch", str(LM_BATCH),
                     "--prompt-len", str(SERVE_PROMPT), "--gen", str(SERVE_GEN)]
                    + (["--reduced"] if arch in LM_CONFIGS else []))
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    out["serve"] = {"prefill_tok_s": res["prefill_tok_s"],
                    "decode_tok_s": res["decode_tok_s"],
                    "params": res["params"], "launches": counts,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "first_tokens": res["tokens"][0, :8].tolist()}
    print(f"   (a) launch.serve (the loop serve.main runs), decode-only, "
          f"{LM_BATCH} x {SERVE_PROMPT} prompt tokens + {SERVE_GEN}: "
          + json.dumps(out["serve"]), flush=True)
    require(res["tokens"].shape == (LM_BATCH, SERVE_GEN),
            f"{SERVE_GEN} tokens per sequence")
    require(bool(torch.isfinite(res["logits"].float()).all()),
            "finite decode logits")
    require(not counts, f"the decode-only loop launches no kernel: {counts}")
    del res

    prompts = torch.randint(0, V, (LM_BATCH, LM_PROMPT), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    cmp = prompts[:, :min(LM_CMP_BY_ARCH.get(arch, LM_CMP_PROMPT),
                           LM_PROMPT)]
    with torch.inference_mode():
        # float32 weights at full depth: prefill against the decode-only
        # loop, two of the prompts
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        p32 = M.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        ops.reset_launch_counts()
        lg32, _ = M.prefill(cfg32, p32, {"tokens": cmp[:2]})
        counts32 = {k: v for k, v in ops.launch_counts().items() if v}
        results[f"launches.lm_fp32.{arch}"] = counts32
        n32 = counts32.get(LM_KERNEL_FP32[arch], 0)
        g = gap(lg32[:, :V], decode_loop(cfg32, p32, cmp[:2])[:, :V])
        out["fp32_prefill_vs_decode"] = dict(g, prompt=cmp.shape[1])
        print(f"   float32, 2 x {cmp.shape[1]}: prefill vs the decode-only "
              f"loop " + json.dumps(g), flush=True)
        require(counts32 == {LM_KERNEL_FP32[arch]: nl},
                f"{LM_KERNEL_FP32[arch]} launched {n32} times (all "
                f"launches: {counts32}) in a float32 prefill of {nl} "
                f"layers")
        require(g["max_abs"] <= LM_FP32_REL[arch] * g["max_abs_ref"],
                f"float32 prefill agrees with the decode-only loop: {g}")

        # (b) bf16, the same weights rounded
        params = M.cast_params(cfg, p32)
        del p32, lg32
        torch.cuda.empty_cache()
        M.prefill(cfg, params, {"tokens": prompts[:, :256]})      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = M.prefill(cfg, params, {"tokens": prompts})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        peak_prefill = torch.cuda.max_memory_allocated()
        # the peaks leave out the copy that grows the cache
        cache = _with_room(torch, cache, LM_GEN)
        torch.cuda.reset_peak_memory_stats()
        finite = bool(torch.isfinite(logits.float()).all())
        tok = torch.argmax(logits[:, :V], -1)[:, None]
        t0 = time.perf_counter()
        for i in range(LM_DECODE):
            logits, cache = M.decode_step(cfg, params, cache,
                                          {"token": tok,
                                           "pos": LM_PROMPT + i})
            tok = torch.argmax(logits[:, :V], -1)[:, None]
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        finite = finite and bool(torch.isfinite(logits.float()).all())
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        results[f"launches.lm.{arch}"] = counts
        out["prefill"] = {
            "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_DECODE,
            "prefill_ms": t_prefill * 1e3,
            "prefill_tok_s": LM_BATCH * LM_PROMPT / t_prefill,
            "decode_ms_per_step": t_decode / LM_DECODE * 1e3,
            "decode_tok_s": LM_BATCH * LM_DECODE / t_decode,
            "max_memory_allocated": max(peak_prefill,
                                        torch.cuda.max_memory_allocated()),
            "cache_bytes": cache_bytes(cache),
            "launches": counts}
        print(f"   (b) prefill {LM_BATCH} x {LM_PROMPT}, then {LM_DECODE} "
              f"decode steps: " + json.dumps(out["prefill"]), flush=True)
        print(f"   prefill {out['prefill']['prefill_tok_s']:.0f} tok/s; PR "
              f"14's run (PERF.md): {EARLIER_PREFILL_TOK_S[arch]:.0f} tok/s",
              flush=True)
        require(finite, "finite prefill and decode logits")
        require(counts == {key: nl}, f"one prefill and {LM_DECODE} decode "
                f"steps launch {key} exactly {nl} times: {counts}")
        # the last decode step again (it rewrites its own cache slot)
        out["profile_decode"] = lm_profile(
            torch, "one decode step", lambda: M.decode_step(
                cfg, params, cache, {"token": tok,
                                     "pos": LM_PROMPT + LM_DECODE - 1}),
            t_decode / LM_DECODE)
        del cache
        lg_cmp, _ = M.prefill(cfg, params, {"tokens": cmp})
        g = gap(lg_cmp[:, :V], decode_loop(cfg, params, cmp)[:, :V])
        out["bf16_prefill_vs_decode"] = dict(g, prompt=cmp.shape[1])
        print(f"   bf16: prefill vs the decode-only loop at position "
              f"{cmp.shape[1] - 1}: " + json.dumps(g) + f" (bound: RMS "
              f"ratio {LM_BF16_RMS[arch]})", flush=True)
        require(g["rms_ratio"] <= LM_BF16_RMS[arch],
                f"bf16 prefill agrees with the decode-only loop: {g}")

        out["profile"] = lm_profile(
            torch, "one prefill",
            lambda: M.prefill(cfg, params, {"tokens": prompts}), t_prefill)
    del params
    torch.cuda.empty_cache()
    out["cut"] = lm_cut_parity(torch, cfg, arch)
    results[f"lm.{arch}"] = out


@phase("9. serve Phi-3-mini-3.8B at full width, bf16")
def phase_phi3(torch, results):
    lm_phase(torch, PHI3, results)


@phase("10. serve Mamba2-780m at full width, bf16")
def phase_mamba2(torch, results):
    lm_phase(torch, MAMBA2, results)


def _prefix(batch, n):
    """prefill's batch cut to its first ``n`` decoder positions (vlm's
    M-RoPE positions along their last axis; encdec's frames kept)."""
    out = dict(batch)
    for key in ("tokens", "embeds"):
        if key in out:
            out[key] = out[key][:, :n]
    if "positions" in out:
        out["positions"] = out["positions"][..., :n]
    return out


def serve_full_depth(torch, cfg, arch, prompts, expected, results, *,
                     profile=None, decode_expected=None) -> dict:
    """bf16 at full width and depth, random weights (phases 13, 15, 16,
    18 and 19): a prefill of ``prompts`` (token ids (B, S), or prefill's
    batch for the stub-frontend families: vlm's embeddings at M-RoPE
    positions, encdec's frames beside the tokens) that launches exactly
    ``expected`` (launches by counter), LM_GEN decode steps in its grown
    cache that each launch exactly ``decode_expected`` (default nothing),
    finite logits; tok/s (of the S decoder positions), peak memory and
    the cache's bytes.  A vlm decode step reads the embedding of the
    token it generated.  ``profile(params, cache, tok, out)``, where
    given, runs last, with the weights, the grown cache and the last
    token still held, and its dict goes under ``"profile"``."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import model as M
    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    feed = batch.get("tokens", batch.get("embeds"))
    dev, V = feed.device, cfg.vocab_size
    B, S = feed.shape[:2]
    decode_expected = decode_expected or {}
    with torch.inference_mode():
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)

        def step(tok):
            if cfg.family == "vlm":
                return {"embeds": params["embed"]["embedding"][tok]}
            return {"token": tok}

        M.prefill(cfg, params, _prefix(batch, 256))               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = M.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        results[f"launches.lm.{arch}"] = counts
        peak_prefill = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits.float()).all())
        cache = _with_room(torch, cache, LM_GEN)
        torch.cuda.reset_peak_memory_stats()
        tok = torch.argmax(logits[:, :V], -1)[:, None]
        steps = []
        t0 = time.perf_counter()
        for i in range(LM_DECODE):
            ops.reset_launch_counts()
            logits, cache = M.decode_step(cfg, params, cache,
                                          dict(step(tok), pos=S + i))
            steps.append({k: v for k, v in ops.launch_counts().items()
                          if v})
            tok = torch.argmax(logits[:, :V], -1)[:, None]
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        finite = finite and bool(torch.isfinite(logits.float()).all())
        results[f"launches.lm_decode.{arch}"] = steps[-1]
        out = {
            "batch": B, "prompt": S, "gen": LM_DECODE,
            "params": M.param_count(params),
            "prefill_ms": t_prefill * 1e3,
            "prefill_tok_s": B * S / t_prefill,
            "decode_ms_per_step": t_decode / LM_DECODE * 1e3,
            "decode_tok_s": B * LM_DECODE / t_decode,
            "max_memory_allocated": max(peak_prefill,
                                        torch.cuda.max_memory_allocated()),
            "cache_bytes": cache_bytes(cache),
            "launches": counts, "launches_per_decode_step": steps[-1]}
        print(f"   (b) bf16, {cfg.num_layers} layers: prefill {B} x {S}, "
              f"then {LM_DECODE} decode steps: " + json.dumps(out), flush=True)
        require(finite, "finite prefill and decode logits")
        require(counts == expected and all(
            c == decode_expected for c in steps),
                f"a prefill launches exactly {expected} and each decode "
                f"step {decode_expected}: {counts}, {steps}")
        if profile is not None:
            out["profile"] = profile(params, cache, tok, out)
        del params, cache, logits
    torch.cuda.empty_cache()
    return out


def zoo_phase(torch, arch, results):
    """One of phase 13's dense configs: (a) float32 at full width on a
    ZOO_FP32_LAYERS-layer cut, prefill against the decode-only loop over
    2 x 128 tokens within 1e-3 of the largest logit, K7's
    float32 route once a layer;
    (b) bf16 at full width and depth (``serve_full_depth``): K7's bf16
    route exactly once a layer in a prefill; (c) a 2-layer float32 cut on
    the card and on the CPU (``lm_cut_parity``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.prefill_gap import decode_loop, gap
    from repro_torch.models.transformer import model as M
    dev = torch.device("cuda")
    cfg = LM_CONFIGS.get(arch) or get_config(arch)
    V, nl = cfg.vocab_size, cfg.num_layers
    out: dict = {}
    prompts = torch.randint(0, V, (LM_BATCH, LM_PROMPT), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    cmp = prompts[:2, :min(LM_CMP_BY_ARCH.get(arch, LM_CMP_PROMPT),
                           LM_PROMPT)]
    with torch.inference_mode():
        cut = cfg.replace(num_layers=min(ZOO_FP32_LAYERS, nl),
                          param_dtype="float32", compute_dtype="float32")
        p32 = M.init_params(cut, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        ops.reset_launch_counts()
        lg32, _ = M.prefill(cut, p32, {"tokens": cmp})
        counts32 = {k: v for k, v in ops.launch_counts().items() if v}
        results[f"launches.lm_fp32.{arch}"] = counts32
        g = gap(lg32[:, :V], decode_loop(cut, p32, cmp)[:, :V])
        out["fp32_cut_prefill_vs_decode"] = dict(
            g, layers=cut.num_layers, prompt=cmp.shape[1], launches=counts32)
        print(f"   (a) float32, {cut.num_layers}-layer cut, 2 x "
              f"{cmp.shape[1]}: prefill vs the decode-only loop "
              + json.dumps(g), flush=True)
        require(counts32 == {"flash_attention_fp32": cut.num_layers},
                f"K7's float32 route once a layer of the cut: {counts32}")
        require(g["max_abs"] <= 1e-3 * g["max_abs_ref"],
                f"float32 prefill agrees with the decode-only loop: {g}")
        del p32, lg32
        torch.cuda.empty_cache()

    out["prefill"] = serve_full_depth(torch, cfg, arch, prompts,
                                      {"flash_attention": nl}, results)
    out["cut"] = lm_cut_parity(torch, cfg, arch)
    results[f"lm.{arch}"] = out


@phase("15. serve Zamba2-2.7B at full width, bf16")
def phase_zamba2(torch, results):
    """The hybrid family: (a) float32 at full width on a
    ZAMBA2_FP32_LAYERS-layer cut, through ``launch/prefill_gap.py``:
    prefill against the decode-only loop over 2 x LM_CMP_PROMPT tokens
    within LM_FP32_REL of the largest logit (K8's float32 route once an
    SSM layer, K7's once a group), and its ``--flip`` control, which must
    lie above the bound; (b) bf16 at full width and depth
    (``serve_full_depth``): a prefill launches K8's bf16 route (the N 64
    tensor-core kernel) once an SSM layer and K7's bf16 route (hd 80)
    once a group, the decode steps in its grown nested cache neither;
    (c) a 2-layer float32 cut with ``attn_every`` 1 (two applications of
    the shared block) on the card and on the CPU (``lm_cut_parity``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import prefill_gap
    dev = torch.device("cuda")
    cfg = LM_CONFIGS.get(ZAMBA2) or get_config(ZAMBA2)
    nl, per = cfg.num_layers, cfg.attn_every
    out: dict = {}

    # (a) the launcher at the cut, its own seeded weights and prompts
    S_cmp = min(LM_CMP_PROMPT, LM_PROMPT)
    flags = ["--arch", ZAMBA2, "--dtype", "float32", "--layers",
             str(ZAMBA2_FP32_LAYERS), "--batch", "2", "--prompt-len",
             str(S_cmp)] + (["--reduced"] if ZAMBA2 in LM_CONFIGS else [])
    ops.reset_launch_counts()
    g = prefill_gap.run(flags)
    counts32 = {k: v for k, v in ops.launch_counts().items() if v}
    results[f"launches.lm_fp32.{ZAMBA2}"] = counts32
    flip = prefill_gap.run(flags + ["--flip", str(S_cmp - 8)])
    out["fp32_cut_prefill_vs_decode"] = dict(g, launches=counts32,
                                             flip_control=flip)
    bound = LM_FP32_REL[ZAMBA2]
    print(f"   (a) float32, {ZAMBA2_FP32_LAYERS}-layer cut, 2 x {S_cmp}: "
          f"prefill vs the decode-only loop " + json.dumps(g) + f" (bound "
          f"{bound} of the largest logit; the reference's own two paths: "
          f"{ZAMBA2_REFERENCE_GAP})", flush=True)
    print(f"   (a) control, the decode loop reading token {S_cmp - 8} "
          f"changed: max_abs_rel {flip['max_abs_rel']}", flush=True)
    # the launcher's config: the published one (or its --reduced cut)
    gap_cfg = get_config(ZAMBA2)
    if ZAMBA2 in LM_CONFIGS:
        gap_cfg = gap_cfg.reduced()
    groups = ZAMBA2_FP32_LAYERS // gap_cfg.attn_every
    require(counts32 == {"ssd_chunk_state_fp32": ZAMBA2_FP32_LAYERS,
                         "flash_attention_fp32": groups},
            f"K8's float32 route once a layer and K7's once a group of the "
            f"cut: {counts32}")
    require(g["max_abs_rel"] <= bound,
            f"float32 prefill agrees with the decode-only loop: {g}")
    require(flip["max_abs_rel"] > bound,
            f"the one-token control lies above the bound: {flip}")
    torch.cuda.empty_cache()

    # (b) bf16 at full width and depth, nl // per groups
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            device=dev, generator=torch.Generator(device=dev)
                            .manual_seed(1))
    out["prefill"] = serve_full_depth(
        torch, cfg, ZAMBA2, prompts,
        {"ssd_chunk_state": nl, "flash_attention": nl // per}, results)
    out["cut"] = lm_cut_parity(torch, cfg.replace(attn_every=1), ZAMBA2)
    results[f"lm.{ZAMBA2}"] = out


# ---------------------------------------------------------------------------
# phase 16: the moe family, Granite-MoE-1B-A400M (32 experts, top 8)
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-1b-a400m"
# 16(c): prefill against the decode-only loop needs a capacity factor
# that drops nothing on either side (a prefill groups its 1 024 tokens, a
# decode step the batch, so at 1.25 they drop different tokens): at
# least E/k = 4; the reduced configs' 8.0
GRANITE_FREE_CF = 8.0
# 16(c) runs on a cut of 6 of the 24 layers at full width: at full depth
# each of its two runs (prefill and 512 decode steps) took 29 s, and 12
# layers still put chip_smoke.py at 957 s (PR 24)
GRANITE_FP32_LAYERS = 6
# and over 2 x GRANITE_CMP_PROMPT tokens (one of K7's bf16 key tiles,
# four float32 ones; cut from LM_CMP_PROMPT's 512 for phase 18's time,
# then from 256 for the 900 s budget)
GRANITE_CMP_PROMPT = 128
# 16(f), in phase 14's world: one Granite MoE block, 8 x 1024 tokens in
# float32, its 32 experts split over the ranks
EP_BATCH, EP_SEQ = 8, 1024
# the moe module's functions 16(d) labels in its profile, and the part of
# the time each stands for
MOE_REGIONS = {"route": "router, softmax, top-k",
               "dispatch": "dispatch (places, slots, token gather)",
               "expert_ffn": "expert products",
               "combine": "combine (gather back, weighted sum)"}
LM_FP32_REL[GRANITE] = 1e-3
LM_CUT[GRANITE] = (2, 128)


def moe_profile(torch, label, step, wall_s, regions=None) -> dict:
    """Device time of one ``step`` of a ``moe`` model split by the moe
    module's functions (:data:`MOE_REGIONS`, each labelled with a
    ``record_function`` for the profile only; ``regions``, as (module,
    function name, description) triples, labels others too) and, within
    each, by :func:`kernel_kind`; the rest of the step by kernel kind
    alone.  A kernel belongs to the innermost labelled function that
    launched it; the kernels no PyTorch operator launched (the port's,
    through ``ctypes``: K7) are split by kind apart, from the profile's
    device rows.  The largest kernels of each part are listed."""
    from repro_torch.models.transformer import moe as MOE
    if regions is None:
        regions = [(MOE, n, d) for n, d in MOE_REGIONS.items()]
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in regions]
    names = {f"region.{i}": d for i, (_, _, d) in enumerate(regions)}

    def labelled(fn, name):
        @functools.wraps(fn)
        def run(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return run

    try:
        for i, (mod, n, fn) in enumerate(saved):
            setattr(mod, n, labelled(fn, f"region.{i}"))
        prof = profile_active_step(torch, step)
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    split: dict = {}
    by_name: dict = {}                 # (part, kernel): ms
    for e in prof.events():
        if not e.kernels:
            continue
        region, p = "the rest", e
        while p is not None:
            if p.name in names:
                region = names[p.name]
                break
            p = p.cpu_parent
        for kern in e.kernels:
            by_name[region, kern.name] = (by_name.get((region, kern.name),
                                                      0.0)
                                          + kern.duration / 1e3)
    rows = device_rows(prof)
    rows_ms = sum(dev_us(e) for e in rows) / 1e3
    for e in rows:
        seen = sum(ms for (_, n), ms in by_name.items() if n == e.key)
        if dev_us(e) / 1e3 - seen > 1e-6:
            key = ("launched through ctypes", e.key)
            by_name[key] = dev_us(e) / 1e3 - seen
    for (region, name), ms in by_name.items():
        part = split.setdefault(region, {})
        kind = kernel_kind(name)
        part[kind] = part.get(kind, 0.0) + ms
    total = sum(sum(v.values()) for v in split.values())
    top = {}
    for (region, name), ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        if len(top.setdefault(region, [])) < 4:
            top[region].append({"kernel": name[:90], "ms": ms})
    print(f"   (d) {label} profiled: device {total:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall ({total / (wall_s * 1e3):.2%} busy; "
          f"the kernels' own rows sum to {rows_ms:.3f} ms); split (ms): "
          + json.dumps(split), flush=True)
    for region, kernels in top.items():
        print(f"      {region}: " + json.dumps(kernels), flush=True)
    return {"device_ms": total, "kernel_rows_ms": rows_ms,
            "wall_ms": wall_s * 1e3, "split_ms": split, "top": top}


class ForcedRoutes:
    """16(e)'s stand-in for the moe module's ``route``: on the CPU it
    records each call's experts and router logits; on the card it records
    the card's own choice and logits, then routes by the CPU's experts of
    the same call (their gates renormalised from the card's softmax), so
    the two sides compute the rest of the model from one expert choice.
    A token whose expert set differs is a flip; :meth:`flips` holds each
    to a tie (``lm_cut_parity`` runs the CPU first)."""

    def __init__(self, torch, route):
        self.torch, self.route = torch, route
        self.cpu: list = []
        self.card: list = []

    def __call__(self, cfg, p, x):
        w, idx, gates = self.route(cfg, p, x)
        logits = (x.float() @ p["router"].float()).reshape(
            -1, gates.shape[-1]).cpu()
        flat = idx.reshape(-1, idx.shape[-1]).cpu()
        if x.device.type == "cpu":
            self.cpu.append((flat, logits))
            return w, idx, gates
        want = self.cpu[len(self.card)][0]
        self.card.append((flat, logits))
        idx = want.to(idx.device).reshape(idx.shape)
        w = self.torch.gather(gates, -1, idx)
        return w / w.sum(-1, keepdim=True), idx, gates

    def flips(self) -> dict:
        """The tokens whose expert set differs between the card's own
        choice and the CPU's, call by call; each must lie within the two
        sides' own logit difference of a tie: the CPU's margin between
        its k-th and (k+1)-th logit at most twice the largest card-vs-CPU
        logit difference of that call (each of the two logits moved by
        at most that much)."""
        torch = self.torch
        out = {"calls": len(self.cpu), "tokens": 0, "flips": 0,
               "max_logit_diff": 0.0, "flip_margins": [],
               "unexplained": 0}
        for (ci, cl), (gi, gl) in zip(self.cpu, self.card):
            k = ci.shape[-1]
            delta = float((cl - gl).abs().max())
            top = cl.topk(k + 1, dim=-1).values
            margin = top[:, k - 1] - top[:, k]
            differ = (ci.sort(-1).values != gi.sort(-1).values).any(-1)
            out["tokens"] += ci.shape[0]
            out["flips"] += int(differ.sum())
            out["max_logit_diff"] = max(out["max_logit_diff"], delta)
            for m in margin[differ].tolist():
                out["flip_margins"].append(m)
                out["unexplained"] += int(m > 2 * delta)
        return out


@phase("16. serve Granite-MoE-1B-A400M at full width, bf16")
def phase_granite(torch, results):
    """The moe family through K7 at hd 64: (a) the serving launcher's
    decode-only loop, no K7 launch; (b) bf16 at full width and depth
    (``serve_full_depth``): a prefill of LM_BATCH x LM_PROMPT with K7's
    bf16 route exactly once a layer, LM_GEN decode steps in its grown
    cache launching nothing, at the published capacity factor 1.25; (c)
    float32 on a GRANITE_FP32_LAYERS-layer cut through
    ``launch/prefill_gap.py --capacity-factor 8.0``
    (drop-free on both sides) over 2 x GRANITE_CMP_PROMPT tokens, within
    1e-3 of the largest logit, K7's float32 route once a layer, and its
    ``--flip`` control above the bound; (d) a profile of one prefill and
    one decode step split by :func:`moe_profile`; (e) a 2-layer float32
    cut at full width and factor 1.25 on the card and the CPU
    (``lm_cut_parity``), the card following the CPU's expert choices;
    the tokens whose expert set the card's own router picks otherwise
    are counted, and each must be a tie within the two sides' logit
    difference (:class:`ForcedRoutes`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import prefill_gap, serve
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer import moe as MOE
    dev = torch.device("cuda")
    cfg = LM_CONFIGS.get(GRANITE) or get_config(GRANITE)
    nl, V = cfg.num_layers, cfg.vocab_size
    reduced = ["--reduced"] if GRANITE in LM_CONFIGS else []
    out: dict = {}

    # (a) the serving launcher's decode-only loop
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.run(["--arch", GRANITE, "--batch", str(LM_BATCH),
                     "--prompt-len", str(SERVE_PROMPT), "--gen", str(SERVE_GEN)] + reduced)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    out["serve"] = {"prefill_tok_s": res["prefill_tok_s"],
                    "decode_tok_s": res["decode_tok_s"],
                    "params": res["params"], "launches": counts,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "first_tokens": res["tokens"][0, :8].tolist()}
    print(f"   (a) launch.serve, decode-only, {LM_BATCH} x {SERVE_PROMPT} "
          f"prompt tokens + {SERVE_GEN}: " + json.dumps(out["serve"]),
          flush=True)
    require(res["tokens"].shape == (LM_BATCH, SERVE_GEN),
            f"{SERVE_GEN} tokens per sequence")
    require(bool(torch.isfinite(res["logits"].float()).all()),
            "finite decode logits")
    require(not counts, f"the decode-only loop launches no kernel: {counts}")
    del res
    torch.cuda.empty_cache()

    # (b) bf16 at full depth, (d) its profile
    prompts = torch.randint(0, V, (LM_BATCH, LM_PROMPT), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))

    def profile(params, cache, tok, served):
        return {
            "prefill": moe_profile(
                torch, "one prefill", lambda: M.prefill(
                    cfg, params, {"tokens": prompts}),
                served["prefill_ms"] / 1e3),
            "decode": moe_profile(
                torch, "one decode step", lambda: M.decode_step(
                    cfg, params, cache, {"token": tok,
                                         "pos": LM_PROMPT + LM_DECODE - 1}),
                served["decode_ms_per_step"] / 1e3)}

    out["prefill"] = serve_full_depth(
        torch, cfg, GRANITE, prompts, {"flash_attention": nl}, results,
        profile=profile)

    # (c) float32 prefill against the decode-only loop, drop-free
    S_cmp = min(GRANITE_CMP_PROMPT, LM_PROMPT)
    layers = GRANITE_FP32_LAYERS
    flags = ["--arch", GRANITE, "--dtype", "float32", "--layers",
             str(layers), "--capacity-factor", str(GRANITE_FREE_CF),
             "--batch", "2", "--prompt-len", str(S_cmp)] + reduced
    ops.reset_launch_counts()
    g = prefill_gap.run(flags)
    counts32 = {k: v for k, v in ops.launch_counts().items() if v}
    results[f"launches.lm_fp32.{GRANITE}"] = counts32
    flip = prefill_gap.run(flags + ["--flip", str(S_cmp - 8)])
    out["fp32_prefill_vs_decode"] = dict(g, launches=counts32,
                                         flip_control=flip)
    bound = LM_FP32_REL[GRANITE]
    print(f"   (c) float32, {layers} layers, capacity factor "
          f"{GRANITE_FREE_CF}, 2 x {S_cmp}: prefill vs the decode-only loop "
          + json.dumps(g) + f" (bound {bound} of the largest logit)",
          flush=True)
    print(f"   (c) control, the decode loop reading token {S_cmp - 8} "
          f"changed: max_abs_rel {flip['max_abs_rel']}", flush=True)
    require(counts32 == {"flash_attention_fp32": layers},
            f"K7's float32 route once a layer: {counts32}")
    require(g["max_abs_rel"] <= bound,
            f"float32 prefill agrees with the decode-only loop: {g}")
    require(flip["max_abs_rel"] > bound,
            f"the one-token control lies above the bound: {flip}")
    torch.cuda.empty_cache()

    # (e) card against CPU at factor 1.25: the card follows the CPU's
    # expert choices, and every token where its own choice differs must
    # be a tie within the two sides' logit difference
    forced = ForcedRoutes(torch, MOE.route)
    MOE.route = forced
    try:
        out["cut"] = lm_cut_parity(torch, cfg, GRANITE)
    finally:
        MOE.route = forced.route
    fl = forced.flips()
    out["cut"]["routing"] = fl
    print(f"   (e) expert sets, card's own choice vs the CPU's: "
          + json.dumps(fl), flush=True)
    require(fl["calls"] == len(forced.card) > 0 and fl["unexplained"] == 0,
            f"every expert-set flip lies within the card-vs-CPU logit "
            f"difference of a tie: {fl}")
    results[f"lm.{GRANITE}"] = out


# ---------------------------------------------------------------------------
# phase 18: the mla_moe family, DeepSeek-V3 (MLA, 256 experts, top 8)
# ---------------------------------------------------------------------------

DSV3 = "deepseek-v3-671b"
# 18(b): the bf16 cut served at full width: the published 3 dense layers
# and 2 MoE layers, 5 of 61 (about 53 GB of weights; the published depth,
# about 1.3 TB in bf16, does not fit a card)
DSV3_LAYERS = 5
# 18(c): float32 prefill against the decode-only loop on a cut of 1 dense
# + 1 MoE layer (about 55 GB), over 2 x 128 tokens (cut from 256 for the
# 900 s budget) at the drop-free factor E/k = 32 (a prefill's one group
# of 256 tokens has C = 256); the control, the decode loop reading the
# prompt's last token changed, must move the logits by more than
# DSV3_FLIP_MIN of the largest (a token further back reaches the last
# position only through two attention layers: 8 back, it moved a
# 1024-wide float32 cut's logits by 0.14 of the largest on a CPU, too
# near the floor)
DSV3_FP32_LAYERS, DSV3_CMP_PROMPT, DSV3_FREE_CF = 2, 128, 32.0
DSV3_FLIP_MIN = 0.1
LM_FP32_REL[DSV3] = 1e-3
# 18(d): the first dense MLA block at full width in float32 on the card and
# the CPU, over 1 x DSV3_BLOCK_TOKENS tokens (the full cut does not fit the
# host's memory)
DSV3_BLOCK_TOKENS = 256


def sdpa_backend(torch, fn) -> dict:
    """The backend ``scaled_dot_product_attention`` picks for the call
    ``fn`` makes, read from the device kernels one call launches: flash,
    efficient (memory-efficient), cudnn, math (kernels, none of them a
    fused one), or "not seen" where the profile holds no device row."""
    names = [e.key for e in device_rows(profile_active_step(torch, fn))]
    low = " ".join(names).lower()
    backend = ("not seen" if not names else
               "cudnn" if "cudnn" in low else
               "flash" if "flash" in low else
               "efficient" if ("fmha" in low or "efficient" in low
                               or "mem_eff" in low) else "math")
    return {"backend": backend, "kernels": [n[:80] for n in names[:4]]}


def mla_k7_cases(torch, cfg, results) -> dict:
    """18(a): K7 at MLA's (q/k, v) widths against its plain version at
    the served prefill's shape, Sq 64 against Skv LM_PROMPT + LM_GEN and a
    window of 256, in bf16 and float32, each timed beside its bound and
    SDPA's time (the backend SDPA picks, by dtype, from its kernels at the
    prefill shape); then small ragged shapes (G 2, non-causal, a window of
    40), untimed."""
    import torch.nn.functional as F
    c = Checker(torch, seed=18)
    H = cfg.num_heads
    hd, hd_v = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    S, Bsz, Sd = LM_PROMPT, LM_BATCH, LM_PROMPT + LM_GEN
    name = f"K7 {cfg.name} MLA ({hd}, {hd_v})"
    cases = (("", f"{name} prefill (B {Bsz}, S {S}, {H} / {H} heads, "
                  f"causal)", (Bsz, H, H, S, S), {}),
             (".sq_lt_skv", f"{name}, Sq 64 < Skv {Sd}", (Bsz, H, H, 64, Sd),
              {}),
             (".window", f"{name} prefill shape, window 256",
              (Bsz, H, H, S, S), {"window": 256}))
    out = {}
    for dname, dtype, counter in (("bf16", torch.bfloat16, "flash_attention"),
                                  ("float32", torch.float32,
                                   "flash_attention_fp32")):
        for key, label, shape, kw in cases:
            r = k7_case(torch, c, f"{label}, {dname}", *shape, hd,
                        hd_v=hd_v, dtype=dtype, **kw)
            results[f"{counter}.{DSV3}{key}"] = r
        q = c.randn(Bsz, S, H, hd).to(dtype).transpose(1, 2)
        v = c.randn(Bsz, S, H, hd_v).to(dtype).transpose(1, 2)
        out[f"sdpa_{dname}"] = sdpa_backend(torch, lambda: (
            F.scaled_dot_product_attention(q, q, v, is_causal=True)))
        results[f"{counter}.{DSV3}"]["library_backend"] = \
            out[f"sdpa_{dname}"]["backend"]
        print(f"   SDPA at the prefill shape, {dname}: "
              + json.dumps(out[f"sdpa_{dname}"]), flush=True)
        del q, v
        for args, kw in (((f"{name}, G 2, S 200", 2, 8, 4, 200, 200), {}),
                         ((f"{name}, non-causal, Sq 48 < Skv 96", 2, 4, 4,
                           48, 96), {"causal": False}),
                         ((f"{name}, window 40, S 130", 1, 4, 2, 130, 130),
                          {"window": 40})):
            k7_case(torch, c, f"{args[0]}, {dname}", *args[1:], hd,
                    hd_v=hd_v, dtype=dtype, timed=False, **kw)
    return out


def mla_block_parity(torch, cfg) -> dict:
    """18(d): the first dense MLA block (``_mla_body`` with the dense
    FFN) at full width in float32, its weights drawn on the CPU, on the
    card (K7's float32 route, once) and on the CPU over the same 1 x
    DSV3_BLOCK_TOKENS inputs: within 1e-4 of the largest CPU output."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import model as M
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    T = DSV3_BLOCK_TOKENS
    p_cpu = M._init_mla_dense_layer(c32, torch.Generator().manual_seed(3),
                                    torch.float32, "cpu")
    x = torch.randn(1, T, c32.d_model,
                    generator=torch.Generator().manual_seed(4))
    pos = torch.arange(T)[None]
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = M._mla_body(c32, x, p_cpu, pos)
        cpu_s = time.perf_counter() - t0
        p_dev = _to_cuda(p_cpu)
        ops.reset_launch_counts()
        got = M._mla_body(c32, x.cuda(), p_dev, pos.cuda()).cpu()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    res = {"tokens": T, "max_abs_err": err, "max_abs_cpu": scale,
           "cpu_s": cpu_s, "launches": counts}
    print(f"   (d) the first dense MLA block, float32, 1 x {T}, card vs CPU: "
          + json.dumps(res), flush=True)
    require(counts == {"flash_attention_fp32": 1},
            f"the block launches K7's float32 route once: {counts}")
    require(bool(torch.isfinite(got).all()) and err <= 1e-4 * scale,
            f"the dense MLA block, card vs CPU: {err} (max|cpu| {scale})")
    return res


@phase("18. serve DeepSeek-V3 (mla_moe) at full width, bf16")
def phase_deepseek(torch, results):
    """The mla_moe family through K7 at (192, 128): (a) K7's cases
    (:func:`mla_k7_cases`); (b) bf16 on a DSV3_LAYERS-layer cut at full
    width (``serve_full_depth``): K7's bf16 route exactly once a layer in
    a prefill, none in the decode steps, and a profile of the prefill
    split into the MLA blocks' own work (``attention.mla_forward``: the
    projections, the latent's norm and RoPE, the decompression; K7 apart,
    launched through ctypes), the moe module's functions and the rest;
    (c) float32 prefill against the decode-only loop through
    ``launch/prefill_gap.py --layers DSV3_FP32_LAYERS --capacity-factor
    32`` over 2 x DSV3_CMP_PROMPT tokens within LM_FP32_REL of the
    largest logit, K7's float32 route once a layer, and its ``--flip``
    control above DSV3_FLIP_MIN; (d) the first dense MLA block on the card
    and the CPU (:func:`mla_block_parity`); (e) the serving launcher's
    decode-only loop at ``--reduced`` (no K7 launch)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import prefill_gap, serve
    from repro_torch.models.transformer import attention as A
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer import moe as MOE
    dev = torch.device("cuda")
    cfg = LM_CONFIGS.get(DSV3) or get_config(DSV3)
    reduced = ["--reduced"] if DSV3 in LM_CONFIGS else []
    out: dict = {}

    # (a) K7 at (192, 128)
    out["k7"] = mla_k7_cases(torch, cfg, results)
    torch.cuda.empty_cache()

    # (b) bf16 on the cut, its prefill profiled
    cut = cfg.replace(num_layers=min(DSV3_LAYERS, cfg.num_layers))
    prompts = torch.randint(0, cut.vocab_size, (LM_BATCH, LM_PROMPT),
                            device=dev, generator=torch.Generator(device=dev)
                            .manual_seed(1))
    regions = [(A, "mla_forward", "MLA projections, norms, RoPE, "
                "decompression (K7 apart)")] + [
        (MOE, n, d) for n, d in MOE_REGIONS.items()]

    def profile(params, cache, tok, served):
        return moe_profile(torch, "one prefill", lambda: M.prefill(
            cut, params, {"tokens": prompts}), served["prefill_ms"] / 1e3,
            regions=regions)

    out["prefill"] = serve_full_depth(
        torch, cut, DSV3, prompts, {"flash_attention": cut.num_layers},
        results, profile=profile)
    print(f"   (b) {cut.num_layers} layers ({cut.first_dense_layers} dense),"
          f" prefill {out['prefill']['prefill_tok_s']:.0f} tok/s, decode "
          f"{out['prefill']['decode_ms_per_step']:.2f} ms a step, peak "
          f"{out['prefill']['max_memory_allocated'] / 2**30:.2f} GiB",
          flush=True)

    # (c) float32 prefill against the decode-only loop, drop-free
    S_cmp = min(DSV3_CMP_PROMPT, LM_PROMPT)
    flags = ["--arch", DSV3, "--dtype", "float32", "--layers",
             str(DSV3_FP32_LAYERS), "--capacity-factor", str(DSV3_FREE_CF),
             "--batch", "2", "--prompt-len", str(S_cmp)] + reduced
    ops.reset_launch_counts()
    g = prefill_gap.run(flags)
    counts32 = {k: v for k, v in ops.launch_counts().items() if v}
    results[f"launches.lm_fp32.{DSV3}"] = counts32
    torch.cuda.empty_cache()
    flip = prefill_gap.run(flags + ["--flip", str(S_cmp - 1)])
    torch.cuda.empty_cache()
    out["fp32_prefill_vs_decode"] = dict(g, launches=counts32,
                                         flip_control=flip)
    bound = LM_FP32_REL[DSV3]
    print(f"   (c) float32, {DSV3_FP32_LAYERS} layers (1 dense, 1 MoE), "
          f"capacity factor {DSV3_FREE_CF}, 2 x {S_cmp}: prefill vs the "
          f"decode-only loop " + json.dumps(g) + f" (bound {bound} of the "
          f"largest logit)", flush=True)
    print(f"   (c) control, the decode loop reading token {S_cmp - 1} "
          f"changed: max_abs_rel {flip['max_abs_rel']}", flush=True)
    require(counts32 == {"flash_attention_fp32": DSV3_FP32_LAYERS},
            f"K7's float32 route once a layer: {counts32}")
    require(g["max_abs_rel"] <= bound,
            f"float32 prefill agrees with the decode-only loop: {g}")
    require(flip["max_abs_rel"] > DSV3_FLIP_MIN,
            f"the one-token control lies above {DSV3_FLIP_MIN}: {flip}")

    # (d) the first dense MLA block, card against CPU
    out["block"] = mla_block_parity(torch, cfg)
    torch.cuda.empty_cache()

    # (e) the serving launcher's decode-only loop at the reduced config
    ops.reset_launch_counts()
    res = serve.run(["--arch", DSV3, "--reduced", "--batch", str(LM_BATCH),
                     "--prompt-len", str(SERVE_PROMPT), "--gen", str(SERVE_GEN)])
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    out["serve_reduced"] = {"prefill_tok_s": res["prefill_tok_s"],
                            "decode_tok_s": res["decode_tok_s"],
                            "params": res["params"], "launches": counts}
    print(f"   (e) launch.serve --reduced, decode-only, {LM_BATCH} x "
          f"{SERVE_PROMPT} + {SERVE_GEN}: " + json.dumps(out["serve_reduced"]),
          flush=True)
    require(res["tokens"].shape == (LM_BATCH, SERVE_GEN),
            f"{SERVE_GEN} tokens per sequence")
    require(bool(torch.isfinite(res["logits"].float()).all()),
            "finite decode logits")
    require(not counts, f"the decode-only loop launches no kernel: {counts}")
    results[f"lm.{DSV3}"] = out


# ---------------------------------------------------------------------------
# phase 19: the encdec (Whisper-tiny) and vlm (Qwen2-VL-7B) families
# ---------------------------------------------------------------------------

WHISPER, QWEN2VL = "whisper-tiny", "qwen2-vl-7b"
# 19(b): Whisper's 30-s window, 1 500 frame embeddings after its stride-2
# conv stem (stubbed, as in the reference), and a 224-token decoder prompt
# (32 decode steps stay within its 448-token context)
WHISPER_ENC_LEN, WHISPER_PROMPT = 1500, 224
# 19(c): Qwen2-VL's M-RoPE layout over LM_PROMPT positions: text tokens,
# a grid of merged patches (rows x cols), text tokens
QWEN2VL_LAYOUT = (128, 24, 32, 128)
# 19(d): float32 prefill against the decode-only loop over 2 x 128
# positions (cut from 256 for the 900 s budget), Whisper at full depth,
# Qwen2-VL on a 4-layer cut at full width; the control (the last token, or its embedding, changed) must
# lie above ENCDEC_VLM_FLIP_FACTOR times the gap and above the bound
ENCDEC_VLM_CMP, QWEN2VL_FP32_LAYERS, ENCDEC_VLM_FLIP_FACTOR = 128, 4, 100.0
LM_FP32_REL[WHISPER] = LM_FP32_REL[QWEN2VL] = 1e-3
# 19(e): Qwen2-VL's first block on the card and the CPU in float32, under
# this M-RoPE layout (32 text, a 12 x 16 grid, 32 text: 256 positions)
QWEN2VL_BLOCK_LAYOUT = (32, 12, 16, 32)


def mrope_positions(torch, B, n_text, gh, gw, n_after, dev):
    """Qwen2-VL's M-RoPE position ids (3, B, S) for ``n_text`` text tokens
    (t = h = w = i), a gh x gw grid of merged patches (t = n_text, h =
    n_text + row, w = n_text + col) and ``n_after`` text tokens continuing
    from n_text + max(gh, gw), as Qwen2-VL numbers an image's patches."""
    text = torch.arange(n_text, device=dev).expand(3, n_text)
    rows = torch.arange(gh, device=dev).repeat_interleave(gw)
    cols = torch.arange(gw, device=dev).repeat(gh)
    img = torch.stack([torch.zeros_like(rows), rows, cols]) + n_text
    after = (n_text + max(gh, gw) + torch.arange(n_after, device=dev)
             ).expand(3, n_after)
    pos = torch.cat([text, img, after], dim=1)
    return pos[:, None].expand(3, B, pos.shape[1]).contiguous()


def encdec_vlm_k7_cases(torch, wcfg, qcfg, results) -> dict:
    """19(a): K7 at the new call shapes, each in bf16 (element by element,
    as phase 8) and float32 (1e-4 of the largest value), timed beside its
    bound and SDPA's time: Whisper's encoder (non-causal, Se x Se), its
    cross attention from prefill (Sd x Se) and from one-token decode (1 x
    Se), and Qwen2-VL's causal prefill (G 7, hd 128)."""
    c = Checker(torch, seed=19)
    Bsz, Se, Sd, S = LM_BATCH, WHISPER_ENC_LEN, WHISPER_PROMPT, LM_PROMPT
    wh = (wcfg.num_heads, wcfg.num_kv_heads)
    qh = (qcfg.num_heads, qcfg.num_kv_heads)
    cases = (
        ("whisper.encoder", f"K7 {wcfg.name} encoder (B {Bsz}, {Se} x {Se}, "
         f"{wh[0]} / {wh[1]} x {wcfg.resolved_head_dim}, non-causal)",
         (Bsz, *wh, Se, Se, wcfg.resolved_head_dim), {"causal": False}),
        ("whisper.cross_prefill", f"K7 {wcfg.name} cross attention, prefill "
         f"(B {Bsz}, Sq {Sd} x Skv {Se})",
         (Bsz, *wh, Sd, Se, wcfg.resolved_head_dim), {"causal": False}),
        ("whisper.cross_decode", f"K7 {wcfg.name} cross attention, decode "
         f"(B {Bsz}, Sq 1 x Skv {Se})",
         (Bsz, *wh, 1, Se, wcfg.resolved_head_dim), {"causal": False}),
        (QWEN2VL, f"K7 {qcfg.name} prefill (B {Bsz}, S {S}, {qh[0]} / "
         f"{qh[1]} x {qcfg.resolved_head_dim}, causal)",
         (Bsz, *qh, S, S, qcfg.resolved_head_dim), {}))
    out = {}
    for dname, dtype, counter in (("bf16", torch.bfloat16, "flash_attention"),
                                  ("float32", torch.float32,
                                   "flash_attention_fp32")):
        for key, label, shape, kw in cases:
            r = k7_case(torch, c, f"{label}, {dname}", *shape, dtype=dtype,
                        **kw)
            results[f"{counter}.{key}"] = r
            out[f"{key}.{dname}"] = r
    return out


def encdec_vlm_gap(torch, arch, cfg_name, layers, expected, reduced,
                   results):
    """19(d): float32 prefill against the decode-only loop through
    ``launch/prefill_gap.py`` over 2 x ENCDEC_VLM_CMP positions (Whisper
    with WHISPER_ENC_LEN frames), the launches of both paths by counter
    (``expected``), and the ``--flip`` control (the last position's token,
    or Qwen2-VL's embedding, changed)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import prefill_gap
    S_cmp = min(ENCDEC_VLM_CMP, LM_PROMPT)
    flags = (["--arch", arch, "--dtype", "float32", "--batch", "2",
              "--prompt-len", str(S_cmp), "--enc-len", str(WHISPER_ENC_LEN)]
             + (["--layers", str(layers)] if layers else []) + reduced)
    ops.reset_launch_counts()
    g = prefill_gap.run(flags)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    results[f"launches.lm_fp32.{arch}"] = counts
    torch.cuda.empty_cache()
    flip = prefill_gap.run(flags + ["--flip", str(S_cmp - 1)])
    torch.cuda.empty_cache()
    bound = LM_FP32_REL[arch]
    print(f"   (d) {cfg_name}, float32, {g['layers']} layers, 2 x {S_cmp}: "
          f"prefill vs the decode-only loop " + json.dumps(g) + f" (bound "
          f"{bound} of the largest logit); launches {counts}", flush=True)
    print(f"   (d) control, position {S_cmp - 1} changed: max_abs_rel "
          f"{flip['max_abs_rel']}", flush=True)
    require(counts == expected, f"{cfg_name}: the float32 prefill and the "
            f"decode-only loop launch {expected}: {counts}")
    require(g["max_abs_rel"] <= bound,
            f"{cfg_name}: float32 prefill agrees with the decode-only loop: "
            f"{g}")
    require(flip["max_abs_rel"] > max(bound, ENCDEC_VLM_FLIP_FACTOR
                                      * g["max_abs_rel"]),
            f"{cfg_name}: the control lies clearly above the gap: {flip}")
    return dict(g, launches=counts, flip_control=flip)


def _card_vs_cpu(torch, label, fn, params, inputs, want_launches) -> dict:
    """``fn(params, *inputs)`` in float32 on the CPU and on the card
    (params and inputs copied there): within 1e-4 of the largest CPU
    output, with exactly ``want_launches`` on the card."""
    from repro_torch.kernels import ops
    with torch.inference_mode():
        want = fn(params, *inputs)
        ops.reset_launch_counts()
        got = fn(_to_cuda(params), *(t.cuda() for t in inputs)).cpu()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    res = {"max_abs_err": err, "max_abs_cpu": scale, "launches": counts}
    print(f"   (e) {label}, float32, card vs CPU: " + json.dumps(res),
          flush=True)
    require(counts == want_launches,
            f"{label} launches {want_launches}: {counts}")
    require(bool(torch.isfinite(got).all()) and err <= 1e-4 * scale,
            f"{label}, card vs CPU: {err} (max|cpu| {scale})")
    return res


def encdec_vlm_block_parity(torch, wcfg, qcfg) -> dict:
    """19(e): Whisper's first encoder block (non-causal) over 1 x
    WHISPER_ENC_LEN frames, its first decoder block (causal self and
    cross attention) over 1 x WHISPER_PROMPT positions against a random
    encoder output, and Qwen2-VL's first block under the
    QWEN2VL_BLOCK_LAYOUT M-RoPE positions, each in float32 with weights
    drawn on the CPU, on the card and the CPU."""
    from repro_torch.models.transformer import attention as A
    from repro_torch.models.transformer import model as M
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    w32, q32 = wcfg.replace(**f32), qcfg.replace(**f32)
    gen = torch.Generator().manual_seed(3)

    def x(*shape):
        return torch.randn(shape, generator=gen)

    Se, Sd = WHISPER_ENC_LEN, WHISPER_PROMPT
    out = {}
    enc_p = M._init_encdec_layer(w32, gen, torch.float32, "cpu", cross=False)
    out["whisper_encoder_block"] = _card_vs_cpu(
        torch, f"{wcfg.name}'s first encoder block, 1 x {Se}",
        lambda p, h, pos: M._dense_body(w32, h, p, pos, causal=False),
        enc_p, (x(1, Se, w32.d_model), torch.arange(Se)[None]),
        {"flash_attention_fp32": 1})

    def dec(p, h, pos, enc):
        xk, xv = A._kv(w32, p["xattn"], enc)
        return M._dec_body(w32, h, p, pos, xk, xv)[0]

    dec_p = M._init_encdec_layer(w32, gen, torch.float32, "cpu", cross=True)
    out["whisper_decoder_block"] = _card_vs_cpu(
        torch, f"{wcfg.name}'s first decoder block, 1 x {Sd} over {Se} "
        f"frames", dec, dec_p, (x(1, Sd, w32.d_model),
                                torch.arange(Sd)[None],
                                x(1, Se, w32.d_model)),
        {"flash_attention_fp32": 2})
    pos = mrope_positions(torch, 1, *QWEN2VL_BLOCK_LAYOUT, "cpu")
    q_p = M._init_dense_layer(q32, gen, torch.float32, "cpu")
    out["qwen2vl_block"] = _card_vs_cpu(
        torch, f"{qcfg.name}'s first block, 1 x {pos.shape[-1]}, M-RoPE "
        f"layout {QWEN2VL_BLOCK_LAYOUT}",
        lambda p, h, ps: M._dense_body(q32, h, p, ps), q_p,
        (x(1, pos.shape[-1], q32.d_model), pos), {"flash_attention_fp32": 1})
    return out


@phase("19. serve Whisper-tiny (encdec) and Qwen2-VL-7B (vlm) at full "
       "width, bf16")
def phase_encdec_vlm(torch, results):
    """The encdec and vlm families through K7: (a) K7 at their new call
    shapes (:func:`encdec_vlm_k7_cases`); (b) Whisper-tiny in bf16 at
    full size (``serve_full_depth``): 1 500 frames and a 224-token
    prompt, K7 exactly 12 times a prefill (4 encoder, 4 causal decoder, 4
    cross) and 4 times a decode step (cross attention; self attention
    decodes in plain PyTorch, as the reference); (c) Qwen2-VL-7B in bf16
    at full depth, its prompt's M-RoPE positions in Qwen2-VL's image
    layout (QWEN2VL_LAYOUT), K7 exactly once a layer in a prefill and
    never in decode, the prefill profiled by kind; (d) float32 prefill
    against the decode-only loop (:func:`encdec_vlm_gap`); (e) card
    against CPU (:func:`encdec_vlm_block_parity`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.prefill_gap import stub_inputs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    wcfg = LM_CONFIGS.get(WHISPER) or get_config(WHISPER)
    qcfg = LM_CONFIGS.get(QWEN2VL) or get_config(QWEN2VL)
    out: dict = {}

    # (a) K7 at the new shapes
    out["k7"] = encdec_vlm_k7_cases(torch, wcfg, qcfg, results)
    torch.cuda.empty_cache()

    # (b) Whisper-tiny, bf16, full size
    nl, ne = wcfg.num_layers, wcfg.encoder_layers
    out["whisper"] = serve_full_depth(
        torch, wcfg, WHISPER,
        stub_inputs(wcfg, LM_BATCH, WHISPER_PROMPT, gen, dev,
                    enc_len=WHISPER_ENC_LEN),
        {"flash_attention": ne + 2 * nl}, results,
        decode_expected={"flash_attention": nl})

    # (c) Qwen2-VL-7B, bf16, full depth, the image layout's positions
    batch = dict(stub_inputs(qcfg, LM_BATCH, LM_PROMPT, gen, dev),
                 positions=mrope_positions(torch, LM_BATCH, *QWEN2VL_LAYOUT,
                                           dev))
    require(batch["positions"].shape[-1] == LM_PROMPT,
            f"the M-RoPE layout {QWEN2VL_LAYOUT} covers {LM_PROMPT}")

    def profile(params, cache, tok, served):
        from repro_torch.models.transformer import model as M
        return lm_profile(torch, "one prefill", lambda: M.prefill(
            qcfg, params, batch), served["prefill_ms"] / 1e3)

    out["qwen2vl"] = serve_full_depth(
        torch, qcfg, QWEN2VL, batch, {"flash_attention": qcfg.num_layers},
        results, profile=profile)
    del batch
    torch.cuda.empty_cache()

    # (d) float32 prefill against the decode-only loop
    reduced = {a: ["--reduced"] if a in LM_CONFIGS else []
               for a in (WHISPER, QWEN2VL)}
    gap_w = get_config(WHISPER).reduced() if reduced[WHISPER] else \
        get_config(WHISPER)
    S_cmp = min(ENCDEC_VLM_CMP, LM_PROMPT)
    # prefill: 12; the loop: a prefill over the first token (12), then 4
    # cross attentions a step
    n_w = gap_w.encoder_layers + 2 * gap_w.num_layers
    out["whisper_gap"] = encdec_vlm_gap(
        torch, WHISPER, wcfg.name, 0,
        {"flash_attention_fp32": 2 * n_w + gap_w.num_layers * (S_cmp - 1)},
        reduced[WHISPER], results)
    out["qwen2vl_gap"] = encdec_vlm_gap(
        torch, QWEN2VL, qcfg.name, QWEN2VL_FP32_LAYERS,
        {"flash_attention_fp32": QWEN2VL_FP32_LAYERS}, reduced[QWEN2VL],
        results)

    # (e) card against CPU
    out["cpu"] = encdec_vlm_block_parity(torch, wcfg, qcfg)
    results["lm.encdec_vlm"] = out


def ep_inputs(torch, dev, batch, seq):
    """16(f)'s block: Granite's MoE layer at full width in float32 (32
    experts, top 8, capacity factor 1.25) and its ``batch`` x ``seq``
    input, drawn on ``dev`` from one seed, so every rank of a world on
    that card and the main process hold the same numbers."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import moe as MOE
    cfg = get_config(GRANITE).replace(param_dtype="float32",
                                      compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(16)
    p = MOE.init_moe(cfg, gen, torch.float32, dev)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev)
    return cfg, p, x


def dist_moe_ep_job(rank, world, dev, *, batch, seq):
    """(16f) One Granite MoE block through ``moe_expert_parallel``: the
    rank keeps its experts' rows (``expert_shard``), runs the block three
    times (the last one timed and its bytes counted), and returns its
    output's digest, rank 0 also the output."""
    import hashlib

    import torch
    from repro_torch.core import collectives as C
    from repro_torch.core import parallel as PL
    cfg, p, x = ep_inputs(torch, dev, batch, seq)
    p = PL.expert_shard(cfg, p, rank, world)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        for _ in range(2):
            PL.moe_expert_parallel(cfg, p, x, capacity_factor=1.25)
        sync()
        C.STATS.reset()
        t0 = time.perf_counter()
        y = PL.moe_expert_parallel(cfg, p, x, capacity_factor=1.25)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
    host = y.cpu().numpy()
    return {"ms": ms, "comm": C.STATS.snapshot(),
            "experts": int(p["w_in"].shape[0]),
            "digest": hashlib.sha256(host.tobytes()).hexdigest(),
            "y": host if rank == 0 else None}


def _ep_checks(torch, res, results):
    """(16f) The EP block against the single card's
    ``moe_block_gathered`` on the same numbers: within 1e-5 of its
    largest value, every rank's output bitwise equal; ms and bytes a
    rank beside the single card's ms."""
    from repro_torch.models.transformer import moe as MOE
    dev = torch.device("cuda")
    cfg, p, x = ep_inputs(torch, dev, EP_BATCH, EP_SEQ)
    with torch.inference_mode():
        for _ in range(2):
            MOE.moe_block_gathered(cfg, p, x, capacity_factor=1.25)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = MOE.moe_block_gathered(cfg, p, x, capacity_factor=1.25)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
    want = want.cpu().numpy()
    ranks = res["ranks"]
    err = float(np.abs(ranks[0]["y"] - want).max())
    top = float(np.abs(want).max())
    summary = {"tokens": x.shape[0] * x.shape[1], "world": len(ranks),
               "experts_per_rank": [r["experts"] for r in ranks],
               "max_abs_err": err, "max_abs_ref": top,
               "ranks_bitwise_equal": len({r["digest"] for r in ranks}) == 1,
               "ms_per_rank": [r["ms"] for r in ranks],
               "bytes_sent_per_rank": [r["comm"]["bytes_sent"]
                                       for r in ranks],
               "bytes_received_per_rank": [r["comm"]["bytes_received"]
                                           for r in ranks],
               "stage_s": [r["comm"]["stage_s"] for r in ranks],
               "wait_s": [r["comm"]["wait_s"] for r in ranks],
               "single_card_gathered_ms": single_ms}
    results["dist.moe_ep"] = summary
    print("   (16f) expert-parallel Granite block vs the single card: "
          + json.dumps(summary), flush=True)
    require(summary["experts_per_rank"] == [32 // len(ranks)] * len(ranks),
            "each rank holds its share of the 32 experts")
    require(err <= 1e-5 * top, f"EP block within 1e-5 of the single card "
            f"({err} of {top})")
    require(summary["ranks_bitwise_equal"], "every rank's output bitwise "
            "equal")


# ---------------------------------------------------------------------------
# phase 17: the port's examples
# ---------------------------------------------------------------------------

EXAMPLES = ("serve_batched", "serve_gnn", "quickstart", "distributed_gnn")
EXAMPLE_TIMEOUT_S = 600
# flags every example gets: none on the card (a rehearsal off the card
# puts "--device", "cpu" here)
EXAMPLE_ARGS: tuple = ()


@phase("17. the port's examples on the card")
def phase_examples(torch, results):
    """``python -m repro_torch.examples.<name>`` for each example, on the
    card (their default device), all four side by side: each must exit
    0.  Each one's seconds from start to exit are printed (times of
    processes sharing the card and the host's cores), and its output goes
    to ``chiprun_out/example_<name>.log``."""
    logs = os.path.join(ROOT, "chiprun_out")
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out, procs = {}, {}
    for name in EXAMPLES:
        f = open(os.path.join(logs, f"example_{name}.log"), "w",
                 encoding="utf-8")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.examples.{name}",
             *EXAMPLE_ARGS], cwd=ROOT, env=env, stdout=f,
            stderr=subprocess.STDOUT), f, time.perf_counter())
    for name, (proc, f, t0) in procs.items():
        try:
            rc = proc.wait(timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        finally:
            f.close()
        secs = time.perf_counter() - t0
        with open(os.path.join(logs, f"example_{name}.log"),
                  encoding="utf-8") as log:
            tail = log.read().strip().splitlines()[-4:]
        out[name] = {"exit_code": rc, "seconds": secs}
        print(f"   {name}: exit {rc}, {secs:.1f} s; last lines: "
              + json.dumps(tail), flush=True)
    results["examples"] = out
    bad = {n: r["exit_code"] for n, r in out.items() if r["exit_code"]}
    require(not bad, f"every example exits 0: {bad}")


# ---------------------------------------------------------------------------
# phase 14: distributed GNN training, 4 ranks on the one card
# ---------------------------------------------------------------------------

DIST_WORLD = 4
# the synchronous modes (stale and hysync with a 3-epoch snapshot), two
# pull runs for the bitwise repeat, then the asynchronous trainer
DIST_SYNC = (("pull", []), ("pull_again", []), ("push", ["--mode", "push"]),
             ("stale", ["--mode", "stale", "--staleness", "3"]),
             ("hysync", ["--mode", "hysync", "--staleness", "3"]))
DIST_ASYNC = (("async_s0", ["--staleness", "0"]),
              ("async_s1", ["--staleness", "1"]),
              ("async_s4", ["--staleness", "4"]),
              ("async_s1_int8", ["--staleness", "1", "--wire-codec",
                                 "int8"]))
# the update-stream run: phase 11(d)'s stream in 4 folds over 5 epochs
DIST_STREAM_EPOCHS, DIST_STREAM_PER_EPOCH = 5, 500
# Parameters after TRAIN_EPOCHS AdamW epochs: AdamW divides each gradient element
# by its own running magnitude, so a nearly cancelled element moves by
# far more than its rounding, and another order of summation over 233 k
# rows moves the parameters by float32's own error on the problem.
# Phase 14 reads it in every run (phase 6's float32 GCN and pull against
# the same GCN in float64: 1.3e-4 and 2.4e-4 on an H100), beside two
# wrong paths (DIST_FAULTS: 2.2e-2 and 1.1e-1), and requires the sound
# readings within the bound and the wrong ones above it.  Under SGD (lr
# 0.1) every mode is held to 1e-5, the first 4 losses to the
# reference's 1e-4.
DIST_ADAMW_PARAM_TOL, DIST_SGD_TOL, DIST_LOSS_TOL = 1e-3, 1e-5, 1e-4
DIST_SGD_LR = 0.1
# the SGD parity runs take this many steps (cut from 10 for phase 18's
# time, then from 5 for the 900 s budget; stale and hysync still read a
# 3-step-old snapshot)
DIST_SGD_STEPS = 4
DIST_SGD_MODES = ("pull", "push", "stale", "hysync", "async_s0")
# pull with a fault put in for one job: every all-gathered row rounded
# to bf16 (straight-through), or the last rank's gradient left out of
# the sum
DIST_FAULTS = ("bf16_gather", "rank_gradient_dropped")
# (f) the distributed mini-batch launcher: SAGE at batch 1024 (a global
# batch, about 256 seeds a rank), fp32 and int8, a fixed number of steps
# each (reduced from the epoch's 227, as phase 7's int8 run; from 40 for
# phase 18's time, from 20 for phase 20's)
DIST_MB_STEPS = 10
# (g) each arch, 10 SGD steps on the same global seed batches on 4 ranks
# and on the single card (GAT on its 40-class graph); SAGE also under
# AdamW, and two wrong paths: the last rank's gradient left out (judged
# under AdamW) and each rank dividing by its own seed count (under SGD,
# where the ~4x scale shows; Adam's scale invariance would hide it)
DIST_MB_ARCHS = ("gcn", "sage", "gin", "gat")
# GIN's unnormalized sums at Reddit's widths oscillate under SGD at 0.1
# (loss 14.2 -> 89.7 -> ... -> 114.6 -> 21.3 over 10 steps of the single
# card, where float64 gradients end 0.21 away: chaos, not a parity test;
# scripts/minibatch_sgd_check.py on a CPU); 0.01 gives a falling loss
# (14.2 -> 2.40) with float64 gradients 7.5e-7 away
DIST_MB_SGD_LR = {"gin": 0.01}
DIST_MB_RUNS = tuple((a, "sgd", None) for a in DIST_MB_ARCHS) + (
    ("sage", "adamw", None), ("sage", "adamw", "rank_gradient_dropped"),
    ("sage", "sgd", "local_count"))
# (h) P3 splits the features over the ranks: 602 zero-padded to 604
# (602 % 4 != 0); W1 gets two zero rows, whose gradients are zero
P3_FEAT = 604


def dist_args(mode_flags, epochs=TRAIN_EPOCHS):
    return train_args("gcn", CLASSES, ["--devices", str(DIST_WORLD),
                                       "--epochs", str(epochs),
                                       *mode_flags])


def dist_coordination_job(rank, world, dev):
    """Both coordinators (``core/coordination.py``) from the same
    parameters, at GCN's Reddit shapes, on each rank's own random
    gradients, three AdamW steps each: the largest parameter difference
    (the reference's bound is 1e-5)."""
    import torch
    from repro_torch.core import coordination
    from repro_torch.optim import AdamW
    shapes = [(FEAT, HIDDEN), (HIDDEN,), (HIDDEN, CLASSES), (CLASSES,)]
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(s, generator=gen) for s in shapes]
    gen = torch.Generator().manual_seed(1 + rank)
    grads = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    out = {}
    for name, fn in coordination.COORDINATORS.items():
        ps = [torch.nn.Parameter(t.clone().to(dev)) for t in init]
        opt = AdamW(ps, lr=1e-2, weight_decay=0.0)
        for _ in range(3):
            fn(opt, ps, grads)
        out[name] = [p.detach() for p in ps]
    return {"max_diff": max(float((a - b).abs().max()) for a, b in zip(
        out["decentralized"], out["parameter_server"]))}


def _dist_setup(world, dev, argv):
    """The graph the launcher makes for ``argv`` (a phase-14 job's), its
    GCN config and its hash cut over ``world`` ranks."""
    from repro_torch.core import propagation as PR
    from repro_torch.launch import train_gnn
    from repro_torch.models.gnn import model as GM
    args = train_gnn.parse_args(argv)
    g, _ = train_gnn._rank_graph(args, lambda *a: None)
    cfg = GM.GNNConfig(arch="gcn", feat_dim=g.features.shape[1],
                       hidden=args.hidden, num_classes=g.num_classes)
    return g, cfg, PR.shard_graph(g, world)


def _params_np(model) -> list:
    return [{k: v.detach().cpu().numpy() for k, v in layer.named_parameters()}
            for layer in model]


def dist_sgd_job(rank, world, dev, *, argv):
    """Every synchronous mode and the asynchronous trainer at S 0,
    DIST_SGD_STEPS SGD steps each from phase 6's initial parameters
    (``propagation.run_sync``, ``AsyncFullGraphTrainer.run``): each
    mode's final parameters (numpy)."""
    import torch
    from repro_torch.core import propagation as PR
    from repro_torch.distributed import AsyncFullGraphTrainer
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import Sgd
    g, cfg, sg = _dist_setup(world, dev, argv)
    out = {}
    for mode in DIST_SGD_MODES:
        model = GM.init_gnn(cfg, torch.Generator().manual_seed(0),
                            device=dev)
        opt = Sgd(model.parameters(), lr=DIST_SGD_LR)
        if mode == "async_s0":
            AsyncFullGraphTrainer(g, cfg, opt, world, staleness=0,
                                  device=dev).run(model, DIST_SGD_STEPS)
        else:
            PR.run_sync(model, opt, sg, g, rank, dev, mode=mode,
                        staleness=3, steps=DIST_SGD_STEPS)
        out[mode] = _params_np(model)
    return out


def dist_fault_job(rank, world, dev, *, argv, fault):
    """Pull, 10 AdamW epochs from phase 6's initial parameters as the
    launcher runs it, with ``fault`` (one of ``DIST_FAULTS``) put into
    ``core/propagation.py`` for this job alone: the final parameters
    (numpy), a wrong path's reading against the AdamW bound."""
    import torch
    from repro_torch.core import propagation as PR
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW
    g, cfg, sg = _dist_setup(world, dev, argv)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    opt = AdamW(model.parameters(), lr=1e-2, weight_decay=0.0)
    saved = PR.pull_aggregate, PR.sum_grads_and_loss

    def bf16_gather(h, shard, *, coef_e=None):
        wire = h.to(torch.bfloat16).to(h.dtype)
        return saved[0](h + (wire - h).detach(), shard, coef_e=coef_e)

    def rank_gradient_dropped(params, loss):
        if rank == world - 1:
            for p in params.parameters():
                p.grad = None
        return saved[1](params, loss)

    if fault == "bf16_gather":
        PR.pull_aggregate = bf16_gather
    else:
        PR.sum_grads_and_loss = rank_gradient_dropped
    try:
        PR.run_sync(model, opt, sg, g, rank, dev, mode="pull",
                    steps=TRAIN_EPOCHS)
    finally:
        PR.pull_aggregate, PR.sum_grads_and_loss = saved
    return {"params": _params_np(model)}


def mb_args(codec, arch="sage", classes=CLASSES):
    return train_args(arch, classes, [
        "--devices", str(DIST_WORLD), "--minibatch", "--batch",
        str(MB_BATCH), "--cache", "degree", "--epochs", "1",
        "--wire-codec", codec])


def dist_mb_job(rank, world, dev, *, argv, steps):
    """(f) the launcher's distributed mini-batch path, ``steps`` steps
    (``train_gnn._distributed_job``, as ``run_world`` runs an argv job,
    with the epoch cut short)."""
    from repro_torch.launch import train_gnn
    return train_gnn._distributed_job(train_gnn.parse_args(argv), rank,
                                      world, dev, steps_per_epoch=steps)


def _mb_batches(g, parts, world):
    """The sampler of phase 14(g) over ``world`` partitions (``parts``:
    the stores built), and the ``TRAIN_EPOCHS`` global seed batches of
    ``--seed 0``."""
    from repro_torch.distributed import DistributedMinibatchSampler
    ds = DistributedMinibatchSampler(
        g, world, [5, 5], MB_BATCH, cache_policy="degree" if world > 1
        else "none", cache_capacity=g.num_nodes // 10, seed=0, parts=parts)
    rng = np.random.default_rng(0)
    return ds, [rng.choice(g.num_nodes, MB_BATCH, replace=False)
                for _ in range(TRAIN_EPOCHS)]


def _mb_model(torch, arch, classes, optimizer, dev, dtype=None):
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW, Sgd
    cfg = GM.GNNConfig(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=classes)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    if dtype is not None:
        model = model.to(dtype)
    opt = (AdamW(model.parameters(), lr=1e-2, weight_decay=0.0)
           if optimizer == "adamw" else Sgd(
               model.parameters(), lr=DIST_MB_SGD_LR.get(arch, DIST_SGD_LR)))
    return cfg, model, opt


def dist_mb_parity_job(rank, world, dev, *, argv, argv_gat):
    """(g) every ``DIST_MB_RUNS`` run, ``TRAIN_EPOCHS`` distributed
    mini-batch steps of this rank from phase 6's initial parameters, on
    the rank's batches of the same global seed batches: the final
    parameters and the launches of each run (numpy, dicts)."""
    import torch
    from repro_torch.core import propagation as PR
    from repro_torch.distributed import make_distributed_minibatch_step
    from repro_torch.kernels import ops
    from repro_torch.launch import train_gnn
    out = {}
    for gat, a in ((False, argv), (True, argv_gat)):
        g, _ = train_gnn._rank_graph(train_gnn.parse_args(a),
                                     lambda *x: None)
        ds, seeds = _mb_batches(g, (rank,), world)
        batches = [ds.sample_partition(rank, ds.owned_seeds(rank, s))
                   for s in seeds]
        for arch, optimizer, fault in DIST_MB_RUNS:
            if (arch == "gat") != gat:
                continue
            cfg, model, opt = _mb_model(torch, arch, g.num_classes,
                                        optimizer, dev)
            step = make_distributed_minibatch_step(cfg, opt)
            saved = PR.sum_grads_and_loss

            def dropped(params, loss, **kw):
                if rank == world - 1:
                    for p in params.parameters():
                        p.grad = None
                return saved(params, loss, **kw)

            if fault == "rank_gradient_dropped":
                PR.sum_grads_and_loss = dropped
            ops.reset_launch_counts()
            try:
                for b, s in zip(batches, seeds):
                    count = (int(b.label_mask.sum()) if fault ==
                             "local_count" else len(s))
                    step(model, b, ds.out_deg, count)
            finally:
                PR.sum_grads_and_loss = saved
            out["/".join(x for x in (arch, optimizer, fault) if x)] = {
                "params": _params_np(model),
                "launches": {k: v for k, v in ops.launch_counts().items()
                             if v}}
    return out


def _mb_single_card(torch, g, runs, *, float64=False) -> dict:
    """(g) the single card: a one-partition sampler without a cache over
    the same global seed batches, ``make_minibatch_train_step`` over
    ``device_blocks``: each run's final parameters (numpy).  Under
    ``float64`` through the kernels' plain versions (the kernels take
    float32): the exact answer float32's own error is read against."""
    from repro_torch.distributed import device_blocks
    from repro_torch.kernels import segment_sum
    from repro_torch.models.gnn import model as GM
    dev = torch.device("cuda")
    dtype = torch.float64 if float64 else torch.float32
    ds, seeds = _mb_batches(g, None, 1)
    batches = [ds.sample_global(s)[0] for s in seeds]
    out = {}
    pick = segment_sum.pick
    if float64:
        segment_sum.pick = lambda cuda_fn, plain_fn, t: plain_fn
    try:
        for arch, optimizer in runs:
            cfg, model, opt = _mb_model(torch, arch, g.num_classes,
                                        optimizer, dev, dtype)
            step = GM.make_minibatch_train_step(cfg, opt)
            for b in batches:
                blocks = device_blocks(b, ds.out_deg, dev)
                for bl in blocks:
                    bl.in_deg, bl.out_deg = (bl.in_deg.to(dtype),
                                             bl.out_deg.to(dtype))
                step(model, blocks, torch.from_numpy(b.x_in).to(dev, dtype),
                     torch.from_numpy(b.labels).to(dev),
                     torch.from_numpy(b.label_mask).to(dev, dtype))
            out[f"{arch}/{optimizer}"] = _params_np(model)
    finally:
        segment_sum.pick = pick
    return out


def _p3_inputs(g, sg):
    """The P3 run's cut (features zero-padded to ``P3_FEAT``) and phase
    6's initial GCN parameters with W1 zero-padded alike (numpy)."""
    import dataclasses
    import torch
    from repro_torch.models.gnn import model as GM
    cfg = GM.GNNConfig(arch="gcn", feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=g.num_classes)
    p0 = _params_np(GM.init_gnn(cfg, torch.Generator().manual_seed(0),
                                device="cpu"))
    p0[0]["w"] = np.pad(p0[0]["w"], ((0, P3_FEAT - FEAT), (0, 0)))
    sg = dataclasses.replace(sg, x=np.pad(sg.x, ((0, 0),
                                                 (0, P3_FEAT - FEAT))))
    return dataclasses.replace(cfg, feat_dim=P3_FEAT), p0, sg


def dist_p3_job(rank, world, dev, *, argv):
    """(h) GCN under P3 (``core/parallel.py``), 10 epochs under SGD and
    10 under AdamW from phase 6's initial parameters, features padded to
    ``P3_FEAT``: each run's parameters (W1 the rank's slice), losses,
    ``StepClock`` rows and launches (by width)."""
    from repro_torch.core import collectives as C
    from repro_torch.core import parallel as PL
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamW, Sgd
    g, _, sg = _dist_setup(world, dev, argv)
    cfg, p0, sg = _p3_inputs(g, sg)
    shard = PL.p3_shard(sg, g, rank, dev)
    out = {}
    for optimizer in ("sgd", "adamw"):
        model = PL.p3_params(cfg, p0, rank, world, device=dev)
        opt = (AdamW(model.parameters(), lr=1e-2, weight_decay=0.0)
               if optimizer == "adamw" else Sgd(model.parameters(),
                                                lr=DIST_SGD_LR))
        step = PL.make_p3_train_step(opt)
        clock = C.StepClock(dev)
        C.release_buffers()
        ops.reset_launch_counts()
        losses = []
        for _ in range(TRAIN_EPOCHS):
            with clock.step():
                losses.append(float(step(model, shard)))
        out[optimizer] = {
            "params": _params_np(model), "losses": losses,
            "epochs": clock.rows,
            "launches": {k: v for k, v in ops.launch_counts().items() if v},
            "launches_by_width": ops.launch_counts_by_width()}
    return out


def _single_card(torch, g, optimizer, *, float64=False, device="cuda",
                 steps=TRAIN_EPOCHS):
    """Phase 6's GCN trained ``steps`` steps from its initial parameters
    by ``optimizer`` (``"adamw"``: the launcher's, or ``"sgd"``: lr
    ``DIST_SGD_LR``); under ``float64`` through the kernels' plain
    versions (the kernels take float32): the exact answer every float32
    run is read against.  Its parameters (numpy)."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.kernels import segment_sum
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW, Sgd
    dev = torch.device(device)
    dtype = torch.float64 if float64 else torch.float32
    cfg = GM.GNNConfig(arch="gcn", feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=CLASSES)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0),
                        device=dev).to(dtype)
    opt = (AdamW(model.parameters(), lr=1e-2, weight_decay=0.0)
           if optimizer == "adamw" else Sgd(model.parameters(),
                                            lr=DIST_SGD_LR))
    step = GM.make_fullgraph_train_step(cfg, opt)
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    x = torch.from_numpy(g.features).to(dev, dtype)
    y = torch.from_numpy(g.labels).to(dev)
    mask = torch.ones(y.shape, dtype=dtype, device=dev)
    pick = segment_sum.pick
    if float64:
        segment_sum.pick = lambda cuda_fn, plain_fn, t: plain_fn
    try:
        for _ in range(steps):
            step(model, dg, x, y, mask)
    finally:
        segment_sum.pick = pick
    return _params_np(model)


def _dist_params_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x[k]) - np.asarray(y[k])).max())
               for x, y in zip(a, b) for k in x)


def _dist_ranks_bitwise(res) -> bool:
    first = res["ranks"][0]["params"]
    return all(np.array_equal(r["params"][i][k], first[i][k])
               for r in res["ranks"] for i in range(len(first))
               for k in first[i])


def _dist_summary(res) -> dict:
    """ms an epoch (host clock, median of epochs 2..: the first builds
    the staging buffers), split into the collectives (staging + gloo
    wait) and the rest, the CUDA-event span, bytes a rank an epoch; each
    a median over the epochs and the ranks' worst."""
    rows = [e for r in res["ranks"] for e in r["epochs"][1:]] or [
        e for r in res["ranks"] for e in r["epochs"]]
    med = lambda k: float(np.median([e[k] for e in rows]))  # noqa: E731
    return {"epoch_ms": med("wall_s") * 1e3,
            "comm_ms": med("comm_s") * 1e3,
            "stage_ms": med("stage_s") * 1e3,
            "wait_ms": med("wait_s") * 1e3,
            "rest_ms": (med("wall_s") - med("comm_s")) * 1e3,
            "event_ms": (med("event_ms") if rows[0]["event_ms"] is not None
                         else None),
            "bytes_received_per_epoch": med("bytes_received"),
            "bytes_sent_per_epoch": med("bytes_sent"),
            "setup_s": max(r["setup_s"] for r in res["ranks"]),
            "losses": res["losses"]}


def _dist_k1_cases(torch, g, results):
    """K1 and K1ᵀ at the distributed shapes of rank 0 (hash, 4 ranks):
    pull ``N_pad -> n_local`` and push ``n_local -> N_pad``, at GCN's
    widths, with the shard's own coefficients."""
    from repro_torch.core import propagation as PR
    c = Checker(torch, seed=14)
    sg = PR.shard_graph(g, DIST_WORLD)
    push = PR.push_layout(sg, g)
    for layout, arrays in (("pull", None), ("push", push)):
        sh = PR.rank_shard(sg, 0, c.dev, push_arrays=arrays)
        dg = sh.graph
        coef = sh.coef * dg.edge_mask.to(torch.float32)
        print(f"   {layout} layout, rank 0: {dg.num_src} sources -> "
              f"{dg.num_dst} destinations, {int(dg.order.numel())} edges",
              flush=True)
        for F in (HIDDEN, CLASSES):
            results[f"k1.dist.{layout}.{F}"] = c.k1(
                f"K1 {layout} layout, F {F} ({dg.num_src} -> "
                f"{dg.num_dst})", c.randn(dg.num_src, F), dg.edge_src,
                coef, dg.order, dg.row_ptr, dg.num_dst)
            results[f"k1_transpose.dist.{layout}.{F}"] = c.k1(
                f"K1 over the src layout, {layout}, F {F} ({dg.num_dst} "
                f"-> {dg.num_src})", c.randn(dg.num_dst, F), dg.edge_dst,
                coef, *dg.src_layout, dg.num_src, transpose=True)


def _dist_mb_k1_cases(torch, g, results):
    """K1 and K1ᵀ at the distributed mini-batch shapes, rank 0's padded
    blocks of the first global batch (SAGE's mask as the coefficient),
    and P3's whole-graph K1 at its column slice."""
    from repro_torch.core import parallel as PL
    from repro_torch.core import propagation as PR
    from repro_torch.distributed import device_blocks
    c = Checker(torch, seed=15)
    ds, seeds = _mb_batches(g, (0,), DIST_WORLD)
    inner, outer = device_blocks(ds.sample_partition(
        0, ds.owned_seeds(0, seeds[0])), ds.out_deg, c.dev)
    for name, dg, F in (("mb_inner", inner, FEAT), ("mb_outer", outer,
                                                    HIDDEN)):
        coef = dg.edge_mask.to(torch.float32)
        print(f"   {name} block, rank 0: {dg.num_src} sources -> "
              f"{dg.num_dst} destinations, {int(dg.order.numel())} of "
              f"{dg.edge_src.numel()} edge slots", flush=True)
        results[f"k1.dist.{name}.{F}"] = c.k1(
            f"K1 {name} block, F {F}", c.randn(dg.num_src, F), dg.edge_src,
            coef, dg.order, dg.row_ptr, dg.num_dst)
        if name == "mb_outer":
            results[f"k1_transpose.dist.{name}.{F}"] = c.k1(
                f"K1 over the src layout, {name} block, F {F}",
                c.randn(dg.num_dst, F), dg.edge_dst, coef, *dg.src_layout,
                dg.num_src, transpose=True)
    _, _, sg = _p3_inputs(g, PR.shard_graph(g, DIST_WORLD))
    sh = PL.p3_shard(sg, g, 0, c.dev)
    F = P3_FEAT // DIST_WORLD
    results[f"k1.dist.p3.{F}"] = c.k1(
        f"K1 P3 layer 1, whole graph, F {F}", sh.x_f, sh.graph.edge_src,
        sh.coef, sh.graph.order, sh.graph.row_ptr, sh.graph.num_dst)


def _mb_steps_summary(res) -> dict:
    """(f) a distributed mini-batch run's steps: the median over steps
    2.. and the ranks of ms a step, the collectives' share, and the
    prefetch overlap and traffic of the run."""
    rows = [e for r in res["ranks"] for e in r["steps"][1:]]
    med = lambda k: float(np.median([e[k] for e in rows]))  # noqa: E731
    return {"median_step_ms": med("wall_s") * 1e3,
            "comm_ms": med("comm_s") * 1e3,
            "comm_share": med("comm_s") / med("wall_s"),
            "bytes_received_per_step": med("bytes_received"),
            "prefetch_overlap": [r["prefetch_overlap"]
                                 for r in res["ranks"]],
            "sampled": [r["sampled"] for r in res["ranks"]],
            "trained": res["trained"], "traffic": res["traffic"],
            "halo_hit_ratio": res["stats"]["halo_hit_ratio"],
            "setup_s": max(r["setup_s"] for r in res["ranks"]),
            "loss_first5": float(np.mean(res["losses"][:5])),
            "loss_last5": float(np.mean(res["losses"][-5:]))}


def _dist_minibatch_checks(torch, g, g_gat, out, results):
    """(f) the launcher's runs, (g) parity with the single card."""
    mb = {}
    for codec in ("fp32", "int8"):
        res = out[f"mb_{codec}"]
        summary = _mb_steps_summary(res)
        steps = res["trained"]
        summary["launches_per_rank"] = [r["launches"] for r in res["ranks"]]
        summary["ranks_bitwise_equal"] = _dist_ranks_bitwise(res)
        print(f"   minibatch {codec}, {DIST_WORLD} ranks: "
              + json.dumps(summary), flush=True)
        results[f"dist.mb_{codec}"] = summary
        mb[codec] = summary
        require(bool(np.isfinite(res["losses"]).all())
                and summary["loss_last5"] < summary["loss_first5"],
                f"minibatch {codec}: finite, falling loss")
        require(summary["ranks_bitwise_equal"],
                f"minibatch {codec}: every rank's parameters bitwise equal")
        want = {"gather_scale_segment_sum": 2 * steps,
                "gather_scale_segment_sum_t": steps}
        want_w = {"gather_scale_segment_sum": {FEAT: steps, HIDDEN: steps},
                  "gather_scale_segment_sum_t": {HIDDEN: steps}}
        for r, rr in enumerate(res["ranks"]):
            require(rr["launches"] == want and rr["launches_by_width"]
                    == want_w, f"minibatch {codec} rank {r}: launches "
                    f"{rr['launches']} {rr['launches_by_width']}, by "
                    f"design {want} {want_w} (no K4, no K6)")
        require(summary["traffic"]["cross_partition_bytes"] > 0
                and 0.0 < summary["halo_hit_ratio"] < 1.0,
                f"minibatch {codec}: cross-partition bytes and a halo hit "
                f"ratio strictly between 0 and 1")
    results["launches.dist.mb"] = out["mb_fp32"]["ranks"][0][
        "launches_by_width"]
    ratio = (mb["int8"]["traffic"]["cross_partition_bytes"]
             / mb["fp32"]["traffic"]["cross_partition_bytes"])
    one = results.get("minibatch.fp32", {}).get("median_step_ms")
    results["dist.mb_vs_single"] = {
        "int8_bytes_ratio": ratio, "single_card_step_ms": one,
        "fp32_step_ms": mb["fp32"]["median_step_ms"],
        "int8_step_ms": mb["int8"]["median_step_ms"]}
    print("   minibatch, 4 ranks vs phase 7's single card: "
          + json.dumps(results["dist.mb_vs_single"]), flush=True)
    require(ratio <= 0.35, f"int8 moves {ratio:.3f} of fp32's bytes "
            f"(<= 0.35)")
    # (g) parity: each arch under SGD within DIST_SGD_TOL of the single
    # card, SAGE under AdamW within DIST_ADAMW_PARAM_TOL, both faults over
    parity = out["mb_parity"]["ranks"]
    single = _mb_single_card(torch, g, [("gcn", "sgd"), ("sage", "sgd"),
                                        ("gin", "sgd"), ("sage", "adamw")])
    single.update(_mb_single_card(torch, g_gat, [("gat", "sgd")]))
    diffs = {}
    for arch, optimizer, fault in DIST_MB_RUNS:
        name = "/".join(x for x in (arch, optimizer, fault) if x)
        per_rank = [r[name]["params"] for r in parity]
        diffs[name] = _dist_params_diff(per_rank[0],
                                        single[f"{arch}/{optimizer}"])
        if fault is None:
            require(all(_dist_params_diff(p, per_rank[0]) == 0.0
                        for p in per_rank), f"{name}: ranks bitwise equal")
            want = {k: v * TRAIN_EPOCHS
                    for k, v in STEP_LAUNCHES[arch].items()}
            for r, rr in enumerate(parity):
                require(rr[name]["launches"] == want, f"{name} rank {r}: "
                        f"launches {rr[name]['launches']}, by design {want}")
    results["dist.mb_parity"] = diffs
    print(f"   minibatch, {TRAIN_EPOCHS} steps, parameters vs the single "
          f"card: " + json.dumps(diffs), flush=True)
    for arch in DIST_MB_ARCHS:
        d = diffs[f"{arch}/sgd"]
        if d > DIST_SGD_TOL:
            # the single card's own float32 error can exceed the bound:
            # GIN's one-batch run on the card lies 1.41e-5 from its run
            # with float64 gradients, the ranks' 7.5e-7 (PERF.md section
            # 6).  Both runs are then read against the float64 one, and
            # the ranks' held to the bound there.
            gg = g_gat if arch == "gat" else g
            exact = _mb_single_card(torch, gg, [(arch, "sgd")],
                                    float64=True)[f"{arch}/sgd"]
            floor = {"dist_vs_float64": _dist_params_diff(
                parity[0][f"{arch}/sgd"]["params"], exact),
                "single_vs_float64": _dist_params_diff(
                    single[f"{arch}/sgd"], exact)}
            results[f"dist.mb_parity_float64.{arch}"] = floor
            print(f"   {arch}: the float32 runs {d:.3e} apart; against "
                  f"the single card's float64 gradients: "
                  + json.dumps(floor), flush=True)
            d = floor["dist_vs_float64"]
        require(d <= DIST_SGD_TOL, f"{arch} SGD within {DIST_SGD_TOL} of "
                f"the single card ({d:.3e})")
    d = diffs["sage/adamw"]
    require(d <= DIST_ADAMW_PARAM_TOL, f"SAGE AdamW within "
            f"{DIST_ADAMW_PARAM_TOL} ({d:.3e})")
    d = diffs["sage/adamw/rank_gradient_dropped"]
    require(d > DIST_ADAMW_PARAM_TOL, f"the AdamW bound catches a dropped "
            f"rank gradient ({d:.3e})")
    d = diffs["sage/sgd/local_count"]
    require(d >= 10 * DIST_SGD_TOL, f"the SGD bound catches each rank's "
            f"own seed count, 10x over ({d:.3e})")


def _p3_checks(out, sgd_ref, results):
    """(h) P3 against phase 6's single-card GCN (``sgd_ref``: TRAIN_EPOCHS
    SGD steps; the first 602 rows of
    W1; the padded rows stay zero), bitwise equal replicated parameters,
    launches by design, times and bytes beside pull's."""
    res = out["p3"]["ranks"]
    E = TRAIN_EPOCHS
    F = P3_FEAT // DIST_WORLD
    report = {}
    for optimizer in ("sgd", "adamw"):
        runs = [r[optimizer] for r in res]
        full = [dict(p) for p in runs[0]["params"]]
        w1 = np.concatenate([r["params"][0]["w"] for r in runs])
        require(not w1[FEAT:].any(), f"P3 {optimizer}: W1's padded rows "
                f"stay zero")
        full[0]["w"] = w1[:FEAT]
        require(all(np.array_equal(r["params"][i][k], runs[0]["params"][i][
            k]) for r in runs for i in range(2) for k in ("w", "b")
            if (i, k) != (0, "w")), f"P3 {optimizer}: replicated "
            f"parameters bitwise equal")
        for q, r in enumerate(runs):
            want = {"gather_scale_segment_sum": 2 * E,
                    "gather_scale_segment_sum_t": E}
            want_w = {"gather_scale_segment_sum": {F: E, CLASSES: E},
                      "gather_scale_segment_sum_t": {CLASSES: E}}
            require(r["launches"] == want and r["launches_by_width"]
                    == want_w, f"P3 {optimizer} rank {q}: launches "
                    f"{r['launches']} {r['launches_by_width']}, by design "
                    f"{want} {want_w}")
        summary = _dist_summary({"ranks": [dict(epochs=r["epochs"],
                                                setup_s=0.0) for r in runs],
                                 "losses": runs[0]["losses"]})
        if optimizer == "sgd":
            summary["vs_single_card"] = _dist_params_diff(full, sgd_ref)
        elif "gcn" in TRAINED:
            summary["vs_single_card"] = _dist_params_diff(
                full, _params_np(TRAINED["gcn"][0]))
            summary["pull_vs_single_card"] = results.get(
                "dist.pull", {}).get("vs_single_card_params")
        report[optimizer] = summary
        results[f"dist.p3_{optimizer}"] = summary
        print(f"   P3 {optimizer}: " + json.dumps(summary), flush=True)
        require(bool(np.isfinite(runs[0]["losses"]).all()),
                f"P3 {optimizer}: finite losses")
    results["launches.dist.p3"] = res[0]["sgd"]["launches_by_width"]
    pull = results.get("dist.pull", {})
    print(f"   P3 vs pull, ms an epoch (collectives), bytes received a "
          f"rank: {report['sgd']['epoch_ms']:.1f} "
          f"({report['sgd']['comm_ms']:.1f}), "
          f"{report['sgd']['bytes_received_per_epoch']:.0f} vs "
          f"{pull.get('epoch_ms', float('nan')):.1f} "
          f"({pull.get('comm_ms', float('nan')):.1f}), "
          f"{pull.get('bytes_received_per_epoch', float('nan')):.0f}",
          flush=True)
    d = report["sgd"]["vs_single_card"]
    require(d <= DIST_SGD_TOL, f"P3 SGD within {DIST_SGD_TOL} of phase "
            f"6's GCN ({d:.3e})")
    d = report["adamw"].get("vs_single_card")
    require(d is not None and d <= DIST_ADAMW_PARAM_TOL, f"P3 AdamW "
            f"within {DIST_ADAMW_PARAM_TOL} of phase 6's GCN ({d})")


@phase("14. distributed GNN training, 4 ranks on the card")
def phase_distributed(torch, g, g_gat, results):
    """(a) pull, push, stale (S 3), hysync, 10 epochs each, and (d) the
    asynchronous trainer at S 0, 1, 4 (fp32) and S 1 (int8), then one run
    folding phase 11(d)'s stream, (f) the distributed mini-batch launcher
    (SAGE, fp32 and int8), (g) its parity runs and (h) GCN under P3, all
    in one spawned world of 4 ranks on the card through
    ``train_gnn.run_world``; (c) the coordinators inside the same world;
    (b) exact launch counts; (e) times, bytes, and (e, i) K1 / K1ᵀ at the
    distributed shapes."""
    from repro_torch.core.updates import synthesize_updates
    from repro_torch.launch import train_gnn
    torch.cuda.empty_cache()
    stream = os.path.join(ROOT, "chiprun_out", "updates.jsonl")
    if not os.path.exists(stream):            # phase 11(d) did not run
        os.makedirs(os.path.dirname(stream), exist_ok=True)
        synthesize_updates(g, UPDATE_EVENTS, seed=11).to_jsonl(stream)
    jobs = {name: dist_args(flags) for name, flags in DIST_SYNC}
    jobs["coordination"] = dist_coordination_job
    jobs["sgd"] = functools.partial(dist_sgd_job, argv=dist_args([]))
    jobs.update({f"fault_{f}": functools.partial(
        dist_fault_job, argv=dist_args([]), fault=f) for f in DIST_FAULTS})
    jobs.update({name: dist_args(["--fullgraph", "--refresh-frac", "0",
                                  *flags]) for name, flags in DIST_ASYNC})
    jobs["async_stream"] = dist_args(
        ["--fullgraph", "--staleness", "1", "--update-stream", stream,
         "--updates-per-epoch", str(DIST_STREAM_PER_EPOCH)],
        epochs=DIST_STREAM_EPOCHS)
    jobs.update({f"mb_{codec}": functools.partial(
        dist_mb_job, argv=mb_args(codec), steps=DIST_MB_STEPS)
        for codec in ("fp32", "int8")})
    jobs["mb_parity"] = functools.partial(
        dist_mb_parity_job, argv=mb_args("fp32"),
        argv_gat=mb_args("fp32", "gat", GAT_CLASSES))
    jobs["p3"] = functools.partial(dist_p3_job, argv=dist_args([]))
    jobs["moe_ep"] = functools.partial(dist_moe_ep_job, batch=EP_BATCH,
                                       seq=EP_SEQ)
    t0 = time.perf_counter()
    out = dict(zip(jobs, train_gnn.run_world(
        list(jobs.values()), world=DIST_WORLD, device="cuda",
        timeout_s=900)))
    print(f"   one world of {DIST_WORLD} ranks, {len(jobs)} jobs: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # K1 and K1ᵀ once a layer an epoch each: at 256 and at 41 columns
    want_k1_fwd = "gather_scale_segment_sum"
    want_k1 = {"gather_scale_segment_sum": 2, "gather_scale_segment_sum_t": 2}
    for name, res in out.items():
        if name in ("coordination", "sgd", "mb_parity", "p3", "moe_ep") or \
                name.startswith(("fault_", "mb_")):
            continue
        summary = _dist_summary(res)
        epochs = len(res["losses"])
        launches = [r["launches"] for r in res["ranks"]]
        by_width = [r["launches_by_width"] for r in res["ranks"]]
        summary["launches_per_rank"] = launches
        summary["launches_per_rank_by_width"] = by_width
        summary["ranks_bitwise_equal"] = _dist_ranks_bitwise(res)
        if res["mode"] == "fullgraph":
            summary["stats"] = res["stats"]
            summary["accuracy"] = res["accuracy"]
            summary["ghost_digests_equal"] = len(
                {r["ghost_digest"] for r in res["ranks"]}) == 1
        print(f"   {name}: " + json.dumps(summary), flush=True)
        results[f"dist.{name}"] = summary
        require(bool(np.isfinite(res["losses"]).all()),
                f"{name}: finite losses")
        require(summary["ranks_bitwise_equal"],
                f"{name}: every rank's parameters bitwise equal")
        for r, (counts, widths) in enumerate(zip(launches, by_width)):
            want = {k: v * epochs for k, v in want_k1.items()}
            # rank 0 of --fullgraph: one forward more, the accuracy
            acc = int(res["mode"] == "fullgraph" and r == 0)
            want["gather_scale_segment_sum"] += 2 * acc
            require(counts == want, f"{name} rank {r}: launches {counts}, "
                    f"by design {want} (K6 none, nothing else)")
            want_w = {k: dict.fromkeys((HIDDEN, CLASSES), epochs + (
                acc if k == want_k1_fwd else 0)) for k in want_k1}
            require(widths == want_w, f"{name} rank {r}: K1 launches by "
                    f"width {widths}, by design {want_w}")
        if res["mode"] == "fullgraph":
            require(summary["ghost_digests_equal"],
                    f"{name}: every rank's ghost planes bitwise equal")
    for layout in ("pull", "push"):
        results[f"launches.dist.{layout}"] = out[layout]["ranks"][1][
            "launches_by_width"]
    # (a) pull against phase 6's single-card GCN (same graph and initial
    # parameters), then the other modes against pull: the first 4 losses
    # within the reference's 1e-4, the parameters after 10 AdamW epochs
    # within DIST_ADAMW_PARAM_TOL, which both faults must exceed; beside
    # them float32's own error (phase 6's run and pull against float64),
    # and after DIST_SGD_STEPS SGD steps every mode within 1e-5 of the
    # single card
    pull = out["pull"]
    adamw = {}                       # name: (first 4 losses, parameters)
    if "gcn" in TRAINED and "train.gcn" in results:
        one = results["train.gcn"]["losses"]
        ref = _params_np(TRAINED["gcn"][0])
        adamw["pull"] = (max(abs(a - b) for a, b in zip(pull["losses"][:4],
                                                        one[:4])),
                         _dist_params_diff(pull["params"], ref))
        results["dist.pull"].update(vs_single_card_early=adamw["pull"][0],
                                    vs_single_card_params=adamw["pull"][1])
        t0 = time.perf_counter()
        exact = _single_card(torch, TRAINED["gcn"][1], "adamw",
                             float64=True)
        floor = {"single_card_vs_float64": _dist_params_diff(ref, exact),
                 "pull_vs_float64": _dist_params_diff(pull["params"], exact),
                 "float64_s": time.perf_counter() - t0}
        results["dist.float32_floor"] = floor
        print(f"   float32's own error, parameters after {TRAIN_EPOCHS} "
              f"AdamW epochs: " + json.dumps(floor), flush=True)
    else:
        failures.append("14: phase 6's GCN is missing, pull not held to it")
    for name in ("push", "stale", "hysync", "async_s0"):
        res = out[name]
        adamw[name] = (max(abs(a - b) for a, b in zip(res["losses"][:4],
                                                      pull["losses"][:4])),
                       _dist_params_diff(res["params"], pull["params"]))
        results[f"dist.{name}"].update(vs_pull_early=adamw[name][0],
                                       vs_pull_params=adamw[name][1])
    faults = {f: _dist_params_diff(out[f"fault_{f}"]["ranks"][0]["params"],
                                   pull["params"]) for f in DIST_FAULTS}
    results["dist.faults_vs_pull"] = faults
    print(f"   AdamW, {TRAIN_EPOCHS} epochs (pull vs phase 6's GCN, the "
          f"others vs pull; first 4 losses, parameters): "
          + json.dumps(adamw), flush=True)
    print("   pull with a fault, parameters vs pull: " + json.dumps(faults),
          flush=True)
    for name, (early, pdiff) in adamw.items():
        require(early <= DIST_LOSS_TOL and pdiff <= DIST_ADAMW_PARAM_TOL,
                f"{name}: losses 1-4 within {DIST_LOSS_TOL} and parameters "
                f"within {DIST_ADAMW_PARAM_TOL} ({early:.3e}, {pdiff:.3e})")
    for what in ("single_card_vs_float64", "pull_vs_float64"):
        d = results.get("dist.float32_floor", {}).get(what, 0.0)
        require(d <= DIST_ADAMW_PARAM_TOL, f"{what}: {d:.3e} within "
                f"{DIST_ADAMW_PARAM_TOL}")
    for f, d in faults.items():
        require(d > DIST_ADAMW_PARAM_TOL, f"the AdamW bound "
                f"{DIST_ADAMW_PARAM_TOL} catches the fault {f} ({d:.3e})")
    sgd_ref = _single_card(torch, g, "sgd", steps=DIST_SGD_STEPS)
    sgd = {}
    for mode in DIST_SGD_MODES:
        per_rank = [r[mode] for r in out["sgd"]["ranks"]]
        sgd[mode] = _dist_params_diff(per_rank[0], sgd_ref)
        require(all(_dist_params_diff(p, per_rank[0]) == 0.0
                    for p in per_rank), f"SGD {mode}: ranks bitwise equal")
    results["dist.sgd_vs_single_card"] = sgd
    print(f"   SGD, {DIST_SGD_STEPS} steps, parameters vs the single card: "
          + json.dumps(sgd), flush=True)
    require(max(sgd.values()) <= DIST_SGD_TOL,
            f"every mode within 1e-5 of the single card under SGD: {sgd}")
    require(_dist_params_diff(out["pull_again"]["params"], pull["params"])
            == 0.0 and out["pull_again"]["losses"] == pull["losses"],
            "two pull runs bitwise equal")
    # (c) the coordinators
    coord = [r["max_diff"] for r in out["coordination"]["ranks"]]
    results["dist.coordination"] = {"max_diff_per_rank": coord}
    print(f"   parameter server vs all-reduce: {coord}", flush=True)
    require(max(coord) <= 1e-5, "PS within 1e-5 of all-reduce")
    # (d) the asynchronous trainer's bytes and the int8 run
    b = [out[f"async_s{s}"]["stats"]["bytes_per_step"] for s in (0, 1, 4)]
    b8 = out["async_s1_int8"]["stats"]["bytes_per_step"]
    l32 = out["async_s1"]["losses"][-1]
    l8 = out["async_s1_int8"]["losses"][-1]
    results["dist.async_bytes"] = {"s0": b[0], "s1": b[1], "s4": b[2],
                                   "s1_int8": b8, "int8_ratio": b8 / b[1],
                                   "int8_loss_rel": abs(l8 - l32) / l32}
    print("   async bytes/step: " + json.dumps(results["dist.async_bytes"]),
          flush=True)
    require(b[0] > b[1] > b[2], f"bytes/step fall with S: {b}")
    require(b8 <= 0.35 * b[1], "int8 moves <= 0.35 of fp32's bytes")
    require(abs(l8 - l32) <= 0.05 * abs(l32), "int8 final loss within 5 % "
            "of fp32's")
    st = out["async_stream"]
    folds = st["folds"]
    results["dist.async_stream"].update(
        folds=len(folds), events=sum(f["events"] for f in folds),
        invalidated_rows=sum(f["invalidated_rows"] for f in folds),
        fold_s=[f["seconds"] for f in folds])
    require(st["update_seq"] == UPDATE_EVENTS and sum(
        f["events"] for f in folds) == UPDATE_EVENTS
        and all(f["invalidated_rows"] > 0 for f in folds),
        "the stream folded in full, ghost rows invalidated at each fold")
    # (e) K1 / K1ᵀ at the distributed shapes
    _dist_k1_cases(torch, g, results)
    # (f), (g) the distributed mini-batch path, (h) P3, (i) their K1 / K1ᵀ
    t0 = time.perf_counter()
    _dist_minibatch_checks(torch, g, g_gat, out, results)
    # P3 trains TRAIN_EPOCHS SGD steps: its own single-card reference
    _p3_checks(out, _single_card(torch, g, "sgd"), results)
    _dist_mb_k1_cases(torch, g, results)
    print(f"   (f)-(i) in the main process: {time.perf_counter() - t0:.1f} s",
          flush=True)
    # phase 16(f): the expert-parallel Granite block
    _ep_checks(torch, out["moe_ep"], results)


# ---------------------------------------------------------------------------
# phase 20: the transformer trainer (repro_torch.launch.train) and K7's and
# K8's VJPs
# ---------------------------------------------------------------------------

QWEN14 = "qwen2.5-14b"
# 20(a): K7's VJP at every width pair the trainer meets, (key, label,
# (B, H, K, Sq, Skv, hd, hd_v), kw, timed): the width pairs' training
# shapes (timed; 20(b)'s Qwen2.5-14B step first), then the masks and
# shapes that only change which tiles a block walks
K7_BWD_CASES = (
    ("qwen", "Qwen2.5-14B training step (B 4, S 1024, 40 / 8 x 128, "
     "causal)", (4, 40, 8, 1024, 1024, 128, 128), {}, True),
    ("hd64", "Granite-MoE (B 2, S 1024, 16 / 8 x 64, causal)",
     (2, 16, 8, 1024, 1024, 64, 64), {}, True),
    ("hd80", "Zamba2-2.7B (B 2, S 1024, 32 / 32 x 80, causal)",
     (2, 32, 32, 1024, 1024, 80, 80), {}, True),
    ("hd96", "Phi-3-mini (B 2, S 1024, 32 / 32 x 96, causal)",
     (2, 32, 32, 1024, 1024, 96, 96), {}, True),
    ("hd256", "Gemma-7B (B 2, S 1024, 16 / 16 x 256, causal)",
     (2, 16, 16, 1024, 1024, 256, 256), {}, True),
    ("192_192", "train_lm_100m (B 4, S 192, 4 / 2 x (192, 192), causal)",
     (4, 4, 2, 192, 192, 192, 192), {}, True),
    ("192_128", "MLA widths (B 1, S 1024, 16 / 16 x (192, 128), causal)",
     (1, 16, 16, 1024, 1024, 192, 128), {}, True),
    ("window", "window 256 (B 1, S 1024, 8 / 2 x 64)",
     (1, 8, 2, 1024, 1024, 64, 64), {"window": 256}, False),
    ("noncausal", "non-causal 64 x 64 (whisper_vlm_smoke; B 4, 4 / 2 x 64)",
     (4, 4, 2, 64, 64, 64, 64), {"causal": False}, False),
    ("whisper_cross", "Whisper cross attention (B 2, Sq 224 x Skv 1500, "
     "6 / 6 x 64, non-causal)", (2, 6, 6, 224, 1500, 64, 64),
     {"causal": False}, False),
    ("ragged", "ragged tiles (B 1, S 1000, 8 / 2 x 128, causal)",
     (1, 8, 2, 1000, 1000, 128, 128), {}, False),
    ("ragged_offset", "ragged, Sq 37 x Skv 101 (B 2, 6 / 3 x 96, causal)",
     (2, 6, 3, 37, 101, 96, 96), {}, False))
# the case whose bf16 run also runs the widened bound's control
K7_BWD_CONTROL = "ragged"
# 20(a): K8's VJP, (key, label, (C, L, H, P, G, N), timed)
K8_BWD_CASES = (
    ("mamba2", "Mamba2-780m (8 chunks of 256, 48 x 64, N 128, G 1)",
     (8, 256, 48, 64, 1, 128), True),
    ("zamba2", "Zamba2-2.7B (8 chunks of 256, 80 x 64, N 64, G 1)",
     (8, 256, 80, 64, 1, 64), True),
    ("reduced", "the reduced configs (64 chunks of 16, 16 x 32, N 16)",
     (64, 16, 16, 32, 1, 16), True),
    ("g2", "G 2 (2 chunks of 256, 48 x 64, N 128)",
     (2, 256, 48, 64, 2, 128), False),
    ("ragged", "a ragged chunk of 100 (3 chunks, 48 x 64, N 128)",
     (3, 100, 48, 64, 1, 128), False))


def _grad_err(torch, got, ref, *, bf16, elem_abs=None) -> dict:
    """One gradient against its reference: float32 within 1e-4 of the
    reference's largest element; bf16 element by element within one bf16
    ulp of the reference (2**-7 of it) plus ``elem_abs`` plus 1e-5 of the
    largest, as phase 8 holds K7's bf16 forward."""
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item() if ref.numel() else 0.0
    if bf16:
        over = diff - BF16_ULP_REL * ref.float().abs()
        if elem_abs is not None:
            over = over - elem_abs
        err, rel = max(over.max().item(), 0.0), BF16_ATOL_REL
    else:
        err, rel = diff.max().item(), 1e-4
    return {"shape": list(got.shape), "max_abs_err": diff.max().item(),
            "max_abs_ref": scale, "excess" if bf16 else "err": err,
            "bound_rel": rel, "finite": bool(torch.isfinite(got).all()),
            "ok": bool(torch.isfinite(got).all()) and err <= rel * scale}


def k7_bwd_d_terms(torch, q, k, v, do, out, causal, window):
    """bf16: the backward reads the forward's bf16 output o, so D = <dO,
    o> differs from the plain version's float32 D by dD a row; that moves
    dq_i by at most scale |dD_i| (P|k|)_i and dk_j by scale sum_i P_ij
    |dD_i| |q_i| (over the group's heads), the element-wise terms added
    to those two gradients' bounds (dv reads no D)."""
    from repro_torch.kernels import flash_attention as fa
    B, H, Sq, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = 1.0 / float(np.sqrt(hd))
    kw = dict(causal=causal, window=window)
    o32 = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    dof = do.float()
    dD = ((dof * out.float()).sum(-1) - (dof * o32).sum(-1)).abs()
    pk = fa.flash_attention_plain(q.float(), k.float(), k.float().abs(), **kw)
    logits, _ = fa._logits(q, k, causal, window, None)
    p = torch.softmax(logits, dim=-1)
    dk = scale * torch.einsum("bkgqs,bkgq,bkgqh->bksh", p,
                              dD.reshape(B, K, G, Sq),
                              q.float().abs().reshape(B, K, G, Sq, hd))
    return scale * dD[..., None] * pk, dk


# bf16: the tensor-core VJP rounds P and dS to bf16 before the products
# that accumulate them (dV = P^T dO, dK = dS^T Q, dQ = dS K), as the
# forward rounds P for P V (BF16_P_REL) and as FlashAttention's backward
# does.  Rounding to nearest in bf16 (8 significant bits) moves a value x
# by at most 2^-8 |x|, so a sum of products x_j y_j whose x_j are rounded
# moves by at most 2^-8 sum_j |x_j| |y_j|, column by column:
#   dQ_i  by 2^-8 scale sum_j |dS_ij| |k_j|
#   dK_j  by 2^-8 scale sum_{h in group} sum_i |dS_ij| |q_i|
#   dV_j  by 2^-8 sum_{h in group} sum_i P_ij |dO_i|
# taken from the plain version's float32 P and dS, and added to each
# gradient's element bound beside k7_bwd_d_terms'.  In a CPU emulation of
# the rounding against jax.vjp at 1 x 512, 4 / 2 x 128, causal, the
# gradients exceeded the element bound without these terms by 5.5e-4 (dq),
# 3.8e-4 (dk) and 7.4e-4 (dv) of the largest value, and with them by
# 1.3e-7, 0 and 0 (within the 1e-5 allowance); dropping keys 64-127
# exceeded the widened bound by 0.45, 0.42 and 0.22 of it
# (tests/test_torch_attention_bwd.py emulates the same at three pairs).
# The control (k7_bwd_control) shows on the card that the widened bound
# still fails a VJP that drops one 64-key tile.
BF16_DS_REL = 2.0 ** -8


def k7_bwd_round_terms(torch, q, k, v, do, causal, window):
    """bf16: the element-wise terms of rounding P and dS to bf16 (above),
    for dq, dk and dv."""
    from repro_torch.kernels import flash_attention as fa
    B, H, Sq, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = 1.0 / float(np.sqrt(hd))
    logits, _ = fa._logits(q, k, causal, window, None)
    p = torch.softmax(logits, dim=-1)
    dog = do.float().reshape(B, K, G, Sq, -1)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dog, v.float())
    o32 = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    ds = (p * (dp - (dog * o32).sum(-1, keepdim=True))).abs()
    del dp, o32
    dq = BF16_DS_REL * scale * torch.einsum(
        "bkgqs,bksh->bkgqh", ds, k.float().abs()).reshape(B, H, Sq, hd)
    dk = BF16_DS_REL * scale * torch.einsum(
        "bkgqs,bkgqh->bksh", ds, q.float().abs().reshape(B, K, G, Sq, hd))
    dv = BF16_DS_REL * torch.einsum("bkgqs,bkgqh->bksh", p, dog.abs())
    return dq, dk, dv


def k7_bwd_control(torch, q, k, v, do, out, lse, ref, terms, causal,
                   window) -> dict:
    """The widened bf16 bound's control: the plain VJP (FlashAttention-2's
    formulas in float32, rounded to bf16 at the end) with every pair of
    keys 64-127 dropped (P = 0 there, as a kernel that skipped that tile
    would) must fail the bound in each of dq, dk and dv."""
    from repro_torch.kernels import flash_attention as fa
    B, H, Sq, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = 1.0 / float(np.sqrt(hd))
    logits, mask = fa._logits(q, k, causal, window, None)
    keep = mask.clone()
    keep[:, 64:128] = False
    p = torch.exp(logits - lse.float().reshape(B, K, G, Sq, 1))
    p = p.masked_fill(~keep, 0.0)
    dog = do.float().reshape(B, K, G, Sq, -1)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dog, v.float())
    D = (dog * out.float().reshape(B, K, G, Sq, -1)).sum(-1, keepdim=True)
    ds = p * (dp - D)
    bad = (scale * torch.einsum("bkgqs,bksh->bkgqh", ds, k.float()
                                ).reshape(B, H, Sq, hd),
           scale * torch.einsum("bkgqs,bkgqh->bksh", ds,
                                q.float().reshape(B, K, G, Sq, hd)),
           torch.einsum("bkgqs,bkgqh->bksh", p, dog))
    grads = {name: _grad_err(torch, b.to(q.dtype), r, bf16=True, elem_abs=t)
             for name, b, r, t in zip(("dq", "dk", "dv"), bad, ref, terms)}
    res = {"case": "the plain VJP with keys 64-127 dropped, against the "
                   "widened bf16 bound (each gradient must fail it)",
           "excess_rel": {n: g["excess"] / g["max_abs_ref"]
                          for n, g in grads.items()},
           "fails_each": all(not g["ok"] for g in grads.values())}
    print("   control: " + json.dumps(res), flush=True)
    if not res["fails_each"]:
        failures.append(f"K7 VJP bound control: {res}")
    return res


def sdpa_choice(torch, q, k, v, **kw) -> str:
    """The backend SDPA's dispatcher picks for these inputs (its forward's:
    the backward runs the same backend's kernels)."""
    from torch.nn.attention import SDPBackend
    args = (q, k, v, kw.get("attn_mask"), 0.0, kw.get("is_causal", False))
    try:
        i = torch._fused_sdp_choice(*args, enable_gqa=kw.get("enable_gqa",
                                                             False))
    except TypeError:
        i = torch._fused_sdp_choice(*args)
    try:
        return SDPBackend(i).name
    except (TypeError, ValueError):
        return str(i)


def k7_bwd_case(torch, c, key, label, B, H, K, Sq, Skv, hd, hd_v, *,
                dtype, timed, causal=True, window=0, control=False) -> dict:
    """K7's VJP: the FlashAttention Function's gradients (K7 with lse,
    then the dq and dk/dv kernels) against autograd through the plain
    version on the same inputs and output cotangent, on the views the
    model passes; the backward kernels bitwise repeatable on the saved
    tensors, and the Function's gradients bitwise theirs.  Timed: each
    kernel alone (median of REPS, L2 flushed) and both in one call, the
    plain VJP and SDPA's backward (its backend named from the
    profile's kernels, else by the dispatcher's pick), beside each
    kernel's bound: dq needs the products S, dP and dS K, dk/dv S, dP,
    P^T dO and dS^T Q, over the pairs the mask keeps, against the
    tensors each reads and writes once."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    bf16 = dtype == torch.bfloat16
    kw = dict(causal=causal, window=window)
    q = c.randn(B, Sq, H, hd).to(dtype).transpose(1, 2)
    k = c.randn(B, Skv, K, hd).to(dtype).transpose(1, 2)
    v = c.randn(B, Skv, K, hd_v).to(dtype).transpose(1, 2)
    do = c.randn(B, Sq, H, hd_v).to(dtype).transpose(1, 2)

    def leaves():
        return [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    ins = leaves()
    got = torch.autograd.grad(
        fa.FlashAttention.apply(*ins, causal, window, None), ins, do)
    ins = leaves()
    ref = torch.autograd.grad(fa.flash_attention_plain(*ins, **kw), ins, do)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    g1 = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    g2 = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    terms = (None, None, None)
    if bf16:
        d_terms = k7_bwd_d_terms(torch, q, k, v, do, out, causal, window)
        r_terms = k7_bwd_round_terms(torch, q, k, v, do, causal, window)
        terms = (d_terms[0] + r_terms[0], d_terms[1] + r_terms[1],
                 r_terms[2])
        del d_terms, r_terms
    grads = {name: _grad_err(torch, a, r, bf16=bf16, elem_abs=t)
             for name, a, r, t in zip(("dq", "dk", "dv"), got, ref, terms)}
    bitwise = all(torch.equal(a, b) for a, b in zip(g1, g2))
    same = all(torch.equal(a, b) for a, b in zip(g1, got))
    ok = bitwise and same and all(g["ok"] for g in grads.values())
    res = {"case": f"K7 VJP {label}, {'bf16' if bf16 else 'float32'}",
           "grads": grads, "bitwise_repeatable": bitwise,
           "function_is_the_kernels": same, "ok": ok,
           "max_abs_err": max(g["max_abs_err"] for g in grads.values())}
    if control:
        res["control"] = k7_bwd_control(torch, q, k, v, do, out, lse, ref,
                                        terms, causal, window)
    del terms
    if timed:
        mask = fa._mask(Sq, Skv, causal, window, c.dev)
        pairs = int(mask.sum()) * B * H
        e = q.element_size()
        qo = B * H * Sq * e
        kv = B * K * Skv * e
        # dq: q, k, v, o, dO and lse read, D and dq written
        dq_bytes = qo * (2 * hd + 2 * hd_v) + kv * (hd + hd_v) + 8 * B * H * Sq
        # dk/dv: q, k, v, dO, lse and D read, dk and dv written
        dkdv_bytes = (qo * (hd + hd_v) + 2 * kv * (hd + hd_v)
                      + 8 * B * H * Sq)
        peak = BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S
        plan, _, args = fa._bwd_prepare(q, k, v, out, do, lse, causal,
                                        window, None)
        fa._bwd_launch(plan, 0, args)
        for which, name, nbytes, flops in (
                (0, "dq", dq_bytes, 2.0 * pairs * (2 * hd + hd_v)),
                (1, "dkdv", dkdv_bytes, 2.0 * pairs * (2 * hd + 2 * hd_v))):
            res[f"{name}_ms"] = median_ms(
                torch, functools.partial(fa._bwd_launch, plan, which, args),
                c.flush)
            res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = bound(
                nbytes, flops, peak)
        res["ms"] = median_ms(torch, lambda: fa.flash_attention_bwd_cuda(
            q, k, v, out, do, lse, **kw), c.flush)
        res["plain_ms"] = median_ms(torch, lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, do, lse, **kw), c.flush)
        res["bound_ms"], res["bound_by"] = bound(
            qo * (2 * hd + 2 * hd_v) + 2 * kv * (hd + hd_v) + 4 * B * H * Sq,
            2.0 * pairs * (3 * hd + 2 * hd_v), peak)
        sdpa_kw = ({} if not causal and not window else
                   {"is_causal": True} if causal and not window and Sq == Skv
                   else {"attn_mask": mask})
        ls = leaves()
        try:
            o_lib = F.scaled_dot_product_attention(
                *ls, enable_gqa=H != K, **sdpa_kw)
            res["library_ms"] = median_bwd_ms(torch, o_lib, ls, do, c.flush)
            res["sdpa_backward"] = sdpa_backend(
                torch, lambda: torch.autograd.grad(o_lib, ls, do,
                                                   retain_graph=True))
            if res["sdpa_backward"]["backend"] == "not seen":
                # the profile held no device row: the dispatcher's pick
                res["sdpa_backward"]["backend"] = sdpa_choice(
                    torch, *ls, enable_gqa=H != K, **sdpa_kw) + \
                    " (the dispatcher's pick)"
        except RuntimeError as e:
            res["library_ms"] = None
            res["sdpa_backward"] = f"not timed: {str(e)[:160]}"
    print("   " + json.dumps(res), flush=True)
    if not ok:
        failures.append(f"{res['case']}: {grads}, bitwise {bitwise}, "
                        f"function {same}")
    return res


def k8_bwd_case(torch, c, key, label, C, L, H, P, G, N, *, dtype,
                timed) -> dict:
    """K8's VJP: the SSDChunkState Function's gradients (dx, ddt, dA,
    dBm) against autograd through the plain version on the same inputs
    (x and Bm as float32 leaves) and state cotangent, x and Bm views of
    one (C, L, conv_dim) tensor as the model passes them; A in [-16, -1]
    and dt = softplus(N(0,1) - 5), Mamba2's ranges.  bf16's dx and dBm
    element by element within one bf16 ulp plus 1e-5 of the largest, the
    rest within 1e-4 of the largest.  The kernels bitwise repeatable.
    Timed: the tile kernel (u and v, 4 C H L P N flops, against its
    inputs, dx and the scratch) and the scan kernel (the scratch in, ddt,
    dA's partials and dBm out) each beside its bound, and the VJP beside
    its bound and autograd through the reference's einsum."""
    from repro_torch.kernels import ssd_chunk as sc
    bf16 = dtype == torch.bfloat16
    xBC = c.randn(C, L, H * P + 2 * G * N).to(dtype)
    x = xBC[..., :H * P].reshape(C, L, H, P)
    Bm = xBC[..., H * P:H * P + G * N].reshape(C, L, G, N)
    dt = torch.nn.functional.softplus(c.randn(C, L, H) - 5.0)
    A = -(1.0 + 15.0 * torch.rand(H, generator=c.gen)).to(c.dev)
    gs = c.randn(C, H, P, N)

    def leaves():
        return [t.detach().clone().requires_grad_(True) for t in (x, dt, A, Bm)]

    ins = leaves()
    got = torch.autograd.grad(sc.SSDChunkState.apply(*ins), ins, gs)
    # the reference takes x and Bm as float32 leaves (the same values):
    # through bf16 leaves autograd would round each head's dBm to bf16
    # and sum the group's heads in bf16 (repeat_interleave's backward),
    # where the kernel sums them in float32
    ins = [t.float().detach().requires_grad_(True) for t in leaves()]
    ref = torch.autograd.grad(sc.ssd_chunk_state_plain(*ins), ins, gs)
    g1 = sc.ssd_chunk_state_bwd_cuda(x, dt, A, Bm, gs)
    g2 = sc.ssd_chunk_state_bwd_cuda(x, dt, A, Bm, gs)
    torch.cuda.synchronize()
    grads = {name: _grad_err(torch, a, r, bf16=bf16 and name in ("dx", "dBm"))
             for name, a, r in zip(("dx", "ddt", "dA", "dBm"), got, ref)}
    bitwise = all(torch.equal(a, b) for a, b in zip(g1, g2))
    ok = bitwise and all(g["ok"] for g in grads.values())
    res = {"case": f"K8 VJP {label}, {'bf16' if bf16 else 'float32'}",
           "grads": grads, "bitwise_repeatable": bitwise, "ok": ok,
           "max_abs_err": max(g["max_abs_err"] for g in grads.values()),
           "plan": sc.bwd_launch_plan(x, Bm)}
    if timed:
        e = x.element_size()
        plan, _, args = sc._bwd_prepare(x, dt, A, Bm, gs)
        runs = plan["runs"]
        # tile: x, Bm, dt, A, G read, dx and the scratch written; scan: the
        # scratch, dt and A read, ddt, dA's partials and dBm written
        tile_bytes = (e * (2 * C * L * H * P + C * L * G * N)
                      + 4 * (3 * C * L * H + H + C * H * P * N
                             + C * G * runs * L * N))
        scan_bytes = (e * C * L * G * N
                      + 4 * (4 * C * L * H + H + C * H + C * G * runs * L * N))
        peak = BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S
        for name, fn, counter, nbytes, flops in (
                ("tile", sc.BWD_ENTRIES[0], plan["counters"][0], tile_bytes,
                 4.0 * C * H * L * P * N),
                ("scan", sc.BWD_ENTRIES[1], plan["counters"][1], scan_bytes,
                 0.0)):
            res[f"{name}_ms"] = median_ms(
                torch, functools.partial(sc._bwd_launch, fn, counter, args),
                c.flush)
            res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = bound(
                nbytes, flops, peak)
        res["ms"] = median_ms(torch, lambda: sc.ssd_chunk_state_bwd_cuda(
            x, dt, A, Bm, gs), c.flush)
        res["plain_ms"] = median_ms(torch, lambda: sc.ssd_chunk_state_bwd_plain(
            x, dt, A, Bm, gs), c.flush)
        res["bound_ms"], res["bound_by"] = bound(
            e * 2 * (C * L * H * P + C * L * G * N)
            + 4 * (2 * C * L * H + C * H * P * N + 2 * H + C * H),
            4.0 * C * H * L * P * N,
            BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)
        lx, ldt, lA, lB = leaves()
        cum = torch.cumsum(ldt * lA, dim=1)
        st = torch.einsum("blhn,blh,blhp->bhpn",
                          lB.repeat_interleave(H // G, dim=2).float(),
                          torch.exp(cum[:, -1:, :] - cum),
                          lx.float() * ldt[..., None])
        res["library_ms"] = median_bwd_ms(torch, st, [lx, ldt, lA, lB], gs,
                                          c.flush)
    print("   " + json.dumps(res), flush=True)
    if not ok:
        failures.append(f"{res['case']}: {grads}, bitwise {bitwise}")
    return res


def k7_lse_cases(torch, c, results) -> dict:
    """K7 with lse written against K7 with lse null, at every width pair in
    both dtypes (B 2, S 200, G 2, causal): the outputs bitwise equal (the
    served path's output does not move), and lse within 1e-4 of the
    plain version's largest value."""
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for hd, hd_v in fa.WIDTH_PAIRS:
        for dname, dtype in (("bf16", torch.bfloat16),
                             ("float32", torch.float32)):
            q = c.randn(2, 200, 4, hd).to(dtype).transpose(1, 2)
            k = c.randn(2, 200, 2, hd).to(dtype).transpose(1, 2)
            v = c.randn(2, 200, 2, hd_v).to(dtype).transpose(1, 2)
            o_null = fa.flash_attention_cuda(q, k, v)
            o_lse, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
            _, ref = fa.flash_attention_plain(q, k, v, return_lse=True)
            torch.cuda.synchronize()
            err = (lse - ref).abs().max().item()
            r = {"same_output": torch.equal(o_null, o_lse), "lse_err": err,
                 "lse_max": ref.abs().max().item()}
            r["ok"] = r["same_output"] and err <= 1e-4 * r["lse_max"]
            out[f"({hd}, {hd_v}) {dname}"] = r
            if not r["ok"]:
                failures.append(f"K7 lse at ({hd}, {hd_v}) {dname}: {r}")
    print("   K7 with lse against lse null, per width pair: "
          + json.dumps(out), flush=True)
    results["k7_lse"] = out
    return out


@phase("20a. K7's and K8's VJPs against autograd through the plain versions")
def phase_lm_vjps(torch, results):
    c = Checker(torch, seed=20)
    k7_lse_cases(torch, c, results)
    # K7's forward at (192, 192): train_lm_100m's attention
    for dname, dtype, counter in (("bf16", torch.bfloat16, "flash_attention"),
                                  ("float32", torch.float32,
                                   "flash_attention_fp32")):
        results[f"{counter}.192_192"] = k7_case(
            torch, c, f"K7 (192, 192) train_lm_100m (B 4, S 192, 4 / 2 "
            f"heads), {dname}", 4, 4, 2, 192, 192, 192, dtype=dtype)
    for dname, dtype in (("bf16", torch.bfloat16), ("float32", torch.float32)):
        for key, label, shape, kw, timed in K7_BWD_CASES:
            results[f"k7_vjp.{key}.{dname}"] = k7_bwd_case(
                torch, c, key, label, *shape, dtype=dtype, timed=timed,
                control=key == K7_BWD_CONTROL and dtype == torch.bfloat16,
                **kw)
        for key, label, shape, timed in K8_BWD_CASES:
            results[f"k8_vjp.{key}.{dname}"] = k8_bwd_case(
                torch, c, key, label, *shape, dtype=dtype, timed=timed)
        torch.cuda.empty_cache()


# 20(b)-(d): the trainer's runs, (key, label, argv, the kernel launches of
# every step).  Full widths in the configs' bf16; depth cut where stated
# (the 'reduced' of PERF.md section 4): Qwen2.5-14B to 4 of its 48 layers
# (~2.7 B parameters with its two 152 064-row embeddings, ~32 GB with
# AdamW's float32 moments), Mamba2-780m at full depth, 20(d)'s models to 2
# layers (Zamba2-2.7B to 6: one group of attn_every SSM layers and one
# application of the shared attention block).  A peak learning rate of
# 3e-4 after 2 warm-up steps: at the launcher's default 3e-3 Qwen2.5-14B's
# third loss jumped to 22.7 from 12.4 (H100 80GB HBM3, 700 W).
# Qwen2.5-14B takes 6 steps, Mamba2-780m 4 (host-bound: 0.78-0.90 s a
# step on the same card)
TRAIN_STEPS = {QWEN14: 6, MAMBA2: 4}
TRAIN_LR = ["--lr", "3e-4", "--warmup", "2"]
TRAIN_RUNS = (
    (QWEN14, "20b. Qwen2.5-14B, 4 layers, B 4 x S 1024",
     ["--arch", QWEN14, "--layers", "4", "--batch", "4", "--seq", "1024",
      "--steps", str(TRAIN_STEPS[QWEN14]), *TRAIN_LR],
     {"flash_attention": 4, "flash_attention_bwd_dq": 4,
      "flash_attention_bwd_dkdv": 4}),
    (MAMBA2, "20c. Mamba2-780m, 48 layers, B 2 x S 1024",
     ["--arch", MAMBA2, "--batch", "2", "--seq", "1024",
      "--steps", str(TRAIN_STEPS[MAMBA2]), *TRAIN_LR],
     {"ssd_chunk_state": 48, "ssd_chunk_state_bwd": 48,
      "ssd_chunk_state_bwd_scan": 48}))
TRAIN_CUTS = tuple(
    (arch, f"20d. {arch}, {n} layers, B 2 x S 1024",
     ["--arch", arch, "--layers", str(n), "--batch", "2", "--seq", "1024",
      "--steps", "1"], want)
    for arch, n, want in (
        (PHI3, 2, {"flash_attention": 2, "flash_attention_bwd_dq": 2,
                   "flash_attention_bwd_dkdv": 2}),
        ("gemma-7b", 2, {"flash_attention": 2, "flash_attention_bwd_dq": 2,
                         "flash_attention_bwd_dkdv": 2}),
        ("glm4-9b", 2, {"flash_attention": 2, "flash_attention_bwd_dq": 2,
                        "flash_attention_bwd_dkdv": 2}),
        (GRANITE, 2, {"flash_attention": 2, "flash_attention_bwd_dq": 2,
                      "flash_attention_bwd_dkdv": 2}),
        (ZAMBA2, 6, {"flash_attention": 1, "flash_attention_bwd_dq": 1,
                     "flash_attention_bwd_dkdv": 1, "ssd_chunk_state": 6,
                     "ssd_chunk_state_bwd": 6,
                     "ssd_chunk_state_bwd_scan": 6})))
# 20(e): every family the trainer runs on the card, at its reduced config
# in float32, card against CPU: (arch, batch, seq)
TRAIN_PARITY = tuple((a, 2, 64) for a in (
    QWEN14, PHI3, "gemma-7b", "glm4-9b", GRANITE, MAMBA2, ZAMBA2))
TRAIN_PARITY_STEPS = 3
# 20(f): train_lm_100m's steps (its default 300; cut from 220 to 60 for
# time, PERF.md section 7: its loss falls from 9.5 to 6.8 by then, the
# corpus's unigram entropy 6.5)
TRAIN_EXAMPLE_STEPS = 60


def train_kind(key: str) -> str:
    """A training step's device kernel by kind: K7's forward and VJP,
    K8's forward and VJP, else :func:`kernel_kind`'s."""
    k = key.lower()
    for name, kind in (("flash_fwd", "K7 forward"), ("flash_bwd", "K7 VJP"),
                       ("ssd_bwd", "K8 VJP"),
                       ("ssd_state", "K8 forward")):
        if name in k:
            return kind
    return kernel_kind(key)


def train_run(torch, key, label, argv, want, results, *, profile) -> dict:
    """One run of ``repro_torch.launch.train`` (its ``run``, the launcher's
    main path) from zeroed launch counts: every step launches exactly
    ``want`` and nothing else of the port's, every loss and grad norm is
    finite and, over several steps, the last loss lies below the first;
    ms a step (the median after the first), tok/s, peak device memory,
    and optionally a profile of one more step split by kind."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models.transformer import model as M
    args = T.parse_args(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = T.run(args)
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    steps = len(out["losses"])
    ms = float(np.median(out["step_seconds"][1:] or out["step_seconds"])
               ) * 1e3
    res = {"case": label, "argv": argv, "launches": launches,
           "launches_per_step": out["step_launches"][0],
           "losses": out["losses"], "grad_norms": out["grad_norms"],
           "step_ms": [t * 1e3 for t in out["step_seconds"]],
           "ms_per_step": ms,
           "tok_per_s": args.batch * args.seq / (ms / 1e3),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "params": M.param_count(out["params"])}
    print(f"   {label}: " + json.dumps(
        {k: res[k] for k in ("losses", "grad_norms", "ms_per_step",
                             "tok_per_s", "peak_gib", "params",
                             "launches_per_step")}), flush=True)
    results[f"train.{key}"] = res
    results[f"launches.train.{key}"] = launches
    require(all(s == want for s in out["step_launches"]),
            f"{label}: every step launches exactly {want}: "
            f"{out['step_launches']}")
    require(all(np.isfinite(out["losses"] + out["grad_norms"])),
            f"{label}: finite losses and grad norms")
    if steps > 1:
        require(out["losses"][-1] < out["losses"][0],
                f"{label}: the loss falls: {out['losses']}")
    if profile:
        # one profiling session, its active step after a profiled warm-up
        # step (the run's earlier profiled phases paid CUPTI's start-up;
        # a second session, as profile_active_step takes, cost about 15 s
        # at Mamba2's 48 layers on an H100 80GB HBM3, 700 W)
        from torch.profiler import ProfilerActivity, profile as prof_, \
            schedule
        step_fn, params, batch = out["step_fn"], out["params"], \
            out["batches"][-1]
        with prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1,
                                     repeat=1)) as prof:
            for _ in range(2):
                step_fn(params, batch)
                torch.cuda.synchronize()
                prof.step()
        rows = device_rows(prof)
        split = {}
        for e in rows:
            split[train_kind(e.key)] = split.get(train_kind(e.key), 0.0) + \
                dev_us(e) / 1e3
        res["profile_split_ms"] = split
        res["profile_device_ms"] = sum(split.values())
        res["profile_top"] = [{"kernel": e.key[:90], "count": e.count,
                               "ms": dev_us(e) / 1e3} for e in rows[:12]]
        print(f"   {label} profiled: device {res['profile_device_ms']:.3f} "
              f"ms a step of {ms:.3f} ms wall; split (ms): "
              + json.dumps(split), flush=True)
    del out
    torch.cuda.empty_cache()
    return res


def phase_train_lm(torch, results):
    """20(b)-(d), a phase each run (one that fails leaves the rest to
    run)."""
    for runs, profile in ((TRAIN_RUNS, True), (TRAIN_CUTS, False)):
        for key, label, argv, want in runs:
            phase(label)(train_run)(torch, key, label, argv, want, results,
                                    profile=profile)


def _named_leaves(tree, prefix=""):
    """(path, tensor) pairs of a param tree, in ``M._leaves``'s order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rel_errs(got, want) -> list:
    """|got - want| / max|want| per tensor (want on the CPU)."""
    out = []
    for x, y in zip(got, want):
        scale = float(y.abs().max()) if y.numel() else 0.0
        err = float((x.cpu() - y).abs().max()) if y.numel() else 0.0
        out.append(err / scale if scale else err)
    return out


@phase("20e. the trainer's step, card against CPU, float32")
def phase_train_parity(torch, results):
    """For each family the trainer runs on the card, at its reduced config
    in float32 from the same CPU-drawn weights and the same batches,
    card against CPU, each within 1e-4 of its tensor's largest element on
    the CPU: under the launcher's AdamW, the TRAIN_PARITY_STEPS losses and
    every gradient of the first step; under SGD (lr 0.01), every parameter
    after TRAIN_PARITY_STEPS steps (at lr 0.1 the reduced models' unclipped
    steps, gradient norms up to 16, let float32 trajectories separate by
    themselves: Zamba2's parameters 5.3e-4 apart after 3 steps, with its
    first gradients 1.3e-5 apart).  AdamW's parameters after those steps
    are printed beside, worst tensor named, and not held to 1e-4: Adam
    divides each gradient element by its own magnitude, so an element whose
    gradient is roundoff moves by +-lr on either device in a direction the
    roundoff picks (the key bias of Qwen2.5 and GLM-4 has a gradient that
    is zero but for roundoff, since softmax ignores a shift shared by a
    row's keys: 5.2e-2 and 7.5e-2 of its largest value apart after 3 steps
    on an H100 80GB HBM3 at 700 W; embedding rows summed in another
    order, 1.8e-4 in Phi-3), as the CPU tests hold GIN and GGNN under
    SGD.  ``make_train_step`` runs with its default per-layer recompute
    (``remat=True``) on both devices."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import model as M
    from repro_torch.optim import AdamW, Sgd, cosine_schedule
    out = {}
    ops.reset_launch_counts()
    for arch, B, S in TRAIN_PARITY:
        cfg = get_config(arch).reduced()
        cpu = M.init_params(cfg, torch.Generator().manual_seed(27),
                            max_seq=S, device="cpu")
        names = [n for n, _ in _named_leaves(cpu)]
        it = SyntheticLMDataset(cfg.vocab_size, S, seed=27).batches(B)
        batches = [{k: torch.from_numpy(v) for k, v in next(it).items()}
                   for _ in range(TRAIN_PARITY_STEPS)]
        runs = {}
        for opt_name in ("adamw", "sgd"):
            for dev in ("cpu", "cuda"):
                params = _to_cuda(cpu) if dev == "cuda" else \
                    M._map(lambda w, g: g.clone(), cpu, cpu)
                leaves = M.trainable(params)
                opt = (AdamW(leaves, lr=cosine_schedule(
                    3e-3, 20, TRAIN_PARITY_STEPS), weight_decay=0.01)
                    if opt_name == "adamw" else Sgd(leaves, lr=0.01))
                step = M.make_train_step(cfg, opt)
                losses, grads = [], None
                for i, b in enumerate(batches):
                    m = step(params, {k: v.to(dev) for k, v in b.items()})
                    losses.append(float(m["loss"]))
                    if i == 0:
                        grads = [p.grad.detach().clone() for p in leaves]
                runs[opt_name, dev] = (losses, grads,
                                       [p.detach() for p in leaves])
        (lc, gc, pc), (lg, gg, pg) = runs["adamw", "cpu"], \
            runs["adamw", "cuda"]
        adam_params = _rel_errs(pg, pc)
        worst = int(np.argmax(adam_params))
        sgd = runs["sgd", "cpu"], runs["sgd", "cuda"]
        sgd_params = _rel_errs(sgd[1][2], sgd[0][2])
        r = {"loss_cpu": lc, "loss_card": lg,
             "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(lg, lc)),
             "grad_rel": max(_rel_errs(gg, gc)),
             "sgd_loss_rel": max(abs(a - b) / abs(b)
                                 for a, b in zip(sgd[1][0], sgd[0][0])),
             "sgd_param_rel": max(sgd_params),
             "sgd_param_worst": names[int(np.argmax(sgd_params))],
             "adamw_param_rel": adam_params[worst],
             "adamw_param_worst": names[worst]}
        r["ok"] = max(r["loss_rel"], r["grad_rel"], r["sgd_loss_rel"],
                      r["sgd_param_rel"]) <= 1e-4
        out[arch] = r
        print(f"   {arch} (reduced, float32): " + json.dumps(r), flush=True)
        if not r["ok"]:
            failures.append(f"20e {arch}: card vs CPU {r}")
    results["train_parity"] = out
    results["launches.train.parity"] = {
        k: n for k, n in ops.launch_counts().items() if n}


@phase("20f. the trainer's examples on the card")
def phase_train_examples(torch, results):
    """``train_lm_100m`` at its default steps (losses, the unigram-entropy
    floor and whether the last loss lies below it; the loss must fall)
    and ``whisper_vlm_smoke`` as it stands, in this process, from zeroed
    launch counts."""
    from repro_torch.examples import train_lm_100m, whisper_vlm_smoke
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = train_lm_100m.main(["--steps", str(TRAIN_EXAMPLE_STEPS)])
    losses = out["losses"]
    ms = float(np.median(out["step_seconds"][1:])) * 1e3
    r = {"losses_every_20": losses[::20] + [losses[-1]],
         "first": losses[0], "last": losses[-1],
         "unigram_entropy": out["unigram_entropy"],
         "last_below_floor": losses[-1] < out["unigram_entropy"],
         "ms_per_step": ms,
         "launches": {k: n for k, n in ops.launch_counts().items() if n}}
    results["launches.train.train_lm_100m"] = r["launches"]
    print("   train_lm_100m: " + json.dumps(r), flush=True)
    require(losses[-1] < losses[0], f"train_lm_100m's loss falls: {r}")
    del out
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    smoke = whisper_vlm_smoke.main([])
    r["whisper_vlm_smoke"] = {a: v["losses"] for a, v in smoke.items()}
    results["launches.train.whisper_vlm_smoke"] = {
        k: n for k, n in ops.launch_counts().items() if n}
    print("   whisper_vlm_smoke: " + json.dumps(r["whisper_vlm_smoke"])
          + " launches " + json.dumps(
              results["launches.train.whisper_vlm_smoke"]), flush=True)
    results["train_examples"] = r


# phase 21: the sharding-plan dry run's combinations, each in a child of
# its own (both at once, side by side with phase 17's examples), and each
# child's time limit (on a CPU host Whisper-tiny took 16 s and DeepSeek-V3
# 22 s; 30.6 and 46.4 s for both on two card hosts, alone)
DRYRUN_COMBOS = (("whisper-tiny", "train_4k"), ("deepseek-v3-671b",
                                                "train_4k"))
DRYRUN_TIMEOUT_S = 150


def start_dryrun(torch) -> dict:
    """Phase 21's start: this process's allocated and peak device memory,
    then ``repro_torch.launch.dryrun`` for each of :data:`DRYRUN_COMBOS`
    on the 16x16 mesh in a child process of its own, all started at once
    (each writes its result to a file in a temporary directory).  They
    run while phase 17's examples, which are child processes too, run;
    :func:`phase_dryrun` collects them."""
    import tempfile
    torch.cuda.synchronize()
    run = {"before": (torch.cuda.memory_allocated(),
                      torch.cuda.max_memory_allocated()),
           "tmp": tempfile.mkdtemp(prefix="chip_smoke_dryrun_"), "procs": []}
    code = ("import time\n"
            "t0 = time.perf_counter()\n"
            "import sys, torch\n"
            "from repro_torch.launch import dryrun as DR\n"
            "rc = DR.main(['--arch', sys.argv[1], '--shape', sys.argv[2],\n"
            "              '--json', sys.argv[3]])\n"
            "print('CUDA_INITIALIZED', torch.cuda.is_initialized())\n"
            "print('CHILD_SECONDS', time.perf_counter() - t0)\n"
            "sys.exit(rc)\n")
    # fake tensors do no arithmetic: one thread each spares the cores
    # the examples run on
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    try:
        for arch, shape in DRYRUN_COMBOS:
            path = os.path.join(run["tmp"], f"{arch}.json")
            run["procs"].append((arch, shape, path, time.perf_counter(),
                                 subprocess.Popen(
                                     [sys.executable, "-c", code, arch,
                                      shape, path], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=env, cwd=ROOT)))
    except Exception:
        for *_, p in run["procs"]:
            p.kill()
            p.communicate()
        shutil.rmtree(run["tmp"], ignore_errors=True)
        raise
    return run


@phase("21. the sharding-plan dry run on fake tensors")
def phase_dryrun(torch, run, results):
    """Phase 21's end: each child of :func:`start_dryrun` must print
    ``done: 1 ok, 0 skip, 0 fail`` within its time limit (counted from its
    start) and report that it never initialised CUDA; this process's
    allocated and peak device memory must not have moved since the start
    (phase 17, run in between, runs child processes only).  One line a
    combination: per-device bytes, FLOPs, collective bytes by kind and
    the dominant roofline term (plan estimates against the H100's
    datasheet), the child's own seconds and the seconds from its start to
    its collection."""
    out, problems = {}, []
    try:
        for arch, shape, path, t0, p in run["procs"]:
            tag = f"{arch} x {shape} x 16x16"
            try:
                stdout, stderr = p.communicate(timeout=max(
                    1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                problems.append(f"{tag}: over {DRYRUN_TIMEOUT_S} s")
                continue
            waited = time.perf_counter() - t0
            if "CUDA_INITIALIZED False" not in stdout:
                problems.append(f"{tag}: the child initialised CUDA "
                                f"or did not say")
            if p.returncode or "done: 1 ok, 0 skip, 0 fail" not in stdout:
                problems.append(f"{tag}: rc {p.returncode}: "
                                f"{stdout[-600:]} {stderr[-600:]}")
                continue
            with open(path, encoding="utf-8") as f:
                r = json.load(f)[0]
            line = {k: r[k] for k in (
                "status", "chips", "bytes_per_device", "arg_bytes",
                "flops_per_device", "model_flops", "useful_ratio",
                "hbm_bytes_per_device", "collective_bytes_per_device",
                "roofline", "trace_s")}
            # the child's own seconds, and from its start to its collection
            own = re.search(r"CHILD_SECONDS ([0-9.]+)", stdout)
            line["child_s"] = float(own.group(1)) if own else None
            line["collected_after_s"] = waited
            out[tag] = line
            print(f"   {tag}: " + json.dumps(line), flush=True)
    finally:
        for *_, p in run["procs"]:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(run["tmp"], ignore_errors=True)
    results["dryrun"] = out
    before = run["before"]
    after = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    require(after == before, f"21: device memory moved: {before} -> {after}")
    require(not problems, "21: " + "; ".join(problems))


# phase 22: the linter's child (started beside phase 21's) and its time
# limit (it took 6.7 s on an H100's host beside phase 17, 8.9 s alone on
# a CPU-only one)
LINT_TIMEOUT_S = 120


def start_lint() -> dict:
    """Phase 22's start: ``python -m repro_torch.analysis --json`` over
    the port's default paths in a child process; a thread reads its
    output and notes when it exits.  :func:`phase_lint` collects it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = {"t0": time.perf_counter(), "proc": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--json"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)}

    def drain():
        run["out"] = run["proc"].communicate()
        run["seconds"] = time.perf_counter() - run["t0"]
    run["reader"] = threading.Thread(target=drain, daemon=True)
    run["reader"].start()
    return run


def raw_wrapper_cases(torch, dev) -> list:
    """``(label, wrapper, args, name)`` for each raw kernel wrapper on
    small inputs on ``dev``, one floating input of each requiring grad;
    ``name`` is what its refusal must say."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gat_fused as gf
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.kernels import ssd_chunk as sc
    gen = torch.Generator().manual_seed(22)

    def f(*shape, grad=False):
        return torch.randn(*shape, generator=gen).to(dev).requires_grad_(
            grad)

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    src, order, row_ptr = i32(0, 1, 2), i32(0, 1, 2), i32(0, 2, 3)
    h, g2, es, ed = f(3, 4), f(2, 4), f(3, 2), f(2, 2)
    q = f(1, 2, 64, 64).to(torch.bfloat16)
    x, dt, A, Bm = f(1, 64, 2, 64), f(1, 64, 2).abs(), -f(2).abs(), \
        f(1, 64, 1, 64)
    return [
        ("K1", ss.gather_scale_segment_sum_cuda,
         (h, src, f(3, grad=True), order, row_ptr, 2),
         "GatherScaleSegmentSum"),
        ("K2", ss.segment_sum_cuda, (f(3, 4, grad=True), order, row_ptr, 2),
         "SegmentSum"),
        ("K3", gf.gat_attention_cuda,
         (f(3, 4, grad=True), es, ed, src, order, row_ptr, 2),
         "GatAttention"),
        ("K3 VJP", gf.gat_backward_dst_cuda,
         (f(2, 4, grad=True), h, es, ed, ed, ed, src, order, row_ptr, 3),
         "no double backward"),
        ("K4", ss.gather_scale_segment_sum_q_cuda,
         (torch.zeros(3, 4, dtype=torch.uint8, device=dev), f(3, 1),
          f(3, 1), src, f(3, grad=True), order, row_ptr, 2),
         "forward only"),
        ("K5", ss.gather_rows_cuda, (f(2, 4, grad=True), src, order, 3),
         "GatherRows"),
        ("K6", ss.edge_dot_cuda, (h, f(2, 4, grad=True), src, order,
                                  row_ptr), "forward only"),
        ("K7", fa.flash_attention_cuda, (q, q, q.detach().requires_grad_()),
         "FlashAttention"),
        ("K7 VJP", fa.flash_attention_bwd_cuda,
         (q, q, q, q, q.detach().requires_grad_(), f(1, 2, 64)),
         "no double backward"),
        ("K8", sc.ssd_chunk_state_cuda, (x, dt, A, f(1, 64, 1, 64,
                                                     grad=True)),
         "SSDChunkState"),
        ("K8 VJP", sc.ssd_chunk_state_bwd_cuda,
         (x, dt, A, Bm, f(1, 2, 64, 64, grad=True)), "no double backward"),
    ]


@phase("22. the port's linter over the port; raw wrappers refuse grad")
def phase_lint(torch, run, results, dev="cuda"):
    """Phase 22's end: :func:`start_lint`'s child must exit 0 with no
    finding within its time limit (counted from its start); one line of
    its files by kind, suppressions and seconds.  Then each raw wrapper
    of :func:`raw_wrapper_cases` must refuse its input that requires
    grad, naming its Function, with no launch counted."""
    from repro_torch.kernels import ops
    run["reader"].join(max(1.0, LINT_TIMEOUT_S
                           - (time.perf_counter() - run["t0"])))
    if run["reader"].is_alive():
        run["proc"].kill()
        run["reader"].join()
        raise RuntimeError(f"check failed: the linter took over "
                           f"{LINT_TIMEOUT_S} s")
    stdout, stderr = run["out"]
    rc = run["proc"].returncode
    require(rc == 0, f"the linter exited {rc}: {stdout[-2000:]} "
            f"{stderr[-2000:]}")
    report = json.loads(stdout)
    line = {"exit_code": rc, "findings": len(report["findings"]),
            "files_checked": report["files_checked"],
            "files_by_kind": report["files_by_kind"],
            "suppressed": [f"{d['rule']} {d['path']}:{d['line']}"
                           for d in report["suppressed"]],
            "seconds": run["seconds"],
            "collected_after_s": time.perf_counter() - run["t0"]}
    print("   linter: " + json.dumps(line), flush=True)
    require(report["findings"] == [] and report["files_by_kind"]["cuda"],
            f"the port's linter is clean and read the CUDA sources: "
            f"{report['findings'][:5]}")
    refusals = {}
    before = ops.launch_counts()
    for label, fn, args, name in raw_wrapper_cases(torch, dev):
        try:
            fn(*args)
        except NotImplementedError as e:
            refusals[label] = name in str(e)
            print(f"   raw {label} on an input that requires grad "
                  f"refused: {str(e).split('gradient.  ')[-1]}", flush=True)
        else:
            refusals[label] = False
            print(f"   raw {label} ran on an input that requires grad",
                  flush=True)
    line["refusals"] = refusals
    results["lint"] = line
    require(all(refusals.values()), f"every raw wrapper refuses an input "
            f"that requires grad, naming its Function: {refusals}")
    require(ops.launch_counts() == before, "a refusal launched nothing")


def kernels_line(results) -> dict:
    """One row per kernel: its times from phase 2, 5 or 8, its launches
    from the phase that drives the path through it (phases 6 and 7 train
    through K1-K5 and K3's VJP, K6 runs in phase 5's dcoef case, the
    reference's _fused_bwd; phases 9 and 10 serve through K7 and K8;
    the float32 routes of K7 and K8 run in the float32 prefills of phases
    9 and 10; K7 at hd 80 and K8 at N 64 in phase 15; K7 at Whisper's
    and Qwen2-VL's shapes in phase 19).  K6's row is the
    single-head dcoef, with GAT's 4 x 64 and 4 x 10 beside it.  K3's row
    is the served inner block, with GAT's whole graph at 4 x 64 and 4 x
    10 beside it; its VJP's row is 4 x 64, with 4 x 10 beside it.  K1's row is the served inner block, with the whole graph
    at 602, 256 and 41 beside it; its transpose's row is GCN's 256, with
    41 and the GAT VJP's source pass (4 x 64, 4 x 10, without and with
    the column) beside it."""
    rows = []
    meta = [("gather_scale_segment_sum", "gather_scale_segment_sum",
             "segment_sum.cu", "src/repro/kernels/segment_sum.py:345",
             "launches.train.gcn"),
            ("gather_scale_segment_sum_t", f"k1_transpose.{HIDDEN}",
             "segment_sum.cu", "src/repro/kernels/segment_sum.py:345",
             "launches.train.gcn"),
            ("segment_sum", "segment_sum", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:152", "launches.train.gin"),
            ("gat_attention", "gat_attention", "gat_fused.cu",
             "src/repro/kernels/gat_fused.py:163", "launches.train.gat"),
            ("gat_attention_backward", "gat_backward", "gat_fused.cu",
             "src/repro/kernels/gat_fused.py:217", "launches.train.gat"),
            ("gather_scale_segment_sum_q", "gather_scale_segment_sum_q",
             "segment_sum.cu", "src/repro/kernels/segment_sum.py:580",
             "launches.minibatch.int8"),
            ("gather_rows", "gather_rows", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:221", "launches.train.gin"),
            ("edge_dot", "edge_dot", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:411", "launches.k6_dcoef"),
            ("flash_attention", "flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:90",
             f"launches.lm.{PHI3}"),
            ("flash_attention_fp32", "flash_attention_fp32",
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:90",
             f"launches.lm_fp32.{PHI3}"),
            ("ssd_chunk_state", "ssd_chunk_state", "ssd_chunk.cu",
             "src/repro/kernels/ssd_chunk.py:55", f"launches.lm.{MAMBA2}"),
            ("ssd_chunk_state_fp32", "ssd_chunk_state_fp32", "ssd_chunk.cu",
             "src/repro/kernels/ssd_chunk.py:55",
             f"launches.lm_fp32.{MAMBA2}"),
            ("ssd_chunk_state_fp32_cuda_core", "ssd_chunk_state_fp32_cuda_core",
             "ssd_chunk.cu", "src/repro/kernels/ssd_chunk.py:55",
             f"launches.lm_fp32.{MAMBA2}"),
            ("ssd_chunk_state_bf16_cuda_core",
             "ssd_chunk_state_bf16_cuda_core", "ssd_chunk.cu",
             "src/repro/kernels/ssd_chunk.py:55", f"launches.lm.{MAMBA2}")]
    for name, key, src, replaces, path in meta:
        r = results[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": results[path].get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("gather_bound_ms",) if k in r}})
        if name in ("ssd_chunk_state", "ssd_chunk_state_fp32"):
            # at Zamba2's widths (N 64), launched by phase 15's bf16
            # prefill or its float32 cut
            rn = results[f"{name}.n64"]
            lkey = "lm" if name == "ssd_chunk_state" else "lm_fp32"
            rows[-1]["at_zamba2_n64"] = dict(
                {k: rn[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
                launches=results[f"launches.{lkey}.{ZAMBA2}"].get(name, 0))
        if name in ("flash_attention", "flash_attention_fp32"):
            # hd 80 on the hd-96 tiles: phase 8's case at Zamba2's prefill
            # and its launches in phase 15's prefill (bf16) or cut
            # (float32); Granite's prefill (phase 8) with its launches in
            # phase 16's prefill (bf16) or parity run (float32); MLA's
            # (192, 128) at DeepSeek-V3's prefill (18(a)) with its launches
            # in 18(b)'s prefill or 18(c)'s parity run
            lkey = "lm" if name == "flash_attention" else "lm_fp32"
            for arch, label in ((ZAMBA2, f"at_{ZAMBA2}_hd80"),
                                (GRANITE, f"at_{GRANITE}"),
                                (DSV3, f"at_{DSV3}_192_128")):
                r = results[f"{name}.{arch}"]
                rows[-1][label] = dict(
                    {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
                    launches=results.get(f"launches.{lkey}.{arch}",
                                         {}).get(name, 0))
            # phase 19: Whisper's encoder and cross attention (launches:
            # all of K7's in 19(b)'s prefill, or one decode step's; in
            # float32, 19(d)'s two paths) and Qwen2-VL's prefill
            for key, path in (("whisper.encoder", f"{lkey}.{WHISPER}"),
                              ("whisper.cross_prefill", f"{lkey}.{WHISPER}"),
                              ("whisper.cross_decode",
                               f"lm_decode.{WHISPER}" if lkey == "lm"
                               else f"lm_fp32.{WHISPER}"),
                              (QWEN2VL, f"{lkey}.{QWEN2VL}")):
                r = results[f"{name}.{key}"]
                rows[-1][f"at_{key}"] = dict(
                    {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
                    launches=results.get(f"launches.{path}", {}).get(
                        name, 0))
        if name == "ssd_chunk_state_fp32_cuda_core":
            # the reduced configs' widths; no path launches it (the
            # serving launcher's loop is decode-only)
            r = results[f"{name}.reduced"]
            rows[-1]["at_reduced_configs"] = {
                k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}
        # K3 and its VJP over GAT's whole graph at its two layers' shapes
        wide = f"{GAT_HEADS}x{HIDDEN // GAT_HEADS}"
        narrow = f"{GAT_HEADS}x{GAT_CLASSES // GAT_HEADS}"
        extra = {"gat_attention": {f"at_{w}": f"gat_attention.full.{w}"
                                   for w in (wide, narrow)},
                 "gat_attention_backward": {f"at_{narrow}":
                                            f"gat_backward.{narrow}"},
                 # K1 over the whole graph at each trainer's width, and
                 # its transposes (GCN's, the GAT VJP's source pass)
                 "gather_scale_segment_sum": {
                     f"at_full_{F}": f"k1.full.{F}"
                     for F in (FEAT, HIDDEN, CLASSES)},
                 # K6 per head at GAT's two widths
                 "edge_dot": {f"at_{w}": f"edge_dot.{w}"
                              for w in (wide, narrow)},
                 "gather_scale_segment_sum_t": {
                     "at_41": f"k1_transpose.{CLASSES}",
                     **{f"at_{w}": f"k1_transpose.{w}"
                        for w in (wide, narrow)},
                     **{f"at_{w}_col": f"k1_transpose_col.{w}"
                        for w in (wide, narrow)}}}
        for label, key_ in extra.get(name, {}).items():
            rows[-1][label] = {k: results[key_][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "gather_bound_ms", "library_ms") if k in results[key_]}
        # phase 14: K1 and its transpose at the distributed shapes (rank
        # 0 of 4), with rank 1's launches at that width in the 10 pull
        # (push) epochs, as the wrapper counted them; then the
        # distributed mini-batch and P3 shapes
        if name in ("gather_scale_segment_sum", "gather_scale_segment_sum_t"):
            pre = "k1" if name == "gather_scale_segment_sum" else \
                "k1_transpose"
            for layout in ("pull", "push"):
                for F in (HIDDEN, CLASSES):
                    r = results.get(f"{pre}.dist.{layout}.{F}")
                    if r is None:
                        continue
                    rows[-1][f"at_dist_{layout}_{F}"] = dict(
                        {k: r[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")},
                        launches_per_rank=results.get(
                            f"launches.dist.{layout}", {}).get(
                                name, {}).get(F, 0))
            # the distributed mini-batch blocks (rank 0, launches a rank
            # over phase 14(f)'s fp32 run) and P3's layer 1 (launches a
            # rank over its 10 SGD epochs)
            for layout, F in (("mb_inner", FEAT), ("mb_outer", HIDDEN),
                              ("p3", P3_FEAT // DIST_WORLD)):
                r = results.get(f"{pre}.dist.{layout}.{F}")
                if r is None:
                    continue
                lkey = "mb" if layout.startswith("mb") else "p3"
                rows[-1][f"at_dist_{layout}_{F}"] = dict(
                    {k: r[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                    launches_per_rank=results.get(
                        f"launches.dist.{lkey}", {}).get(
                            name, {}).get(F, 0))
        if name in ("flash_attention", "flash_attention_fp32"):
            # (192, 192), train_lm_100m's pair (20(a)), with its launches
            # in 20(f) (float32; no bf16 path runs it)
            r = results[f"{name}.192_192"]
            rows[-1]["at_192_192"] = dict(
                {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
                launches=results.get("launches.train.train_lm_100m",
                                     {}).get(name, 0))
        if name == "flash_attention":
            # phase 13's configs: the case at each prefill shape (phase 8)
            # and its launches in that config's prefill (phase 13)
            for arch in ZOO:
                r = results[f"flash_attention.{arch}"]
                rows[-1][f"at_{arch}"] = dict(
                    {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
                    launches=results[f"launches.lm.{arch}"].get(name, 0))
    rows.extend(vjp_rows(results))
    return {"kernels": rows}


def vjp_rows(results) -> list:
    """Phase 20's kernels, K7's and K8's VJPs, which replace no TPU kernel.
    K7's two kernels are timed apart (each with its own bound); plain and
    library times are the whole VJP's (the plain FlashAttention-2
    backward, SDPA's backward), as is ``vjp_ms``.  bf16 rows: 20(a)'s
    Qwen2.5-14B case and 20(b)'s launches; float32: train_lm_100m's (192,
    192) and 20(f)'s launches.  K8's two kernels (tile, scan) are timed
    apart too, plain and library times the whole VJP's: bf16 rows
    Mamba2-780m (20(c)); float32 rows the reduced configs' widths (20(e)'s
    launches).  The other timed width pairs and widths stand beside each
    row."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    rows = []
    k7_src = {"bf16": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
              "float32":
              "src/repro_torch/kernels/csrc/flash_attention_bwd_tf32.cu"}
    k7_none = ("none: the reference differentiates L.attention "
               "(src/repro/models/transformer/layers.py:152) in XLA")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name, part, dname, main_key, path in (
            ("flash_attention_bwd_dq", "dq", "bf16", "qwen", QWEN14),
            ("flash_attention_bwd_dkdv", "dkdv", "bf16", "qwen", QWEN14),
            ("flash_attention_bwd_dq_fp32", "dq", "float32", "192_192",
             "train_lm_100m"),
            ("flash_attention_bwd_dkdv_fp32", "dkdv", "float32", "192_192",
             "train_lm_100m")):
        def part_of(r):
            return {"max_abs_err": r["max_abs_err"], "ms": r[f"{part}_ms"],
                    "plain_ms": r["plain_ms"],
                    "bound_ms": r[f"{part}_bound_ms"],
                    "bound_by": r[f"{part}_bound_by"],
                    "library_ms": r["library_ms"], "vjp_ms": r["ms"],
                    "vjp_bound_ms": r["bound_ms"]}
        z = torch.zeros(1, 1, 64, 128, dtype=torch.bfloat16 if dname == "bf16"
                        else torch.float32)
        kernel = fa.bwd_launch_plan(z, z, z)["kernels"][part == "dkdv"]
        row = {"name": name, "kernel": kernel, "route": "cuda",
               "source": k7_src[dname], "replaces": k7_none,
               "launches": results.get(f"launches.train.{path}", {}).get(
                   name, 0),
               **part_of(results[f"k7_vjp.{main_key}.{dname}"])}
        for key, _, _, _, timed in K7_BWD_CASES:
            if timed and key != main_key:
                row[f"at_{key}"] = part_of(results[f"k7_vjp.{key}.{dname}"])
        rows.append(row)
    for name, part, dname, main_key, path in (
            ("ssd_chunk_state_bwd", "tile", "bf16", "mamba2", MAMBA2),
            ("ssd_chunk_state_bwd_scan", "scan", "bf16", "mamba2", MAMBA2),
            ("ssd_chunk_state_bwd_fp32", "tile", "float32", "reduced",
             "parity"),
            ("ssd_chunk_state_bwd_scan_fp32", "scan", "float32", "reduced",
             "parity")):
        def k8_part(r):
            return {"max_abs_err": r["max_abs_err"], "ms": r[f"{part}_ms"],
                    "plain_ms": r["plain_ms"],
                    "bound_ms": r[f"{part}_bound_ms"],
                    "bound_by": r[f"{part}_bound_by"],
                    "library_ms": r["library_ms"], "vjp_ms": r["ms"],
                    "vjp_bound_ms": r["bound_ms"]}
        row = {"name": name,
               "kernel": results[f"k8_vjp.{main_key}.{dname}"]["plan"][
                   "kernels"][part == "scan"],
               "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
               "replaces": "none: the reference differentiates its states "
                           "einsum (src/repro/models/transformer/ssm.py:109) "
                           "in XLA",
               "launches": results.get(f"launches.train.{path}", {}).get(
                   name, 0),
               **k8_part(results[f"k8_vjp.{main_key}.{dname}"])}
        for key, _, _, timed in K8_BWD_CASES:
            if timed and key != main_key:
                row[f"at_{key}"] = k8_part(results[f"k8_vjp.{key}.{dname}"])
        rows.append(row)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    deadline = arm_deadline()
    from repro_torch import device as D
    D.resolve("cuda")
    smi = nvidia_smi_line()
    print(f"card: {smi} | torch.cuda.get_device_name: "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    results: dict = {}
    phase_build(torch, results)
    t0 = time.perf_counter()
    g = reddit_graph()
    blocks, x_np = sampled_blocks(g, FANOUTS)
    print(f"reddit-width graph: {g.num_nodes} nodes, {g.num_edges} edges "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    phase_kernels(torch, blocks, x_np, results)
    phase_serve(torch, results)
    phase_cpu_parity(torch, blocks, x_np)
    phase_profile(torch, blocks, x_np, results)
    phase_gin_gat(torch, results)
    g_gat = reddit_graph(GAT_CLASSES)
    phase_train_kernels(torch, g, g_gat, results)
    del blocks, x_np
    phase_fullbatch(torch, results)
    phase_minibatch(torch, results)
    phase_reorder_kernels(torch, g, g_gat, results)
    phase_reorder_train(torch, results)
    phase_reorder_serve(torch, results)
    phase_update_stream(torch, g, results)
    phase_samplers(torch, results)
    phase_datasets(torch, results)
    phase_replicas(torch, results)
    phase_autoscale(torch, results)
    phase_hot_swap(torch, results)
    phase_replica_updates(torch, g, results)
    phase_lm_kernels(torch, results)
    phase_phi3(torch, results)
    phase_mamba2(torch, results)
    for arch in ZOO:
        phase(f"13. serve {arch} at full width, bf16")(zoo_phase)(
            torch, arch, results)
        torch.cuda.empty_cache()
    phase_zamba2(torch, results)
    phase_granite(torch, results)
    torch.cuda.empty_cache()
    phase_deepseek(torch, results)
    torch.cuda.empty_cache()
    phase_encdec_vlm(torch, results)
    torch.cuda.empty_cache()
    phase_lm_vjps(torch, results)
    torch.cuda.empty_cache()
    phase_train_lm(torch, results)
    phase_train_parity(torch, results)
    phase_train_examples(torch, results)
    torch.cuda.empty_cache()
    dryrun = start_dryrun(torch)
    lint = start_lint()
    phase_examples(torch, results)
    phase_dryrun(torch, dryrun, results)
    phase_lint(torch, lint, results)
    phase_distributed(torch, g, g_gat, results)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": smi, "failures": failures,
                   "phase_seconds": PHASE_SECONDS, "results": results}, f,
                  indent=1, default=str)
    print("phase seconds: " + json.dumps(
        {k.split(" ")[0]: round(v, 1) for k, v in PHASE_SECONDS.items()}),
        flush=True)
    print(f"script seconds: {time.perf_counter() - T_START:.1f} (phases "
          f"{sum(PHASE_SECONDS.values()):.1f})", flush=True)
    deadline.cancel()
    faulthandler.cancel_dump_traceback_later()
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), flush=True)
        return 1
    print(smi)
    print(json.dumps(kernels_line(results)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
