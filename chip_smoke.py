#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py    # everything below, on one card

Phases, one line each (or a few):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, compute capability (must be 9.0), TF32 off;
2. build: every kernel of ``src/repro_torch/kernels/csrc`` with one nvcc
   per source, all started together, beside ``python -m
   repro_torch.launch.analyze`` in a process of its own on the CPU and
   the certifier's verdicts the armed phases will ask for
   (``warm_certificates``, all of which must be certified);
   then the analysis phase (``phase_analysis``): the certifier's matrix
   (every deployed entry certified, every frontier entry as expected,
   each refusal printed with its finding), every built instantiation's
   registers (``-Xptxas -v``) x the most threads its wrapper launches
   within 65,536 and its static + most dynamic shared memory within
   232,448 bytes, with its blocks an SM printed, the shared-memory model
   equal to the plans the built libraries report for every GEMM tile (all
   four GEMMs) and every attention kernel at every head width and dtype,
   and one exact qwen3-0.6b decode step's FLOPs and bytes
   (``launch/hlo_analysis.py``), printed after the serve phase beside
   the bound they imply and the measured step.  The kernel phases and the
   qwen3-0.6b serve phase run with ``REPRO_STATIC_AUDIT=1``: every launch
   is checked by the dispatch gate first (the ``gate ...`` lines count the
   checks beside the launches), and an uncertified call (seqmul at n =
   13) must raise ``CertificationError`` before any launch;
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card at the main path's shapes.  GEMMs: M in {decode batch,
   admission prompt, batch x prompt}, (K, N) the projections of
   qwen3-0.6b, plus a sweep over (n, t), and lut_matmul at the train
   shape (M = 1024, both MLP projections); the integer GEMMs must be
   bit-equal, lowrank_matmul within 2e-6 * max|want|, and every GEMM must
   give the same bits on two launches; each GEMM's ``launch_plan`` (lut,
   seqmul, packed, lowrank) must equal the launch the built library
   makes.  Then
   their edge cases: packed lanes at +-(2^n - 1) at n = 8 and 15 with K =
   3072, an odd K, M = 1 and (33, 300, 70); lowrank with every magnitude
   255 and mixed signs, with zero SVD tables (then bit-equal), M = 1,
   (33, 300, 70) and rank 24; lut and seqmul with every magnitude 2^n - 1
   and mixed signs, M = 1, (33, 301, 70), n = 1 and int64 sums; lut, packed
   and lowrank also at every projection of gemma2-9b (q, k/v, o, MLP up and
   down; the MLP rows timed) and of yi-9b at M = 4 and 128, and untimed
   at the projections of mamba2-130m (lut, packed and seqmul at in_proj 768
   -> 3352, N not a multiple of 16, and out_proj 1536 -> 768) and of
   recurrentgemma-2b (lut), and of seamless-m4t-large-v2 (lut, packed and
   seqmul at (1024, 1024), (1024, 8192) and (8192, 1024)), M = 4 and 128.
   Attention: the serve shapes of qwen3-0.6b (16 query and 8 KV heads of 128, bf16;
   prefill q (4, 32) over a 48-slot cache with a masked tail, key block
   16; decode batch 4 over 48 slots), a window + softcap case each, and
   one long shape each, and flash_attention and approx_attention_bitexact
   at the train shape (B 8, S = T = 128, key block 64 for the latter, with
   lse, as the train step's forward runs them), and flash_attention at the
   speculative verify shape (q (4, 5) over the 52-slot pool cache, per-row
   starts, stale slots past each window, a dead lane parked in the spare
   tail); flash_attention (o, and
   lse at the train shape) and flash_decode within rtol = atol = 2e-5
   of the plain version (max|err| / limit printed),
   approx_attention within one probability
   quantum (max|v| / 255) and 1e-5 for 99% of the outputs, with the
   bit-equal share printed; every attention row bit-identical over two
   launches and with ``launch_plan`` equal to the launch the built
   library makes; one more launch counts on the card the work the kernel
   skips, which must equal the masked-block rule's count (the (work item,
   key tile) pairs of ``fwd_tile_plan`` or ``approx_tile_plan``, the
   cache chunks of ``decode_chunk_plan``), and the count goes into the
   kernels line; every flash_attention and flash_decode row also prints
   its ``device_ms`` and SDPA's (``library_device_ms``); the build phase
   checks that every forward instantiation of flash_attention and every
   lowrank instantiation of approx_attention has tensor-core instructions
   (HMMA, IMMA) in its SASS and no decode or bitexact one has any, and
   prints each instantiation's registers and spill bytes, which must be 0
   at every head-width-256 instantiation of both.  Head width 256,
   every row timed and held as above: gemma2-9b's 16 query and 8 KV heads
   at the serve shape and with window 16 and softcap 50 (all four
   kernels), at S = T = 1024 (forward, bitexact, lowrank) and a decode over
   4,096 slots, a decode over 8,192 slots under gemma2's own window of
   4,096 (its dead chunks skipped and counted); gemma-7b's 16 / 16 heads
   (forward and decode), yi-9b's 32 / 4 heads of 128 (forward and decode
   at the serve shape), one float32 forward at 256, and the forward of
   train (c) at gemma2's train shape with lse, with and without softcap
   50, and bitexact there with lse (the approximate route's train forward).
   Query groups of 7 and head width 64, every row timed and held as above:
   qwen2-vl-7b's 28 query heads over 4 KV heads of 128 (the forward at the
   serve shape, at S = T = 1024 and at the train shape with lse, the decode
   at the serve shape and over 4,096 slots, bitexact and lowrank at the
   serve shape) and granite-moe-1b-a400m's 16 / 8 of 64 (the forward at
   the serve and train shapes, the decode at the serve shape).
   Query groups of 10, every row timed and held as above: recurrentgemma-2b's
   10 query heads over one KV head of 256 (the forward at the serve shape
   and at S = T = 4,096 under its window of 2,048, the decode at the serve
   shape and over 4,096 slots under the window, bitexact at the serve
   shape).
   Query groups of 1 at head width 64, causal and not, every row timed and
   held as above: seamless-m4t-large-v2's 16 query heads over 16 KV heads of
   64 (the forward non-causal, as its encoder runs it, at the serve shape
   S = T = 32, at the train shape with lse and at S = T = 1024; causal over
   the serve cache, as its decoder's prefill; the decode at the serve shape
   and over 4,096 slots; bitexact and lowrank non-causal at the serve shape,
   key block as the reference computes it, and at S = T = 1024).
   Backward: the dq and dk/dv kernels (bf16 tensor cores, float32
   operands split into two bf16 terms, tiles with nothing to add skipped)
   against ``flash_attention_bwd_plain`` on the forward kernel's (o, lse),
   float32, within 1e-4 * max|want| per output (max|err| / limit printed for
   each) and bit-identical over two launches, at the train shape (B 8, S =
   T = 128, bf16), at S = T = 1024, with window + softcap, and over the
   serve cache with masked slots and one left-padded row, each with
   ``launch_plan`` equal to the launch the built library makes, beside
   SDPA's backward by loop time and by device time (its forward and
   backward replayed from one CUDA graph, less its forward alone); then at
   head width 256, gemma2-9b's 16 / 8 heads at each of those shapes (window
   64 and softcap 50 at the train shape), gemma-7b's 16 / 16, gemma2's in
   float32 and on the bitexact forward's (o, lse), and yi-9b's 32 / 4 of
   128 (g = 8), qwen2-vl-7b's 28 / 4 of 128 (g = 7) and granite's 16 / 8
   of 64, all at the train shape; seamless's 16 / 16 of 64 non-causal and
   causal and recurrentgemma-2b's 10 / 1 of 256 (g = 10) under its window
   of 2,048, at the train shape and at S = T = 1024; the build phase checks that every
   instantiation of both kernels has tensor-core instructions (HMMA) in its
   SASS, and that none of their four at head width 256 spills.  Elementwise multiplier:
   ``seqmul_packed`` at n in {4, 8, 12, 15} and ``seqmul_words`` at n in
   {8, 15, 16}, t in {1, n/2, n-1}, approx and fix_to_1 both ways, on
   every (a, b) pair (n <= 8, 12) or numpy draws (2^20 + 3 at n = 15, 2^24
   at n = 16), then sizes 1, 127, 129 and 2^20 + 3, a 0-d and an empty
   tensor, and unaligned views: all bit-equal.
   Timed rows print the kernel's time, the plain version's, the bound
   (the larger of the bytes at 3.35 TB/s and the operations at their
   rate: table lookups at the shared-memory rate, the least integer
   operations of the recurrence at the SMs' int32 issue rate, int8
   tensor-core products (4 per product of 9- to 16-bit operands), TF32
   tensor-core products (lowrank's correction, 3 per product), bf16
   tensor-core products (the flash forward and backward, as their splits
   run them), float32 FLOPs on the CUDA cores (the decode); for attention
   counted over the query-slot pairs and the K/V slots this run's
   positions need, masked pairs adding nothing; approx_attention_lowrank
   as int8 tensor-core products for its exact parts and split TF32 for
   its corrections, as lowrank_matmul) and one PyTorch
   call that computes the same function, a yardstick the port never calls
   (torch.matmul for packed_matmul and lowrank_matmul,
   scaled_dot_product_attention for flash_attention and flash_decode, its
   backward alone for the backward kernels; none exists for the
   approximate products of lut_matmul, seqmul_matmul, approx_attention
   and the elementwise pair, and the exact torch.matmul beside the first
   two is printed as a yardstick only).  Times are per call over a loop
   of calls (the host's launch included); every GEMM row also prints
   ``device_ms``, the device's time alone (calls replayed from one CUDA
   graph), packed_matmul and lowrank_matmul with ``library_device_ms``
   beside it, lut_matmul with its time on magnitudes below 64 (no bank
   conflict in its gathers), and the backward pair, the flash rows and the
   timed approximate attention rows their ``device_ms``;
4. reference: ``engine.matmul`` on the card against the CPU reference
   bodies at a small shape (bit-equal; lowrank within 2e-6 * max|want|),
   and reduced qwen3-0.6b prefill logits on the card against the CPU
   (float32, rtol/atol 1e-4: sums run in another order): exact and
   bitexact, each with ``attn_impl`` "xla" and "pallas" (bitexact under
   pallas with the attention contractions approximated too); one train
   step's loss and gradients of reduced qwen3-0.6b (bitexact on mlp and
   attn, pallas) on the card against the CPU (rtol 1e-5; 1e-4 * max|want|);
   the same of gemma2-9b at ``reduced(head_dim=256, attn_impl="pallas")``
   (float32: the forward with lse and the backward pair at 256) on the
   card against the same step with the plain attention on the card, from
   the same parameters and batch (the same limits);
   then prefill and four decode steps' logits of reduced gemma-7b,
   gemma2-9b and yi-9b (exact), and of gemma2-9b at ``reduced(head_dim=256,
   attn_impl="pallas")`` at exact and at bitexact on mlp and attn (the
   attention kernels at head width 256; each approximate call fed the
   CPU's inputs after its own are held to 1e-4, since an ulp can cross an
   8-bit quantizer boundary), card against CPU within rtol/atol 1e-4;
   then reduced qwen2-vl-7b with 7 query heads on one KV head of 128 (g =
   7), fed patch embeddings at distinct t/h/w ids: prefill and four decode
   steps through flash_attention and flash_decode against the plain
   attention on the card (rtol/atol 1e-4), and reduced granite-moe-1b-a400m
   at the balanced tier (bitexact experts and attention projections),
   card against CPU, the approximate calls fed the CPU's inputs; then
   reduced mamba2-130m and recurrentgemma-2b (four layers, pallas) at the
   balanced tier, prefill and four decode steps card against CPU, the
   approximate calls fed the CPU's inputs; one train step each of reduced
   mamba2-130m and recurrentgemma-2b (pallas: the pair at its local
   attention) card against CPU; reduced seamless-m4t-large-v2 under pallas
   (two encoder and two decoder layers, 16 frames of memory): prefill and
   four decode steps' logits card against CPU at exact (flash_attention
   non-causal in the encoder, causal in the decoder, flash_decode) and at
   balanced (approx_attention_bitexact both ways; the approximate calls fed
   the CPU's inputs), and one train step through the kernels against the
   plain attention, both on the card (the same limits as the other train
   steps);
5. serve: the continuous scheduler on full-width qwen3-0.6b (28 layers,
   d_model 1024, vocab 151936, bf16, weights from a seed) at tier
   ``exact`` (no kernel: the yardstick), tier ``balanced`` (lut_matmul),
   tier ``draft`` (packed_matmul) and ``--approx-mode seqmul``
   (seqmul_matmul); then with ``attn_impl="pallas"`` at tier ``exact``
   (flash_attention, flash_decode), tier ``balanced`` (adds
   approx_attention_bitexact and lut_matmul) and ``lowrank`` on mlp and
   attn (lowrank_matmul, approx_attention_lowrank, flash_decode); one
   batch of 4 requests per run (2 for seqmul).  Every launch count is
   set to 0 just before each run and read just after.
   After each run, one pool prefill and one decode step give the
   launches and host time per step, and a profiler pass over one
   decode step the device's busy share (every profile traces the device
   and the CUDA runtime's calls; the host's PyTorch ops only where the
   host split of the tensor-parallel serves is printed: the balanced,
   pallas exact and pallas lowrank runs and their (1, 1)-mesh twins, so
   the other profiles stop and read in a fraction of the time).  Then
   the rest of serving:
   ``SelfSpeculative(k=4, draft_tier="draft")`` on the exact pool over 1
   of the exact run's 4 requests (packed_matmul) and on the pallas exact
   pool over 1 of its own (flash_decode, flash_attention, packed_matmul),
   their streams held against the greedy runs' by the margin rule (equal
   up to each request's first greedy step whose top-2 logit gap, by
   teacher forcing, is under ``STREAM_MARGIN``), with accept rate, rounds,
   modeled cost, tok/s and launches per round; the open loop on the
   ``bursty`` preset (32 requests, virtual clock, ``SLOAdaptive`` on its
   default ladder: lut_matmul, packed_matmul), whose switch sequence and
   per-request queue delays must equal those of reduced qwen3-0.6b on the
   CPU in the same call; the static loop at exact on 16 prompts of the
   bucket's length, held against the continuous scheduler by the margin
   rule; and ``run_soak`` on the ``steady`` preset (64 requests, windows of
   32, two parity spot-checks), which must keep every invariant.  Then
   full-width gemma2-9b (42 layers, d_model 3584, 16 / 8 heads of 256,
   9.24B params), gemma-7b (28 layers, 16 / 16 heads of 256) and yi-9b (48
   layers, 32 / 4 heads of 128, an untied head), bf16 weights from seed 0,
   one model on the card at a time, 4 requests (one batch) a run, 16
   tokens a request at the exact tiers and 8 at the approximate ones, with
   the same
   checks and launch counts (one profiled decode step a run, none for
   granite's draft run): gemma2-9b at exact, balanced, draft,
   pallas exact, pallas balanced and pallas lowrank on mlp and attn;
   gemma-7b at exact and pallas exact; yi-9b at exact, balanced and pallas
   exact; qwen2-vl-7b (28 layers, d_model 3584, 28 / 4 heads of 128, M-RoPE,
   d_ff 18944, vocab 152064, untied, 7.62B params; served on text tokens,
   t = h = w) at exact, balanced, pallas exact and pallas balanced
   (approx_attention_bitexact at g = 7); granite-moe-1b-a400m (24 layers,
   32 experts top-8 of moe_d_ff 512, 16 / 8 heads of 64, vocab 49155, tied,
   1.335B params) at exact, balanced (lut_matmul on every expert GEMM and
   attention projection), draft (packed_matmul per expert; these two at 4
   tokens a request) and pallas exact, each MoE run also printing the kernel launches inside the
   expert GEMMs per decode step and the share of routed assignments that
   capacity dropped, counted in the run (balanced and draft unprofiled);
   recurrentgemma-2b (26 layers of (rglru, rglru, attn_local), d_model
   2560, RG-LRU width 2560, 10 / 1 heads of 256, window 2,048, GeGLU d_ff
   7680, vocab 256,000, tied, 2.89B params) at exact, balanced, pallas
   exact and pallas balanced (the attention kernels at g = 10) and
   mamba2-130m (24 SSD layers, d_inner 1536, 24 heads of 64, state 128,
   chunk 256, vocab 50,280, tied) at exact, balanced, draft and seqmul,
   both on prompts of the bucket's full length (their recurrent state
   refuses left pads), each then through the static loop at exact (held
   against the continuous streams by the margin rule) and the long-prompt
   check: a prompt of 4,096 at batch 1 prefilled and 8 teacher-forced
   decode steps against one forward over 4,104 tokens (argmax equal
   wherever that forward's top-2 gap is at least ``STREAM_MARGIN``; the
   largest logit difference printed), mamba2 at exact, recurrentgemma at
   exact and pallas exact; each run with its parameter count, decode step
   and pool prefill ms, busy share, launches per decode step by kernel and
   peak device memory; then seamless-m4t-large-v2 (24 encoder + 24 decoder
   layers, d_model 1024, 16 / 16 heads of 64, d_ff 8192, vocab 256,206,
   tied, 1.772B params) through the static loop (the continuous scheduler
   refuses an encoder-decoder), prompts and an encoder memory of 32
   synthesized frames, at exact, balanced (lut_matmul), pallas exact
   (flash_attention non-causal and causal, flash_decode) and pallas
   balanced (approx_attention_bitexact non-causal and causal), 4 requests
   a run, each with its prefill
   (encoder, cross K/V, decoder) and decode-step ms, launches a step,
   busy share, tok/s and peak device memory;
5b. distribution, after the qwen3-0.6b serve runs on their weights: a
   one-rank NCCL process group through a ``FileStore`` in a temporary
   directory (no network); ``make_host_mesh()`` on ``cuda`` is (1, 1) and
   ``data_parallel_mesh(4)`` None; a mesh without a process group (the
   production mesh, an object) must make the scheduler raise; qwen3-0.6b
   served under an explicit one-rank ``("data",)`` mesh at ``exact``,
   ``balanced`` (lut_matmul) and ``draft`` (packed_matmul), each stream
   bit-equal to the ``mesh=None`` run's, with decode-step ms, launches a
   step and busy share beside it; qwen3-0.6b's full-width train state
   (bf16 parameters, two float32 AdamW moments drawn from a seed) sharded
   over the (1, 1) mesh, saved, restored onto the card (sharded) and onto
   the CPU (unsharded), both bit-equal, with the bytes and the save and
   restore seconds; the dry-run of kimi-k2-1t-a32b at ``train_4k`` and
   ``decode_32k`` on the 16 x 16 mesh, per-device GB beside the card's
   memory, under 10 s of host time;
5c. tensor parallel (``phase_tensor_parallel``): under the armed gate,
   each integer epilogue (lut_matmul and packed_matmul at n = 8,
   seqmul_matmul at n = 12) at qwen3-0.6b's row-parallel shard shapes
   (w2: K 3,072 over 2 and 4 shards, wo: K 2,048; N 1,024; M 4 and 128):
   every shard's output equal to its plain version, the shards' int64
   sums bit-equal to the whole K's integer launch, whose conversion equals
   the float32 launch, both epilogues timed, and the row-parallel seqmul
   route at n = 13 refused; the decode's (o, lse) over 2 and 4 slot ranges
   combined within rtol/atol 2e-5 of the whole decode (and its lse of the
   plain version's), o unmoved by writing lse, at the serve shape and
   over 4,096 slots, g = 2 (qwen3) and g = 10 (recurrentgemma, window
   2,048), with and without lse timed; then on a one-rank NCCL (1, 1)
   mesh the TP code: two full-width qwen3-0.6b train steps (bitexact
   mlp+attn, pallas; the row-parallel GEMMs take the integer epilogue),
   held after phase 6 against the first two of train (b), the same steps
   with ``mesh=None`` (losses within rtol 1e-5, both under PyTorch's
   deterministic algorithms; step ms, launches a step, busy share), and a
   balanced serve (lut_matmul) and a pallas exact one (flash_attention and
   flash_decode with their lse, the ranges combined) and a pallas lowrank
   mlp+attn one (the approximate attention at prefill under a model axis:
   the cache's slots gathered, lowrank_matmul, approx_attention_lowrank)
   with placed parameters, of the serve phase's requests, streams
   bit-equal to its ``mesh=None`` runs', the profiled decode step's host
   time in collectives and in device syncs and copies beside theirs; and
   two steps of each of train runs (d) granite-moe-1b-a400m,
   (e) mamba2-130m, (f) recurrentgemma-2b at 6 layers and (g)
   seamless-m4t-large-v2 on the mesh (the MoE, SSD, RG-LRU and
   encoder-decoder layers tensor-parallel; on one rank ``_moe_sharded``
   is not taken: its condition needs a model axis above 1), held after
   phase 6 against each run's first two steps there (losses within rtol
   1e-5, both under deterministic algorithms; losses' and grad norms'
   equality printed), and full-width mamba2-130m and recurrentgemma-2b
   at exact (full-length prompts) and seamless-m4t-large-v2 at pallas
   exact (the static loop, the cross K/V cache split over its memory
   slots) served on the mesh, their streams held bit-equal to the wide
   serve phase's ``mesh=None`` runs after it;
6. train: ``make_train_step`` through ``run_loop`` at full width (seed-0
   weights, ``SyntheticLM`` data, batch 8 x seq 128, 16 steps, the
   reference driver's schedule) for ``paper-multiplier`` with
   ``attn_impl="pallas"`` (lut_matmul on the MLPs, flash_attention with
   lse, the dq and dk/dv kernels) and qwen3-0.6b bitexact on mlp and attn
   with ``attn_impl="pallas"`` (adds approx_attention_bitexact; train (b),
   under PyTorch's deterministic algorithms, as (d)-(g) are, so that 5c's
   sharded steps are held against their first two), and (c)
   gemma2-9b at its published widths (d_model 3584, 16 / 8 heads of 256,
   vocab 256,000, both softcaps, window 4,096, tied embeddings), its depth
   cut to 4 layers (local, global, local, global), bf16, remat "full",
   pallas (flash_attention, dq and dk/dv at head width 256), and (d)
   granite-moe-1b-a400m at its published widths and depth (24 layers, 32
   experts top-8, capacity 1.25, bf16, remat "full", pallas: the forward
   and the pair at head width 64, the MoE aux loss in the loss): the loss
   must be finite and fall (and (d)'s aux positive at every step), and
   each expected kernel must launch in every step; each prints the means
   of its first and last ten losses, its first two losses ((d) also its CE
   and aux at steps 1 and 16), step ms, train tokens/s, launches per step, peak device memory
   and the busy share of one profiled step (with the device's top
   kernels and each of the port's kernels' device time); then (e)
   mamba2-130m at its published widths and depth (the SSD's scans under
   autograd; no kernel), (f) recurrentgemma-2b at its published widths cut
   to 6 of 26 layers, two (rglru, rglru, attn_local) periods (the forward
   and the pair at g = 10, head width 256), and (g) seamless-m4t-large-v2
   at its published widths and depth, fed 128 seeded frames a row (the
   forward non-causal and causal, the pair after each; both causal
   settings must be called on the card);
7. the train CLI, in a process of its own beside the error analysis:
   paper-multiplier, 6 steps with a checkpoint every 4 and a failure
   injected at step 5, which it must recover from, with the losses of its
   steps 1 and 6 (its own "loss a -> b", which averages ten steps at each
   end, the same steps over a run of 6, is checked but not printed);
   error analysis: ``engine.multiply`` (auto) and
   ``kernels.ops.approx_multiply`` on CUDA tensors (``seqmul_packed``, its
   launch count seen to rise), ``exhaustive_eval(12, 6)`` with fix_to_1
   both ways and ``mc_eval(16, 8)`` at 2^24 samples (their products from
   ``seqmul_words``) and ``mc_eval(32, 16)`` at 2^22 (``core.seqmul`` on
   the card), each with its wall time and the device's busy share, printed
   as a JSON line of its own; the launch counts are those of these calls.
   Then the checks: ``exhaustive_eval(12, 6)`` equal field for field to
   the CPU's (computed in a process of its own started before the kernel
   phases) (without fix_to_1 its worst overshoot is the closed-form
   MAE), so are ``exhaustive_eval`` at n = 1 and 4 and both ``mc_eval`` at
   2^16 samples; ``seqmul_words``' low + (high << 16) equal to
   ``core.seqmul``'s products on mc_eval(16, 8)'s draws; and ``python -m
   repro_torch.examples.quickstart`` and ``accuracy_sweep --steps 80`` on
   the card, both processes started with the phase, which must exit 0
   (the phase's walls are taken beside them and the train CLI);
8. the kernel table as JSON, then ``{"ok": true, "device": {...}}`` as the
   last line.

Each phase prints its wall seconds (``phase <name>: <s>s wall``).

Any failed check exits non-zero before the last line is printed; so does
a machine without CUDA, or a directory without the repository's ``src``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_CLK_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes
SMEM_LOOKUPS_PER_CLK_PER_SM = 32  # 32 banks, one 4-byte word each per clock
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores (NVIDIA data sheet)
TF32_TENSOR_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 tensor cores (NVIDIA data sheet)
BF16_TENSOR_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
F32_LANES_PER_CLK_PER_SM = 128  # Hopper SM: 4 partitions x 32 FP32 lanes, one FMA each

# qwen3-0.6b projections (K, N): q, k/v, o, mlp up/gate, mlp down
PROJECTIONS = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
SERVE = dict(requests=16, batch=4, prompt=32, gen=16)
# the qwen3-0.6b tier runs serve one batch (the open loop 32 requests, the
# static loop 16, the soak 64): the script's time limit
QWEN3_REQUESTS = SERVE["requests"] // 4
MAIN_SHAPE = (SERVE["batch"] * SERVE["prompt"], 1024, 3072)  # reported in the JSON
# qwen3-0.6b attention: query heads, KV heads, head width; the serve cache length
HEADS, KV_HEADS, HEAD_DIM = 16, 8, 128
CACHE = SERVE["prompt"] + SERVE["gen"]
# the heads (query, KV, width) of gemma2-9b, gemma-7b and yi-9b, and gemma2's
# local window and attention logit softcap
GEMMA2_HEADS = dict(h=16, kv=8, hd=256)
GEMMA7_HEADS = dict(h=16, kv=16, hd=256)
YI_HEADS = dict(h=32, kv=4, hd=128)
# qwen2-vl-7b's 28 query heads over 4 KV heads (g = 7), granite-moe-1b-a400m's
# 16 over 8 of head width 64
QWEN2VL_HEADS = dict(h=28, kv=4, hd=128)
GRANITE_HEADS = dict(h=16, kv=8, hd=64)
GEMMA2_WINDOW, GEMMA2_SOFTCAP = 4096, 50.0
# gemma2-9b's MLP projections (K, N): up/gate, down; its attention
# projections: q, k/v, o; yi-9b's: q and o, k/v, MLP up/gate, down
GEMMA2_MLP = [(3584, 14336), (14336, 3584)]
GEMMA2_ATTN_PROJECTIONS = [(3584, 4096), (3584, 2048), (4096, 3584)]
YI_PROJECTIONS = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096)]
# granite-moe-1b-a400m's expert GEMMs (K, N): up/gate (also its k/v
# projection), down; qwen2-vl-7b's projections: q and o, k/v, MLP up/gate, down
GRANITE_EXPERT_GEMMS = [(1024, 512), (512, 1024)]
QWEN2VL_PROJECTIONS = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)]
# recurrentgemma-2b's 10 query heads over one KV head of 256 (MQA, g = 10) and its
# local window; its projections (K, N): in_x, in_gate, q and o (also the
# RG-LRU's gates, which stay exact float32), k/v, MLP up/gate, down;
# mamba2-130m's in_proj (768 -> 3352: N not a multiple of 16) and out_proj
RECURRENTGEMMA_HEADS = dict(h=10, kv=1, hd=256)
RECURRENTGEMMA_WINDOW = 2048
RECURRENTGEMMA_PROJECTIONS = [(2560, 2560), (2560, 256), (2560, 7680), (7680, 2560)]
MAMBA2_PROJECTIONS = [(768, 3352), (1536, 768)]
# seamless-m4t-large-v2's 16 query heads over 16 KV heads of 64 (g = 1) and its
# projections (K, N): q, k, v, o and their cross twins, MLP up/gate, down
SEAMLESS_HEADS = dict(h=16, kv=16, hd=64)
SEAMLESS_PROJECTIONS = [(1024, 1024), (1024, 8192), (8192, 1024)]
# the long-prompt check of the recurrent families: a prompt of 4,096 at batch
# 1 (mamba2's SSD over 16 chunks of 256, recurrentgemma's window of 2,048
# binding), then teacher-forced decode steps, against one full forward
LONG_PROMPT, LONG_STEPS = 4096, 8
# the full-width serve runs of the wide models: one batch at every tier, half
# the tokens a request at the approximate ones (their steps are device-bound);
# the decode step itself is timed apart (step_breakdown)
WIDE_REQUESTS = SERVE["batch"]
WIDE_APPROX_REQUESTS = SERVE["batch"]
WIDE_APPROX_GEN = SERVE["gen"] // 2
# self-speculative serving: proposals per round; a verify forward is (B, k+1)
# over the pool cache, which holds k spare slots per row
SPEC_K = 4
VERIFY_CACHE = CACHE + SPEC_K
# the open-loop run's TTFT target (ms), at which the bursty trace makes the
# SLO-adaptive policy switch tiers (found on the CPU: the virtual clock's
# schedule does not depend on the model)
OPEN_SLO_TTFT_MS = 50.0
# A greedy choice whose top-2 logit gap is under this many logits may go
# either way between two programs that differ only in rounding: the logits
# are float32 from a bf16 hidden state, whose rounding moves a logit by
# about 1e-2 at full width.  Two streams must agree up to a request's first
# step with a gap under it (gaps by teacher forcing the greedy stream)
STREAM_MARGIN = 0.1
GEMM_KERNELS = ("lut_matmul", "seqmul_matmul", "packed_matmul", "lowrank_matmul")
ATTN_KERNELS = ("flash_attention", "flash_decode", "approx_attention_bitexact",
                "approx_attention_lowrank")
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# the head-width-256 instantiations of each attention library, which must not
# spill: forward (bf16, float32) x (softcap or not) and decode (bf16, float32);
# lowrank, and bitexact at 1, 2 and 4 rows a thread; dq and dk/dv (bf16, float32)
WIDE_INSTANTIATIONS = {"flash_attention": 6, "approx_attention": 4, "flash_attention_bwd": 4}
ELEMENTWISE_KERNELS = ("seqmul_packed", "seqmul_words")
# the elementwise kernels' main rows: every (a, b) pair at n = 12 (packed)
# and as many numpy draws at the paper's n = 16 (words), 2^24 elements each
ELEMENTWISE_MAIN = {"seqmul_packed": (12, 6), "seqmul_words": (16, 8)}
ELEMENTWISE_RAGGED = [(), (0,), (1,), (127,), (129,), ((1 << 20) + 3,)]
# the train runs: the reference driver's batch and sequence defaults
TRAIN = dict(batch=8, seq=128, steps=16)
TRAIN_CLI_STEPS = 6  # one checkpoint (step 4) before the failure at step 5
# train (c): gemma2-9b at its published widths, its depth cut to two
# (local, global) periods; the train CLI has no depth flag; train (f):
# recurrentgemma-2b's depth cut to two (rglru, rglru, attn_local) periods
GEMMA2_TRAIN_LAYERS = 4
RECURRENTGEMMA_TRAIN_LAYERS = 6
REPLACES = {
    "lut_matmul": "src/repro/kernels/lut_matmul.py:30",
    "seqmul_matmul": "src/repro/kernels/seqmul_matmul.py:53",
    "packed_matmul": "src/repro/kernels/packed_matmul.py:64",
    "lowrank_matmul": "src/repro/kernels/lowrank_matmul.py:33",
    "flash_attention": "src/repro/kernels/flash_attention.py:57",
    "flash_decode": "src/repro/kernels/flash_attention.py:296",
    "approx_attention_bitexact": "src/repro/kernels/approx_attention.py:184",
    "approx_attention_lowrank": "src/repro/kernels/approx_attention.py:171",
    "flash_attention_bwd_dq": "src/repro/kernels/flash_attention.py:126",
    "flash_attention_bwd_dkv": "src/repro/kernels/flash_attention.py:158",
    "seqmul_packed": "src/repro/kernels/seqmul_kernel.py:33",
    "seqmul_words": "src/repro/kernels/seqmul_kernel.py:54",
}
SOURCES = {
    "flash_decode": "flash_attention",
    "approx_attention_bitexact": "approx_attention",
    "approx_attention_lowrank": "approx_attention",
    "flash_attention_bwd_dq": "flash_attention_bwd",
    "flash_attention_bwd_dkv": "flash_attention_bwd",
    "seqmul_packed": "seqmul_kernel",
    "seqmul_words": "seqmul_kernel",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    """Print the wall seconds of the phase run inside."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f}s wall", flush=True)


def tensor_core_instructions(source: str, names: tuple, without: tuple = ()) -> dict:
    """``{kernel: [count per instantiation]}`` of tensor-core MMA
    instructions (HMMA for float and mma.sync, HGMMA for wgmma, IMMA for
    integer mma.sync) in the SASS of a built library (``cuobjdump
    -sass``), for the kernels whose names contain one of ``names`` or
    ``without``; each instantiation of ``names`` must have some, none of
    ``without`` any."""
    from repro_torch.kernels import build

    tool = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(source))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            name = next((n for n in names + without if n in mangled), None)
            current = None if name is None else counts.setdefault(name, [])
            if current is not None:
                current.append(0)
        elif current is not None and any(op in line for op in ("HMMA", "HGMMA", "IMMA")):
            current[-1] += 1
    check(all(counts.get(n) and all(counts[n]) for n in names),
          f"{source}: a kernel without tensor-core instructions: {counts}")
    check(all(counts.get(n) and not any(counts[n]) for n in without),
          f"{source}: tensor-core instructions where none belong: {counts}")
    return counts


# ------------------------------------------------------------- analysis
GATE = "REPRO_STATIC_AUDIT"  # the dispatch gate's switch (analysis.audit.gate)
AUDIT_REPORT = ROOT / "build" / "chip_smoke_audit.json"


def start_audit():
    """``python -m repro_torch.launch.analyze --report`` in a process of its
    own on the CPU, beside the build; killed at exit if still running."""
    import atexit

    AUDIT_REPORT.parent.mkdir(parents=True, exist_ok=True)
    AUDIT_REPORT.unlink(missing_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.analyze", "--report", str(AUDIT_REPORT)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": "",
             "OMP_NUM_THREADS": "2"})
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def warm_certificates() -> int:
    """Ask the certifier, while nvcc runs, for every verdict the armed
    phases' gate will ask for (the gate caches each; a first ask traces on
    the host): each GEMM kernel at the kernel phases' and edges' widths,
    the elementwise pair at theirs, the engine routes at n = 8 (every
    split the tiers may resolve), the approximate attention at the splits
    the phases use, the exact attention at every built head width.
    Returns the verdicts asked for; every one must be certified."""
    import torch

    from repro_torch.analysis import audit
    from repro_torch.kernels import flash_attention as fa

    kind = {"lut_matmul": "lut_gemm", "seqmul_matmul": "seqmul_gemm",
            "packed_matmul": "packed_gemm", "lowrank_matmul": "lowrank_gemm"}
    gemms = {(kind[c[0]], c[4], c[5] if c[0] == "seqmul_matmul" else max(1, c[4] // 2))
             for c in kernel_cases()}
    gemms |= {(kind[e[0]], e[5], max(1, e[5] // 2)) for e in GEMM_EDGES}
    asked = [audit.certified_kernel(*g) for g in sorted(gemms)]
    for name, n, t, *_ in elementwise_cases():
        asked.append(audit.certified_elementwise(n, t) if name == "seqmul_packed"
                     else audit.certified_kernel("packed_words", n, t))
    asked += [audit.certified(mode, 8, t) for mode in ("bitexact", "inject", "lowrank", "seqmul")
              for t in range(1, 8)]
    # the tensor-parallel phase's integer epilogues
    asked += [audit.certified_kernel(f"{kind[name]}_int", n, max(1, n // 2))
              for name, n in TP_EPILOGUES]
    asked += [audit.certified_attention(mode, 8, t, 128, 8) for mode in ("bitexact", "lowrank")
              for t in (1, 2, 4)]
    asked += [audit.certified_flash(hd, dt) for hd in fa.HEAD_DIMS
              for dt in (torch.bfloat16, torch.float32)]
    check(all(asked), "analysis: a configuration the armed phases run is not certified")
    return len(asked)


def phase_analysis(card: Card, audit_run) -> dict:
    """The static certifier on the card's machine: (1) the audit matrix,
    every deployed entry certified and every frontier entry as expected,
    each refusal printed with its finding; (2) every built instantiation's
    block: static + dynamic shared memory <= 232,448 bytes, registers x
    threads <= 65,536, with registers, shared memory and blocks an SM
    printed; (3) the shared-memory model against the plans the built
    libraries report, for all six wrappers: each GEMM tile (and seqmul at
    n = 12), each attention kernel at every built head width and dtype;
    (4) one exact qwen3-0.6b decode step's FLOPs and bytes
    (``launch/hlo_analysis.py``, meta tensors), printed after the serve
    phase beside the measured step."""
    import torch

    from repro_torch.analysis import smem
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import approx_attention as aa
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lowrank_matmul as lr
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import seqmul_matmul as sm
    from repro_torch.launch import hlo_analysis
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_decode_step

    # (1) the matrix, run beside the build
    out, _ = audit_run.communicate(timeout=900)
    check(audit_run.returncode == 0 and AUDIT_REPORT.exists(),
          f"analysis: the analyze CLI exited {audit_run.returncode}:\n{out[-4000:]}")
    rep = json.loads(AUDIT_REPORT.read_text())
    entries = rep["entries"]
    deployed = [e for e in entries if e["deployed"]]
    check(rep["all_deployed_certified"] and rep["frontier_holds"],
          f"analysis: uncertified entries {[e['name'] for e in entries if not e['as_expected']]}")
    for e in entries:
        if not e["certified"]:
            why = "; ".join(f"{f['kind']}: {f['message']}" for f in e["findings"] if f["gating"])
            print(f"analysis: refused {e['name']} (frontier entry, as expected): {why}",
                  flush=True)
    print(f"analysis: audit matrix {len(entries)} entries, {len(deployed)} deployed and all "
          f"certified, {len(entries) - len(deployed)} frontier entries as expected", flush=True)

    # (2) every built instantiation against Hopper's limits
    footprints = smem.built_report(smem.built_logs())
    for fp in footprints:
        print(f"analysis: {fp.config}: {fp.registers} registers x {fp.threads} threads = "
              f"{(fp.registers or 0) * fp.threads} of {smem.REGS_PER_SM}; shared memory "
              f"{fp.static_smem} static + {fp.smem} dynamic (its most) = {fp.smem_total} of "
              f"{smem.SMEM_PER_BLOCK}; spills {fp.spill_bytes} bytes; {fp.blocks_per_sm} "
              f"blocks an SM", flush=True)
    over = [fp.config for fp in footprints if not fp.within or fp.registers is None]
    check(not over, f"analysis: instantiations over Hopper's limits (or unread): {over}")
    print(f"analysis: {len(footprints)} built instantiations within {smem.SMEM_PER_BLOCK} "
          f"bytes of shared memory and {smem.REGS_PER_SM} registers a block", flush=True)

    # (3) the model's blocks as the built libraries launch them
    sms, k, n_cols = card.sms, 1024, 3072
    for mode, mod in (("bitexact", lm), ("seqmul", sm), ("inject", pm), ("lowrank", lr)):
        for bits in ((8, 12) if mode == "seqmul" else (8,)):
            for bm, bn in mod.TILES:
                fp = smem.validate_tiles(mode, bits, 4, (bm, bn))
                if mode == "bitexact":
                    built = lm.built_launch_plan(lm.launch_plan(bm, k, n_cols, bits, sms), bm, k,
                                                 n_cols, bits, sms)
                elif mode == "seqmul":
                    built = sm.built_launch_plan(sm.launch_plan(bm, k, n_cols, bits, sms), bm, k,
                                                 n_cols, bits, 4)
                elif mode == "inject":
                    built = pm.built_launch_plan(pm.launch_plan(bm, k // 2, n_cols, sms), bm,
                                                 k // 2, n_cols)
                else:
                    built = lr.built_launch_plan(lr.launch_plan(bm, k, n_cols, bits, sms), bm, k,
                                                 n_cols, bits, 8)
                check(built[1:] == (fp.threads, fp.smem),
                      f"analysis: {mode} tile ({bm}, {bn}) n={bits}: model {fp} but the library "
                      f"launches {built}")
                print(f"analysis: {mod.KERNEL.name} tile ({bm}, {bn}) n={bits}: {fp.smem} bytes "
                      f"of shared memory, {fp.threads} threads, as built", flush=True)
    held = 0
    for hd in fa.HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for kernel in ("fwd", "decode", "dq", "dkv"):
                args = (kernel, 4, 1 if kernel == "decode" else 1024, 4096, 16, 8, hd, dtype)
                plan = fa.launch_plan(*args, sms=sms)
                check(plan == fa.built_launch_plan(*args, sms=sms) and
                      plan.smem <= smem.SMEM_PER_BLOCK, f"analysis: {args}: plan {plan}")
                held += 1
        for mode in aa.ATTN_MODES:
            args = (mode, 4, 1024, 1024, 16, 8, hd, 8, 8, sms)
            plan = aa.launch_plan(*args)
            check(plan == aa.built_launch_plan(*args) and plan.smem <= smem.SMEM_PER_BLOCK,
                  f"analysis: {args}: plan {plan}")
            held += 1
    print(f"analysis: {held} attention plans (head widths {fa.HEAD_DIMS}, bf16 and float32) "
          f"equal to the built libraries' and within {smem.SMEM_PER_BLOCK} bytes", flush=True)

    # (4) one exact decode step of the serve pool, counted on meta tensors
    model = build_model(get_config("qwen3-0.6b"))
    params = model.init_params(0, device="meta")
    b = SERVE["batch"]
    caches = model.init_caches(b, CACHE, torch.bfloat16, "meta")
    tok = torch.zeros((b, 1), dtype=torch.int64, device="meta")
    at = torch.full((b,), SERVE["prompt"], dtype=torch.int64, device="meta")
    decode = make_decode_step(model)
    with torch.no_grad():
        counts = hlo_analysis.analyze(lambda: decode(params, caches, tok, at, at), [])
    return dict(flops=counts.flops, bytes=counts.bytes, ops=len(counts.ops),
                top=[(r.name, r.bytes, r.module.split("/")[-1]) for r in counts.top_bytes(3)])


def report_gate(where: str, launches: dict) -> None:
    """Every kernel launched under the armed gate was checked by it, once
    per wrapper call (an empty elementwise call is checked and launches
    nothing)."""
    from repro_torch.analysis import audit

    checked = dict(audit.GATE_CHECKS)
    missed = {k: n for k, n in launches.items() if n and checked.get(k, 0) < 1}
    check(not missed, f"{where}: launched past the armed gate, unchecked: {missed}")
    short = {k: (checked.get(k, 0), n) for k, n in launches.items() if checked.get(k, 0) < n}
    check(not short, f"{where}: fewer gate checks than launches (checks, launches): {short}")
    print(f"gate {where}: {GATE}=1, checks {sum(checked.values())} "
          f"({', '.join(f'{k} {v}' for k, v in sorted(checked.items()))}); launches "
          f"{sum(launches.values())}", flush=True)


def gate_refuses() -> None:
    """The armed gate is live: an uncertified call (seqmul past its dispatch
    contract, n = 13) raises ``CertificationError`` before any launch."""
    import torch

    from repro_torch import engine, kernels
    from repro_torch.analysis import audit

    before = kernels.launch_counts()
    x = torch.ones((4, 64), device="cuda")
    w = torch.ones((64, 32), device="cuda")
    try:
        engine.matmul(x, w, mode="seqmul", n=13, t=6)
    except audit.CertificationError as e:
        refused = str(e)
    else:
        raise SmokeFailure("gate: seqmul at n = 13 launched under the armed gate")
    check(kernels.launch_counts() == before, "gate: a launch happened before the refusal")
    print(f"gate: refused before launching: {refused[:160]}", flush=True)


def report_decode_counts(counts: dict, exact_run: dict, card_line: str) -> None:
    """One exact qwen3-0.6b decode step's FLOPs and bytes (eager model), the
    bound they imply and the step measured in the serve phase: a record,
    not a claim."""
    bound_ms = 1e3 * max(counts["bytes"] / HBM_BYTES_PER_S,
                         counts["flops"] / BF16_TENSOR_FLOPS_PER_S)
    by = "bytes" if counts["bytes"] / HBM_BYTES_PER_S >= \
        counts["flops"] / BF16_TENSOR_FLOPS_PER_S else "FLOPs"
    print(f"analysis: qwen3-0.6b exact decode step (B={SERVE['batch']}, cache {CACHE}): "
          f"{counts['flops']:.6g} FLOPs, {counts['bytes']:.6g} bytes over {counts['ops']} ops "
          f"(launch/hlo_analysis.py, eager byte model); bound {bound_ms:.4f} ms by {by} "
          f"(bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, FLOPs at "
          f"{BF16_TENSOR_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16); measured step "
          f"{exact_run['decode_ms']:.2f} ms (host clock), busy share "
          f"{exact_run['busy_share']}; top bytes {counts['top']}; {card_line}", flush=True)


# --------------------------------------------------------------- timing
def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's time per call (Python, the launch) drops out."""
    import torch

    fn()  # warm: builds, caches, the split-K counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps=5) / reps


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------- kernels
class Card:
    """The rates the bounds use, read from this run's card."""

    def __init__(self):
        import torch

        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        self.clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
        self.int32_ops_per_s = INT32_OPS_PER_CLK_PER_SM * self.sms * self.clock_hz
        self.lookups_per_s = SMEM_LOOKUPS_PER_CLK_PER_SM * self.sms * self.clock_hz
        self.f32_flops_per_s = 2 * F32_LANES_PER_CLK_PER_SM * self.sms * self.clock_hz

    def bound(self, nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
        return self.bound_s(nbytes, ops / ops_per_s)

    def bound_s(self, nbytes: float, ops_s: float) -> tuple[float, str]:
        """The larger of the bytes' time and ``ops_s``, the operations' time."""
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_bytes, ops_s) * 1e3, "bytes" if t_bytes >= ops_s else "operations")


def one_word_ops_per_product(n: int) -> int:
    """The least int32 operations one product of the elementwise kernels'
    one-word recurrence needs (``csrc/seqmul_kernel.cu``), one Hopper
    instruction each: 8 per cycle and 7 per product."""
    return 8 * n + 7


def seqmul_ops(m: int, k: int, n_cols: int, n: int) -> int:
    """The int32 issue slots the bit-sliced recurrence needs for an (m, k)
    x (k, n_cols) call, the count set out in the note of
    ``csrc/seqmul_matmul.cu``: 3n^2 + 19n + 4 per output and K word of 32
    lanes (POPC, at a quarter of the rate of LOP3 and IADD3 on sm_90,
    counted as 4), and 2 (n + 2) per operand element to build its planes.
    Every product runs all n cycles, whatever its operands."""
    words = -(-k // 32)
    return m * n_cols * words * (3 * n * n + 19 * n + 4) + (m * k + k * n_cols) * 2 * (n + 2)


def operands(m, k, n, bits, seed):
    """Quantized operands of one main-path GEMM, as the mode bodies make them."""
    import torch

    from repro_torch.engine.modes import quantize_operands

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") * k**-0.5
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, bits)
    return x, w, mx, sx, mw, sw, scale


def kernel_cases():
    """(kernel, M, K, N, n, t, timed) at the main-path shapes plus the
    sweep, and the GEMMs of the serve tiers at every projection of
    gemma2-9b and yi-9b (timed at gemma2's MLP), of qwen2-vl-7b, at
    granite-moe-1b-a400m's k/v projection and expert GEMMs, and at the
    projections of mamba2-130m, recurrentgemma-2b and seamless-m4t-large-v2
    (untimed)."""
    from repro_torch.configs.granite_moe_1b import CONFIG as granite
    from repro_torch.models.moe import capacity

    ms = (SERVE["batch"], SERVE["prompt"], SERVE["batch"] * SERVE["prompt"])
    cases = []
    for name in ("lut_matmul", "seqmul_matmul", "packed_matmul"):
        for m in ms:
            for k, n in PROJECTIONS:
                cases.append((name, m, k, n, 8, 4))
    for n_bits, t in ((8, 1), (8, 2), (8, 6), (4, 2), (6, 3)):
        cases.append(("lut_matmul", SERVE["batch"], 1024, 3072, n_bits, t))
        cases.append(("seqmul_matmul", SERVE["batch"], 1024, 3072, n_bits, t))
    for k, n in ((1024, 3072), (3072, 1024)):  # the MLP projections at the train shape
        cases.append(("lut_matmul", TRAIN["batch"] * TRAIN["seq"], k, n, 8, 4))
    for m in (SERVE["batch"], SERVE["batch"] * SERVE["prompt"]):
        cases.append(("seqmul_matmul", m, 1024, 3072, 12, 6))
        cases.append(("seqmul_matmul", m, 3072, 1024, 12, 5))
    cases.append(("packed_matmul", SERVE["batch"], 3072, 1024, 15, 1))
    cases.append(("packed_matmul", SERVE["batch"] * SERVE["prompt"], 1024, 3072, 12, 1))
    for m in ms:
        for k, n in PROJECTIONS:
            cases.append(("lowrank_matmul", m, k, n, 8, 4))
    # the main path's (n, t), and seqmul's int64 sums at n = 12
    cases = [(*c, c[4:] == (8, 4) or (c[0] == "seqmul_matmul" and c[4] == 12))
             for c in cases]
    # gemma2-9b's and yi-9b's projections at the decode batch and the pool prefill
    for name in ("lut_matmul", "packed_matmul", "lowrank_matmul"):
        for m in (SERVE["batch"], SERVE["batch"] * SERVE["prompt"]):
            for k, n in GEMMA2_MLP:
                cases.append((name, m, k, n, 8, 4, True))
            for k, n in GEMMA2_ATTN_PROJECTIONS + YI_PROJECTIONS:
                cases.append((name, m, k, n, 8, 4, False))
    # qwen2-vl-7b balanced and granite's k/v projection at the same M
    for m in (SERVE["batch"], SERVE["batch"] * SERVE["prompt"]):
        for k, n in QWEN2VL_PROJECTIONS + GRANITE_EXPERT_GEMMS[:1]:
            cases.append(("lut_matmul", m, k, n, 8, 4, False))
    # an expert's rows: its capacity at a decode step, a request's admission
    # prefill and the pool prefill (1, 10, 40); balanced and draft
    for tokens in (SERVE["batch"], SERVE["prompt"], SERVE["batch"] * SERVE["prompt"]):
        m = capacity(tokens, granite.num_experts_per_tok, granite.num_experts,
                     granite.capacity_factor)
        for name in ("lut_matmul", "packed_matmul"):
            for k, n in GRANITE_EXPERT_GEMMS:
                cases.append((name, m, k, n, 8, 4, False))
    # mamba2-130m's projections at balanced, draft and seqmul, recurrentgemma-2b's
    # at balanced, at the decode batch and the pool prefill
    for m in (SERVE["batch"], SERVE["batch"] * SERVE["prompt"]):
        for name in ("lut_matmul", "packed_matmul", "seqmul_matmul"):
            for k, n in MAMBA2_PROJECTIONS:
                cases.append((name, m, k, n, 8, 4, False))
        for k, n in RECURRENTGEMMA_PROJECTIONS:
            cases.append(("lut_matmul", m, k, n, 8, 4, False))
    # seamless-m4t-large-v2's projections at the decode batch and the prefill
    # (untimed): balanced, draft and seqmul
    for m in (SERVE["batch"], SERVE["batch"] * SERVE["prompt"]):
        for name in ("lut_matmul", "packed_matmul", "seqmul_matmul"):
            for k, n in SEAMLESS_PROJECTIONS:
                cases.append((name, m, k, n, 8, 4, False))
    return cases


def run_kernel_case(card: Card, name, m, k, n, bits, t, seed, timed: bool):
    import torch

    from repro_torch.engine import artifacts
    from repro_torch.kernels import lowrank_matmul as lr
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import seqmul_matmul as sm

    _, _, mx, sx, mw, sw, scale = operands(m, k, n, bits, seed)
    library = None
    extra = {}
    if name == "lowrank_matmul":
        u, v, _ = artifacts.svd_factors(bits, t, 8, True, mx.device)
        a, b = mx.to(torch.uint8), mw.to(torch.uint8)
        kern = lambda: lr.lowrank_matmul(u, v, a, sx, b, sw, n=bits)
        plain = lambda: lr.lowrank_matmul_plain(u, v, a, sx, b, sw, n=bits)
        rank = u.shape[1]
        nbytes = 2 * u.numel() * 4 + 2 * m * k + 2 * k * n + 4 * m * n
        # the least time of the kernel's design: the integer part on the int8
        # tensor cores (9-bit signed operands: 4 int8 products of 2 ops each),
        # the correction as 3 TF32 products on the tensor cores (split TF32)
        ops_s = (8 * m * k * n / INT8_TENSOR_OPS_PER_S
                 + 3 * 2 * m * k * n * rank / TF32_TENSOR_FLOPS_PER_S)
        bound = card.bound_s(nbytes, ops_s)
        # one torch.matmul of [A | Ue'] @ [B ; Ve'], concatenated outside the timing
        sxf, swf = sx.to(torch.float32), sw.to(torch.float32)
        lhs = torch.cat([mx.to(torch.float32) * sxf,
                         (u[mx.long()] * sxf[..., None]).reshape(m, k * rank)], dim=1)
        rhs = torch.cat([mw.to(torch.float32) * swf,
                         (v[mw.long()] * swf[..., None]).permute(0, 2, 1).reshape(k * rank, n)])
        library = lambda: torch.matmul(lhs, rhs)
        plan = lr.launch_plan(m, k, n, bits, card.sms)
        built = lr.built_launch_plan(plan, m, k, n, bits, rank)
        expect = (((n + plan.bn - 1) // plan.bn, (m + plan.bm - 1) // plan.bm, plan.splits),
                  lr.THREADS, lr.smem_bytes(bits, plan.bm, rank))
    elif name == "lut_matmul":
        lut = artifacts.product_lut_u16(bits, t, True, mx.device)
        a, b = mx.to(torch.uint8), mw.to(torch.uint8)
        kern = lambda: lm.lut_matmul(lut, a, sx, b, sw, n=bits)
        plain = lambda: lm.lut_matmul_plain(lut, a, sx, b, sw, n=bits)
        plan = lm.launch_plan(m, k, n, bits, card.sms)
        built = lm.built_launch_plan(plan, m, k, n, bits, card.sms)
        expect = (plan.grid, plan.threads, plan.smem)
        # the bytes the function must move: operands, output and table once
        nbytes = lut.numel() * 2 + 2 * m * k + 2 * k * n + 4 * m * n
        bound = card.bound(nbytes, m * k * n, card.lookups_per_s)
        # the design's copies of the table, one per block of the persistent
        # grid, read from L2 into shared memory: reported, not in the bound
        extra = dict(table_copy_bytes=lut.numel() * 2 * plan.grid[0])
    elif name == "seqmul_matmul":
        a, b = mx.to(torch.int16), mw.to(torch.int16)
        kern = lambda: sm.seqmul_matmul(a, sx, b, sw, n=bits, t=t)
        plain = lambda: sm.seqmul_matmul_plain(a, sx, b, sw, n=bits, t=t)
        plan = sm.launch_plan(m, k, n, bits, card.sms)
        built = sm.built_launch_plan(plan, m, k, n, bits, t)
        expect = (plan.grid, plan.threads, plan.smem)
        nbytes = 3 * m * k + 3 * k * n + 4 * m * n
        bound = card.bound(nbytes, seqmul_ops(m, k, n, bits), card.int32_ops_per_s)
    else:
        pa = pm.pack_i16_pairs(mx * sx.to(torch.int32), dim=1)
        pb = pm.pack_i16_pairs(mw * sw.to(torch.int32), dim=0)
        kern = lambda: pm.packed_matmul(pa, pb, n=bits)
        plain = lambda: pm.packed_matmul_plain(pa, pb)
        kw = pa.shape[1]
        plan = pm.launch_plan(m, kw, n, card.sms)
        built = pm.built_launch_plan(plan, m, kw, n)
        expect = (((n + plan.bn - 1) // plan.bn, (m + plan.bm - 1) // plan.bm, plan.splits),
                  pm.THREADS, pm.smem_bytes(plan.bm))
        nbytes = 4 * (pa.numel() + pb.numel() + m * n)
        # the least time: int16 lanes split into int8 halves on the tensor
        # cores, 4 int8 products of 2 ops (multiply, add) per lane product
        bound = card.bound(nbytes, 8 * m * k * n, INT8_TENSOR_OPS_PER_S)
    got = kern()
    again = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    where = f"{name} M={m} K={k} N={n} n={bits} t={t}"
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          f"{where}: two launches on the same inputs differ")
    if name == "lowrank_matmul":
        # the float32 correction is summed in another order
        limit = 2e-6 * want.abs().max().item()
        check(err <= limit, f"{where}: kernel vs plain max |err| {err} over {limit}")
    else:
        check(torch.equal(got, want), f"{where}: kernel != plain (max |err| {err})")
    row = dict(name=name, shape=[m, k, n], n=bits, t=t, max_abs_err=err,
               bound_ms=bound[0], bound_by=bound[1], **extra)
    # the Python plan the wrapper launches with against the built library's
    # (grid, threads, shared memory), for all four GEMMs
    check(expect == built, f"{where}: launch_plan {plan} ({expect}) but the library "
          f"launches {built}")
    row["plan"] = dict(grid=list(expect[0]), threads=expect[1], smem=expect[2],
                       splits=plan.splits, k_chunk=getattr(plan, "k_chunk", None) or
                       2 * plan.kw_chunk)
    if timed:
        # the dequantized operands (the joint scale folded into the left one)
        xq, wq = (mx * sx).to(torch.float32) * scale, (mw * sw).to(torch.float32)
        row["ms"] = cuda_ms(kern, reps=20, warmup=2)
        row["plain_ms"] = cuda_ms(plain, reps=2)
        if name in ("lut_matmul", "seqmul_matmul"):
            # no PyTorch call computes the approximate products; the exact
            # GEMM on the same operands is kept as a yardstick, not a library time
            row["library_ms"] = None
            row["exact_matmul_ms"] = cuda_ms(lambda: torch.matmul(xq, wq), reps=20, warmup=2)
        else:
            if library is None:
                library = lambda: torch.matmul(xq, wq)
            row["library_ms"] = cuda_ms(library, reps=20, warmup=2)
        # the device's time alone, kernel and library call alike
        row["device_ms"] = graph_ms(kern)
        if library is not None:
            row["library_device_ms"] = graph_ms(library)
        if name == "lut_matmul":
            # the same call with every magnitude below 64, where no two lanes
            # of a warp's gather share a bank (csrc/lut_matmul.cu): the rest of
            # device_ms over this is what the bank conflicts cost
            a64, b64 = a & 63, b & 63
            row["device_ms_mag_below_64"] = graph_ms(
                lambda: lm.lut_matmul(lut, a64, sx, b64, sw, n=bits))
    return row


def phase_kernels(card: Card) -> list:
    rows = []
    for i, (name, m, k, n, bits, t, timed) in enumerate(kernel_cases()):
        row = run_kernel_case(card, name, m, k, n, bits, t, seed=100 + i, timed=timed)
        rows.append(row)
        times = (
            f" ms {row['ms']:.4f} plain_ms {row['plain_ms']:.3f} library_ms "
            + (f"{row['library_ms']:.4f}" if row["library_ms"] is not None else
               f"none (exact matmul {row['exact_matmul_ms']:.4f})") if "ms" in row else ""
        )
        if row.get("library_ms"):
            times += f" ratio {row['ms'] / row['library_ms']:.3f}"
        if "library_device_ms" in row:
            times += (f" device_ms {row['device_ms']:.4f} library_device_ms "
                      f"{row['library_device_ms']:.4f} device ratio "
                      f"{row['device_ms'] / row['library_device_ms']:.3f}")
        elif "device_ms" in row:
            times += f" device_ms {row['device_ms']:.4f}"
        if "device_ms_mag_below_64" in row:
            times += f" (magnitudes below 64: {row['device_ms_mag_below_64']:.4f})"
        if "plan" in row:
            times += f" plan {row['plan']} as built"
        if "table_copy_bytes" in row:
            times += f" table copies (L2 to shared memory) {row['table_copy_bytes']} bytes"
        agree = "bit-equal" if row["max_abs_err"] == 0 else f"max |err| {row['max_abs_err']:.3e}"
        print(f"kernel {name} M={m} K={k} N={n} n={bits} t={t}: {agree}{times} "
              f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']})", flush=True)
    return rows + phase_gemm_edges()


# (kernel, kind, M, K, N, n): the tensor-core GEMMs at their edges
GEMM_EDGES = [
    ("packed_matmul", "extreme mixed", 4, 3072, 1024, 8),
    ("packed_matmul", "extreme alike", 4, 3072, 1024, 8),
    ("packed_matmul", "extreme mixed", 128, 3072, 1024, 15),
    ("packed_matmul", "extreme alike", 4, 3072, 1024, 15),
    ("packed_matmul", "random", 4, 301, 64, 12),  # odd K: a zero pad lane
    ("packed_matmul", "random", 1, 1024, 3072, 8),
    ("packed_matmul", "random", 33, 300, 70, 15),
    ("lowrank_matmul", "mag 255", 4, 1024, 3072, 8),
    ("lowrank_matmul", "mag 255", 128, 1024, 3072, 8),
    ("lowrank_matmul", "zero tables", 4, 3072, 1024, 8),
    ("lowrank_matmul", "zero tables", 33, 300, 70, 8),
    ("lowrank_matmul", "random", 1, 1024, 3072, 8),
    ("lowrank_matmul", "random", 33, 300, 70, 8),
    ("lowrank_matmul", "rank 24", 33, 300, 70, 8),  # three blocks of 8 r per K step
    ("lut_matmul", "mag max", 4, 3072, 1024, 8),
    ("lut_matmul", "mag max", 1024, 1024, 3072, 8),
    ("lut_matmul", "random", 1, 1024, 3072, 8),
    ("lut_matmul", "random", 33, 301, 70, 8),  # ragged: byte loads, one split tile
    ("lut_matmul", "random", 2, 33000, 64, 8),  # int64 sums
    ("lut_matmul", "random", 33, 301, 70, 1),
    ("seqmul_matmul", "mag max", 4, 3072, 1024, 12),  # int64 sums
    ("seqmul_matmul", "mag max", 128, 1024, 3072, 8),
    ("seqmul_matmul", "random", 1, 1024, 3072, 8),
    ("seqmul_matmul", "random", 33, 301, 70, 8),
    ("seqmul_matmul", "random", 33, 301, 70, 1),
]


def phase_gemm_edges() -> list:
    """The split-K GEMMs at their edges, untimed: packed lanes at
    +-(2^n - 1) with mixed or like signs (every int8 plane pair at its
    extreme; int32 sums at n = 8, int64 at n = 15), an odd K, M = 1 and
    a ragged shape; lowrank with every magnitude 255 and mixed signs, and
    with zero SVD tables, where it must be bit-equal (the exact part
    alone); lut and seqmul with every magnitude 2^n - 1 and mixed signs,
    M = 1, a ragged shape, n = 1, and int64 sums (lut at K = 33000, seqmul
    at n = 12).  Each also launched twice: the same bits both times."""
    import numpy as np
    import torch

    from repro_torch.engine import artifacts
    from repro_torch.kernels import lowrank_matmul as lr
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import seqmul_matmul as sm

    rows = []
    for i, (name, kind, m, k, n_cols, bits) in enumerate(GEMM_EDGES):
        rng = np.random.default_rng(900 + i)
        qmax = (1 << bits) - 1
        if name == "packed_matmul":
            if kind == "extreme mixed":
                a, b = rng.choice([-qmax, qmax], (m, k)), rng.choice([-qmax, qmax], (k, n_cols))
            elif kind == "extreme alike":
                a, b = np.full((m, k), qmax), np.full((k, n_cols), -qmax)
            else:
                a, b = rng.integers(-qmax, qmax + 1, (m, k)), rng.integers(-qmax, qmax + 1, (k, n_cols))
            pa = pm.pack_i16_pairs(torch.from_numpy(a).cuda(), dim=1)
            pb = pm.pack_i16_pairs(torch.from_numpy(b).cuda(), dim=0)
            kern = lambda: pm.packed_matmul(pa, pb, n=bits)
            plain = lambda: pm.packed_matmul_plain(pa, pb)
        elif name in ("lut_matmul", "seqmul_matmul"):
            mag_a, mag_b = rng.integers(0, qmax + 1, (m, k)), rng.integers(0, qmax + 1, (k, n_cols))
            if kind == "mag max":
                mag_a, mag_b = np.full_like(mag_a, qmax), np.full_like(mag_b, qmax)
            dtype = torch.uint8 if name == "lut_matmul" else torch.int16
            args = (torch.from_numpy(mag_a).to("cuda", dtype),
                    torch.from_numpy(rng.choice([-1, 0, 1], (m, k), p=[0.45, 0.1, 0.45]))
                    .to("cuda", torch.int8),
                    torch.from_numpy(mag_b).to("cuda", dtype),
                    torch.from_numpy(rng.choice([-1, 0, 1], (k, n_cols), p=[0.45, 0.1, 0.45]))
                    .to("cuda", torch.int8))
            t = max(1, bits // 2)
            if name == "lut_matmul":
                args = (artifacts.product_lut_u16(bits, t, True, torch.device("cuda")), *args)
                kern = lambda: lm.lut_matmul(*args, n=bits)
                plain = lambda: lm.lut_matmul_plain(*args, n=bits)
            else:
                kern = lambda: sm.seqmul_matmul(*args, n=bits, t=t)
                plain = lambda: sm.seqmul_matmul_plain(*args, n=bits, t=t)
        else:
            mag_a, mag_b = rng.integers(0, qmax + 1, (m, k)), rng.integers(0, qmax + 1, (k, n_cols))
            if kind == "mag 255":
                mag_a, mag_b = np.full_like(mag_a, qmax), np.full_like(mag_b, qmax)
            sign_a = rng.choice([-1, 0, 1], (m, k), p=[0.45, 0.1, 0.45])
            sign_b = rng.choice([-1, 1], (k, n_cols))
            rank = 24 if kind == "rank 24" else 8
            u, v, _ = artifacts.svd_factors(bits, 4, rank, True, torch.device("cuda"))
            if kind == "zero tables":
                u, v = torch.zeros_like(u), torch.zeros_like(v)
            args = (u, v, torch.from_numpy(mag_a).to("cuda", torch.uint8),
                    torch.from_numpy(sign_a).to("cuda", torch.int8),
                    torch.from_numpy(mag_b).to("cuda", torch.uint8),
                    torch.from_numpy(sign_b).to("cuda", torch.int8))
            kern = lambda: lr.lowrank_matmul(*args, n=bits)
            plain = lambda: lr.lowrank_matmul_plain(*args, n=bits)
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        where = f"{name} {kind} M={m} K={k} N={n_cols} n={bits}"
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"{where}: two launches on the same inputs differ")
        err = (got - want).abs().max().item()
        if name == "lowrank_matmul" and kind != "zero tables":
            limit = 2e-6 * want.abs().max().item()
            check(err <= limit, f"{where}: kernel vs plain max |err| {err} over {limit}")
        else:
            check(torch.equal(got, want), f"{where}: kernel != plain (max |err| {err})")
        agree = "bit-equal" if err == 0 else f"max |err| {err:.3e} (max |want| {want.abs().max().item():.6g})"
        print(f"kernel {where}: {agree}, two launches bit-identical", flush=True)
        rows.append(dict(name=name, label=kind, shape=[m, k, n_cols], n=bits, t=None,
                         max_abs_err=err))
    return rows


# ----------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnCase:
    """One attention row: the kernel, a label, q (b, s) over t slots, the
    key block (approximate attention), window, softcap, whether it is
    timed, the heads (query, KV, width), the dtype of q, k, v, and whether
    the mask is causal (an encoder's self-attention is not)."""

    name: str
    label: str
    b: int
    s: int
    t: int
    bk: int = None
    window: int = None
    softcap: float = None
    timed: bool = False
    h: int = HEADS
    kv: int = KV_HEADS
    hd: int = HEAD_DIM
    dtype: str = "bfloat16"
    causal: bool = True


def attention_cases():
    """The serve shapes of qwen3-0.6b (prefill q (B, 32) over the 48-slot
    cache, decode over it), a window + softcap variant of each, one long
    shape each, and the forwards of train runs (a) and (b) at their shape,
    with lse: flash_attention and bitexact; then head width 256
    (``wide_attention_cases``)."""
    b, p = SERVE["batch"], SERVE["prompt"]
    cases = []
    for name in ATTN_KERNELS:
        s = 1 if name == "flash_decode" else p
        bk = {"flash_decode": None, "flash_attention": None}.get(name, 16)
        cases.append(AttnCase(name, "serve", b, s, CACHE, bk, timed=True))
        cases.append(AttnCase(name, "window+softcap", b, s, CACHE, bk, 16, 30.0))
    cases.append(AttnCase("flash_attention", "long", 1, 1024, 1024, timed=True))
    cases.append(AttnCase("flash_decode", "long", 4, 1, 4096, timed=True))
    cases.append(AttnCase("approx_attention_bitexact", "long", 1, 1024, 1024, 64, timed=True))
    cases.append(AttnCase("approx_attention_lowrank", "long", 1, 1024, 1024, 128, timed=True))
    cases.append(AttnCase("flash_attention", "train", TRAIN["batch"], TRAIN["seq"],
                          TRAIN["seq"], timed=True))
    # the speculative verify forward under attn_impl="pallas": q (B, k+1) over the
    # whole pool cache, per-row starts, stale suffix slots, a dead lane parked
    cases.append(AttnCase("flash_attention", "verify", b, SPEC_K + 1, VERIFY_CACHE))
    cases.append(AttnCase("approx_attention_bitexact", "train", TRAIN["batch"], TRAIN["seq"],
                          TRAIN["seq"], 64, timed=True))
    return (cases + wide_attention_cases() + vl_moe_attention_cases()
            + recurrent_attention_cases() + seamless_attention_cases())


def seamless_attention_cases():
    """seamless-m4t-large-v2's 16 query heads over 16 KV heads of 64 (g = 1):
    the encoder's non-causal forward at the serve shape (S = T = 32, the
    memory of 32 frames), at the train shape with lse and at S = T = 1024;
    the decoder's causal prefill over the serve cache; the decode at the
    serve shape and over 4,096 slots; bitexact and lowrank non-causal at
    the serve shape (key block as the reference computes it) and at S = T =
    1024.  All timed."""
    from repro_torch.kernels.approx_attention import attn_tiles
    from repro_torch.models.attention import _block

    b, p = SERVE["batch"], SERVE["prompt"]
    tb, ts = TRAIN["batch"], TRAIN["seq"]
    heads = dict(SEAMLESS_HEADS, timed=True)
    enc = dict(heads, causal=False)
    bk = lambda mode, t: min(_block(t), attn_tiles(mode)[1])
    cases = [
        AttnCase("flash_attention", "seamless enc serve", b, p, p, **enc),
        AttnCase("flash_attention", "seamless enc train", tb, ts, ts, **enc),
        AttnCase("flash_attention", "seamless enc long", 1, 1024, 1024, **enc),
        AttnCase("flash_attention", "seamless dec serve", b, p, CACHE, **heads),
        AttnCase("flash_decode", "seamless serve", b, 1, CACHE, **heads),
        AttnCase("flash_decode", "seamless long", 4, 1, 4096, **heads),
    ]
    for mode in ("bitexact", "lowrank"):
        name = f"approx_attention_{mode}"
        cases.append(AttnCase(name, "seamless enc serve", b, p, p, bk(mode, p), **enc))
        cases.append(AttnCase(name, "seamless enc long", 1, 1024, 1024, bk(mode, 1024), **enc))
    return cases


def recurrent_attention_cases():
    """recurrentgemma-2b's 10 query heads over one KV head of 256 (g = 10: a
    forward item holds 10 heads x 6 rows, 60 of its 64 row-heads): the
    forward at the serve shape and at S = T = 4,096 under its window of
    2,048 (key tiles skipped), the decode at the serve shape and over 4,096
    slots under the window (dead chunks), bitexact at the serve shape.  All
    timed."""
    b, p, w = SERVE["batch"], SERVE["prompt"], RECURRENTGEMMA_WINDOW
    heads = RECURRENTGEMMA_HEADS
    return [
        AttnCase("flash_attention", "recurrentgemma serve", b, p, CACHE, timed=True, **heads),
        AttnCase("flash_attention", "recurrentgemma window 2048", 1, LONG_PROMPT, LONG_PROMPT,
                 window=w, timed=True, **heads),
        AttnCase("flash_decode", "recurrentgemma serve", b, 1, CACHE, timed=True, **heads),
        AttnCase("flash_decode", "recurrentgemma window 2048", b, 1, LONG_PROMPT, window=w,
                 timed=True, **heads),
        AttnCase("approx_attention_bitexact", "recurrentgemma serve", b, p, CACHE, 16,
                 timed=True, **heads),
    ]


def vl_moe_attention_cases():
    """qwen2-vl-7b's 28 query heads over 4 KV heads of 128 (g = 7: a forward
    item holds 7 heads x 9 rows, 63 of its 64 row-heads; bitexact's the
    same, lowrank's 7 x 4 of 32): the forward at the serve shape, at S = T
    = 1024 and at the train shape with lse, the decode at the serve shape
    and over 4,096 slots, bitexact and lowrank at the serve shape; then
    granite-moe-1b-a400m's 16 / 8 of 64: the forward at the serve and train
    shapes, the decode at the serve shape.  All timed."""
    b, p = SERVE["batch"], SERVE["prompt"]
    tb, ts = TRAIN["batch"], TRAIN["seq"]
    return [
        AttnCase("flash_attention", "qwen2-vl serve", b, p, CACHE, timed=True, **QWEN2VL_HEADS),
        AttnCase("flash_attention", "qwen2-vl long", 1, 1024, 1024, timed=True, **QWEN2VL_HEADS),
        AttnCase("flash_attention", "qwen2-vl train", tb, ts, ts, timed=True, **QWEN2VL_HEADS),
        AttnCase("flash_decode", "qwen2-vl serve", b, 1, CACHE, timed=True, **QWEN2VL_HEADS),
        AttnCase("flash_decode", "qwen2-vl long", 4, 1, 4096, timed=True, **QWEN2VL_HEADS),
        AttnCase("approx_attention_bitexact", "qwen2-vl serve", b, p, CACHE, 16, timed=True,
                 **QWEN2VL_HEADS),
        AttnCase("approx_attention_lowrank", "qwen2-vl serve", b, p, CACHE, 16, timed=True,
                 **QWEN2VL_HEADS),
        AttnCase("flash_attention", "granite serve", b, p, CACHE, timed=True, **GRANITE_HEADS),
        AttnCase("flash_attention", "granite train", tb, ts, ts, timed=True, **GRANITE_HEADS),
        AttnCase("flash_decode", "granite serve", b, 1, CACHE, timed=True, **GRANITE_HEADS),
    ]


def wide_attention_cases():
    """Head width 256 and the new head groups, all timed: gemma2-9b's 16
    query and 8 KV heads of 256 at the serve shape, with window 16 and
    softcap 50, at S = T = 1024 (the decode over 4,096 slots) and a decode
    over 8,192 slots under gemma2's own window of 4,096 (dead chunks);
    gemma-7b's 16 / 16 (one query head per KV head) forward and decode;
    yi-9b's 32 / 4 of 128 (eight per KV head) forward and decode; one
    float32 forward at 256; the forward of train (c) with lse, with and
    without gemma2's softcap; bitexact's at that shape."""
    b, p = SERVE["batch"], SERVE["prompt"]
    cases = []
    for name in ATTN_KERNELS:
        s = 1 if name == "flash_decode" else p
        bk = {"flash_decode": None, "flash_attention": None}.get(name, 16)
        cases.append(AttnCase(name, "gemma2 serve", b, s, CACHE, bk, timed=True,
                              **GEMMA2_HEADS))
        cases.append(AttnCase(name, "gemma2 window+softcap", b, s, CACHE, bk, 16,
                              GEMMA2_SOFTCAP, timed=True, **GEMMA2_HEADS))
    return cases + [
        AttnCase("flash_attention", "gemma2 long", 1, 1024, 1024, timed=True, **GEMMA2_HEADS),
        AttnCase("flash_decode", "gemma2 long", 4, 1, 4096, timed=True, **GEMMA2_HEADS),
        AttnCase("approx_attention_bitexact", "gemma2 long", 1, 1024, 1024, 64, timed=True,
                 **GEMMA2_HEADS),
        AttnCase("approx_attention_lowrank", "gemma2 long", 1, 1024, 1024, 128, timed=True,
                 **GEMMA2_HEADS),
        AttnCase("flash_decode", "gemma2 window 4096", 4, 1, 2 * GEMMA2_WINDOW, None,
                 GEMMA2_WINDOW, GEMMA2_SOFTCAP, timed=True, **GEMMA2_HEADS),
        AttnCase("flash_attention", "gemma-7b serve", b, p, CACHE, timed=True, **GEMMA7_HEADS),
        AttnCase("flash_decode", "gemma-7b serve", b, 1, CACHE, timed=True, **GEMMA7_HEADS),
        AttnCase("flash_attention", "yi-9b serve", b, p, CACHE, timed=True, **YI_HEADS),
        AttnCase("flash_decode", "yi-9b serve", b, 1, CACHE, timed=True, **YI_HEADS),
        AttnCase("flash_attention", "gemma2 f32 serve", b, p, CACHE, timed=True,
                 dtype="float32", **GEMMA2_HEADS),
        # the forward of train (c), with lse: gemma2's heads at the train
        # shape, plain and under gemma2's softcap (its window of 4,096 does
        # not bind at seq 128)
        AttnCase("flash_attention", "gemma2 train", TRAIN["batch"], TRAIN["seq"], TRAIN["seq"],
                 timed=True, **GEMMA2_HEADS),
        AttnCase("flash_attention", "gemma2 softcap train", TRAIN["batch"], TRAIN["seq"],
                 TRAIN["seq"], None, None, GEMMA2_SOFTCAP, timed=True, **GEMMA2_HEADS),
        # the approximate route's forward of a gemma2 train step, with lse (the
        # backward pair then runs on its (o, lse): backward_cases)
        AttnCase("approx_attention_bitexact", "gemma2 train", TRAIN["batch"], TRAIN["seq"],
                 TRAIN["seq"], 64, timed=True, **GEMMA2_HEADS),
    ]


def attention_inputs(case: AttnCase, seed):
    """q/k/v of the case's heads and dtype, and positions.  Prefill over a
    cache (t > s): row 1 is left-padded by 5, every row's slots past its
    prompt are an unwritten (masked) tail.  Decode: row i has written t -
    16 + 4i slots (32-44 of the 48 at the serve shape, a nearly full cache
    at the long ones).  Long prefill: no cache, positions 0..t-1.  Verify:
    ``verify_positions``."""
    import torch

    b, s, t = case.b, case.s, case.t
    dtype = getattr(torch, case.dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, case.h, case.hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, t, case.kv, case.hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, t, case.kv, case.hd), generator=g, device="cuda").to(dtype)
    q_pos, k_pos = verify_positions(b, s, t) if case.label == "verify" else positions(b, s, t)
    return q, k, v, q_pos.to(torch.int32), k_pos.to(torch.int32)


def verify_positions(b, s, t):
    """A speculative verify window as ``models.attention`` masks it: row i,
    left-padded by ``pad[i]`` in the prompt bucket with ``emitted[i]``
    tokens out, writes slots ``w0 .. w0 + s - 1`` (``w0 = prompt + emitted -
    1``) at true positions from ``w0 - pad``; the slots past the window hold
    stale draft entries, masked.  The last row is a dead lane, parked at
    ``t - s`` with positions 0..s-1."""
    import torch

    p = SERVE["prompt"]
    pad = torch.tensor([0, 5, 2, 0][:b], device="cuda")
    emitted = torch.tensor([1, 6, 11, 0][:b], device="cuda")
    starts = p + emitted - 1
    starts[-1], pad[-1] = t - s, t - s  # the dead lane: offset = its start
    q_pos = (starts - pad)[:, None] + torch.arange(s, device="cuda")[None, :]
    jj = torch.arange(t, device="cuda").expand(b, t)
    last = (starts + s - 1)[:, None]
    k_pos = torch.where((jj >= pad[:, None]) & (jj <= last), jj - pad[:, None], -1)
    return q_pos, k_pos


def positions(b, s, t):
    import torch

    jj = torch.arange(t, device="cuda").expand(b, t)
    if s == t:
        return jj[:, :s].clone(), jj.clone()
    if s == 1:
        written = t - 16 + 4 * torch.arange(b, device="cuda")[:, None]
        return written[:, 0] - 1, torch.where(jj < written, jj, -1)
    pad = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
    pad[1] = 5
    q_pos = torch.arange(s, device="cuda").expand(b, s) - pad
    return q_pos, torch.where((jj >= pad) & (jj < s), jj - pad, -1)


def run_attention_case(card: Card, case, seed):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import approx_attention as aa
    from repro_torch.kernels import flash_attention as fa

    name, label, b, s, t = case.name, case.label, case.b, case.s, case.t
    bk, window, softcap, timed = case.bk, case.window, case.softcap, case.timed
    causal = case.causal
    q, k, v, q_pos, k_pos = attention_inputs(case, seed)
    hd, h, kv = case.hd, case.h, case.kv
    scale = hd**-0.5
    # The work this run's data needs: a query row reads the slots it may
    # attend (a masked slot adds exactly 0); a row with none, a left pad,
    # averages every slot.  pairs: (query head, slot) pairs; slots: the
    # (row, slot) pairs whose K and V some query reads.
    allow = fa.allow_mask(q_pos.reshape(b, s), k_pos, causal=causal, window=window)
    needed = allow | ~allow.any(-1, keepdim=True)
    pairs = h * needed.sum().item()
    slots = needed.any(1).sum().item()
    # per needed slot, K and V of every KV head: bf16 (float32 in the f32
    # row), or a magnitude and a sign byte each for the approximate kernels
    # (2 bytes per element)
    esize = 2 if name.startswith("approx") else q.element_size()
    kv_bytes = 2 * esize * kv * hd * slots
    # positions read once, the f32 output written once
    io_bytes = 4 * (q_pos.numel() + k_pos.numel()) + 4 * q.numel()
    # the train rows return lse too (written once), as the train step's forward does
    with_lse = label.split()[-1] == "train"
    lse_bytes = 4 * b * h * s if with_lse else 0
    library = None
    if name == "flash_decode":
        kw = dict(window=window, softcap=softcap, scale=scale)
        kern = lambda: fa.flash_decode(q[:, 0], k, v, q_pos, k_pos, **kw)
        plain = lambda: fa.flash_decode_plain(q[:, 0], k, v, q_pos, k_pos, **kw)
        # bytes-bound: float32 FMAs on the CUDA cores, QK and PV (4 hd FLOPs a pair)
        bound = card.bound(esize * q.numel() + kv_bytes + io_bytes, 4 * pairs * hd,
                           card.f32_flops_per_s)
    elif name == "flash_attention":
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        if with_lse:
            # the train step's forward: (o, lse) against the plain version's
            kern = lambda: fa.flash_attention_fwd(q, k, v, q_pos, k_pos, with_lse=True, **kw)
            plain = lambda: fa.attend(q, k, v, q_pos, k_pos, with_lse=True, **kw)
        else:
            kern = lambda: fa.flash_attention(q, k, v, q_pos, k_pos, **kw)
            plain = lambda: fa.flash_attention_plain(q, k, v, q_pos, k_pos, **kw)
        # the products the kernel runs on the bf16 tensor cores: QK^T on bf16 q
        # and k (2 hd FLOPs a pair) and P.V with p as two bf16 terms (4 hd);
        # float32 q, k, v and p as three bf16 terms each, six products a
        # term product (12 hd each)
        flops = 6 * hd if esize == 2 else 24 * hd
        bound = card.bound(esize * q.numel() + kv_bytes + io_bytes + lse_bytes, flops * pairs,
                           BF16_TENSOR_FLOPS_PER_S)
    else:
        mode, rank = name.rsplit("_", 1)[1], 8
        kw = dict(mode=mode, n=8, t=4, rank=rank, causal=causal, window=window, softcap=softcap,
                  scale=scale, bk=bk)
        wrapper = lambda: aa.approx_flash_attention(q, k, v, q_pos, k_pos, **kw)
        plain = lambda: aa.approx_attention_plain(q, k, v, q_pos, k_pos, with_lse=with_lse,
                                                  **kw)
        # the kernel alone, on operands quantized once outside the timing
        ops = aa.kernel_operands(q, k, v, mode=mode, n=8, t=4, fix_to_1=True, rank=rank)
        kern = lambda: aa.launch_kernel(ops, q_pos, k_pos, bk=bk, causal=causal, window=window,
                                        softcap=softcap, scale=scale, with_lse=with_lse)
        plan = aa.launch_plan(mode, b, s, t, h, kv, hd, 8, rank, card.sms)
        built = aa.built_launch_plan(mode, b, s, t, h, kv, hd, 8, rank, card.sms)
        # magnitudes and signs of q and the needed k, v slots (a byte each)
        nbytes = 2 * q.numel() + kv_bytes + io_bytes + lse_bytes
        if mode == "bitexact":
            # and the uint16 table, once; two lookups per pair and d
            bound = card.bound(nbytes + 2 * 2**16, 2 * pairs * hd, card.lookups_per_s)
        else:
            # and U and V (2^n, r) float32, once.  Per pair, the exact
            # products of QK and AV (2 hd) on the int8 tensor cores (4
            # products of 2 ops each, as lowrank_matmul), their corrections
            # (2 hd r) as 3 TF32 products, and r lookups for U[p_int]
            ops_s = (16 * pairs * hd / INT8_TENSOR_OPS_PER_S
                     + 3 * 2 * 2 * pairs * hd * rank / TF32_TENSOR_FLOPS_PER_S
                     + pairs * rank / card.lookups_per_s)
            bound = card.bound_s(nbytes + 2 * 4 * 2**8 * rank, ops_s)
    if name in ("flash_attention", "flash_decode") and softcap is None:
        # the same q/k/v and boolean mask; SDPA takes heads before the sequence
        qt = (q[:, :1] if name == "flash_decode" else q).transpose(1, 2).contiguous()
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = allow[:, None]
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         scale=scale, enable_gqa=True)
    got = (wrapper if name.startswith("approx") else kern)()
    want = plain()
    torch.cuda.synchronize()
    where = (f"{name} {label} B={b} S={s} T={t} H={h} KV={kv} hd={hd} {case.dtype} bk={bk} "
             f"window={window} softcap={softcap} causal={causal}")
    row = dict(name=name, label=label, shape=[b, s, t, h, kv, hd], bk=bk,
               bound_ms=bound[0], bound_by=bound[1])
    if name.startswith("approx"):
        first, again = kern(), kern()
        if with_lse:
            (first, lse), (again, lse2), (want, want_lse) = first, again, want
            check(torch.equal(lse.view(torch.int32), lse2.view(torch.int32)),
                  f"{where}: lse differs between two launches")
            row["lse_max_abs_err"] = (lse - want_lse).abs().max().item()
        check(torch.equal(first.view(torch.int32), got.view(torch.int32)),
              f"{where}: the kernel alone != the wrapper")
        check(torch.equal(first.view(torch.int32), again.view(torch.int32)),
              f"{where}: two launches on the same inputs differ")
        check(plan == built, f"{where}: launch_plan {plan} but the kernel launches {built}")
        row["plan"] = dict(grid=list(plan.grid), threads=plan.threads, smem=plan.smem,
                           rows=plan.rows, heads=plan.heads)
        # the (work item, key block) pairs the kernel skips, counted on the card
        # in one more launch, against the masked-block rule's count on the CPU
        # (approx_tile_plan's pairs, once per KV head and head chunk)
        live = aa.approx_tile_plan(q_pos, k_pos, bk=bk, rows=plan.rows, causal=causal,
                                   window=window)
        per_tile = kv * -(-(h // kv) // plan.heads)
        planned, pairs_total = int((~live).sum()) * per_tile, live.numel() * per_tile
        counter = torch.zeros(1, dtype=torch.int32, device=q.device)
        counted = aa.launch_kernel(ops, q_pos, k_pos, bk=bk, causal=causal, window=window,
                                   softcap=softcap, scale=scale, with_lse=with_lse,
                                   skipped=counter)
        counted = counted[0] if with_lse else counted
        check(torch.equal(first.view(torch.int32), counted.view(torch.int32)),
              f"{where}: the launch that counts skipped pairs differs")
        row["skipped_pairs"] = int(counter.item())
        check(row["skipped_pairs"] == planned,
              f"{where}: the kernel skipped {row['skipped_pairs']} (item, block) pairs, "
              f"approx_tile_plan {planned}")
    else:
        again = kern()
        if with_lse:
            (got, lse), (again, lse2), (want, want_lse) = got, again, want
            check(torch.equal(lse.view(torch.int32), lse2.view(torch.int32)),
                  f"{where}: lse differs between two launches")
            lse_diff = (lse - want_lse).abs()
            row["lse_max_abs_err"] = lse_diff.max().item()
            row["lse_err_over_limit"] = (lse_diff / (2e-5 + 2e-5 * want_lse.abs())).max().item()
            check(row["lse_err_over_limit"] <= 1,
                  f"{where}: lse max |err| {row['lse_max_abs_err']} over rtol/atol 2e-5")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"{where}: two launches on the same inputs differ")
        decode = name == "flash_decode"
        plan_args = ("decode" if decode else "fwd", b, s, t, h, kv, hd, q.dtype)
        plan = fa.launch_plan(*plan_args, sms=card.sms)
        built = fa.built_launch_plan(*plan_args, sms=card.sms)
        check(plan == built, f"{where}: launch_plan {plan} but the kernel launches {built}")
        row["plan"] = dict(grid=list(plan.grid), threads=plan.threads, smem=plan.smem,
                           rows=plan.rows, heads=plan.heads, keys=plan.keys)
        # what the kernel skips, counted on the card in one more launch, against
        # the rule's count on the CPU: (item, key tile) pairs of fwd_tile_plan once
        # per KV head, or cache chunks of decode_chunk_plan once per KV head
        counter = torch.zeros(1, dtype=torch.int32, device=q.device)
        if decode:
            live = fa.decode_chunk_plan(q_pos, k_pos, chunk=plan.keys, window=window)
            counted = fa.launch_decode(q[:, 0], k, v, q_pos, k_pos, skipped=counter, **kw)
            key, what = "skipped_chunks", "(b, KV head, chunk) triples"
        else:
            live = fa.fwd_tile_plan(q_pos, k_pos, rows=plan.rows, keys=plan.keys, causal=causal,
                                    window=window)
            counted, counted_lse = fa.launch_forward(q, k, v, q_pos, k_pos, with_lse=with_lse,
                                                     skipped=counter, **kw)
            if with_lse:
                check(torch.equal(lse.view(torch.int32), counted_lse.view(torch.int32)),
                      f"{where}: the launch that counts skipped work writes another lse")
            key, what = "skipped_pairs", "(item, key tile) pairs"
        per_tile = kv * -(-(h // kv) // plan.heads)
        planned, pairs_total = int((~live).sum()) * per_tile, live.numel() * per_tile
        check(torch.equal(got.view(torch.int32), counted.view(torch.int32)),
              f"{where}: the launch that counts skipped work differs")
        row[key] = int(counter.item())
        check(row[key] == planned, f"{where}: the kernel skipped {row[key]} {what}, the plan "
                                   f"{planned}")
    check(bool(torch.isfinite(got).all()), f"{where}: non-finite output")
    diff = (got - want).abs()
    err = row["max_abs_err"] = diff.max().item()
    if name.startswith("approx"):
        quantum = v.float().abs().max().item() / 255
        row["bit_equal_share"] = (diff == 0).float().mean().item()
        row["within_1e-5_share"] = (diff <= 1e-5).float().mean().item()
        check(err <= quantum and row["within_1e-5_share"] >= 0.99,
              f"{where}: max |err| {err} (quantum {quantum}), within 1e-5: "
              f"{row['within_1e-5_share']}")
        agree = (f"max |err| {err:.3e} (quantum {quantum:.3e}), bit-equal "
                 f"{row['bit_equal_share']:.4f}, within 1e-5 {row['within_1e-5_share']:.4f}"
                 + (f", lse max |err| {row['lse_max_abs_err']:.3e}" if with_lse else "")
                 + f"; two launches bit-identical, launch_plan as built {row['plan']}, "
                 f"(item, key block) pairs skipped on the card {row['skipped_pairs']} of "
                 f"{pairs_total}, approx_tile_plan's count {planned}")
    else:
        row["err_over_limit"] = (diff / (2e-5 + 2e-5 * want.abs())).max().item()
        check(row["err_over_limit"] <= 1, f"{where}: max |err| {err}")
        agree = (f"max |err| {err:.3e}, over the limit rtol/atol 2e-5: "
                 f"{row['err_over_limit']:.4f}"
                 + (f", lse max |err| {row['lse_max_abs_err']:.3e}, over the limit "
                    f"{row['lse_err_over_limit']:.4f}" if with_lse else "")
                 + f"; two launches bit-identical, launch_plan as built "
                 f"{row['plan']}, {what} skipped on the card {row[key]} of {pairs_total}, the "
                 f"plan's count {planned}")
        row["device_ms"] = graph_ms(kern)
        if library is not None:
            row["library_device_ms"] = graph_ms(library)
    if timed:
        reps = 20 if label == "serve" else 5
        row["ms"] = cuda_ms(kern, reps=reps, warmup=2)
        row["plain_ms"] = cuda_ms(plain, reps=2)
        row["library_ms"] = cuda_ms(library, reps=reps, warmup=2) if library else None
        if name.startswith("approx"):
            row["wrapper_ms"] = cuda_ms(wrapper, reps=reps, warmup=2)
            row["device_ms"] = graph_ms(kern)
    device = (f" device_ms {row['device_ms']:.4f}" if "device_ms" in row else "") + (
        f" library_device_ms {row['library_device_ms']:.4f}" if "library_device_ms" in row
        else "")
    times = (f" ms {row['ms']:.4f} plain_ms {row['plain_ms']:.3f} library_ms "
             + (f"{row['library_ms']:.4f}" if row["library_ms"] is not None else "none")
             + (f" wrapper_ms (with quantization) {row['wrapper_ms']:.4f}"
                if "wrapper_ms" in row else "") + device
             if timed else device)
    print(f"kernel {where}: {agree}{times} bound_ms {row['bound_ms']:.5f} ({row['bound_by']})",
          flush=True)
    return row


def phase_attention(card: Card) -> list:
    return [run_attention_case(card, case, seed=300 + i)
            for i, case in enumerate(attention_cases())]


# ------------------------------------------------------------ backward
@dataclasses.dataclass(frozen=True)
class BwdCase:
    """One backward row: a label, q (b, s) over t slots, window, softcap,
    the heads (query, KV, width), the dtype of q, k, v, and the forward
    whose (o, lse) the pair runs on: ``flash``, or ``bitexact``, the
    approximate forward (straight-through)."""

    label: str
    b: int
    s: int
    t: int
    window: int = None
    softcap: float = None
    h: int = HEADS
    kv: int = KV_HEADS
    hd: int = HEAD_DIM
    dtype: str = "bfloat16"
    forward: str = "flash"
    causal: bool = True


def backward_cases():
    """The train shape, one long shape, a window + softcap variant, and the
    serve shape's cache with masked slots and one left-padded row (its pad
    queries see no slot); then head width 256: gemma2-9b's 16 / 8 heads at
    each of those (window 64 and gemma2's softcap 50 at the train shape),
    gemma-7b's 16 / 16, gemma2's heads in float32 and on the approximate
    bitexact forward's (o, lse); and yi-9b's 32 / 4 of 128 (eight query
    heads to a KV head in dk/dv), qwen2-vl-7b's 28 / 4 of 128 (seven) and
    granite-moe-1b-a400m's 16 / 8 of 64, all at the train shape; then
    seamless-m4t-large-v2's 16 / 16 of 64 non-causal (its encoder) and
    causal (its decoder) at the train shape and at S = T = 1024, and
    recurrentgemma-2b's 10 / 1 of 256 (g = 10) under its window of 2,048 at
    both."""
    b, s = TRAIN["batch"], TRAIN["seq"]
    serve = (SERVE["batch"], SERVE["prompt"], CACHE)
    return [BwdCase("train", b, s, s),
            BwdCase("long", 1, 1024, 1024),
            BwdCase("window+softcap", b, s, s, 64, 30.0),
            BwdCase("masked+pad", *serve),
            BwdCase("gemma2 train", b, s, s, **GEMMA2_HEADS),
            BwdCase("gemma2 long", 1, 1024, 1024, **GEMMA2_HEADS),
            BwdCase("gemma2 window+softcap", b, s, s, 64, GEMMA2_SOFTCAP, **GEMMA2_HEADS),
            BwdCase("gemma2 masked+pad", *serve, **GEMMA2_HEADS),
            BwdCase("gemma-7b train", b, s, s, **GEMMA7_HEADS),
            BwdCase("yi-9b train", b, s, s, **YI_HEADS),
            BwdCase("gemma2 f32 train", b, s, s, dtype="float32", **GEMMA2_HEADS),
            BwdCase("gemma2 bitexact train", b, s, s, forward="bitexact", **GEMMA2_HEADS),
            BwdCase("qwen2-vl train", b, s, s, **QWEN2VL_HEADS),
            BwdCase("granite train", b, s, s, **GRANITE_HEADS),
            # train (g): seamless's encoder (non-causal) and decoder (causal)
            BwdCase("seamless enc train", b, s, s, causal=False, **SEAMLESS_HEADS),
            BwdCase("seamless dec train", b, s, s, **SEAMLESS_HEADS),
            BwdCase("seamless enc long", 1, 1024, 1024, causal=False, **SEAMLESS_HEADS),
            BwdCase("seamless dec long", 1, 1024, 1024, **SEAMLESS_HEADS),
            # train (f): recurrentgemma's ten query heads to its one KV head
            # (g = 10) of 256 under its window of 2,048
            BwdCase("recurrentgemma train", b, s, s, RECURRENTGEMMA_WINDOW,
                    **RECURRENTGEMMA_HEADS),
            BwdCase("recurrentgemma long", 1, 1024, 1024, RECURRENTGEMMA_WINDOW,
                    **RECURRENTGEMMA_HEADS)]


def run_backward_case(card: Card, case: BwdCase, seed):
    """dq and dk/dv kernels against flash_attention_bwd_plain on the forward
    kernel's (o, lse), float32 before the cast; two launches must give the
    same bits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import approx_attention as aa
    from repro_torch.kernels import flash_attention as fa

    label, b, s, t, window, softcap = (case.label, case.b, case.s, case.t, case.window,
                                       case.softcap)
    hd, h, kv = case.hd, case.h, case.kv
    q, k, v, q_pos, k_pos = attention_inputs(
        AttnCase("flash_attention", label, b, s, t, h=h, kv=kv, hd=hd, dtype=case.dtype), seed)
    do = torch.randn((b, s, h, hd), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    kw = dict(causal=case.causal, window=window, softcap=softcap, scale=hd**-0.5)
    if case.forward == "bitexact":
        ops = aa.kernel_operands(q, k, v, mode="bitexact", n=8, t=4, fix_to_1=True, rank=8)
        o, lse = aa.launch_kernel(ops, q_pos, k_pos, bk=64, with_lse=True, **kw)
    else:
        o, lse = fa.flash_attention_fwd(q, k, v, q_pos, k_pos, **kw, with_lse=True)
    dd = torch.einsum("bshd,bshd->bhs", do, o)
    dq_fn = lambda: fa.flash_attention_bwd_dq(q, k, v, q_pos, k_pos, do, lse, dd, **kw)
    dkv_fn = lambda: fa.flash_attention_bwd_dkv(q, k, v, q_pos, k_pos, do, lse, dd, **kw)
    plain = lambda: fa.flash_attention_bwd_plain(q, k, v, q_pos, k_pos, o, lse, do, **kw)
    got, again = (dq_fn(), *dkv_fn()), (dq_fn(), *dkv_fn())
    want = plain()
    torch.cuda.synchronize()
    where = (f"backward {label} B={b} S={s} T={t} H={h} KV={kv} hd={hd} {case.dtype} "
             f"window={window} softcap={softcap} causal={case.causal} on the {case.forward} "
             f"forward")
    plans = {}
    for kernel in ("dq", "dkv"):
        plan = fa.launch_plan(kernel, b, s, t, h, kv, hd, q.dtype)
        built = fa.built_launch_plan(kernel, b, s, t, h, kv, hd, q.dtype)
        check(plan == built, f"{where}: launch_plan {plan} but the kernel launches {built}")
        plans[kernel] = dict(grid=list(plan.grid), threads=plan.threads, smem=plan.smem)
    errs, ratios = [], []
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        check(bool(torch.isfinite(a).all()), f"{where}: non-finite {name}")
        check(torch.equal(a, a2), f"{where}: {name} differs between two launches")
        err = (a - w).abs().max().item()
        limit = 1e-4 * w.abs().max().item()
        check(err <= limit, f"{where}: {name} max |err| {err} over {limit}")
        errs.append(err)
        ratios.append(err / limit)
    # The work this run's data needs, on the bf16 tensor cores as the kernels
    # split it (csrc/flash_attention_bwd.cu): per allowed (query head, slot)
    # pair, 2*hd FLOPs per product.  bf16 q, k, v: 5 products in dq (q k^T;
    # do v^T with do as two bf16 terms; ds k, ds as two terms) and 8 in dk/dv
    # (the same 3 for s and dp; ds^T q, 2; p^T do, both split, 3); float32 q,
    # k, v as two terms too: 3 products for each of dq's 3 and dk/dv's 4 (9,
    # 12).  A query with no allowed slot (a pad) adds p^T do at every slot to
    # dv (3).  Bytes: q, k, v, do, lse, dd read once; dq or dk and dv
    # (float32) written once.
    dq_products, dkv_products = (5, 8) if q.dtype == torch.bfloat16 else (9, 12)
    allow = fa.allow_mask(q_pos, k_pos, causal=case.causal, window=window)
    pairs = h * allow.sum().item()
    pad_pairs = h * t * (~allow.any(-1)).sum().item()
    inputs = q.element_size() * (q.numel() + k.numel() + v.numel())
    inputs += 4 * (do.numel() + lse.numel() + dd.numel() + q_pos.numel() + k_pos.numel())
    bf16 = BF16_TENSOR_FLOPS_PER_S
    bounds = {
        "flash_attention_bwd_dq": card.bound(inputs + 4 * q.numel(),
                                             2 * hd * dq_products * pairs, bf16),
        "flash_attention_bwd_dkv": card.bound(inputs + 8 * k.numel(),
                                              2 * hd * (dkv_products * pairs + 3 * pad_pairs),
                                              bf16),
    }
    total = card.bound(inputs + 4 * q.numel() + 8 * k.numel(),
                       2 * hd * ((dq_products + dkv_products) * pairs + 3 * pad_pairs), bf16)
    rows = []
    for name, kernel, err, ratio in (("flash_attention_bwd_dq", "dq", errs[0], ratios[0]),
                                     ("flash_attention_bwd_dkv", "dkv", max(errs[1:]),
                                      max(ratios[1:]))):
        rows.append(dict(name=name, label=label, shape=[b, s, t, h, kv, hd], dtype=case.dtype,
                         max_abs_err=err, err_over_limit=ratio, bound_ms=bounds[name][0],
                         bound_by=bounds[name][1], plan=plans[kernel]))
    reps = 5 if label.endswith("long") else 20
    plain_ms = cuda_ms(plain, reps=2)
    library_ms = library_device_ms = None
    if softcap is None:  # SDPA has no softcap
        # the backward alone of SDPA on the same q/k/v and boolean mask,
        # its forward outside the timing; heads before the sequence
        leaves = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=allow[:, None],
                                             scale=kw["scale"], enable_gqa=True)
        g_out = do.transpose(1, 2).to(out.dtype)
        library_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g_out, retain_graph=True),
                             reps=reps, warmup=2)
        # its device time: forward and backward replayed from one CUDA graph,
        # less the forward alone (autograd runs a backward on its forward's
        # stream, so both are captured), on fresh leaves: the graph kept for
        # the loop above holds the old leaves' gradient nodes on the default
        # stream, which a capture may not wait on; warmed on a side stream
        fresh = [x.detach().requires_grad_() for x in leaves]
        fwd = lambda: F.scaled_dot_product_attention(*fresh, attn_mask=allow[:, None],
                                                     scale=kw["scale"], enable_gqa=True)
        fwd_bwd = lambda: torch.autograd.grad(fwd(), fresh, g_out)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fwd_bwd()
        torch.cuda.current_stream().wait_stream(side)
        library_device_ms = graph_ms(fwd_bwd) - graph_ms(fwd)
    for row, fn in zip(rows, (dq_fn, dkv_fn)):
        row.update(ms=cuda_ms(fn, reps=reps, warmup=2), device_ms=graph_ms(fn),
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms)
    pair_ms = rows[0]["ms"] + rows[1]["ms"]
    times = (f" dq ms {rows[0]['ms']:.4f} (device {rows[0]['device_ms']:.4f}) dkv ms "
             f"{rows[1]['ms']:.4f} (device {rows[1]['device_ms']:.4f}) plain_ms (whole "
             f"backward) {plain_ms:.3f} library_ms (SDPA backward) "
             + (f"{library_ms:.4f} pair/SDPA {pair_ms / library_ms:.3f} library_device_ms "
                f"{library_device_ms:.4f} pair/SDPA by device time "
                f"{(rows[0]['device_ms'] + rows[1]['device_ms']) / library_device_ms:.3f}"
                if library_ms is not None else "none"))
    print(f"kernel {where}: max |err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}, "
          f"over the limit 1e-4 * max|want|: dq {ratios[0]:.4f} dk {ratios[1]:.4f} dv "
          f"{ratios[2]:.4f}; two launches bit-identical, launch_plan as built dq "
          f"{plans['dq']} dkv {plans['dkv']};{times} bound_ms dq {rows[0]['bound_ms']:.5f} "
          f"({rows[0]['bound_by']}) dkv {rows[1]['bound_ms']:.5f} ({rows[1]['bound_by']}) "
          f"whole backward {total[0]:.5f} ({total[1]})", flush=True)
    return rows


def phase_backward(card: Card) -> list:
    return [row for i, case in enumerate(backward_cases())
            for row in run_backward_case(card, case, seed=500 + i)]


# ---------------------------------------------------------- elementwise
def u32_operands(shape, n: int, seed: int):
    """uint32 operands in [0, 2^n) on the card: every (a, b) pair for a 1-d
    shape of 2^(2n) elements, else numpy draws from ``seed``."""
    import numpy as np
    import torch

    size = math.prod(shape)
    if len(shape) == 1 and size == 1 << (2 * n):
        v = np.arange(1 << n, dtype=np.uint32)
        a, b = np.repeat(v, 1 << n), np.tile(v, 1 << n)
    else:
        rng = np.random.default_rng(seed)
        a, b = (rng.integers(0, 1 << n, size, dtype=np.uint64).astype(np.uint32)
                for _ in range(2))
    return tuple(torch.from_numpy(x.reshape(shape)).to("cuda") for x in (a, b))


def u32_err(got, want) -> int:
    """max |got - want| of uint32 tensors; -1 if the shapes or dtypes differ."""
    import torch

    if got.dtype != torch.uint32 or want.dtype != torch.uint32 or got.shape != want.shape:
        return -1
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max().item())


def elementwise_cases():
    """(kernel, n, t, approx, fix_to_1, shape): the (n, t) sweeps (every pair
    at n <= 8 and n = 12, 2^20 + 3 draws at n = 15, 2^24 draws at n = 16),
    then the ragged, 0-d and empty sizes at the main (n, t)."""
    cases = []
    variants = [(approx, fix) for approx in (True, False) for fix in (True, False)]
    for name, widths in (("seqmul_packed", (4, 8, 12, 15)), ("seqmul_words", (8, 15, 16))):
        for n in widths:
            shape = ((1 << 24,) if n in (12, 16) else ((1 << 20) + 3,) if n == 15
                     else (1 << (2 * n),))
            for t in sorted({1, n // 2, n - 1}):
                cases += [(name, n, t, approx, fix, shape) for approx, fix in variants]
        n, t = ELEMENTWISE_MAIN[name]
        cases += [(name, n, t, True, True, shape) for shape in ELEMENTWISE_RAGGED]
    return cases


def run_elementwise_case(card: Card, case, seed: int, timed: bool):
    import torch

    from repro_torch.kernels import seqmul_kernel as sk

    name, n, t, approx, fix, shape = case
    a, b = u32_operands(shape, n, seed)
    kw = dict(n=n, t=t, approx=approx, fix_to_1=fix)
    if name == "seqmul_packed":
        kern = lambda: (sk.seqmul_packed(a, b, **kw),)
        plain = lambda: (sk.seqmul_packed_plain(a, b, **kw),)
        nbytes = 12 * a.numel()  # two uint32 reads, one write
    else:
        kern = lambda: sk.seqmul_words(a, b, **kw)
        plain = lambda: sk.seqmul_words_plain(a, b, **kw)
        nbytes = 16 * a.numel()  # two uint32 reads, two writes
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(u32_err(g, w) for g, w in zip(got, want))
    where = f"{name} n={n} t={t} approx={approx} fix_to_1={fix} shape={shape}"
    check(err == 0, f"{where}: kernel != plain (max |err| {err})")
    if len(shape) == 1 and shape[0] > 4:
        # an operand that does not start on a 16-byte boundary takes the
        # kernel's element-at-a-time path
        a1, b1 = a[1:], b[1:]
        fn = sk.seqmul_packed if name == "seqmul_packed" else sk.seqmul_words
        pl = sk.seqmul_packed_plain if name == "seqmul_packed" else sk.seqmul_words_plain
        g1, w1 = fn(a1, b1, **kw), pl(a1, b1, **kw)
        g1, w1 = (g1, w1) if name == "seqmul_words" else ((g1,), (w1,))
        err1 = max(u32_err(g, w) for g, w in zip(g1, w1))
        check(err1 == 0, f"{where}, unaligned view: kernel != plain (max |err| {err1})")
    bound = card.bound(nbytes, a.numel() * one_word_ops_per_product(n), card.int32_ops_per_s)
    row = dict(name=name, shape=list(shape), n=n, t=t, approx=approx, fix_to_1=fix,
               max_abs_err=err, bound_ms=bound[0], bound_by=bound[1])
    if timed:
        row["ms"] = cuda_ms(kern, reps=20, warmup=2)
        row["plain_ms"] = cuda_ms(plain, reps=2)
        row["library_ms"] = None  # no PyTorch call computes the approximate products
    return row


def phase_elementwise(card: Card) -> list:
    rows = []
    for i, case in enumerate(elementwise_cases()):
        name, n, t, approx, fix, shape = case
        timed = (n, t) == ELEMENTWISE_MAIN[name] and approx and fix and shape == (1 << 24,)
        rows.append(run_elementwise_case(card, case, seed=700 + i, timed=timed))
        if timed:
            row = rows[-1]
            print(f"kernel {name} n={n} t={t} approx fix_to_1 elements {shape[0]}: bit-equal "
                  f"ms {row['ms']:.4f} plain_ms {row['plain_ms']:.3f} library_ms none "
                  f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']})", flush=True)
    for name in ELEMENTWISE_KERNELS:
        mine = [r for r in rows if r["name"] == name]
        print(f"kernel {name}: bit-equal to its plain version in all {len(mine)} cases "
              f"(n in {sorted({r['n'] for r in mine})}, t in {{1, n/2, n-1}}, approx and "
              f"fix_to_1 both ways; sizes {sorted({str(r['shape']) for r in mine})}; "
              f"unaligned views of the 1-d ones)", flush=True)
    return rows


# ------------------------------------------------------- error analysis
# exhaustive_eval(12, 6) on the CPU, both fix_to_1 settings, the reference the
# card's reports are held against: run in a process of its own from the
# start of the kernel phases on, with CPU_EVAL_THREADS threads
CPU_EVAL_THREADS = 3
CPU_EVAL = """
import pickle, sys, time
import torch
torch.set_num_threads(int(sys.argv[2]))
from repro_torch.core import error_metrics
out = {}
for fix in (False, True):
    t0 = time.perf_counter()
    rep = error_metrics.exhaustive_eval(12, 6, fix_to_1=fix, device="cpu")
    out[fix] = (rep, time.perf_counter() - t0)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def start_cpu_eval():
    """Start ``CPU_EVAL`` in a process of its own; it is killed at exit if
    it is still running.  Returns (process, the file it writes)."""
    import atexit

    out = ROOT / "build" / "chip_smoke_cpu_eval.pkl"
    out.unlink(missing_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-c", CPU_EVAL, str(out), str(CPU_EVAL_THREADS)], cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": str(CPU_EVAL_THREADS),
             "CUDA_VISIBLE_DEVICES": ""})
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def cpu_eval_reports(cpu_eval) -> dict:
    """Wait for ``start_cpu_eval``'s process: {fix_to_1: (report, seconds)}."""
    import pickle

    proc, out = cpu_eval
    _, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"exhaustive_eval on the CPU: exit {proc.returncode}: "
                                f"{err[-2000:]}")
    reports = pickle.loads(out.read_bytes())
    out.unlink()
    return reports


def phase_error_analysis(cpu_eval) -> dict:
    """The paper's simulated error analysis on the card: ``engine.multiply``
    and ``kernels.ops.approx_multiply`` through ``seqmul_packed``, then
    ``exhaustive_eval(12, 6)`` and ``mc_eval(16, 8)``, whose products come
    from ``seqmul_words``, and ``mc_eval(32, 16)`` (``core.seqmul`` on the
    card).  Every launch count is set to 0 just before these calls and read
    just after; the comparisons with the CPU and with ``core.seqmul``
    follow.  The two example twins run in processes of their own beside
    all of it (and beside the train CLI, started before), so the walls
    here are taken beside them."""
    # the two example twins, both processes at once, beside all of this
    t0 = time.perf_counter()
    twins = [(module, args, subprocess.Popen(
        [sys.executable, "-m", module, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)}))
        for module, args in (("repro_torch.examples.quickstart", []),
                             ("repro_torch.examples.accuracy_sweep", ["--steps", "80"]))]
    try:
        return _error_analysis(cpu_eval, twins, t0)
    finally:
        for _, _, proc in twins:
            if proc.poll() is None:
                proc.kill()


def _error_analysis(cpu_eval, twins: list, t0: float) -> dict:
    import numpy as np
    import torch

    from repro_torch import engine, kernels
    from repro_torch.core import error_metrics, error_model, seqmul
    from repro_torch.kernels import ops
    from repro_torch.kernels import seqmul_kernel as sk

    # the elementwise product, every (a, b) pair at n = 8, through the engine
    a, b = u32_operands((1 << 16,), 8, 0)
    kernels.reset_launch_counts()
    got = engine.multiply(a, b, n=8, t=4)  # backend "auto": the kernel
    check(kernels.launch_counts()["seqmul_packed"] == 1,
          "engine.multiply(backend='auto') on CUDA tensors did not launch seqmul_packed")
    shim = ops.approx_multiply(a, b, n=8, t=4)

    runs, reports = {}, {}

    def timed(label, fn):
        out = []
        busy_ms, _, wall_ms, _ = profile_fn(lambda: out.append(fn()), 1, label)
        runs[label] = dict(wall_s=wall_ms / 1e3, busy_share=busy_ms / wall_ms if busy_ms else None)
        reports[label] = out[0]

    for fix in (False, True):
        timed(f"exhaustive_eval(12, 6, fix_to_1={fix})",
              lambda: error_metrics.exhaustive_eval(12, 6, fix_to_1=fix, device="cuda"))
    mc_runs = ((16, 8, 1 << 24), (32, 16, 1 << 22))
    for n, t, samples in mc_runs:
        timed(f"mc_eval({n}, {t}, samples=2**{samples.bit_length() - 1})",
              lambda: error_metrics.mc_eval(n, t, samples=samples, device="cuda"))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ELEMENTWISE_KERNELS:
        check(counts[name] > 0, f"error analysis: {name} was never launched ({counts})")
    print(f"error analysis: launches {({k: counts[k] for k in ELEMENTWISE_KERNELS})}",
          flush=True)

    def share(label):
        busy = runs[label]["busy_share"]
        return "not measured" if busy is None else f"{busy:.4f}"

    want = engine.multiply(a, b, n=8, t=4, backend="reference")
    cpu = engine.multiply(a.cpu(), b.cpu(), n=8, t=4)
    check(u32_err(got, want) == 0 and u32_err(shim, want) == 0 and u32_err(want.cpu(), cpu) == 0,
          "engine.multiply / approx_multiply on the card != the reference body")
    print("error analysis: engine.multiply (auto) and ops.approx_multiply on the card "
          "bit-equal to the reference body on the card and on the CPU (n=8, t=4, all "
          "65536 pairs)", flush=True)

    cpu_reports = cpu_eval_reports(cpu_eval)
    for fix in (False, True):
        label = f"exhaustive_eval(12, 6, fix_to_1={fix})"
        rep = reports[label]
        ref, cpu_s = cpu_reports[fix]
        check(rep == ref, f"{label}: card {rep} != CPU {ref}")
        if not fix:
            mae = error_model.mae_closed_form(12, 6)
            check(-rep.max_ed_neg == mae,
                  f"{label}: worst overshoot {-rep.max_ed_neg} != closed-form MAE {mae}")
        print(f"error analysis: {label} on the card equal to the CPU's field for field: "
              f"{rep.summary()}; worst overshoot {-rep.max_ed_neg} (closed-form MAE "
              f"{error_model.mae_closed_form(12, 6)}); wall {runs[label]['wall_s']:.2f}s on "
              f"the card beside the train CLI and the twins (device busy share {share(label)}), "
              f"{cpu_s:.2f}s "
              f"on the CPU (a "
              f"process of its own, {CPU_EVAL_THREADS} threads, beside the card's phases)",
              flush=True)
    for n, t in ((1, 1), (4, 2)):
        check(error_metrics.exhaustive_eval(n, t, device="cuda")
              == error_metrics.exhaustive_eval(n, t, device="cpu"),
              f"exhaustive_eval({n}, {t}): card != CPU")

    for n, t, samples in mc_runs:
        label = f"mc_eval({n}, {t}, samples=2**{samples.bit_length() - 1})"
        rep = reports[label]
        small = dict(samples=1 << 16, seed=1)
        check(error_metrics.mc_eval(n, t, device="cuda", **small)
              == error_metrics.mc_eval(n, t, device="cpu", **small),
              f"mc_eval({n}, {t}) at 2^16 samples: card != CPU")
        check(rep.samples == samples and all(map(math.isfinite, (rep.er, rep.nmed, rep.mred))),
              f"{label}: {rep}")
        print(f"error analysis: {label} on the card: {rep.summary()}; wall "
              f"{runs[label]['wall_s']:.2f}s beside the train CLI and the twins (device busy share "
              f"{share(label)}); at 2^16 "
              f"samples equal to the CPU's field for field", flush=True)

    # the two-word kernel against core.seqmul on mc_eval(16, 8)'s draws
    rng = np.random.default_rng(0)
    chunk = 1 << 22
    for _ in range((1 << 24) // chunk):
        a_np = rng.integers(0, 1 << 16, size=chunk, dtype=np.uint64)
        b_np = rng.integers(0, 1 << 16, size=chunk, dtype=np.uint64)
        a16, b16 = (torch.from_numpy(x.astype(np.uint32)).to("cuda") for x in (a_np, b_np))
        low, high = sk.seqmul_words(a16, b16, n=16, t=8)
        prod = (low.cpu().numpy().astype(np.uint64)
                + (high.cpu().numpy().astype(np.uint64) << np.uint64(16)))
        words = seqmul.seq_mul_words(a16, b16, n=16, t=8, approx=True)
        check(np.array_equal(prod, seqmul.assemble_product_u64(words, n=16, t=8)),
              "seqmul_words low + (high << 16) != core.seqmul's product at n=16")
    print("error analysis: seqmul_words on mc_eval(16, 8)'s 2^24 draws: low + (high << 16) "
          "equal to core.seqmul's products on the card", flush=True)
    print("error analysis runs: " + json.dumps(runs), flush=True)

    for module, args, proc in twins:
        out, err = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"{module} exit {proc.returncode}: {err[-2000:]}")
        print(f"error analysis: python -m {module} {' '.join(args)} on the card (both "
              f"twins at once, beside the phase, {time.perf_counter() - t0:.1f}s): "
              + " | ".join(out.splitlines()), flush=True)
    return dict(counts=counts, runs=runs)


# ------------------------------------------------------------ reference
def phase_reference() -> None:
    import torch

    from repro_torch import engine
    from repro_torch.configs.registry import apply_approx, get_config

    g = torch.Generator().manual_seed(7)
    x = torch.randn((16, 128), generator=g)
    w = torch.randn((128, 64), generator=g)
    want = engine.matmul(x, w, mode="lowrank", n=8, t=4, backend="reference")
    got = engine.matmul(x.cuda(), w.cuda(), mode="lowrank", n=8, t=4, backend="cuda").cpu()
    err = (got - want).abs().max().item()
    check(err <= 2e-6 * want.abs().max().item(),
          f"engine.matmul lowrank: card vs CPU reference max |err| {err}")
    print(f"reference: engine.matmul lowrank on the card vs the CPU reference body at "
          f"(16,128)x(128,64): max |err| {err:.3e} (2e-6 * max|want|)", flush=True)
    for mode, n, t in (("bitexact", 8, 4), ("seqmul", 8, 4), ("seqmul", 12, 6), ("inject", 8, 4)):
        kw = dict(mode=mode, n=n, t=t)
        if mode == "inject":
            # the same noise on both sides: drawn once on the CPU, handed to both
            spec, p = engine.get_mode("inject"), engine.GemmParams(n, t, True, 8)
            (noise,) = spec.prepare(x, w, p, torch.Generator().manual_seed(1))
            want = spec.reference(x, w, p, noise)
            got = spec.cuda(x.cuda(), w.cuda(), p, noise.cuda()).cpu()
        else:
            want = engine.matmul(x, w, backend="reference", **kw)
            got = engine.matmul(x.cuda(), w.cuda(), backend="cuda", **kw).cpu()
        check(torch.equal(got, want), f"engine.matmul {mode} n={n} t={t}: card != CPU reference")
    print("reference: engine.matmul bitexact/seqmul(n=8,12)/inject on the card bit-equal "
          "to the CPU reference bodies at (16,128)x(128,64)", flush=True)

    reduced = get_config("qwen3-0.6b").reduced()
    pallas = get_config("qwen3-0.6b").reduced(attn_impl="pallas")
    for label, cfg in (("exact", reduced),
                       ("bitexact", apply_approx(reduced, mode="bitexact", n=8, t=4)),
                       ("pallas exact", pallas),
                       ("pallas bitexact mlp+attn", apply_approx(
                           pallas, mode="bitexact", n=8, t=4, targets=("mlp", "attn")))):
        hold_logits_on_card(f"reduced qwen3-0.6b {label}", cfg)


@contextlib.contextmanager
def approximate_inputs(recorded: list, label: str, *, record: bool):
    """Record (``record``) the input of every approximate GEMM, the (E, C, d)
    input of every MoE expert GEMM and the q, k and v of every approximate
    attention call of the model, in call order; or, on the card, check each
    call's own inputs against the recorded ones (rtol/atol 1e-4) and hand it
    the recorded ones instead."""
    import torch

    import repro_torch.models.attention as attention
    import repro_torch.models.layers as layers
    import repro_torch.models.moe as moe

    gemm, attn, experts = layers._approx_2d, attention.approx_flash_attention, moe.expert_gemm

    def take(got: tuple) -> tuple:
        want = recorded.pop(0)
        for g, w in zip(got, want):
            check(torch.allclose(g.cpu(), w, rtol=1e-4, atol=1e-4),
                  f"{label}: an approximate call's input on the card is "
                  f"{(g.cpu() - w).abs().max().item()} from the CPU's")
        return tuple(w.to(g.device) for g, w in zip(got, want))

    def gemm_hook(x2, w, ap, generator):
        if record:
            recorded.append((x2.clone(),))
        else:
            (x2,) = take((x2,))
        return gemm(x2, w, ap, generator)

    def attn_hook(q, k, v, *args, **kw):
        if record:
            recorded.append((q.clone(), k.clone(), v.clone()))
        else:
            q, k, v = take((q, k, v))
        return attn(q, k, v, *args, **kw)

    def experts_hook(x, w, ctx):
        if record:
            recorded.append((x.clone(),))
        else:
            (x,) = take((x,))
        return experts(x, w, ctx)

    layers._approx_2d, attention.approx_flash_attention = gemm_hook, attn_hook
    moe.expert_gemm = experts_hook
    try:
        yield
    finally:
        layers._approx_2d, attention.approx_flash_attention = gemm, attn
        moe.expert_gemm = experts


def hold_logits_on_card(label: str, cfg, *, decode_steps: int = 0, prompt: int = 16,
                        cache: int = 24, forced: bool = False) -> None:
    """Prefill logits of ``cfg`` (seed-0 weights, two prompts of ``prompt``
    tokens; an encoder-decoder also encodes ``prompt`` seeded frames) and
    then ``decode_steps`` greedy decode steps on the card against the
    port's CPU plain path, every step fed the CPU's token.
    ``forced``: each approximate call on the card is first checked to get
    the CPU's inputs within rtol/atol 1e-4 and then fed the CPU's inputs
    themselves (``approximate_inputs``), as tests/test_torch_model.py
    feeds the port the reference's: an input an ulp away can sit on the
    other side of a rounding boundary of the 8-bit quantizer, and that moves
    the layer's output by a quantum, far more than 1e-4."""
    import torch

    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    model = build_model(cfg)
    cpu_params = model.init_params(0, device="cpu")
    gpu_params = model.init_params(0, device="cpu").cuda()
    toks = torch.randint(0, cfg.vocab_size, (2, prompt),
                         generator=torch.Generator().manual_seed(3))
    batch, mem_len = {"tokens": toks}, 0
    if cfg.is_encdec:  # an encoder memory of ``prompt`` seeded frames
        mem_len = prompt
        batch["src_embeds"] = torch.randn((2, prompt, cfg.d_model),
                                          generator=torch.Generator().manual_seed(4))
        batch["src_pos"] = torch.arange(prompt).expand(2, prompt)
    recorded = []

    def on_cpu():
        return approximate_inputs(recorded, label, record=True) if forced else \
            contextlib.nullcontext()

    def on_card():
        return approximate_inputs(recorded, label, record=False) if forced else \
            contextlib.nullcontext()

    with torch.inference_mode():
        prefill = make_prefill_step(model, cache, mem_len=mem_len)
        with on_cpu():
            want_cache, want = prefill(cpu_params, batch)
        with on_card():
            got_cache, got = prefill(gpu_params, {k: v.cuda() for k, v in batch.items()})
        steps = [("prefill", got.cpu(), want)]
        decode = make_decode_step(model)
        for i in range(decode_steps):
            tok = want[:, -1].argmax(-1)[:, None]
            at = torch.full((2,), prompt + i, dtype=torch.int32)
            with on_cpu():
                want, want_cache = decode(cpu_params, want_cache, tok, at, at)
            with on_card():
                got, got_cache = decode(gpu_params, got_cache, tok.cuda(), at.cuda(), at.cuda())
            steps.append((f"decode step {i}", got.cpu(), want))
    check(not recorded, f"{label}: the card made fewer approximate calls than the CPU")
    errs = []
    for what, got, want in steps:
        err = (got - want).abs().max().item()
        errs.append(f"{what} {err:.3e}")
        check(bool(torch.isfinite(got).all()), f"{label} {what}: non-finite logits")
        # All within rtol/atol 1e-4: the float sums (norms, attention, the
        # exact projections) run in another order on the card.  The bitexact
        # GEMMs are integer-exact on both sides, so they add nothing unless an
        # input lands on the other side of a quantizer rounding boundary,
        # which moves a logit by far more than 1e-4 and fails here (unless
        # ``forced``); so does a probability of the approximate attention
        # that the card's expf moves across a boundary of p_int.
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"{label} {what}: card vs CPU max |err| {err}")
    print(f"reference: {label} logits card vs CPU max |err| {', '.join(errs)} "
          f"(rtol/atol 1e-4{'; approximate calls fed the CPU inputs' if forced else ''})",
          flush=True)


def phase_reference_wide() -> None:
    """gemma-7b, gemma2-9b and yi-9b at their plain ``.reduced()``, and
    gemma2-9b at ``reduced(head_dim=256, attn_impl="pallas")`` at exact and
    at bitexact on mlp and attn (the attention kernels at head width 256,
    gemma2's window of 8 binding over the decode steps; the approximate
    calls fed the CPU's inputs): prefill and four decode steps' logits on
    the card against the CPU plain path."""
    from repro_torch.configs.registry import apply_approx, get_config

    for arch in ("gemma-7b", "gemma2-9b", "yi-9b"):
        hold_logits_on_card(f"reduced {arch} exact", get_config(arch).reduced(), decode_steps=4)
    wide = get_config("gemma2-9b").reduced(head_dim=256, attn_impl="pallas")
    hold_logits_on_card("reduced gemma2-9b head_dim 256 pallas exact", wide, decode_steps=4)
    # forced: unforced, the first attention call's q, k, v, an ulp from the
    # CPU's, cross 8-bit quantizer boundaries at this seed (the card's kernel
    # on the CPU's inputs is within 2.4e-7 of the plain version)
    hold_logits_on_card(
        "reduced gemma2-9b head_dim 256 pallas bitexact mlp+attn",
        apply_approx(wide, mode="bitexact", n=8, t=4, targets=("mlp", "attn")), decode_steps=4,
        forced=True)


def phase_reference_vl_moe() -> None:
    """Reduced qwen2-vl-7b with seven query heads on one KV head of 128 (the
    published M-RoPE sections (16, 24, 24)): patch embeddings from a seed at
    t/h/w ids that differ (a frame of 3 x 4 patches after two text tokens)
    into a prefill over a 24-slot cache, then four decode steps of seeded
    tokens; the logits through the attention kernels (``flash_attention``
    at g = 7, ``flash_decode``) against the plain attention, both on the
    card, from the same weights, within rtol/atol 1e-4.  Then reduced
    granite-moe-1b-a400m at the ``balanced`` tier (bitexact expert GEMMs
    and attention projections; capacity 1.25, so prefill and decode drop
    assignments), prefill and four decode steps card vs CPU, the approximate
    calls fed the CPU's inputs."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs.registry import apply_quality, get_config
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_decode_step

    cfg = get_config("qwen2-vl-7b").reduced(num_heads=7, num_kv_heads=1, head_dim=128,
                                             mrope_sections=(16, 24, 24))
    b, s, steps, cache = 2, 14, 4, 24
    g = torch.Generator().manual_seed(11)
    embeds = torch.randn((b, s, cfg.d_model), generator=g).cuda()
    toks = torch.randint(0, cfg.vocab_size, (b, steps), generator=g).cuda()
    j = torch.arange(s) - 2
    t = torch.where(j < 0, torch.arange(s), torch.full_like(j, 2))
    pos = torch.stack([t, torch.where(j < 0, t, 2 + j // 4), torch.where(j < 0, t, 2 + j % 4)])
    check(len({tuple(r.tolist()) for r in pos}) == 3, "the t/h/w streams must differ")
    pos = pos[:, None].expand(3, b, s).cuda()
    params = build_model(cfg).init_params(0, device="cuda")
    sides = {}
    for impl in ("xla", "pallas"):
        model = build_model(dataclasses.replace(cfg, attn_impl=impl))
        kernels.reset_launch_counts()
        with torch.inference_mode():
            caches = model.init_caches(b, cache, torch.float32, "cuda")
            hidden, caches, _ = model.forward(params, None, pos, model.ctx(), embeds=embeds,
                                              caches=caches, cache_pos=0)
            logits = [model.lm_head(params, hidden)]
            decode = make_decode_step(model)
            for i in range(steps):
                out, caches = decode(params, caches, toks[:, i:i + 1], s + i)
                logits.append(out)
        torch.cuda.synchronize()
        sides[impl] = logits, kernels.launch_counts()
    (want, plain_counts), (got, counts) = sides["xla"], sides["pallas"]
    check(counts["flash_attention"] == cfg.num_layers and
          counts["flash_decode"] == steps * cfg.num_layers and
          not any(plain_counts.values()),
          f"reduced qwen2-vl g = 7: launches {counts}, plain side {plain_counts}")
    errs = []
    for i, (a, w) in enumerate(zip(got, want)):
        err = (a - w).abs().max().item()
        errs.append(f"{'prefill' if i == 0 else f'decode step {i - 1}'} {err:.3e}")
        check(bool(torch.isfinite(a).all()) and torch.allclose(a, w, rtol=1e-4, atol=1e-4),
              f"reduced qwen2-vl g = 7 {errs[-1]}: pallas vs plain attention")
    print(f"reference: reduced qwen2-vl-7b, 7 / 1 heads of 128, patch embeds at distinct "
          f"t/h/w, pallas vs plain attention on the card, max |err| {', '.join(errs)} "
          f"(rtol/atol 1e-4); launches flash_attention {counts['flash_attention']}, "
          f"flash_decode {counts['flash_decode']}", flush=True)
    granite = apply_quality(get_config("granite-moe-1b-a400m").reduced(), "balanced")
    hold_logits_on_card("reduced granite-moe-1b-a400m balanced (moe + attn bitexact)", granite,
                        decode_steps=4, forced=True)


def phase_reference_recurrent() -> None:
    """Reduced mamba2-130m (four SSD layers, chunks of 8) and
    recurrentgemma-2b (one scanned (rglru, rglru, attn_local) group and a
    remainder RG-LRU layer, window 8), ``attn_impl="pallas"``, at the
    ``balanced`` tier (bitexact on the projections; recurrentgemma's
    attention through approx_attention_bitexact and flash_decode): prefill
    of 16 tokens (two chunks) and four decode steps' logits on the card
    against the CPU, the approximate calls fed the CPU's inputs."""
    from repro_torch import kernels
    from repro_torch.configs.registry import apply_quality, get_config

    for arch, expect in (("mamba2-130m", ("lut_matmul",)),
                         ("recurrentgemma-2b", ("lut_matmul", "approx_attention_bitexact",
                                                "flash_decode"))):
        cfg = apply_quality(get_config(arch).reduced(num_layers=4, attn_impl="pallas"),
                            "balanced")
        kernels.reset_launch_counts()
        hold_logits_on_card(f"reduced {arch} pallas balanced", cfg, decode_steps=4, forced=True)
        counts = kernels.launch_counts()
        check(all(counts[name] > 0 for name in expect),
              f"reduced {arch} pallas balanced: launches {counts}")


def phase_reference_recurrent_train() -> None:
    """One train step of reduced mamba2-130m (four SSD layers, chunks of 8:
    the SSD's scans under autograd) and recurrentgemma-2b (one scanned
    (rglru, rglru, attn_local) group and two remainder layers, window 8,
    pallas: the forward with lse and the pair on its local attention) on
    the card against the same step on the CPU."""
    from repro_torch.configs.registry import get_config

    for arch, layers_, expect in (("mamba2-130m", 4, ()),
                                  ("recurrentgemma-2b", 5, ("flash_attention", *BWD_KERNELS))):
        cfg = get_config(arch).reduced(num_layers=layers_, attn_impl="pallas")
        phase_train_reference(f"reduced {arch} ({layers_} layers, pallas) train step card vs "
                              f"CPU", ((cfg, "cpu"), (cfg, "cuda")), expect=expect)


@contextlib.contextmanager
def attention_calls():
    """Count the models' calls into ``flash_attention`` and
    ``approx_flash_attention`` on CUDA tensors by their ``causal`` flag:
    {(wrapper, causal): calls}."""
    import collections

    import repro_torch.models.attention as attention

    calls = collections.Counter()
    originals = {name: getattr(attention, name)
                 for name in ("flash_attention", "approx_flash_attention")}

    def counting(name):
        def call(*args, **kw):
            if args[0].is_cuda:
                calls[(name, kw["causal"])] += 1
            return originals[name](*args, **kw)
        return call

    for name in originals:
        setattr(attention, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(attention, name, fn)


def phase_reference_encdec() -> None:
    """Reduced seamless-m4t-large-v2 (two encoder and two decoder layers,
    4 / 2 heads of 16, float32) under ``attn_impl="pallas"``: prefill (16
    frames through the encoder: the forward non-causal; the decoder's
    causal prefill) and four decode steps' logits on the card against the
    CPU, at exact and at balanced (the encoder through
    approx_attention_bitexact non-causal; the approximate calls fed the
    CPU's inputs); then one train step through the kernels (the forward
    non-causal and causal with lse, the pair after each) against the plain
    attention, both on the card."""
    from repro_torch import kernels
    from repro_torch.configs.registry import apply_quality, get_config

    cfg = get_config("seamless-m4t-large-v2").reduced(attn_impl="pallas")
    for label, c, expect, forced in (
            ("exact", cfg, (("flash_attention", False), ("flash_attention", True)), False),
            ("balanced", apply_quality(cfg, "balanced"),
             (("approx_flash_attention", False), ("approx_flash_attention", True)), True)):
        kernels.reset_launch_counts()
        with attention_calls() as calls:
            hold_logits_on_card(f"reduced seamless-m4t-large-v2 pallas {label}", c,
                                decode_steps=4, forced=forced)
        counts = kernels.launch_counts()
        check(all(calls[key] for key in expect) and counts["flash_decode"] > 0,
              f"reduced seamless {label}: attention calls {dict(calls)}, launches {counts}")
    with attention_calls() as calls:
        phase_train_reference(
            "reduced seamless-m4t-large-v2 train step, pallas attention vs plain on the card",
            tuple((dataclasses.replace(cfg, attn_impl=impl), "cuda")
                  for impl in ("xla", "pallas")),
            expect=("flash_attention", *BWD_KERNELS))
    check(calls[("flash_attention", False)] and calls[("flash_attention", True)],
          f"reduced seamless train step: attention calls {dict(calls)}")


@contextlib.contextmanager
def moe_counters():
    """Count, over the calls made inside, the MoE layers' routed assignments
    and those dropped by capacity, and the kernel launches inside the expert
    GEMMs, each by the tokens of the forward (a decode step routes one token
    per row of the pool).  The dropped counts are summed on the device, so
    counting adds no sync; read them after the run."""
    import torch

    import repro_torch.models.moe as moe
    from repro_torch import kernels

    route, experts = moe.route, moe.expert_gemm
    by_tokens, tokens_now = {}, [0]

    def entry(tokens):
        return by_tokens.setdefault(tokens, dict(
            layers=0, assignments=0, launches=0,
            dropped=torch.zeros((), dtype=torch.int64, device="cuda")))

    def route_hook(router, x2, cfg, **kw):
        r = route(router, x2, cfg, **kw)
        tokens_now[0] = x2.shape[0]
        e = entry(x2.shape[0])
        e["layers"] += 1
        e["assignments"] += r.keep.numel()
        e["dropped"] += (~r.keep).sum()
        return r

    def experts_hook(x, w, ctx, **kw):
        before = sum(kernels.launch_counts().values())
        out = experts(x, w, ctx, **kw)
        entry(tokens_now[0])["launches"] += sum(kernels.launch_counts().values()) - before
        return out

    moe.route, moe.expert_gemm = route_hook, experts_hook
    try:
        yield by_tokens
    finally:
        moe.route, moe.expert_gemm = route, experts


# ---------------------------------------------------------------- serve
def phase_serve(label: str, params, model, *, quality=None, mode=None, targets=("mlp",),
                expect=(), forbid=(), requests: int, profile_reps: int = 1,
                gen: int = SERVE["gen"], full_length: bool = False, mesh=None,
                host_profile: bool = False):
    """One closed-loop run of the scheduler, ``gen`` tokens a request (prompts
    of 4 to 32 tokens, or all of 32 with ``full_length``, as the recurrent
    families take them); every kernel in ``expect`` must launch and none in
    ``forbid``; ``profile_reps`` decode steps profiled (``host_profile``:
    the host's ops traced too); the run's peak device memory."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs.registry import apply_approx
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, synth_requests

    if mode is not None:
        model = build_model(apply_approx(model.cfg, mode=mode, targets=targets))
    cfg = model.cfg
    queue = synth_requests(requests, prompt_len=SERVE["prompt"], gen=gen,
                           vocab_size=cfg.vocab_size, seed=0, vary_budget=False,
                           quality=quality, **(dict(min_prompt=SERVE["prompt"])
                                               if full_length else {}))
    sched = ContinuousScheduler(model, params, batch_size=SERVE["batch"],
                                prompt_len=SERVE["prompt"], max_new=gen, quality=quality,
                                mesh=mesh)
    bad_logits = []
    lm_head = params.lm_head

    def checked_lm_head(hidden):
        logits = lm_head(hidden)
        check(logits.shape[-1] == cfg.vocab_size, f"{label}: logits shape {tuple(logits.shape)}")
        bad_logits.append(torch.isnan(logits).any())
        return logits

    params.lm_head = checked_lm_head
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = sched.run(queue)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        del params.lm_head
    st, acc = result.stats, result.accounting
    for name in expect:
        check(counts[name] > 0, f"{label}: {name} was never launched ({counts})")
    for name in forbid:
        check(counts[name] == 0, f"{label}: {name} ran in this pool ({counts})")
    check(st.requests == requests, f"{label}: served {st.requests} of {requests}")
    for r in queue:
        got = len(result.outputs[r.id])
        check(got == r.max_new, f"{label}: request {r.id} got {got} of {r.max_new} tokens")
    check(acc.slot_leaks == 0 and acc.position_violations == 0,
          f"{label}: slot accounting {acc}")
    check(not any(bool(b) for b in bad_logits), f"{label}: NaN logits")
    print(f"serve {label}: {st.summary()}; prefill {st.prefill_s:.3f}s decode "
          f"{st.decode_s:.3f}s over {st.decode_steps} steps; run incl. warmup {wall:.2f}s; "
          f"peak device memory {peak_gb:.2f} GB; launches {counts}", flush=True)
    steps = step_breakdown(label, sched, params, profile_reps, host_profile)
    return dict(counts=counts, tok_s=st.tokens_per_s, wall_s=st.wall_s, queue=queue,
                outputs=result.outputs, model=sched.model, modeled_cost=st.modeled_cost,
                peak_gb=peak_gb, **steps)


def wide_serve_runs(every: tuple) -> dict:
    """arch -> its full-width serve runs: (label, attn_impl="pallas"?,
    phase_serve's tier or mode, its requests, and the kernels it must and
    must not launch)."""
    few = dict(requests=WIDE_APPROX_REQUESTS, gen=WIDE_APPROX_GEN)
    exact = ("exact", False, dict(quality="exact", forbid=every, requests=WIDE_REQUESTS))
    balanced = ("balanced", False, dict(quality="balanced", expect=("lut_matmul",),
                                        forbid=ATTN_KERNELS, **few))
    pallas_exact = ("pallas exact", True, dict(quality="exact",
                                               expect=("flash_attention", "flash_decode"),
                                               forbid=GEMM_KERNELS, requests=WIDE_REQUESTS))
    return {
        "gemma2-9b": [
            exact, balanced,
            ("draft", False, dict(quality="draft", expect=("packed_matmul",), **few)),
            pallas_exact,
            ("pallas balanced", True, dict(
                quality="balanced",
                expect=("approx_attention_bitexact", "flash_decode", "lut_matmul"), **few)),
            ("pallas lowrank mlp+attn", True, dict(
                mode="lowrank", targets=("mlp", "attn"),
                expect=("lowrank_matmul", "approx_attention_lowrank", "flash_decode"), **few)),
        ],
        "gemma-7b": [exact, pallas_exact],
        "yi-9b": [exact, balanced, pallas_exact],
        # bitexact attention at g = 7
        "qwen2-vl-7b": [exact, balanced, pallas_exact, ("pallas balanced", True, dict(
            quality="balanced", expect=("approx_attention_bitexact", "flash_decode",
                                        "lut_matmul"), **few))],
        # the balanced tier approximates the expert GEMMs and the attention
        # projections (lut_matmul), the draft tier the expert GEMMs
        # (packed_matmul), one launch per expert and projection: host-bound
        # steps of 1.7 and 2.9 s, so 4 tokens a request, and no profiled step
        # (key_averages()' pass over draft's 131,000 launches took 90 s, over
        # balanced's 78,880 about 60; profile_totals reads them faster)
        "granite-moe-1b-a400m": [
            exact,
            ("balanced", False, dict(quality="balanced", expect=("lut_matmul",),
                                     forbid=ATTN_KERNELS, gen=SERVE["gen"] // 4, profile_reps=0,
                                     requests=WIDE_APPROX_REQUESTS)),
            ("draft", False, dict(quality="draft", expect=("packed_matmul",), profile_reps=0,
                                  gen=SERVE["gen"] // 4, requests=WIDE_APPROX_REQUESTS)),
            pallas_exact],
        # the recurrent families take only full-length prompts; recurrentgemma's
        # attention kernels at g = 10, mamba2's GEMMs at its in_proj width 3352
        "recurrentgemma-2b": [(label, use_pallas, {**kw, "full_length": True})
                              for label, use_pallas, kw in (
            exact, balanced, pallas_exact,
            ("pallas balanced", True, dict(
                quality="balanced",
                expect=("approx_attention_bitexact", "flash_decode", "lut_matmul"), **few)))],
        "mamba2-130m": [(label, use_pallas, {**kw, "full_length": True})
                        for label, use_pallas, kw in (
            exact, balanced,
            ("draft", False, dict(quality="draft", expect=("packed_matmul",), **few)),
            ("seqmul", False, dict(mode="seqmul", expect=("seqmul_matmul",), **few)))],
    }


def phase_serve_wide(arch: str, runs: list) -> dict:
    """The continuous scheduler on full-width ``arch`` (weights from seed 0,
    bf16) at each of ``runs``, one profiled decode step a run (none where
    the run says ``profile_reps=0``); for the recurrent families then the
    static loop at exact (``phase_serve_static_recurrent``) and the
    long-prompt check (``phase_long_prompt``, at exact and, with attention
    layers, pallas exact); the model is freed before the next arch."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve.scheduler import has_recurrent_state

    cfg = get_config(arch)
    model = build_model(cfg)
    pallas = build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    t0 = time.perf_counter()
    params = model.init_params(0, device="cuda")
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    ffn = (f"{cfg.num_experts} experts, top-{cfg.num_experts_per_tok}, moe_d_ff "
           f"{cfg.moe_d_ff}, capacity factor {cfg.capacity_factor}" if cfg.num_experts
           else f"d_ff {cfg.d_ff}")
    rope = f", M-RoPE sections {cfg.mrope_sections}" if cfg.use_mrope else ""
    mixers = []
    if "ssd" in cfg.layer_pattern:
        mixers.append(f"SSD d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of "
                      f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
                      f"conv {cfg.conv_width}")
    if "rglru" in cfg.layer_pattern:
        mixers.append(f"RG-LRU width {cfg.lru_width}, conv {cfg.conv_width}")
    if any(k.startswith("attn") for k in cfg.layer_pattern):
        window = (f", window {cfg.local_window}" if "attn_local" in cfg.layer_pattern
                  else "")
        mixers.append(f"{cfg.num_heads} query / {cfg.num_kv_heads} KV heads of "
                      f"{cfg.head_dim}{window}{rope}")
    print(f"serve: {arch} {cfg.num_layers} layers {list(cfg.layer_pattern)}, d_model "
          f"{cfg.d_model}, {'; '.join(mixers)}, {ffn}, vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}, {cfg.dtype}: {n_params / 1e9:.3f}B params from seed 0 in "
          f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"on the card", flush=True)
    out, full = {}, {}
    for label, use_pallas, kw in runs:
        t0 = time.perf_counter()
        with moe_counters() if cfg.num_experts else contextlib.nullcontext() as experts:
            run = full[label] = phase_serve(f"{arch} {label}", params,
                                            pallas if use_pallas else model, **kw)
        busy = "not measured" if run["busy_share"] is None else f"{run['busy_share']:.3f}"
        print(f"serve {arch} {label}: {n_params / 1e9:.3f}B params, {kw['requests']} requests, "
              f"{run['tok_s']:.2f} tok/s, decode step {run['decode_ms']:.2f} ms, pool "
              f"prefill {run['prefill_ms']:.2f} ms, busy share {busy}, peak device memory "
              f"{run['peak_gb']:.2f} GB, launches { {k: c for k, c in run['counts'].items() if c} }"
              f" (per decode step { {k: c for k, c in run['per_decode'].items() if c} }); "
              f"{time.perf_counter() - t0:.1f}s wall with its step breakdown", flush=True)
        out[label] = {k: run[k] for k in ("counts", "per_prefill", "per_decode", "decode_ms",
                                          "prefill_ms", "busy_share", "tok_s", "peak_gb",
                                          "queue", "outputs")}
        if experts is not None:
            out[label]["experts"] = report_experts(f"{arch} {label}", cfg, experts)
    if has_recurrent_state(cfg):
        out["static"] = phase_serve_static_recurrent(arch, params, model, full["exact"])
        long_runs = [("exact", model)]
        if any(k.startswith("attn") for k in cfg.layer_pattern):
            long_runs.append(("pallas exact", pallas))
        for label, m in long_runs:
            out[f"long prompt {label}"] = phase_long_prompt(f"{arch} {label}", params, m)
    del params
    torch.cuda.empty_cache()
    return out


def phase_serve_static_recurrent(arch: str, params, model, exact_run: dict) -> dict:
    """The static loop at ``exact`` on the exact run's queue (full-length
    prompts), held against the continuous scheduler's streams by the margin
    rule."""
    import torch

    from repro_torch import kernels
    from repro_torch.serve import static_serve_loop

    queue = exact_run["queue"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = static_serve_loop(model, params, queue, batch_size=SERVE["batch"],
                               prompt_len=SERVE["prompt"], gen=SERVE["gen"], quality="exact")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(not any(counts.values()), f"serve {arch} static: a kernel ran at exact ({counts})")
    st = result.stats
    check(st.requests == len(queue) and st.tokens_out == len(queue) * SERVE["gen"],
          f"serve {arch} static: {st}")
    agree = hold_streams(f"serve {arch} static", queue, result.outputs, exact_run["outputs"],
                         exact_run["model"], params)
    print(f"serve {arch} static: {st.summary()}; {st.decode_steps} decode steps (continuous "
          f"{exact_run['tok_s']:.2f} tok/s); against the continuous scheduler: {agree}; run "
          f"incl. warmup {wall:.2f}s", flush=True)
    return dict(counts=counts, tok_s=st.tokens_per_s)


def encdec_serve_runs() -> list:
    """seamless-m4t-large-v2's static-loop runs: (label, attn_impl="pallas"?,
    the tier, its requests, the kernels it must and must not launch, the
    attention wrappers it must call by their causal flag)."""
    return [
        ("exact", False, dict(quality="exact", forbid=tuple(GEMM_KERNELS + ATTN_KERNELS),
                              requests=WIDE_REQUESTS)),
        ("balanced", False, dict(quality="balanced", expect=("lut_matmul",),
                                 forbid=ATTN_KERNELS, requests=WIDE_APPROX_REQUESTS)),
        ("pallas exact", True, dict(
            quality="exact", expect=("flash_attention", "flash_decode"), forbid=GEMM_KERNELS,
            calls=(("flash_attention", False), ("flash_attention", True)),
            requests=WIDE_REQUESTS)),
        ("pallas balanced", True, dict(
            quality="balanced", expect=("approx_attention_bitexact", "flash_decode",
                                        "lut_matmul"),
            calls=(("approx_flash_attention", False), ("approx_flash_attention", True)),
            requests=WIDE_APPROX_REQUESTS)),
    ]


def phase_serve_encdec(arch: str, runs: list) -> dict:
    """The static loop (the continuous scheduler refuses an encoder-decoder)
    on full-width ``arch`` (weights from seed 0, bf16) at each of ``runs``:
    prompts and encoder memory of ``SERVE["prompt"]``, ``SERVE["gen"]``
    tokens a request; each with ``phase_serve_static_encdec``'s step
    breakdown.  The model is freed after."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    model = build_model(cfg)
    pallas = build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    t0 = time.perf_counter()
    params = model.init_params(0, device="cuda")
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    print(f"serve: {arch} {cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} query / {cfg.num_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}, frontend {cfg.frontend}, {cfg.dtype}: {n_params / 1e9:.3f}B "
          f"params from seed 0 in {time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card", flush=True)
    out = {}
    for label, use_pallas, kw in runs:
        out[label] = phase_serve_static_encdec(f"{arch} {label}", params,
                                               pallas if use_pallas else model, **kw)
        run = out[label]
        busy = "not measured" if run["busy_share"] is None else f"{run['busy_share']:.3f}"
        print(f"serve {arch} {label}: {n_params / 1e9:.3f}B params, {kw['requests']} requests, "
              f"{run['tok_s']:.2f} tok/s, decode step {run['decode_ms']:.2f} ms, prefill "
              f"(encoder, cross K/V, decoder) {run['prefill_ms']:.2f} ms, busy share {busy}, "
              f"peak device memory {run['peak_gb']:.2f} GB, launches "
              f"{ {k: c for k, c in run['counts'].items() if c} } (per prefill "
              f"{ {k: c for k, c in run['per_prefill'].items() if c} }, per decode step "
              f"{ {k: c for k, c in run['per_decode'].items() if c} })", flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def phase_serve_static_encdec(label: str, params, model, *, quality, requests: int,
                              expect=(), forbid=(), calls=(), mesh=None) -> dict:
    """One static-loop run, every kernel in ``expect`` launched, none in
    ``forbid``, each ``(wrapper, causal)`` of ``calls`` called on the card,
    every request given its budget of in-vocabulary tokens and no NaN
    logits; then outside the count window one prefill (B = batch, the
    prompt and the memory of ``SERVE["prompt"]``) and one decode step of
    the tier's model on the host clock with their launches, and a profiled
    decode step for the busy share.  With ``mesh`` (placed parameters) the
    loop runs on it, and the step breakdown is left out."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serve import static_serve_loop, synth_requests
    from repro_torch.serve.scheduler import _apply_pool_quality
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = model.cfg
    b, p, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    queue = synth_requests(requests, prompt_len=p, gen=gen, vocab_size=cfg.vocab_size, seed=0,
                           vary_budget=False, quality=quality)
    bad_logits = []
    lm_head = params.lm_head

    def checked_lm_head(hidden):
        logits = lm_head(hidden)
        check(logits.shape[-1] == cfg.vocab_size, f"{label}: logits shape {tuple(logits.shape)}")
        bad_logits.append(torch.isnan(logits).any())
        return logits

    params.lm_head = checked_lm_head
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with attention_calls() as seen:
            result = static_serve_loop(model, params, queue, batch_size=b, prompt_len=p,
                                       gen=gen, quality=quality, mesh=mesh)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        del params.lm_head
    st = result.stats
    for name in expect:
        check(counts[name] > 0, f"{label}: {name} was never launched ({counts})")
    for name in forbid:
        check(counts[name] == 0, f"{label}: {name} ran in this run ({counts})")
    for key in calls:
        check(seen[key] > 0, f"{label}: no {key} call on the card ({dict(seen)})")
    check(st.requests == requests, f"{label}: served {st.requests} of {requests}")
    for r in queue:
        toks = np.asarray(result.outputs[r.id])
        check(len(toks) == r.max_new and ((toks >= 0) & (toks < cfg.vocab_size)).all(),
              f"{label}: request {r.id} got {toks}")
    check(not any(bool(x) for x in bad_logits), f"{label}: NaN logits")
    print(f"serve {label}: {st.summary()}; prefill {st.prefill_s:.3f}s decode "
          f"{st.decode_s:.3f}s over {st.decode_steps} steps; peak device memory {peak_gb:.2f} "
          f"GB; attention calls on the card {dict(seen)}", flush=True)
    if mesh is not None:
        return dict(counts=counts, tok_s=st.tokens_per_s, peak_gb=peak_gb, queue=queue,
                    outputs=result.outputs, decode_s=st.decode_s, decode_steps=st.decode_steps)

    tier_model, _ = _apply_pool_quality(model, quality)
    prefill = make_prefill_step(tier_model, p + gen, mem_len=p)
    decode = make_decode_step(tier_model)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.zeros((b, p), dtype=torch.int64, device="cuda"),
             "src_embeds": torch.randn((b, p, cfg.d_model), generator=g, device="cuda"),
             "src_pos": torch.arange(p, device="cuda").expand(b, p)}
    tok = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, _ = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        per_prefill = kernels.launch_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        decode(params, caches, tok, p)[0].cpu()
        decode_ms = (time.perf_counter() - t0) * 1e3
        per_decode = kernels.launch_counts()
        busy_ms, kernel_ms, wall_ms, reps = profile_fn(
            lambda: decode(params, caches, tok, p)[0].cpu(), 1, "decode step")
    kernels.reset_launch_counts()
    return dict(counts=counts, per_prefill=per_prefill, per_decode=per_decode,
                prefill_ms=prefill_ms, decode_ms=decode_ms, tok_s=st.tokens_per_s,
                peak_gb=peak_gb, busy_share=busy_ms / wall_ms if busy_ms else None,
                queue=queue, outputs=result.outputs, decode_s=st.decode_s,
                decode_steps=st.decode_steps)


def phase_long_prompt(label: str, params, model) -> dict:
    """Batch 1: a prompt of ``LONG_PROMPT`` seeded tokens prefilled, then
    ``LONG_STEPS`` teacher-forced decode steps, against one forward over all
    ``LONG_PROMPT + LONG_STEPS`` tokens: wherever the full forward's top-2
    logit gap is at least ``STREAM_MARGIN``, the step's argmax must be the
    full forward's.  Prints the largest |logit difference|."""
    import torch

    from repro_torch import kernels
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    total = LONG_PROMPT + LONG_STEPS
    toks = torch.randint(0, model.cfg.vocab_size, (1, total),
                         generator=torch.Generator().manual_seed(5)).cuda()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        hidden, _, _ = model.forward(params, toks, torch.arange(total, device="cuda")[None],
                                     model.ctx())
        # the logits at the positions the prefill and the decode steps predict from
        want = model.lm_head(params, hidden[:, LONG_PROMPT - 1:])[0]
        del hidden
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        caches, first = make_prefill_step(model, total)(params, {"tokens": toks[:, :LONG_PROMPT]})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        got, decode = [first[0, -1]], make_decode_step(model)
        t0 = time.perf_counter()
        for i in range(LONG_STEPS):
            logits, caches = decode(params, caches, toks[:, LONG_PROMPT + i:LONG_PROMPT + i + 1],
                                    LONG_PROMPT + i)
            got.append(logits[0, -1])
        got = torch.stack(got)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if model.cfg.attn_impl == "pallas":
        check(counts["flash_attention"] > 0 and counts["flash_decode"] > 0,
              f"long prompt {label}: launches {counts}")
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          f"long prompt {label}: non-finite logits")
    top2 = torch.topk(want, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    held = [i for i, g in enumerate(gaps) if g >= STREAM_MARGIN]
    bad = [i for i in held if not same[i]]
    check(not bad, f"long prompt {label}: argmax differs from the full forward at steps {bad} "
                   f"(top-2 gaps {[round(gaps[i], 4) for i in bad]})")
    err = (got - want).abs().max().item()
    print(f"long prompt {label}: prompt {LONG_PROMPT} prefilled ({prefill_s:.2f}s) and "
          f"{LONG_STEPS} teacher-forced decode steps ({1e3 * decode_s / LONG_STEPS:.2f} ms a "
          f"step) against one forward over {total} tokens ({full_s:.2f}s): argmax equal at "
          f"{sum(same)} of {len(same)} positions, held at the {len(held)} with a top-2 gap >= "
          f"{STREAM_MARGIN} (gaps {[round(g, 4) for g in gaps]}); max |logit diff| {err:.3e}; "
          f"launches { {k: c for k, c in counts.items() if c} }", flush=True)
    return dict(counts=counts, max_abs_logit_diff=err, held=len(held))


def report_experts(label: str, cfg, by_tokens: dict) -> dict:
    """Print what ``moe_counters`` counted over one serve run: the kernel
    launches inside the expert GEMMs per decode step (a forward over one
    token per pool row) and the share of routed assignments that capacity
    dropped, in decode steps and over the whole run."""
    dec = by_tokens.get(SERVE["batch"])
    check(dec is not None and dec["layers"] > 0, f"{label}: no decode step was routed")
    steps = dec["layers"] / cfg.num_layers
    total = sum(e["assignments"] for e in by_tokens.values())
    dropped = sum(int(e["dropped"]) for e in by_tokens.values())
    row = dict(expert_launches_per_decode_step=dec["launches"] / steps,
               decode_dropped_share=int(dec["dropped"]) / dec["assignments"],
               dropped_share=dropped / total, assignments=total)
    check(0 <= dropped <= total, f"{label}: dropped {dropped} of {total}")
    print(f"serve {label}: experts: {row['expert_launches_per_decode_step']:.1f} kernel "
          f"launches in the expert GEMMs per decode step ({steps:.0f} decode steps routed); "
          f"dropped by capacity {int(dec['dropped'])} of {dec['assignments']} decode "
          f"assignments ({row['decode_dropped_share']:.4f}), {dropped} of {total} in the run "
          f"({row['dropped_share']:.4f}); tokens per routed forward "
          f"{sorted(by_tokens)}", flush=True)
    return row


def hold_streams(label: str, queue, got: dict, want: dict, model, params) -> str:
    """The margin rule: ``got``'s stream of each request must equal ``want``'s
    up to the request's first greedy step whose top-2 gap is under
    ``STREAM_MARGIN``; past it, agreement is reported, not required."""
    import numpy as np

    from repro_torch.serve.soak import teacher_gaps

    equal, after_tie = 0, []
    for r in queue:
        a, b = np.asarray(got[r.id]), np.asarray(want[r.id])
        check(len(a) == len(b), f"{label}: request {r.id} has {len(a)} tokens, want {len(b)}")
        if np.array_equal(a, b):
            equal += 1
            continue
        j = int(np.flatnonzero(a != b)[0])
        gaps = teacher_gaps(model, params, r, b)
        tie = next((i for i, g in enumerate(gaps) if g < STREAM_MARGIN), None)
        check(tie is not None and tie <= j,
              f"{label}: request {r.id} diverged at step {j} before any near tie "
              f"(top-2 gaps {[round(g, 4) for g in gaps[:j + 1]]})")
        after_tie.append(f"{r.id}@{j} (gap {gaps[tie]:.4f} at step {tie})")
    return (f"streams equal {equal} of {len(queue)}"
            + (f", diverged after a near tie (margin {STREAM_MARGIN}): {', '.join(after_tie)}"
               if after_tie else ""))


def phase_serve_speculative(label: str, params, greedy: dict, *, expect: tuple,
                            draft_run: dict = None) -> dict:
    """``SelfSpeculative(k=SPEC_K, draft_tier="draft")`` on the exact pool of
    ``greedy``'s run, over its queue; the streams held against greedy's.
    Launches per round are counted around each decode round.  With
    ``draft_run`` (the plain draft pool's run on the same queue), also the
    degenerate pair draft = verify = exact over the first batch, whose
    proposals the verify forward recomputes, and the share of first tokens
    the draft pool and the exact pool agree on."""
    import collections

    import torch

    from repro_torch import kernels
    from repro_torch.serve import ContinuousScheduler, SelfSpeculative

    queue = greedy["queue"]
    shape = dict(batch_size=SERVE["batch"], prompt_len=SERVE["prompt"], max_new=SERVE["gen"],
                 quality="exact")
    sched = ContinuousScheduler(greedy["model"], params, **shape,
                                strategy=SelfSpeculative(k=SPEC_K, draft_tier="draft"))
    in_rounds, rounds = collections.Counter(), [0]
    decode_round = sched.strategy.decode_round

    def counted_round(*args, **kw):
        before = kernels.launch_counts()
        rr = decode_round(*args, **kw)
        after = kernels.launch_counts()
        in_rounds.update({k: after[k] - before[k] for k in after})
        rounds[0] += 1
        return rr

    sched.strategy.decode_round = counted_round
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = sched.run(queue)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st, acc = result.stats, result.accounting
    for name in expect:
        check(counts[name] > 0, f"{label}: {name} was never launched ({counts})")
    check(st.requests == len(queue) and acc.slot_leaks == 0 and acc.position_violations == 0,
          f"{label}: served {st.requests} of {len(queue)}, accounting {acc}")
    check(st.spec_rounds == rounds[0] and st.spec_proposed == sum(
        r.proposed for r in result.request_stats),
          f"{label}: speculated rounds {st.spec_rounds} of {rounds[0]}, proposed "
          f"{st.spec_proposed}")
    agree = hold_streams(label, queue, result.outputs, greedy["outputs"], sched.model, params)
    per_round = {k: v / rounds[0] for k, v in in_rounds.items() if v}
    extra = ""
    if draft_run is not None:
        first = queue[:SERVE["batch"]]
        same = ContinuousScheduler(greedy["model"], params, **shape,
                                   strategy=SelfSpeculative(k=SPEC_K, draft_tier="exact"))
        deg = same.run(first)
        torch.cuda.synchronize()
        deg_agree = hold_streams(f"{label} draft=exact", first, deg.outputs,
                                 greedy["outputs"], sched.model, params)
        firsts = sum(int(draft_run["outputs"][r.id][0] == greedy["outputs"][r.id][0])
                     for r in queue)
        extra = (f"; degenerate pair draft = verify = exact over {len(first)} requests: "
                 f"accept {deg.stats.spec_accepted}/{deg.stats.spec_proposed}, {deg_agree}; "
                 f"the draft pool's first token equals the exact pool's in {firsts} of "
                 f"{len(queue)} requests")
    print(f"serve {label}: {st.summary()}; k={SPEC_K} draft tier draft, verify exact: accept "
          f"{st.spec_accepted}/{st.spec_proposed} = {st.accept_rate:.4f} over {st.spec_rounds} "
          f"rounds, {st.decode_steps} forwards, modeled cost {st.modeled_cost:.2f} (greedy "
          f"{greedy['modeled_cost']:.2f}), {st.tokens_per_s:.2f} tok/s (greedy "
          f"{greedy['tok_s']:.2f}); launches {counts} (warmup included), per round "
          f"{per_round}; {agree}; run incl. warmup {wall:.2f}s{extra}", flush=True)
    return dict(counts=counts, per_round=per_round, accept_rate=st.accept_rate,
                tok_s=st.tokens_per_s)


def phase_serve_open(params, model) -> dict:
    """The open loop at full width: the ``bursty`` preset, virtual clock,
    ``SLOAdaptive`` on its default ladder (high, balanced, draft).  No
    request has an EOS, so the schedule does not depend on the model: the
    switch sequence and every request's ``queue_delay_s`` and ``ttft_s``
    must equal those of reduced qwen3-0.6b on the CPU, run here too."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousScheduler, SLOAdaptive
    from repro_torch.serve.workload import generate, preset_spec

    spec = preset_spec("bursty", requests=2 * SERVE["requests"], prompt_len=SERVE["prompt"],
                       max_new=SERVE["gen"], vocab_size=model.cfg.vocab_size,
                       slo_ttft_s=OPEN_SLO_TTFT_MS / 1e3)
    draw = generate(spec, seed=0)
    run = dict(arrivals_s=list(draw.arrivals_s), step_time_s=0.01, clock="virtual")
    shape = dict(batch_size=SERVE["batch"], prompt_len=SERVE["prompt"], max_new=SERVE["gen"],
                 quality="high")
    sched = ContinuousScheduler(model, params, **shape)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = sched.run(list(draw.requests), policy=SLOAdaptive(slo_ttft_s=spec.slo_ttft_s),
                       **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    small = build_model(get_config("qwen3-0.6b").reduced())
    cpu = ContinuousScheduler(small, small.init_params(0, device="cpu"), **shape).run(
        [dataclasses.replace(r, tokens=r.tokens % small.cfg.vocab_size) for r in draw.requests],
        policy=SLOAdaptive(slo_ttft_s=spec.slo_ttft_s), **run)
    st = result.stats
    switches = [(w.step, w.now_s, w.from_tier, w.to_tier, w.reason)
                for w in result.tier_switches]
    check(switches == [(w.step, w.now_s, w.from_tier, w.to_tier, w.reason)
                       for w in cpu.tier_switches],
          f"open loop: switches {switches} on the card, {cpu.tier_switches} on the CPU")
    check(len(switches) >= 1, "open loop: the policy never switched tiers")
    timing = lambda res: sorted((r.id, r.queue_delay_s, r.ttft_s, r.tier_served)
                                for r in res.request_stats)
    check(timing(result) == timing(cpu), "open loop: per-request queue delays differ from the "
                                         "CPU run's")
    check(st.requests == len(draw.requests) and st.starved == 0
          and result.accounting.slot_leaks == 0, f"open loop: {st}")
    for name in ("lut_matmul", "packed_matmul"):
        check(counts[name] > 0, f"open loop: {name} was never launched ({counts})")
    print(f"serve open slo-adaptive: bursty preset, {len(draw.requests)} requests offered at "
          f"{draw.offered_rps:.1f} rps (virtual clock, step 10 ms, TTFT SLO "
          f"{OPEN_SLO_TTFT_MS:.0f} ms): {st.summary()}; switches {switches}, equal to the CPU "
          f"run's with every request's queue_delay_s and ttft_s; launches {counts}; run incl. "
          f"warmup {wall:.2f}s", flush=True)
    return dict(counts=counts, switches=len(switches))


def phase_serve_static(params, model) -> dict:
    """The static-batch loop at ``exact`` on 16 prompts of the bucket's
    length (every row then sits at its true positions), held against the
    continuous scheduler on the same queue by the margin rule."""
    import torch

    from repro_torch import kernels
    from repro_torch.serve import ContinuousScheduler, static_serve_loop, synth_requests

    queue = synth_requests(SERVE["requests"], prompt_len=SERVE["prompt"], gen=SERVE["gen"],
                           vocab_size=model.cfg.vocab_size, seed=1,
                           min_prompt=SERVE["prompt"], vary_budget=False)
    shape = dict(batch_size=SERVE["batch"], prompt_len=SERVE["prompt"])
    cont = ContinuousScheduler(model, params, max_new=SERVE["gen"], **shape).run(queue)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = static_serve_loop(model, params, queue, gen=SERVE["gen"], **shape)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(not any(counts.values()), f"serve static: a kernel ran at exact ({counts})")
    st = result.stats
    check(st.requests == len(queue) and st.tokens_out == len(queue) * SERVE["gen"],
          f"serve static: {st}")
    agree = hold_streams("serve static", queue, result.outputs, cont.outputs, model, params)
    print(f"serve static: {st.summary()}; {st.decode_steps} decode steps (continuous "
          f"{cont.stats.decode_steps}, {cont.stats.tokens_per_s:.2f} tok/s); against the "
          f"continuous scheduler: {agree}; run incl. warmup {wall:.2f}s", flush=True)
    return dict(tok_s=st.tokens_per_s)


def phase_soak(params, model) -> dict:
    """``run_soak`` at full width: the ``steady`` preset, 64 requests in
    windows of 32, two parity spot-checks (each re-served alone, unpadded,
    through the static loop, bit-equal)."""
    import torch

    from repro_torch.serve.soak import run_soak
    from repro_torch.serve.workload import preset_spec

    spec = preset_spec("steady", requests=4 * SERVE["requests"], prompt_len=SERVE["prompt"],
                       max_new=SERVE["gen"], vocab_size=model.cfg.vocab_size)
    t0 = time.perf_counter()
    report = run_soak(model, params, spec, batch_size=SERVE["batch"], seed=0, window_size=32,
                      spot_check=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = report.summary_row()
    check(report.ok and row["invariants_ok"] == 1.0, f"soak: {report.violations}")
    check(row["spot_checks"] == 2 and row["spot_check_failures"] == 0, f"soak: {row}")
    print(f"soak: {report.describe()}; {json.dumps(row)}; run {wall:.2f}s", flush=True)
    return row


def step_breakdown(label: str, sched, params, profile_reps: int, host: bool = False) -> dict:
    """One pool prefill and one decode step of the pool's engine, outside
    the main path's count window: launches of each kernel per step, the
    host-clock time of each step, and a profiler pass over
    ``profile_reps`` decode steps (none at 0) for the device's busy share
    and the kernels' share of it (with ``host``, the host's ops too: the
    host split of the tensor-parallel serves)."""
    import torch

    from repro_torch import kernels

    eng = sched.engine_for(None)
    b, p = sched.batch_size, sched.prompt_len
    toks = torch.zeros((b, p), dtype=torch.int64, device="cuda")
    pos = torch.arange(p, device="cuda").expand(b, p)
    tok1 = toks[:, :1]
    at = torch.full((b,), p, dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, _ = eng.prefill_pool(params, toks, pos)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        per_prefill = kernels.launch_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng.decode(params, caches, tok1, at, at)[0].cpu()
        decode_ms = (time.perf_counter() - t0) * 1e3
        per_decode = kernels.launch_counts()
        busy_ms, kernel_ms, wall_ms, reps = (
            profile_decode(eng, params, caches, tok1, at, profile_reps, host) if profile_reps
            else (0.0, 0.0, 0.0, 0))
    kernels.reset_launch_counts()
    share = (f"device busy {busy_ms / wall_ms:.3f} of {wall_ms / reps:.2f} ms/step, own "
             f"kernels {kernel_ms / max(busy_ms, 1e-9):.3f} of busy" if busy_ms else
             "device busy share not measured (" + (
                 "the profiler saw no device time)" if reps else "no profiled step)"))
    print(f"serve {label}: pool prefill (M={b * p}) {prefill_ms:.2f} ms, launches "
          f"{per_prefill}; decode step (M={b}) {decode_ms:.2f} ms, launches {per_decode}; "
          f"{share}", flush=True)
    return dict(per_prefill=per_prefill, per_decode=per_decode, prefill_ms=prefill_ms,
                decode_ms=decode_ms, busy_share=busy_ms / wall_ms if busy_ms else None,
                host_split=dict(HOST_SPLIT) if reps and host else None)


def profile_decode(eng, params, caches, tok, at, reps: int = 3, host: bool = False):
    return profile_fn(lambda: eng.decode(params, caches, tok, at, at)[0].cpu(), reps,
                      "decode step", host_ops=host)


# host ops of a profile: the collectives (c10d's record and ops), and the
# calls that wait for the device or copy (a device-to-host read waits)
COLLECTIVE_OPS = ("record_param_comms", "c10d::")
SYNC_OPS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
HOST_SPLIT: dict = {}  # the last profile's, a call: see profile_fn


def profile_totals(prof) -> tuple:
    """(host, device) of a finished ``torch.profiler.profile``: lists of
    (self µs, count, name), one a name, the numbers ``key_averages()``
    gives (``self_cpu_time_total`` of the host ops and runtime calls,
    ``self_device_time_total`` of the device's kernels, copies and sets),
    read from the raw events.  ``key_averages()`` builds a Python object an
    event first, about 80 µs each: 10 s for one balanced decode step."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    cpu = DeviceType.CPU
    host_nodes, device = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() != cpu:
            us, count = device.get(name, (0.0, 0))
            device[name] = (us + (0.0 if e.is_async() else e.duration_ns() / 1e3), count + 1)
            continue
        thread = e.start_thread_id()
        is_async = e.is_async() or thread != e.end_thread_id()
        # name, start, end, async, correlation, linked correlation, thread,
        # then parent and children
        host_nodes.append([name, e.start_ns(), e.end_ns(), is_async, e.correlation_id(),
                           e.linked_correlation_id(), thread, None, []])
    # a runtime call (a launch, a copy) belongs to the thread of the op it is linked to
    thread_of = {n[4]: n[6] for n in host_nodes if not n[3] and n[5] == 0}
    by_thread: dict = {}
    for n in host_nodes:
        if not n[3]:
            by_thread.setdefault(thread_of.get(n[5], n[6]), []).append(n)
    for events in by_thread.values():  # nest each thread's intervals, as key_averages does
        stack = []
        for n in sorted(events, key=lambda n: (n[1], -n[2])):
            while stack and (n[1] >= stack[-1][2] or n[2] > stack[-1][2]):
                stack.pop()
            if stack:
                n[7] = stack[-1]
                stack[-1][8].append(n)
            stack.append(n)
    dropped = set()
    fold = [n for n in host_nodes if n[7] is not None and n[7][0] == n[0]]
    while fold:  # an op's only child of its own name is folded into it
        again = []
        for n in fold:
            parent = n[7]
            if id(n) in dropped or len(parent[8]) != 1:
                again.append(n)
                continue
            parent[8] = n[8]
            for child in n[8]:
                child[7] = parent
            dropped.add(id(n))
        if len(again) == len(fold):
            break
        fold = again
    host: dict = {}
    for n in host_nodes:
        if id(n) in dropped:
            continue
        self_us = 0.0 if n[3] else (n[2] - n[1] - sum(c[2] - c[1] for c in n[8])) / 1e3
        us, count = host.get(n[0], (0.0, 0))
        host[n[0]] = (us + self_us, count + 1)
    return ([(us, c, _rewrite_name(k, with_wildcard=True)) for k, (us, c) in host.items()],
            [(us, c, _rewrite_name(k, with_wildcard=True)) for k, (us, c) in device.items()])


def profile_fn(fn, reps: int, what: str, *, host_ops: bool = False):
    """Device time over ``reps`` calls of ``fn``, which ends in a sync: (busy
    ms, ms in the port's kernels, host-clock ms, reps).  Busy is the sum of
    kernel times on the one stream the calls use.  ``host_ops``: the host's
    PyTorch ops are traced too (the CUDA runtime's calls and the device's
    work always are), and ``HOST_SPLIT`` then holds a call's host self
    time (ms) and count of the collectives and of the syncs and copies,
    and its wall ms (under the profiler).  Without them the trace holds a
    fraction of the events, which the profiler's stop and the read
    (``profile_totals``) go through one by one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        wall_ms = (t1 - t0) * 1e3
    t0 = time.perf_counter()
    host, device = profile_totals(prof)
    stop_s, read_s = t0 - t1, time.perf_counter() - t0
    busy_us = sum(us for us, _, _ in device)
    own = [ev for ev in device if any(f"{name}_kernel" in ev[2] for name in kernels.ALL)]
    kernel_us = sum(us for us, _, _ in own)
    launches = sum(c for _, c, k in host if k.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    for key, ops in (("collective", COLLECTIVE_OPS), ("sync", SYNC_OPS)):
        HOST_SPLIT[f"{key}_ms"] = sum(us for us, _, k in host if k.startswith(ops)) / 1e3 / reps
        HOST_SPLIT[f"{key}_calls"] = sum(c for _, c, k in host if k.startswith(ops)) // reps
    HOST_SPLIT["wall_ms"] = wall_ms / reps
    top = ", ".join(f"{k} {us / 1e3 / reps:.2f} ms x{c // reps}"
                    for us, c, k in sorted(host, reverse=True)[:6])
    traced = "host self time by op" if host_ops else (
        "host self time by CUDA runtime call (host ops not traced)")
    top_device = ", ".join(f"{k[:60]} {us / 1e3 / reps:.2f} ms x{c // reps}"
                           for us, c, k in sorted(device, reverse=True)[:5])
    own_device = ", ".join(f"{k[:70]} {us / 1e3 / reps:.4f} ms x{c // reps}"
                           for us, c, k in sorted(own, reverse=True)) or "none"
    print(f"profile: per {what} {launches / reps:.0f} launches through the CUDA runtime "
          f"seen; {traced}: {top}; in collectives {HOST_SPLIT['collective_ms']:.2f} "
          f"ms x{HOST_SPLIT['collective_calls']}, in syncs and copies "
          f"{HOST_SPLIT['sync_ms']:.2f} ms x{HOST_SPLIT['sync_calls']}, of "
          f"{HOST_SPLIT['wall_ms']:.2f} ms; device time by kernel: {top_device}; the "
          f"port's kernels: {own_device}; profiler stopped in {stop_s:.2f}s, its "
          f"{len(host) + len(device)} ops read in {read_s:.2f}s",
          flush=True)
    return busy_us / 1e3, kernel_us / 1e3, wall_ms, reps


# ---------------------------------------------------------- distribution
DRYRUN_CELLS = ("train_4k", "decode_32k")


def phase_distribution(params, model, base_runs: dict, n_req: int) -> dict:
    """The mesh path on one card (see the module's note, 5b): a one-rank
    NCCL group, qwen3-0.6b served under a ("data",) mesh against
    ``base_runs`` (tier -> the mesh=None run), the elastic save and
    restore of its train state, and the kimi-k2 dry-run."""
    import tempfile

    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.manager import (
        CheckpointManager, Placed, shard_train_state, state_leaves,
    )
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed.sharding import data_parallel_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HW, make_host_mesh, make_production_mesh
    from repro_torch.models.registry import reference_leaves
    from repro_torch.optim import adamw
    from repro_torch.serve import ContinuousScheduler
    from repro_torch.train.steps import TrainState, init_train_state

    card_line = nvidia_smi("name,power.limit")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = torch.distributed.FileStore(os.path.join(tmp, "store"), 1)
        torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            host = make_host_mesh()
            check(host.mesh_dim_names == ("data", "model") and tuple(host.mesh.shape) == (1, 1),
                  f"distribution: make_host_mesh() is {host}")
            check(data_parallel_mesh(4) is None, "distribution: data_parallel_mesh(4) on one rank")
            for bad in (make_production_mesh(), object()):
                try:
                    ContinuousScheduler(model, params, batch_size=SERVE["batch"],
                                        prompt_len=SERVE["prompt"], max_new=SERVE["gen"],
                                        mesh=bad)
                except ValueError:
                    continue
                raise SmokeFailure(f"distribution: mesh={bad!r} served without a process group")
            data = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
            print(f"distribution: one-rank NCCL group, host mesh {tuple(host.mesh.shape)} "
                  f"{host.mesh_dim_names}, data mesh {tuple(data.mesh.shape)}", flush=True)

            # serve under the mesh: streams bit-equal to mesh=None's in this call
            for tier, kernel in (("exact", None), ("balanced", "lut_matmul"),
                                 ("draft", "packed_matmul")):
                base = base_runs[tier]
                run = phase_serve(f"mesh {tier}", params, model, quality=tier,
                                  expect=(kernel,) if kernel else (), requests=n_req,
                                  forbid=() if kernel else tuple(base["counts"]), mesh=data)
                for r in run["queue"]:
                    check(np.array_equal(run["outputs"][r.id], base["outputs"][r.id]),
                          f"distribution: mesh {tier}: request {r.id} streams differ from "
                          f"mesh=None's")
                print(f"distribution: serve {tier} under the mesh: streams bit-equal to "
                      f"mesh=None over {len(run['queue'])} requests; decode step "
                      f"{run['decode_ms']:.2f} ms (mesh=None {base['decode_ms']:.2f}), "
                      f"launches a step {run['per_decode']} (mesh=None {base['per_decode']}), "
                      f"busy {run['busy_share']} (mesh=None {base['busy_share']}), tok/s "
                      f"{run['tok_s']:.2f} (mesh=None {base['tok_s']:.2f}); {card_line}",
                      flush=True)
                out[tier] = run

            # the elastic save and restore of the full-width train state
            tcfg = TrainConfig()
            state = init_train_state(model, tcfg, 0, device="cuda")
            g = torch.Generator(device="cuda").manual_seed(1)
            for m in state.opt.mu + state.opt.nu:
                m.normal_(generator=g)
            sharded = shard_train_state(state, host)
            mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(1, sharded, blocking=True)
            save_s = time.perf_counter() - t0
            nbytes = os.path.getsize(mgr._path(1))
            card_target = shard_train_state(init_train_state(model, tcfg, 1, device="cuda"),
                                            host)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.restore(card_target)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            cpu_params = model.init_params(0, device="meta").to_empty(device="cpu")
            cpu_target = TrainState(cpu_params, adamw.init(
                reference_leaves(cpu_params), dict(cpu_params.named_parameters()), tcfg),
                None, 0, torch.zeros((), dtype=torch.int64))
            t0 = time.perf_counter()
            mgr.restore(cpu_target)
            cpu_s = time.perf_counter() - t0
            leaves = state_leaves(state)
            for want, on_card, on_cpu in zip(leaves, state_leaves(card_target),
                                             state_leaves(cpu_target)):
                got = on_card.local if isinstance(on_card, Placed) else on_card
                check(torch.equal(got.reshape(want.shape), want),
                      "distribution: restore onto the card is not bit-equal")
                check(torch.equal(on_cpu, want.cpu()),
                      "distribution: restore onto the CPU is not bit-equal")
            print(f"distribution: train state of {len(leaves)} leaves, {nbytes} bytes "
                  f"({nbytes / 1e9:.3f} GB): save {save_s:.2f} s, restore onto the card "
                  f"{card_s:.2f} s, onto the CPU {cpu_s:.2f} s, both bit-equal; {card_line}",
                  flush=True)
            out["checkpoint"] = dict(bytes=nbytes, save_s=save_s, restore_card_s=card_s,
                                     restore_cpu_s=cpu_s)
            del state, sharded, card_target, cpu_target, cpu_params
            torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()

    # the dry-run: kimi-k2-1t-a32b at its published widths on the 16 x 16 pod
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    t0 = time.perf_counter()
    for cell in DRYRUN_CELLS:
        # sizing only: the step's FLOPs and bytes (launch/hlo_analysis.py) are
        # counted by the dry-run CLI, which takes seconds a cell more
        rec = dryrun.size_cell("kimi-k2-1t-a32b", cell, False, steps=False)
        b = rec["per_device_bytes"]
        print(f"distribution: dry-run kimi-k2-1t-a32b {cell} on {rec['chips']} devices "
              f"(16 x 16): per device {rec['per_device_gb']:.3f} GB (params "
              f"{b['params'] / 1e9:.3f}, moments {b['opt'] / 1e9:.3f}, caches "
              f"{b['caches'] / 1e9:.3f}, batch {b['batch'] / 1e9:.6f}) against this card's "
              f"{card_gb:.2f} GB ({'fits' if rec['per_device_gb'] < card_gb else 'does not fit'}"
              f"); compute {rec['terms_s']['compute']:.4f} s, memory "
              f"{rec['terms_s']['memory']:.4f} s at {HW.NAME}'s rates; step FLOPs and bytes "
              f"not counted here, collective bytes absent", flush=True)
        out[f"dryrun {cell}"] = rec
    host_s = time.perf_counter() - t0
    check(host_s < 10.0, f"distribution: the dry-run took {host_s:.1f} s of host time")
    print(f"distribution: dry-run host time {host_s:.2f} s", flush=True)
    return out


# ---------------------------------------------------- tensor parallelism
TP_SHARDS = (2, 4)  # the model-axis sizes whose K shards the epilogues are held at
TP_GEMMS = {"w2": (3072, 1024), "wo": (2048, 1024)}  # qwen3-0.6b's row-parallel (K, N)
TP_ROWS = (SERVE["batch"], SERVE["batch"] * SERVE["prompt"])  # M = 4 and 128
TP_EPILOGUES = (("lut_matmul", 8), ("packed_matmul", 8), ("seqmul_matmul", 12))
TP_DECODES = (("qwen3 g=2", dict(h=16, kv=8, hd=128), None),
              ("recurrentgemma g=10", RECURRENTGEMMA_HEADS, RECURRENTGEMMA_WINDOW))
TP_SERVE_KERNELS = {"balanced": ("lut_matmul",),
                    "pallas exact": ("flash_attention", "flash_decode"),
                    # the approximate attention at prefill under a model axis
                    "pallas lowrank mlp+attn": ("lowrank_matmul", "approx_attention_lowrank",
                                                "flash_decode")}
TP_TRAIN_STEPS = 2


def tp_gemm(kernel: str, n: int, mx, sx, mw, sw, *, integer: bool, plain: bool = False):
    """One call of ``kernel`` (or its plain version) on quantized operands,
    as the engine's mode body makes it."""
    import torch

    from repro_torch.engine import artifacts
    from repro_torch.kernels import lut_matmul as lm, packed_matmul as pm, seqmul_matmul as sm

    mx, sx, mw, sw = (t.contiguous() for t in (mx, sx, mw, sw))  # a K shard's slices
    if kernel == "lut_matmul":
        lut = artifacts.product_lut_u16(n, max(1, n // 2), True, mx.device)
        fn = lm.lut_matmul_plain if plain else lm.lut_matmul
        return fn(lut, mx.to(torch.uint8), sx, mw.to(torch.uint8), sw, n=n, integer=integer)
    if kernel == "packed_matmul":
        pa = pm.pack_i16_pairs(mx * sx.to(torch.int32), dim=1)
        pb = pm.pack_i16_pairs(mw * sw.to(torch.int32), dim=0)
        return (pm.packed_matmul_plain if plain else pm.packed_matmul)(pa, pb, n=n,
                                                                      integer=integer)
    fn = sm.seqmul_matmul_plain if plain else sm.seqmul_matmul
    return fn(mx.to(torch.int16), sx, mw.to(torch.int16), sw, n=n, t=n // 2, integer=integer)


def tp_epilogues(card_line: str) -> dict:
    """Each integer epilogue at qwen3-0.6b's row-parallel shard shapes: the
    K shards' outputs, summed in int64 in rank order, equal the whole-K
    integer launch bit for bit (and its float32 launch equals their
    conversion); each shard's output equals its plain version; the integer
    and float32 epilogues timed at the main row (M = 128, w2 over two
    shards)."""
    import torch

    out = {}
    for kernel, n in TP_EPILOGUES:
        held = 0
        for weight, (k, n_cols) in TP_GEMMS.items():
            for m in TP_ROWS:
                _, _, mx, sx, mw, sw, _ = operands(m, k, n_cols, n, seed=7)
                whole = tp_gemm(kernel, n, mx, sx, mw, sw, integer=True)
                check(torch.equal(whole.to(torch.float32),
                                  tp_gemm(kernel, n, mx, sx, mw, sw, integer=False)),
                      f"tensor parallel: {kernel} {weight} M {m}: the integer epilogue's "
                      f"conversion differs from the float32 output")
                for shards in TP_SHARDS:
                    kl = k // shards
                    total = None
                    for r in range(shards):
                        ks = slice(r * kl, (r + 1) * kl)
                        part = tp_gemm(kernel, n, mx[:, ks], sx[:, ks], mw[ks], sw[ks],
                                       integer=True)
                        want = tp_gemm(kernel, n, mx[:, ks], sx[:, ks], mw[ks], sw[ks],
                                       integer=True, plain=True)
                        check(part.dtype == want.dtype and torch.equal(part, want),
                              f"tensor parallel: {kernel} {weight} M {m} shard {r} of {shards}: "
                              f"differs from its plain version")
                        total = part.to(torch.int64) if total is None else \
                            total + part.to(torch.int64)
                        held += 1
                    check(torch.equal(total, whole.to(torch.int64)),
                          f"tensor parallel: {kernel} {weight} M {m}: the {shards} shards' "
                          f"integer sums differ from the whole K's")
        k, n_cols = TP_GEMMS["w2"]
        kl = k // TP_SHARDS[0]
        _, _, mx, sx, mw, sw, _ = operands(TP_ROWS[-1], kl, n_cols, n, seed=8)
        ms = {integer: graph_ms(lambda: tp_gemm(kernel, n, mx, sx, mw, sw, integer=integer))
              for integer in (False, True)}
        print(f"tensor parallel: {kernel} n = {n}: {held} shard outputs at w2 (K 3,072) and wo "
              f"(K 2,048), M 4 and 128, over 2 and 4 shards, each equal to its plain version, "
              f"their int64 sums bit-equal to the whole K's; device ms at ({TP_ROWS[-1]}, {kl}, "
              f"{n_cols}): integer epilogue {ms[True]:.4f}, float32 {ms[False]:.4f}; "
              f"{card_line}", flush=True)
        out[kernel] = dict(int_epilogue_ms=ms[True], float_epilogue_ms=ms[False],
                           int_epilogue_shape=[TP_ROWS[-1], kl, n_cols])
    return out


def tp_decodes(card_line: str) -> dict:
    """The decode's ``(o, lse)`` over 2 and 4 slot ranges, combined in range
    order (``combine_ranges``), against the whole decode within the flash
    tolerance, at the serve shape and over 4,096 slots, g = 2 and g = 10;
    the decode with and without its lse timed."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    out = {}
    for label, heads, window in TP_DECODES:
        for t in (CACHE, 4096):
            g = torch.Generator(device="cuda").manual_seed(t)
            b, h, kv, hd = SERVE["batch"], heads["h"], heads["kv"], heads["hd"]
            q = torch.randn((b, h, hd), generator=g, device="cuda").to(torch.bfloat16)
            k, v = (torch.randn((b, t, kv, hd), generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            q_pos = torch.tensor([t - 1, t - 5, t // 2, 3], device="cuda", dtype=torch.int32)
            k_pos = torch.arange(t, device="cuda", dtype=torch.int32)[None].expand(b, t)
            k_pos = torch.where(k_pos <= q_pos[:, None], k_pos, -1).contiguous()
            kw = dict(window=window, softcap=None, scale=hd**-0.5)
            whole, whole_lse = fa.launch_decode(q, k, v, q_pos, k_pos, with_lse=True, **kw)
            check(torch.equal(whole, fa.launch_decode(q, k, v, q_pos, k_pos, **kw)),
                  f"tensor parallel: decode {label} over {t}: o moved with its lse written")
            _, plain_lse = fa.flash_decode_plain(q, k, v, q_pos, k_pos, with_lse=True, **kw)
            worst = 0.0
            for shards in TP_SHARDS:
                step = t // shards
                parts = [fa.launch_decode(q, k[:, r * step:(r + 1) * step].contiguous(),
                                          v[:, r * step:(r + 1) * step].contiguous(), q_pos,
                                          k_pos[:, r * step:(r + 1) * step].contiguous(),
                                          with_lse=True, **kw) for r in range(shards)]
                o, lse = fa.combine_ranges(torch.stack([p[0] for p in parts]),
                                           torch.stack([p[1] for p in parts]))
                err = float(((o - whole).abs() / (2e-5 + 2e-5 * whole.abs())).max())
                lerr = float(((lse - whole_lse).abs() / (2e-5 + 2e-5 * whole_lse.abs())).max())
                check(err <= 1.0 and lerr <= 1.0,
                      f"tensor parallel: decode {label} over {t} slots in {shards} ranges: "
                      f"err/limit {err:.3f} (o), {lerr:.3f} (lse)")
                worst = max(worst, err, lerr)
            lse_err = float(((whole_lse - plain_lse).abs() / (2e-5 + 2e-5 * plain_lse.abs())).max())
            check(lse_err <= 1.0, f"tensor parallel: decode {label} over {t}: lse err/limit "
                                  f"{lse_err:.3f} against the plain version")
            ms = {lse: graph_ms(lambda: fa.launch_decode(q, k, v, q_pos, k_pos, with_lse=lse,
                                                         **kw)) for lse in (False, True)}
            print(f"tensor parallel: decode {label} q ({b}, {h}, {hd}) over {t} slots"
                  f"{f' window {window}' if window else ''}: 2 and 4 ranges combined within "
                  f"rtol/atol 2e-5 of the whole (worst err/limit {worst:.3f}), lse err/limit "
                  f"{lse_err:.3f} against the plain version; device ms with lse {ms[True]:.4f}, "
                  f"without {ms[False]:.4f}; {card_line}", flush=True)
            out[f"{label} {t}"] = dict(lse_ms=ms[True], no_lse_ms=ms[False], err=worst)
    return out


# train runs (d)-(g), also run on the (1, 1) mesh (phase 5c) and held there
TP_FAMILY_TRAINS = ("granite-moe-1b-a400m", "mamba2-130m", "recurrentgemma-2b",
                    "seamless-m4t-large-v2")
# full-width serves also run on the (1, 1) mesh: (arch, the run's label in
# the wide serve phase, attn_impl="pallas"?)
TP_WIDE_SERVES = (("mamba2-130m", "exact", False), ("recurrentgemma-2b", "exact", False),
                  ("seamless-m4t-large-v2", "pallas exact", True))


def family_train(arch: str) -> tuple:
    """(label, config, the kernels each step must launch, the (wrapper,
    causal) attention calls the run must make) of train runs (d)-(g), as
    phase 6 runs them and phase 5c runs them again on the (1, 1) mesh."""
    from repro_torch.configs.registry import get_config

    bwd = ("flash_attention", *BWD_KERNELS)
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    if arch == "recurrentgemma-2b":
        cfg = dataclasses.replace(cfg, num_layers=RECURRENTGEMMA_TRAIN_LAYERS)
    return {
        "granite-moe-1b-a400m": ("(d) granite-moe-1b-a400m pallas", cfg, bwd, ()),
        "mamba2-130m": ("(e) mamba2-130m pallas", cfg, (), ()),
        "recurrentgemma-2b": (f"(f) recurrentgemma-2b pallas, {RECURRENTGEMMA_TRAIN_LAYERS} of "
                              f"26 layers", cfg, bwd, ()),
        "seamless-m4t-large-v2": ("(g) seamless-m4t-large-v2 pallas", cfg, bwd,
                                  (("flash_attention", False), ("flash_attention", True))),
    }[arch]


def tp_train(host, cfg, what: str, expect: tuple, *, profile: bool = False) -> dict:
    """``TP_TRAIN_STEPS`` full-width train steps of ``cfg`` through the
    sharded step on the one-rank (1, 1) mesh, from its seed-0 state on
    phase 6's data (an encoder-decoder's frames seeded as phase 6 seeds
    them), with PyTorch's deterministic algorithms on, as phase 6 runs the
    same config (the embedding's backward accumulates with atomics
    otherwise, which can move the second loss by 0.3% between two runs of
    one path): its losses and grad norms, the second step's ms and
    launches (each kernel of ``expect`` launched in every step), peak
    memory, and with ``profile`` the busy share of one more step.
    :func:`tp_train_check` holds them against phase 6's first steps."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.models.layers import fold_seed
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import init_train_state, make_train_step, shard_batch

    model = build_model(cfg)
    tcfg, data = train_setup(cfg, 0)
    b, seq = TRAIN["batch"], TRAIN["seq"]

    def batch_fn(i: int) -> dict:
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch(i).items()}
        if cfg.is_encdec:
            g = torch.Generator(device="cuda").manual_seed(fold_seed(1, i))
            batch["src_embeds"] = torch.randn((b, seq, cfg.d_model), generator=g, device="cuda")
        return shard_batch(batch, host)

    losses, norms, times, counts, busy, wall = [], [], [], [], None, None
    torch.cuda.reset_peak_memory_stats()
    with deterministic_algorithms():
        state = init_train_state(model, tcfg, 0, device="cuda", mesh=host)
        step = make_train_step(model, tcfg, mesh=host)
        for i in range(TP_TRAIN_STEPS + int(profile)):
            batch = batch_fn(i)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i < TP_TRAIN_STEPS:
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            else:  # one more, profiled
                busy, _, wall, _ = profile_fn(lambda: step(state, batch)[1]["loss"].item(), 1,
                                              f"train step {what}, mesh (1, 1)")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts.append({k: v for k, v in kernels.launch_counts().items() if v})
    check(np.all(np.isfinite(losses)), f"tensor parallel: train {what}: losses {losses}")
    for name in expect:
        missed = [i + 1 for i, c in enumerate(counts[:TP_TRAIN_STEPS]) if not c.get(name)]
        check(not missed, f"tensor parallel: train {what}: {name} not launched in steps "
                          f"{missed} ({counts})")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    torch.cuda.empty_cache()
    return dict(losses=losses, norms=norms, step_ms=times[1] * 1e3, per_step=counts[1],
                busy=busy / wall if busy else None, peak_gb=peak_gb)


def tp_train_check(tp: dict, base: dict, card_line: str, what: str) -> None:
    """The (1, 1) mesh's train steps (:func:`tp_train`) against phase 6's
    run of the same config, the same steps with ``mesh=None`` in this call
    and under the same deterministic setting: the losses within rtol 1e-5;
    the equality of losses and grad norms, step ms, launches a step and
    busy share beside each other."""
    import numpy as np

    want, norms = base["losses"][:TP_TRAIN_STEPS], base["norms"][:TP_TRAIN_STEPS]
    check(np.allclose(tp["losses"], want, rtol=1e-5, atol=0),
          f"tensor parallel: train {what}: losses {tp['losses']} against mesh=None's {want}")
    per_step = {k: v for k, v in base["per_step"].items() if v}
    print(f"tensor parallel: train {what}, batch {TRAIN['batch']} x {TRAIN['seq']}: losses "
          f"{tp['losses']} (grad norms {tp['norms']}) on the (1, 1) mesh, {want} ({norms}) "
          f"with mesh=None (equal: losses {tp['losses'] == want}, grad norms "
          f"{tp['norms'] == norms}); step {tp['step_ms']:.1f} ms (mesh=None "
          f"{base['step_ms']:.1f}, the run's median), launches a step {tp['per_step']} "
          f"(mesh=None {per_step}), busy {tp['busy']} (mesh=None {base['busy_share']}), peak "
          f"device memory {tp['peak_gb']:.2f} GB; {card_line}", flush=True)


def tp_wide_check(tp: dict, base: dict, arch: str, label: str, card_line: str) -> None:
    """A full-width serve on the (1, 1) mesh (phase 5c) against the serve
    phase's ``mesh=None`` run of the same requests: streams bit-equal."""
    import numpy as np

    check([r.id for r in tp["queue"]] == [r.id for r in base["queue"]],
          f"tensor parallel: serve {arch} {label}: another queue than mesh=None's")
    for r in tp["queue"]:
        check(np.array_equal(tp["outputs"][r.id], base["outputs"][r.id]),
              f"tensor parallel: serve {arch} {label}: request {r.id} streams differ from "
              f"mesh=None's")
    print(f"tensor parallel: serve {arch} {label} on the (1, 1) mesh: streams bit-equal to "
          f"mesh=None's run in the serve phase over {len(tp['queue'])} requests of "
          f"{SERVE['gen']} tokens; {tp['tok_s']:.2f} tok/s (mesh=None {base['tok_s']:.2f}), "
          f"launches {tp['launched']} (mesh=None "
          f"{ {k: c for k, c in base['counts'].items() if c} }); {card_line}", flush=True)


def phase_tensor_parallel(card_line: str, base_runs: dict) -> dict:
    """Tensor parallelism on one card (see the module's note, 5c): the
    integer epilogues at the row-parallel shard shapes, the decode's
    per-range (o, lse), and the TP code on a one-rank NCCL (1, 1) mesh:
    two train steps of qwen3-0.6b and of train runs (d)-(g) (held against
    phase 6 by :func:`tp_train_check`), qwen3-0.6b's serves of
    ``base_runs`` (label -> (the serve phase's ``mesh=None`` run of the
    same requests, the run's tier or mode)) held here, and the full-width
    serves of ``TP_WIDE_SERVES`` (held after the wide serve phase by
    :func:`tp_wide_check`)."""
    import tempfile

    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import kernels
    from repro_torch.analysis import audit
    from repro_torch.configs.registry import apply_approx, get_config
    from repro_torch.kernels.build import audit_gate
    from repro_torch.models.registry import build_model

    def split(run) -> str:
        h = run["host_split"]
        return (f"in collectives {h['collective_ms']:.2f} ms x{h['collective_calls']}, in syncs "
                f"and copies {h['sync_ms']:.2f} ms x{h['sync_calls']}, of {h['wall_ms']:.2f} ms")

    os.environ[GATE] = "1"
    audit.GATE_CHECKS.clear()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = dict(epilogues=tp_epilogues(card_line))
    print(f"tensor parallel: epilogues {time.perf_counter() - t0:.1f}s", flush=True)
    report_gate("tensor parallel: epilogues", kernels.launch_counts())
    try:
        audit_gate("engine.matmul", "row:seqmul", 13, 6, shards=2)
    except audit.CertificationError:
        print("gate: the row-parallel seqmul route at n = 13 refused", flush=True)
    else:
        raise SmokeFailure("gate: the row-parallel seqmul route at n = 13 was certified")
    del os.environ[GATE]
    t0 = time.perf_counter()
    out["decodes"] = tp_decodes(card_line)
    print(f"tensor parallel: decodes {time.perf_counter() - t0:.1f}s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        store = torch.distributed.FileStore(os.path.join(tmp, "store"), 1)
        torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            host = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            t0 = time.perf_counter()
            qwen3 = get_config("qwen3-0.6b")
            bitexact = apply_approx(dataclasses.replace(qwen3, attn_impl="pallas"),
                                    mode="bitexact", n=8, t=4, targets=("mlp", "attn"))
            out["train"] = tp_train(host, bitexact, "qwen3-0.6b bitexact mlp+attn pallas",
                                    ("lut_matmul", "approx_attention_bitexact", *BWD_KERNELS),
                                    profile=True)
            print(f"tensor parallel: train qwen3-0.6b {time.perf_counter() - t0:.1f}s",
                  flush=True)
            out["trains"] = {}
            for arch in TP_FAMILY_TRAINS:
                t0 = time.perf_counter()
                label, cfg, expect, _ = family_train(arch)
                out["trains"][arch] = tp_train(host, cfg, label, expect)
                print(f"tensor parallel: train {label} {time.perf_counter() - t0:.1f}s",
                      flush=True)
            out["serve"] = {}

            def count(run):
                for name, c in run["counts"].items():
                    if c:
                        out["serve"][name] = out["serve"].get(name, 0) + c

            for label, (base, tier) in base_runs.items():
                t0 = time.perf_counter()
                attn = "pallas" if label.startswith("pallas") else "xla"
                model = build_model(dataclasses.replace(qwen3, attn_impl=attn))
                params = model.init_params(0, device="cuda", mesh=host)
                tp = phase_serve(f"tensor parallel {label}, mesh (1, 1)", params, model,
                                 expect=TP_SERVE_KERNELS[label], requests=QWEN3_REQUESTS,
                                 mesh=host, host_profile=True, **tier)
                del params
                torch.cuda.empty_cache()
                for r in tp["queue"]:
                    check(np.array_equal(tp["outputs"][r.id], base["outputs"][r.id]),
                          f"tensor parallel: serve {label}: request {r.id} streams differ from "
                          f"mesh=None's")
                print(f"tensor parallel: serve {label} on the (1, 1) mesh: streams bit-equal to "
                      f"mesh=None's run in the serve phase over {len(tp['queue'])} requests of "
                      f"{SERVE['gen']} tokens; "
                      f"decode step {tp['decode_ms']:.2f} ms (mesh=None {base['decode_ms']:.2f}), "
                      f"pool prefill {tp['prefill_ms']:.2f} ms (mesh=None "
                      f"{base['prefill_ms']:.2f}), launches a step {tp['per_decode']} (mesh=None "
                      f"{base['per_decode']}), busy {tp['busy_share']} (mesh=None "
                      f"{base['busy_share']}); the profiled decode step's host self time "
                      f"{split(tp)} (mesh=None {split(base)}); {time.perf_counter() - t0:.1f}s "
                      f"wall; {card_line}", flush=True)
                count(tp)
            # full-width families on the mesh: streams held after the wide serves
            out["wide"] = {}
            for arch, label, use_pallas in TP_WIDE_SERVES:
                t0 = time.perf_counter()
                cfg = get_config(arch)
                model = build_model(dataclasses.replace(cfg, attn_impl="pallas") if use_pallas
                                    else cfg)
                params = model.init_params(0, device="cuda", mesh=host)
                what = f"tensor parallel {arch} {label}, mesh (1, 1)"
                if cfg.is_encdec:
                    run = phase_serve_static_encdec(
                        what, params, model, quality="exact", requests=WIDE_REQUESTS,
                        expect=("flash_attention", "flash_decode"), forbid=GEMM_KERNELS,
                        mesh=host)
                else:
                    run = phase_serve(what, params, model, quality="exact",
                                      forbid=tuple(kernels.ALL), requests=WIDE_REQUESTS,
                                      full_length=True, profile_reps=0, mesh=host)
                del params
                torch.cuda.empty_cache()
                run["launched"] = {k: c for k, c in run["counts"].items() if c}
                out["wide"][arch] = run
                count(run)
                print(f"tensor parallel: serve {arch} {label} {time.perf_counter() - t0:.1f}s",
                      flush=True)
        finally:
            torch.distributed.destroy_process_group()
    return out


# ---------------------------------------------------------------- train
def train_setup(cfg, seed: int) -> tuple:
    """(TrainConfig, SyntheticLM) of a full-width train run: the TrainConfig
    the reference's train CLI makes for ``--steps TRAIN["steps"]``, and its
    data stream."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    n = TRAIN["steps"]
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=n, warmup_steps=max(10, n // 20),
                       seed=seed)
    return tcfg, SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                                        global_batch=TRAIN["batch"], seed=seed))


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True):
    """Within, PyTorch's deterministic algorithms (``warn_only``) when
    ``on``, without their fill of each new tensor (a kernel a tensor, which
    the step's results do not depend on)."""
    import torch

    import torch.utils.deterministic as det

    fill = det.fill_uninitialized_memory
    if on:
        torch.use_deterministic_algorithms(True, warn_only=True)
        det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        if on:
            torch.use_deterministic_algorithms(False)
            det.fill_uninitialized_memory = fill


def phase_train(label: str, model, *, expect: tuple, seed: int = 0, calls: tuple = (),
                deterministic: bool = False) -> dict:
    """``TRAIN["steps"]`` steps of ``make_train_step`` through ``run_loop`` at
    full width from seed-0 weights and ``SyntheticLM`` data (an
    encoder-decoder also fed ``src_embeds`` of ``TRAIN["seq"]`` standard
    normal frames, seeded per step as the train CLI seeds them): the loss
    must be finite and fall, every kernel in ``expect`` must launch in
    every step, and each ``(wrapper, causal)`` of ``calls`` must be called
    on the card.  Then one more step under the profiler for the device's
    busy share.  ``deterministic``: all of it under PyTorch's deterministic
    algorithms."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.models.layers import fold_seed
    from repro_torch.runtime.fault import run_loop
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = model.cfg
    b, seq, n = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    tcfg, data = train_setup(cfg, seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, tcfg, seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def batch_fn(step: int) -> dict:
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch(step).items()}
        if cfg.is_encdec:
            g = torch.Generator(device="cuda").manual_seed(fold_seed(seed + 1, step))
            batch["src_embeds"] = torch.randn((b, seq, cfg.d_model), generator=g, device="cuda")
        return batch

    step_fn = make_train_step(model, tcfg)
    times, step_counts = [], []

    def timed(state, batch):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        after = kernels.launch_counts()
        step_counts.append({k: after[k] - before[k] for k in after})
        return out

    kernels.reset_launch_counts()
    with attention_calls() as seen, deterministic_algorithms(deterministic):
        result = run_loop(state, timed, batch_fn, total_steps=n)
    counts = kernels.launch_counts()
    for key in calls:
        check(seen[key] > 0, f"train {label}: no {key} call on the card ({dict(seen)})")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in result.metrics_history]
    auxes = [h["aux"] for h in result.metrics_history]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(len(losses) == n and all(np.isfinite(losses + auxes)),
          f"train {label}: losses {losses}, aux {auxes}")
    check(last < first, f"train {label}: loss did not fall ({first} -> {last}): {losses}")
    for name in expect:
        missed = [i + 1 for i, c in enumerate(step_counts[:n]) if not c[name]]
        check(counts[name] > 0 and not missed,
              f"train {label}: {name} not launched in steps {missed} ({counts})")
    step_ms = float(np.median(times[1:])) * 1e3
    per_step = {k: v / n for k, v in counts.items() if v}
    with deterministic_algorithms(deterministic):
        busy_ms, kernel_ms, wall_ms, _ = profile_fn(lambda: timed(result.state, batch_fn(n)), 1,
                                                    "train step")
    share = (f"device busy {busy_ms / wall_ms:.3f} of {wall_ms:.1f} ms, own kernels "
             f"{kernel_ms / max(busy_ms, 1e-9):.3f} of busy" if busy_ms else
             "device busy share not measured (the profiler saw no device time)")
    depth = (f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder" if cfg.is_encdec
             else f"{cfg.num_layers}")
    print(f"train {label}: {depth} layers, d_model {cfg.d_model}, heads "
          f"{cfg.num_heads} / {cfg.num_kv_heads} of {cfg.head_dim}, vocab {cfg.vocab_size}, "
          f"{model.param_count(state.params) / 1e6:.1f}M params, {cfg.dtype}, remat "
          f"{cfg.remat}, batch {b} x seq {seq}, {n} steps "
          f"(init {init_s:.1f}s): loss {first:.4f} -> {last:.4f} (steps 1 and 2: "
          f"{losses[0]:.6f}, {losses[1]:.6f}"
          + (f"; ce and aux at step 1: {losses[0]:.6f}, {auxes[0]:.6f}, at step {n}: "
             f"{losses[-1]:.6f}, {auxes[-1]:.6f}" if cfg.num_experts else "")
          + f"); step {step_ms:.1f} ms "
          f"(first {times[0] * 1e3:.1f} ms), {b * seq / step_ms * 1e3:.0f} train tokens/s; "
          f"launches per step {per_step}; peak device memory {peak_gb:.2f} GB; {share}",
          flush=True)
    return dict(counts=counts, per_step=per_step, step_ms=step_ms, first=first, last=last,
                losses=losses, norms=[h["grad_norm"] for h in result.metrics_history],
                aux=auxes, busy_share=busy_ms / wall_ms if busy_ms else None)


def phase_train_reference(label: str, sides: tuple, *, expect: tuple = ()) -> None:
    """One train step's loss and gradients (``loss_fn`` and ``.backward()``,
    what ``make_train_step`` runs at ``grad_accum`` 1) of two (config,
    device) sides from the same seeded weights and batch: the loss within
    rtol 1e-5 and every gradient within 1e-4 * max|want| of the first side's
    (the CPU tests' tolerances against the JAX package; float32 sums run in
    another order on the card).  Every kernel in ``expect`` must launch on
    the second side and not on the first.  The first side is this check's
    reference, never a fallback."""
    import torch

    from repro_torch import kernels
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import loss_fn

    vocab = sides[0][0].vocab_size
    toks = torch.randint(0, vocab, (2, 33), generator=torch.Generator().manual_seed(5))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if sides[0][0].is_encdec:  # 24 frames for the encoder, 32 tokens for the decoder
        batch["src_embeds"] = torch.randn((2, 24, sides[0][0].d_model),
                                          generator=torch.Generator().manual_seed(6))
    results = []
    for cfg, device in sides:
        model = build_model(cfg)
        params = model.init_params(0, device="cpu")
        if results:
            check(all(torch.equal(p, q) for p, q in zip(params.parameters(), first)),
                  f"{label}: the two sides start from other parameters")
        first = [p.detach().clone() for p in params.parameters()]
        params = params.to(device)
        kernels.reset_launch_counts()
        loss, _ = loss_fn(params, {k: v.to(device) for k, v in batch.items()}, 0, model)
        loss.backward()
        results.append((loss.item(), {n: p.grad.cpu() for n, p in params.named_parameters()},
                        kernels.launch_counts()))
    (want_loss, want, plain_counts), (got_loss, got, counts) = results
    for name in expect:
        check(counts[name] > 0 and not plain_counts[name],
              f"{label}: {name} launches {counts[name]} (reference side: "
              f"{plain_counts[name]})")
    check(abs(got_loss - want_loss) <= 1e-5 * abs(want_loss),
          f"{label}: loss {got_loss} vs the reference side's {want_loss}")
    worst = 0.0
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        limit = 1e-4 * w.abs().max().item()
        check(err <= limit, f"{label}: {name} gradient max |err| {err} over {limit}")
        worst = max(worst, err / max(w.abs().max().item(), 1e-30))
    print(f"reference: {label}: loss {got_loss:.6f} vs {want_loss:.6f}, worst gradient "
          f"max |err| / max|want| {worst:.3e} over {len(want)} tensors (limits rtol 1e-5, "
          f"1e-4); launches { {n: counts[n] for n in expect} }", flush=True)


def start_train_cli():
    """Start the train CLI on the card in a process of its own: full-width
    paper-multiplier, a checkpoint every 4 steps and a failure injected at
    step 5 (``finish_train_cli`` holds what it printed).  It is killed at
    exit if it is still running."""
    import atexit
    import shutil

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    history = ROOT / "build" / "chip_smoke_train_history.json"
    shutil.rmtree(ckpt, ignore_errors=True)
    history.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "paper-multiplier",
           "--steps", str(TRAIN_CLI_STEPS), "--batch", "8", "--seq", "128", "--ckpt-dir", str(ckpt),
           "--ckpt-every", "4", "--inject-failures", "5", "--log-every", "2",
           "--out", str(history)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)})
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, t0, ckpt, history


def finish_train_cli(started) -> None:
    """Wait for ``start_train_cli``'s process: it must recover from the
    step-4 checkpoint and print its loss line."""
    import re
    import shutil

    proc, t0, ckpt, history = started
    try:
        out, err = proc.communicate(timeout=600)
        # the history holds one loss per step run, the repeated step 5 (after
        # the restore from step 4) included: its first is step 1, its last the final step
        losses = ([h["loss"] for h in json.loads(history.read_text())]
                  if proc.returncode == 0 else [])
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(ckpt, ignore_errors=True)
        history.unlink(missing_ok=True)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"train CLI exit {proc.returncode}: {err[-2000:]}")
    m = re.search(r"loss ([-\d.naif]+) -> ([-\d.naif]+)\s+failures=(\d+) restarts=(\d+)", out)
    check(m is not None, f"train CLI printed no loss line: {out[-2000:]}")
    a, b = float(m.group(1)), float(m.group(2))
    failures, restarts = int(m.group(3)), int(m.group(4))
    check("recovered from step 4" in out, f"train CLI did not recover from step 4: {out[-2000:]}")
    check(failures == 1 and restarts == 1 and all(map(math.isfinite, (a, b))),
          f"train CLI: {m.group(0)}")
    # a step between the restored checkpoint and the failure runs twice
    check(len(losses) >= TRAIN_CLI_STEPS and all(map(math.isfinite, losses)),
          f"train CLI losses {losses}")
    # the CLI's own "loss a -> b" is checked above but not printed: over 8
    # steps both of its ten-step means average the same steps
    lines = [ln for ln in out.splitlines() if ln.startswith(("arch=", "recovered"))]
    print(f"train CLI ({wall:.1f}s, beside the error analysis): " + " | ".join(lines)
          + f" | failures {failures} restarts {restarts} | loss of step 1 {losses[0]:.6f}, "
          f"of step {TRAIN_CLI_STEPS} {losses[-1]:.6f}", flush=True)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {pathlib.Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this script needs a GPU")

    # 1. environment
    card_line = nvidia_smi("name,power.limit")
    print(card_line, flush=True)
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} capability {cap[0]}.{cap[1]} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")
    card = Card()
    print(f"env: {card.sms} SMs at max {card.clock_hz / 1e9:.3f} GHz: int32 "
          f"{card.int32_ops_per_s / 1e12:.2f} Tops/s, shared-memory lookups "
          f"{card.lookups_per_s / 1e12:.2f} T/s, float32 "
          f"{card.f32_flops_per_s / 1e12:.2f} TFLOP/s", flush=True)

    # 2. build, with the static audit's matrix in a process of its own beside it
    from repro_torch import kernels
    from repro_torch.analysis import smem
    from repro_torch.kernels import build

    audit_run = start_audit()
    with phase("build"):
        t0 = time.perf_counter()
        seconds = {}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            built = pool.submit(build.build_all, seconds=seconds)
            warmed = warm_certificates()  # on the host while nvcc runs
            warm_s = time.perf_counter() - t0
            logs = built.result()
        each = ", ".join(f"{n} {s:.1f}s" for n, s in sorted(seconds.items(), key=lambda x: x[1]))
        print(f"build: {sorted(logs) or 'all cached'} in {time.perf_counter() - t0:.1f}s "
              f"({each or 'none built'}; nvcc {' '.join(build.NVCC_FLAGS)}); {warmed} certifier "
              f"verdicts for the armed phases in {warm_s:.1f}s beside it", flush=True)
        for name, log in sorted(logs.items()):
            report = smem.ptxas_report(log)
            for kernel, regs, spill_st, spill_ld, _ in report:
                print(f"build: {name}: {kernel}: {regs} registers, spill stores {spill_st} "
                      f"bytes, spill loads {spill_ld} bytes", flush=True)
            if name in WIDE_INSTANTIATIONS:
                # every instantiation at head width 256 (demangled or mangled) spills nothing
                wide = [r for r in report if re.search(r"[<,] ?256[,>]|Li256E", r[0])]
                check(len(wide) == WIDE_INSTANTIATIONS[name],
                      f"build: {name}: {len(wide)} head-width-256 instantiations in ptxas's "
                      f"log, expected {WIDE_INSTANTIATIONS[name]}")
                spilled = [r for r in wide if r[2:4] != (0, 0)]
                check(not spilled, f"build: {name}: spills at head width 256: {spilled}")
        sass_checks = (("flash_attention", ("flash_attention_kernel",), ("flash_decode_kernel",)),
                       ("flash_attention_bwd", ("bwd_dq_kernel", "bwd_dkv_kernel"), ()),
                       ("approx_attention", ("lowrank_kernel",), ("bitexact_kernel",)))
        with concurrent.futures.ThreadPoolExecutor(len(sass_checks)) as pool:
            found = list(pool.map(lambda c: tensor_core_instructions(*c), sass_checks))
        for (source, _, _), counts in zip(sass_checks, found):
            for kernel, count in sorted(counts.items()):
                print(f"build: {source} SASS: {kernel} HMMA/HGMMA/IMMA per instantiation {count}",
                      flush=True)

    # the CPU's exhaustive_eval(12, 6), which the error analysis holds the
    # card's against, beside the card's phases
    cpu_eval = start_cpu_eval()

    # 2b. the static certifier: its matrix, every built instantiation's
    # block, the plans as built, one exact decode step's FLOPs and bytes
    from repro_torch.analysis import audit

    with phase("analysis"):
        decode_counts = phase_analysis(card, audit_run)

    # 3. kernels, under the armed dispatch gate
    os.environ[GATE] = "1"
    audit.GATE_CHECKS.clear()
    kernels.reset_launch_counts()
    with phase("kernels: GEMMs"):
        rows = phase_kernels(card)
    with phase("kernels: attention"):
        rows += phase_attention(card)
    with phase("kernels: backward"):
        rows += phase_backward(card)
    with phase("kernels: elementwise"):
        rows += phase_elementwise(card)
    report_gate("kernels", kernels.launch_counts())
    gate_refuses()
    del os.environ[GATE]
    kernels.reset_launch_counts()

    # 4. reference
    from repro_torch.configs.registry import apply_approx, get_config
    from repro_torch.models.registry import build_model

    with phase("reference"):
        phase_reference()
        # reduced qwen3-0.6b, bitexact mlp+attn, pallas: the card against the CPU
        qwen3 = apply_approx(get_config("qwen3-0.6b").reduced(attn_impl="pallas"),
                             mode="bitexact", n=8, t=4, targets=("mlp", "attn"))
        phase_train_reference("reduced qwen3-0.6b train step (bitexact mlp+attn, pallas) "
                              "card vs CPU", ((qwen3, "cpu"), (qwen3, "cuda")))
        # gemma2-9b at head width 256 (float32: the flash forward with lse and
        # the pair at 256, window 8 binding at seq 32, both softcaps): the
        # kernels against the plain attention, both on the card
        gemma2 = get_config("gemma2-9b").reduced(head_dim=256)
        phase_train_reference(
            f"reduced gemma2-9b (hd 256, {gemma2.num_layers} layers, window "
            f"{gemma2.local_window}, {gemma2.dtype}) train step, pallas attention vs plain on "
            f"the card", tuple((dataclasses.replace(gemma2, attn_impl=impl), "cuda")
                               for impl in ("xla", "pallas")),
            expect=("flash_attention", *BWD_KERNELS))
    with phase("reference: gemma-7b, gemma2-9b, yi-9b"):
        phase_reference_wide()
    with phase("reference: qwen2-vl-7b, granite-moe-1b-a400m"):
        phase_reference_vl_moe()
    with phase("reference: mamba2-130m, recurrentgemma-2b"):
        phase_reference_recurrent()
        phase_reference_recurrent_train()
    with phase("reference: seamless-m4t-large-v2"):
        phase_reference_encdec()
    kernels.reset_launch_counts()

    # 5. serve, the qwen3-0.6b phase under the armed gate
    os.environ[GATE] = "1"
    audit.GATE_CHECKS.clear()
    with phase("serve: qwen3-0.6b"):
        cfg = get_config("qwen3-0.6b")
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init_params(0, device="cuda")
        torch.cuda.synchronize()
        print(f"serve: qwen3-0.6b {cfg.num_layers} layers, d_model {cfg.d_model}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
              f"{model.param_count(params) / 1e6:.1f}M params from seed 0 in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        every = tuple(kernels.ALL)
        n_req = QWEN3_REQUESTS
        exact_run = phase_serve("exact", params, model, quality="exact", forbid=every,
                                requests=n_req)
        runs = {
            "lut_matmul": phase_serve("balanced", params, model, quality="balanced",
                                      expect=("lut_matmul",), forbid=ATTN_KERNELS,
                                      requests=n_req, host_profile=True),
            "packed_matmul": phase_serve("draft", params, model, quality="draft",
                                         expect=("packed_matmul",), requests=n_req),
            "seqmul_matmul": phase_serve("seqmul", params, model, mode="seqmul",
                                         expect=("seqmul_matmul",), requests=n_req // 2),
        }
        # attn_impl="pallas": the attention kernels on the same weights
        pallas = build_model(dataclasses.replace(cfg, attn_impl="pallas"))
        runs["flash_attention"] = runs["flash_decode"] = phase_serve(
            "pallas exact", params, pallas, quality="exact",
            expect=("flash_attention", "flash_decode"), forbid=GEMM_KERNELS, requests=n_req,
            host_profile=True)
        runs["approx_attention_bitexact"] = phase_serve(
            "pallas balanced", params, pallas, quality="balanced",
            expect=("approx_attention_bitexact", "flash_decode", "lut_matmul"), requests=n_req)
        runs["lowrank_matmul"] = runs["approx_attention_lowrank"] = phase_serve(
            "pallas lowrank mlp+attn", params, pallas, mode="lowrank", targets=("mlp", "attn"),
            expect=("lowrank_matmul", "approx_attention_lowrank", "flash_decode"),
            requests=n_req, host_profile=True)
        # the rest of serving: speculative rounds (draft proposals, one verify
        # forward), the open loop with its policy, the static loop, the soak
        spec_exact = {**exact_run, "queue": exact_run["queue"][:n_req // 4]}
        spec_runs = {"packed_matmul": phase_serve_speculative(
            "speculative", params, spec_exact, expect=("packed_matmul",),
            draft_run=runs["packed_matmul"])}
        pallas_exact = runs["flash_attention"]
        spec_pallas = {**pallas_exact, "queue": pallas_exact["queue"][:n_req // 4]}
        spec_runs["flash_attention"] = spec_runs["flash_decode"] = phase_serve_speculative(
            "pallas speculative", params, spec_pallas,
            expect=("flash_decode", "flash_attention", "packed_matmul"))
        phase_serve_open(params, model)
        phase_serve_static(params, model)
        phase_soak(params, model)
    served = {}
    for run in {id(r): r for r in [exact_run, *runs.values(), *spec_runs.values()]}.values():
        for name, count in run["counts"].items():
            served[name] = served.get(name, 0) + count
    report_gate("serve: qwen3-0.6b", served)
    del os.environ[GATE]
    report_decode_counts(decode_counts, exact_run, card_line)
    with phase("distribution"):
        dist_runs = phase_distribution(params, model, {
            "exact": exact_run, "balanced": runs["lut_matmul"],
            "draft": runs["packed_matmul"]}, n_req)
        del params
        torch.cuda.empty_cache()
    with phase("tensor parallel"):
        tp_runs = phase_tensor_parallel(card_line, {
            "balanced": (runs["lut_matmul"], dict(quality="balanced")),
            "pallas exact": (runs["flash_attention"], dict(quality="exact")),
            "pallas lowrank mlp+attn": (runs["lowrank_matmul"],
                                        dict(mode="lowrank", targets=("mlp", "attn")))})
        torch.cuda.empty_cache()
    # gemma2-9b, gemma-7b, yi-9b, qwen2-vl-7b, granite-moe-1b-a400m,
    # recurrentgemma-2b and mamba2-130m at full width, one at a time
    wide_runs = {}
    for arch, arch_runs in wide_serve_runs(every).items():
        with phase(f"serve: {arch}"):
            wide_runs[arch] = phase_serve_wide(arch, arch_runs)
    # the encoder-decoder at full width, through the static loop
    with phase("serve: seamless-m4t-large-v2"):
        wide_runs["seamless-m4t-large-v2"] = phase_serve_encdec("seamless-m4t-large-v2",
                                                                encdec_serve_runs())
    for arch, label, _ in TP_WIDE_SERVES:  # phase 5c's serves on the (1, 1) mesh
        tp_wide_check(tp_runs["wide"][arch], wide_runs[arch][label], arch, label, card_line)

    # 6. train, full width, attn_impl="pallas" (set on the config; the CLI has no flag)
    with phase("train"):
        paper = build_model(dataclasses.replace(get_config("paper-multiplier"), attn_impl="pallas"))
        train_runs = {"paper-multiplier": phase_train(
            "paper-multiplier pallas", paper,
            expect=("lut_matmul", "flash_attention", *BWD_KERNELS))}
        bitexact = build_model(apply_approx(dataclasses.replace(cfg, attn_impl="pallas"),
                                            mode="bitexact", n=8, t=4, targets=("mlp", "attn")))
        train_runs["bitexact"] = phase_train(
            "qwen3-0.6b bitexact mlp+attn pallas", bitexact,
            expect=("lut_matmul", "approx_attention_bitexact", *BWD_KERNELS),
            deterministic=True)
        tp_train_check(tp_runs["train"], train_runs["bitexact"], card_line,
                       "qwen3-0.6b bitexact mlp+attn pallas")
        for name in BWD_KERNELS:
            runs[name] = dict(counts=train_runs["paper-multiplier"]["counts"],
                              per_step=train_runs["paper-multiplier"]["per_step"])
        del paper, bitexact
        torch.cuda.empty_cache()
        # (c) gemma2-9b at full width, its depth cut: the pair at head width 256
        gemma2 = dataclasses.replace(get_config("gemma2-9b"), num_layers=GEMMA2_TRAIN_LAYERS,
                                     attn_impl="pallas")
        train_runs["gemma2-9b"] = phase_train(
            f"(c) gemma2-9b pallas, {GEMMA2_TRAIN_LAYERS} of 42 layers", build_model(gemma2),
            expect=("flash_attention", *BWD_KERNELS))
        torch.cuda.empty_cache()
        # (d) granite-moe-1b-a400m at full width and depth: the routed experts
        # and their aux loss, the forward and the pair at head width 64;
        # (d)-(g) under PyTorch's deterministic algorithms, as phase 5c runs
        # their first two steps on the (1, 1) mesh
        label, cfg_d, expect, calls = family_train("granite-moe-1b-a400m")
        train_runs["granite-moe-1b-a400m"] = phase_train(label, build_model(cfg_d),
                                                         expect=expect, deterministic=True)
        check(all(a > 0 for a in train_runs["granite-moe-1b-a400m"]["aux"]),
              f"train (d): aux {train_runs['granite-moe-1b-a400m']['aux']}")
    torch.cuda.empty_cache()
    with phase("train: mamba2-130m, recurrentgemma-2b, seamless-m4t-large-v2"):
        # (e) mamba2-130m at full width and depth: the SSD's scans under
        # autograd, no attention (no kernel at exact); (f) recurrentgemma-2b
        # at full width, two (rglru, rglru, attn_local) periods: the forward
        # and the pair at g = 10, head width 256, window 2,048; (g)
        # seamless-m4t-large-v2 at full width and depth: the forward
        # non-causal (encoder) and causal (decoder), the pair after each
        for arch in TP_FAMILY_TRAINS[1:]:
            label, cfg_f, expect, calls = family_train(arch)
            train_runs[arch] = phase_train(label, build_model(cfg_f), expect=expect,
                                           calls=calls, deterministic=True)
            torch.cuda.empty_cache()
    for arch in TP_FAMILY_TRAINS:  # phase 5c's two steps of each on the (1, 1) mesh
        tp_train_check(tp_runs["trains"][arch], train_runs[arch], card_line,
                       family_train(arch)[0])
    torch.cuda.empty_cache()

    # 7. the train CLI in a process of its own, beside the paper's simulated
    # error analysis: engine.multiply through seqmul_packed, the error
    # reports up to n = 16 through seqmul_words
    with phase("train CLI and error analysis"):
        cli = start_train_cli()
        analysis = phase_error_analysis(cpu_eval)
        finish_train_cli(cli)
    for name in ELEMENTWISE_KERNELS:
        runs[name] = analysis

    # 8. report
    table = []
    for name in GEMM_KERNELS + ATTN_KERNELS + BWD_KERNELS + ELEMENTWISE_KERNELS:
        mine = [r for r in rows if r["name"] == name]
        if name in GEMM_KERNELS:
            main_row = next(r for r in mine
                            if tuple(r["shape"]) == MAIN_SHAPE and r["n"] == 8 and "ms" in r)
        elif name in BWD_KERNELS:
            main_row = next(r for r in mine if r["label"] == "train")
        elif name in ELEMENTWISE_KERNELS:
            main_row = next(r for r in mine if "ms" in r)
        else:
            main_row = next(r for r in mine if r["label"] == "serve")
        if name in BWD_KERNELS:
            per_step = dict(launches_per_train_step=runs[name]["per_step"][name],
                            **{f"{arch.replace('-', '_')}_train_launches_per_step":
                               train_runs[arch]["per_step"][name]
                               for arch in ("gemma2-9b", "recurrentgemma-2b",
                                            "seamless-m4t-large-v2")})
        elif name in ELEMENTWISE_KERNELS:
            per_step = dict(n=main_row["n"], t=main_row["t"])
        else:
            # the main-path serve run's pool prefill and decode step around them
            per_step = dict(launches_per_prefill=runs[name]["per_prefill"][name],
                            launches_per_decode_step=runs[name]["per_decode"][name],
                            serve_prefill_ms=runs[name]["prefill_ms"],
                            serve_decode_step_ms=runs[name]["decode_ms"],
                            serve_busy_share=runs[name]["busy_share"])
            if name == "approx_attention_bitexact":
                # and in each step of train run (b), at the train row's shape
                per_step["launches_per_train_step"] = train_runs["bitexact"]["per_step"][name]
        if name in spec_runs:
            # each round of the speculative run: SPEC_K draft decodes and one verify
            per_step["launches_per_spec_round"] = spec_runs[name]["per_round"].get(name, 0.0)
        for tier in ("balanced", "draft"):
            if dist_runs[tier]["counts"].get(name):
                # its launches in the serve run under the one-rank ("data",) mesh
                per_step["mesh_serve_launches"] = dist_runs[tier]["counts"][name]
        if "exact_matmul_ms" in main_row:
            per_step["exact_matmul_ms"] = main_row["exact_matmul_ms"]
        # the tensor-parallel phase: the integer epilogue, the decode's lse,
        # and the launches of the TP code's train step and serve run
        per_step.update(tp_runs["epilogues"].get(name, {}))
        if name == "flash_decode":
            per_step["lse_ms"] = {k: v["lse_ms"] for k, v in tp_runs["decodes"].items()}
            per_step["no_lse_ms"] = {k: v["no_lse_ms"] for k, v in tp_runs["decodes"].items()}
        if tp_runs["train"]["per_step"].get(name):
            per_step["tp_train_launches_per_step"] = tp_runs["train"]["per_step"][name]
        family = {arch.replace("-", "_"): run["per_step"][name]
                  for arch, run in tp_runs["trains"].items() if run["per_step"].get(name)}
        if family:
            # a step of train runs (d)-(g) on the (1, 1) mesh
            per_step["tp_family_train_launches_per_step"] = family
        if tp_runs["serve"].get(name):
            per_step["tp_serve_launches"] = tp_runs["serve"][name]
        for arch in ("gemma2-9b", "qwen2-vl-7b", "granite-moe-1b-a400m", "recurrentgemma-2b",
                     "mamba2-130m", "seamless-m4t-large-v2"):
            used = {label: run["counts"][name] for label, run in wide_runs[arch].items()
                    if run["counts"].get(name)}
            if used:
                # its launches in the arch's full-width serve runs that use it
                per_step[f"{arch.replace('-', '_')}_serve_launches"] = used
        table.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES.get(name, name)}.cu",
            "replaces": REPLACES[name],
            "launches": runs[name]["counts"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            **{key: main_row[key] for key in ("device_ms", "library_device_ms",
                                              "device_ms_mag_below_64", "err_over_limit",
                                              "plan", "skipped_pairs", "skipped_chunks")
               if key in main_row},
            "shape": main_row["shape"],
            **per_step,
        })
    print("kernels: " + json.dumps([[k["name"], k["launches"]] for k in table]), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
