#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--out results.json] [--only 5i|5h|5j|5k|5l]

Needs one CUDA device, ``nvcc`` and the checkout this file lies in; no
network.  Imports nothing of JAX or of the JAX package.  ``--only 5i``
(5h, 5j, 5k, 5l) runs phases 1, 2 and that phase alone and prints no result
lines.  Phases, each
of which ends the run with a non-zero exit code if it fails (a
``phase wall s`` line before ``total`` gives each one's wall seconds):

1. device: ``nvidia-smi`` name and power limit, torch / CUDA / nvcc versions;
2. build: the eight CUDA sources, from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape one EdgeNeXt-S forward gives it at batch 16 and at ragged /
   odd / bfloat16 cases (fused_ibn also at the four batch-1 shapes, at
   RWKV-6's channel mix in bfloat16, M = 4 x 512, D = 2048, F = 7168,
   relu^2, which the model leaves to two library products, and at cases
   that split F over the grid with a ragged last tile, M = 1 and gated
   bfloat16; each fused_ibn record carries ``splits`` and ``ctas`` from
   ``kernels.fused_ibn.plan``), ``|a-b| <= tol + tol*|b|`` with tol 3e-5 for
   float32 (2e-4 attention and WKV, the JAX tests' own) and 2e-2 for
   bfloat16: float32 sums taken in another order, bfloat16 rounding of
   the result.  ``matmul_ln`` is on no model forward: it runs at the three
   EdgeNeXt-S shapes the scheduler lowers at batch 16 (M = 16384 / 4096 /
   1024, K = N = 96 / 160 / 304), the two LM widths it lowers (512 x 2048
   -> 2048, 448 x 2560 -> 2560), two ragged cases, bfloat16 cases (also
   at 512 x 2048 -> 2048) and two calls at 448 x 2560 -> 2560 that must
   give the same bits, each with the blocks ``search.lower`` gives that
   shape.  The kernel splits N over a thread-block cluster of up to 8
   blocks, takes the row statistics through distributed shared memory in
   rank order and multiplies in 3xTF32 (float32) or bf16 on the tensor
   cores; each matmul_ln record, here and in the lowered phase, carries
   ``splits`` and ``ctas`` from ``kernels.matmul_ln.plan``.
   ``flash_attention`` runs at the three XCA shapes of a batch-16 forward
   (in the sums) and of a batch-1 forward (timed, outside the sums), at
   causal, windowed, ragged and bfloat16 cases, at Sk = 128 and 129 (the
   boundary of its whole-row regime), with D shared out unevenly over
   the cluster, with rows that see no key, and twice at 64 x 40 x 256,
   where the two calls must give the same bits; then, in the online
   regime, the dense path's prefill shapes (timed, outside the sums:
   h2o-danube-1.8b 4 x 32 x 512 and 1 x 32 x 4608 under a window of 4096,
   D 80, K / V made on 8 heads and repeated over 32; olmo-1b 4 x 16 x 512,
   D 128; bfloat16, causal; the operations bound counts only the unmasked
   q.k pairs, the library call is SDPA with ``is_causal`` or a boolean
   mask), the encoder-decoder's (timed, outside the sums: the Seamless
   encoder, 4 x 16 x 512 and 1 x 16 x 1500, and the cross-attention of one
   decoder token against 512 and 1500 frames; bfloat16, D 64, non-causal,
   SDPA with ``is_causal=False``), qwen3-moe's 32 / 4 heads at D 128, the
   decoder's first token (Sq = Sk = 1, whole rows), a float32 cross-
   attention 1 -> 700, the 1500-frame encoder twice with the same bits,
   RecurrentGemma's local attention (timed, outside the sums, 8 launches
   a prefill: 10 query heads over 1 KV head at D 256, bfloat16, causal, at
   4 x 512, at 1 x 4608 under the window of 2048 and at a ragged 1 x 700;
   the build's ``ptxas`` registers and spill bytes of each online instance
   are printed after the build), and, last of all the cases, phase 5i's
   4 x 512 prefills (timed, outside the sums: starcoder2-15b's 48 / 4
   heads, minitron-4b's 24 / 8, qwen2-vl-2b's 12 / 2, qwen3-moe's 32 / 4,
   D 128, bfloat16, causal, the layers' count a prefill),
   a float32 causal 1 x 4 x 300 (ragged against the 64-row tile),
   minitron-4b's 24 / 8 heads at D 128, a causal bf16 prompt of the
   whole-row regime, D chunked over the grid, and twice at the served
   shape, where the two calls must give the same bits; a sequence shard's
   queries at their ``q_offset`` (the 'cp' step): RecurrentGemma's 1 x 4608
   split in two (2304 queries at 2304 against 4608 keys, MQA expanded to
   10 heads, D 256, bf16, its window of 2048 across the shard's edge) and
   a whole-row shard (4 x 16 x 64 at 64 against 128 keys, window 96, bf16),
   both timed beside the same call without the offset in turns
   (``no_offset_ms``), and untimed float32 shards of the online and the
   whole-row regime and a non-causal window at an offset; each record, here
   and in the lowered phase, carries ``regime``, ``splits``,
   ``row_splits`` and ``ctas`` from ``kernels.flash_attention.plan``.
   ``depthwise_conv2d`` runs at the nine shapes of a batch-16 forward (in
   the sums) and of a batch-1 forward (timed, outside the sums), the first
   SDTA split of a stage as the channel slice the model hands over, and at
   the generic instance's sizes (4 x 2, 1 x 1, 11 x 11), a 3 x 5 image under
   7 x 7, C = 1 and 3, the stage-3 cascade slice at channel 54 of 160 in
   float32 and bfloat16, and twice at 16 x 16 x 16 x 160 under 7 x 7, where
   the two calls must give the same bits; each record carries ``th``,
   ``tw``, ``cb``, ``cv``, ``ctas`` and ``smem`` from
   ``kernels.depthwise_conv.plan``.
   ``wkv_chunked`` runs at RWKV-6's served prefill shape (B*H = 4*32,
   T = 512, K = V = 64, chunk 64; bfloat16 r/k/v with float32 logw and u,
   and a float32 copy), the B = 1 x 200 prompt's shape (32 x 200, bf16),
   every pow2 chunk 8..256 at T = 512, the JAX tests' ragged T / chunk
   50/16, 33/8, 100/64, T < chunk (50 / 64), RecurrentGemma's K = 1,
   V = 2560, T = 448 at chunks 64 and 256, decays at the extremes
   (-exp(N(2.5, 1)), 0, -1e-6; float32 and bf16), twice at the served
   shape, where the two calls must give the same bits, and from a nonzero
   initial state (a sequence shard's: 4 x 130 at chunk 32, and the served
   shape timed beside the same call from zero in turns, ``no_state_ms``); each record
   carries the outputs pass's plan from ``kernels.rwkv_chunk.plan``
   (``wv``, ``warps``, ``rows``, ``ctas``) and the states pass's
   blocks (``states_ctas``), and, where timed, the bytes of the float32
   workspace of entering states (written once, read once).  Each
   is timed with CUDA events, one pair around each call, the L2 cache
   flushed before each, median of the repeats: the kernel, the plain
   version, and a library call of the same function as a yardstick the
   port never uses (none for WKV: no single PyTorch call computes it).
   ``adamw`` (no Pallas kernel: the loop XLA fuses out of the reference's
   ``upd`` under its launcher's jit) runs at every leaf shape of
   h2o-danube-1.8b uncut (in the sums: one train step's update, a launch a
   leaf), then at an odd length, a leaf one element off 16-byte alignment,
   three elements and with no clip: three steps each against
   ``ref.adamw_ref`` on the same inputs, p, m and v the same bits (tol 0);
   its bound 28 bytes a parameter at 3.35 TB/s, its library call
   ``torch._fused_adamw_`` (which applies the decay in another order:
   timed only);
4. main path, EdgeNeXt-S: full width and depth (256x256x3, dims
   48/96/160/304, depths 3/3/9/3, 1000 classes, float32, seeded random
   weights) answers 4 requests of 16 images and 2 of 1 through
   ``serve_edgenext.serve``.  The launch counters are set to 0 just before
   and read just after: 18 fused_ibn, 21 depthwise, 3 attention launches a
   forward.  Logits must be finite, [B, 1000], within 2e-3 of the same
   model run with the plain versions on the card, and for one single-image
   request within 2e-3 of the plain model on the CPU.  Then the same model
   as ``runtime.capture.captured(model)`` (``edgenext_captured``): captured
   at B = 16 and at B = 1 on images of its own, the counters set to 0
   before each capture and read after it: 18 / 21 / 3 for the capture and
   as many for each of the ``WARMUP`` eager forwards before it; then the
   six requests and one more single image replayed (four fresh batches at
   B = 16, three at B = 1): no counter moves, and the logits equal the
   eager ones bit for bit and are within 2e-3 of the plain model's;
   request ms of both forms in turns (10 rounds at each batch size), by
   CUDA events and by the host's clock from the call to a synchronise; the
   peak device memory of a request in each form and the memory the
   capture reserved;
5. main path, RWKV-6 1.6B (``rwkv6_path``): full width and depth (24
   layers, d 2048, 32 heads of 64, d_ff 7168, vocab 65536, 1,599,873,024
   parameters), weights from seed 0 drawn on the card (``init_on_device``,
   as ``launch.serve`` draws them there), served as ``launch.serve`` serves it
   (bfloat16 compute): 3 requests of 4 x 512-token prompts and 1 of
   1 x 200 tokens (ragged at chunk 64), each followed by 32 greedy tokens.
   Around each prefill and each decode loop the counters are set to 0 and
   read: 24 wkv_chunked launches a prefill, none in decode, no other
   kernel.  Checks: the float32 model (same weights) against itself on
   ``ref.PLAIN`` on the card, one 4 x 512 prefill and 8 decode steps
   (last hidden state, WKV states, logits within 2e-3 (1 + |b|)); the
   served bfloat16 run against the plain bfloat16 model, teacher-forced
   with the served tokens (``BF16_LOGITS_TOL``, ``BF16_AGREEMENT``); one
   1 x 64 float32 request and 4 decode steps against the plain model on
   the CPU within 2e-3.  Then the steps ``launch.serve`` serves on the
   card (``launch.serve.captured_steps``, ``rwkv6_captured``): the prefill
   captured at 4 x 512 and 1 x 200 and the donated decode step at B = 4 and
   1, on prompts of their own: 24 wkv_chunked for each prefill capture and
   as many for each ``WARMUP`` run, none for a decode capture; the four
   requests replayed move no counter and give the eager steps' last
   hidden state, prefill cache, every step's tokens and logits and last
   cache bit for bit; the bfloat16 check above on the captured requests
   too, and the float32 request through the float32 model's captured
   steps (bit for bit its eager run, within 2e-3 of the plain model);
   prefill ms (10 rounds) and decode ms a token (3 loops of 32 steps) of
   both forms in turns, both clocks; peak memory of a 4 x 512 request in
   each form, and each capture's host seconds and reserved memory.  Last,
   ``wkv_graph_edge``: one ``wkv_chunked`` call captured alone, the types of
   the graph's edges as the driver gives them (whether the outputs pass's
   programmatic dependent launch stays one in a graph), a replay on new
   inputs bit for bit the eager call, and both forms' time;
5g. train RWKV-6 (``train_path``, run right after 5, its masters the float32
   draw that its served weights round, drawn on the card again and taken
   over with no copy): ``rwkv6-1.6b`` uncut,
   float32 masters, bfloat16 compute with remat, the schedule, steps, batch
   and limits of 5f.  The first step's gradients launch 24 + 24
   wkv_chunked (the forward and remat's recompute, through ``WKVChunked``)
   and 24 wkv_chunked_bwd and nothing else; against the same step under
   ``kernels=ref.PLAIN`` (both bfloat16, differing in the WKV only; the
   plain step's per-token ``wkv_ref`` under autograd holds ~3 GB a layer
   while remat recomputes it, so the full batch runs): loss within 1e-2,
   every gradient leaf within a relative L2 error of 5e-2, the global norm
   within 1 %; run twice, the same bits; float32 on the first 2 layers:
   every gradient leaf within 2e-3 (1 + |b|) of the plain step's.  Then,
   as 5f: TRAIN_EAGER_STEPS eager steps (48 + 24 + 34 AdamW launches a step)
   and the 20 captured steps from the same draw, the first held to them bit
   for bit, (1 + WARMUP) x (48 + 24 + 34) launches over the run: losses and
   norms finite, the mean loss of the last 5 below that of the first 5,
   step ms by CUDA events and the host's clock (captured: median of the
   last 10; eager: of its steps), capture seconds and graph pool, tokens/s,
   peak memory, one more captured step traced (two until phase 5l came).
   Resume is not repeated here: 5f shows it for the checkpoint store, which
   does not depend on the arch;
5b. dense (``dense_path``, ``lm_phase``): ``h2o-danube-1.8b`` uncut (24 layers, d 2560,
   32 query heads over 8 KV heads of 80, d_ff 6912 SwiGLU, vocab 32000,
   window 4096, 1,831,201,280 parameters), weights from seed 0 drawn on the
   card, bfloat16 compute, served as ``launch.serve`` serves it: 2
   requests of 4 x 512-token prompts with 32 greedy tokens and 1 of a
   1 x 4608 prompt (longer than the window: the banded prefill and a ring
   cache of 4096) with 8.  Around each prefill and each decode loop the
   counters are set to 0 and read: 24 flash_attention a prefill, none in
   decode, no other kernel.  Logits finite, of their shapes, the K cache
   of the prompt's length (a ring of 4096 past the window); the first and
   the last request held to the plain model (``kernels=ref.PLAIN``)
   teacher-forced with the served tokens (``BF16_LOGITS_TOL``,
   ``BF16_AGREEMENT``).  Then the captured steps (``lm_captured``):
   captures at 4 x 512 and 1 x 4608 (24 a
   prefill capture and as many for each ``WARMUP`` run, none for decode),
   the three requests replayed bit for bit the eager steps with no
   launch; prefill ms and decode ms a token eager and captured in turns,
   both clocks; peak memory; capture seconds; the device's busy share of
   one ``torch.profiler`` trace of three captured 4 x 512 prefills;
5c. MoE (``moe_path``, ``lm_phase``): ``qwen2-moe-a2.7b`` at full width and
   4 of its 24 layers (``reduced: num_layers 24 -> 4``: every layer has the
   same shapes; 8 layers until phase 5h came, cut to 4 for the script's
   time; d 2048, 16 heads of 128, 60 routed experts padded to
   64, top 4, 4 shared experts, vocab 151936; 3,042,994,176 parameters),
   served as ``launch.serve`` serves it: 2 requests of 4 x 512 with 32
   greedy tokens, 1 of 1 x 200 with 16.  4 flash_attention a prefill, none
   in decode; then the captured steps, held bit for bit to the eager ones
   (as in 5b, ``lm_captured``), a trace of three captured 4 x 512 prefills;
   the first and the last request held to the plain model teacher-forced
   (``BF16_LOGITS_TOL``, ``BF16_AGREEMENT``), with the share of (token,
   choice) routings the two models agree on.  Then float32 on the first 2
   layers of the same draw (``f32_check``): a 2 x 256 prefill and 4 greedy steps through
   the kernels, within 2e-3 (1 + |b|) of the plain model fed the same
   tokens (a routing that flips between the two moves a logit by more than
   rounding, which the bf16 limits alone would not tell apart);
5d. encoder-decoder (``audio_path``, ``lm_phase``): ``seamless-m4t-large-v2``
   uncut (24 + 24 layers, d 1024, 16 heads of 64, d_ff 8192, vocab 256206;
   1,632,358,400 parameters), frames [B, T, 1024] drawn after the tokens,
   the tokens' first column the decoder's prefix, the self cache sized
   T + gen: 2 requests of 4 x 512 frames with 32 tokens, 1 of 1 x 1500 with
   16.  72 flash_attention a prefill (24 encoder, non-causal; 24 decoder
   self, Sq = Sk = 1; 24 cross, 1 query row against the frames), none in
   decode; captured, traced and held to the plain model as in 5c.  Each of
   5c and 5d prints prefill ms and decode ms a token eager and captured,
   peak memory, capture seconds and its own wall seconds.  5b, 5c and 5d
   draw their weights on the card (drawn by numpy on the host, they took
   ~32, ~56 and ~32 s);
5e. hybrid (``hybrid_path``, ``lm_phase``): ``recurrentgemma-2b`` uncut (26
   layers in the pattern recurrent, recurrent, attention: 18 RG-LRU blocks
   and 8 local-attention blocks; d 2560, 10 query heads over 1 KV head of
   256, window 2048, GeGLU d_ff 7680, LRU width 2560, vocab 256000;
   3,549,934,080 parameters; weights from seed 0 drawn on the card,
   ``init_on_device``): 2 requests of 4 x 512 with 32 greedy tokens,
   1 of 1 x 4608 with 8 (past the window: the banded prefill, a ring of
   2048, the RG-LRU's doubling scan over 4608 rows).  8 flash_attention a
   prefill, none in decode; the recurrent states of their shapes and types;
   captured, traced and held to the plain model as in 5c.  Then float32 on
   the first 3 layers (recurrent, recurrent, attention) of the same
   weights: a 2 x 300 prefill and 4 greedy steps through the kernels within
   2e-3 (1 + |b|) of the plain model fed the same tokens, every cache leaf
   included;
5f. train (``train_path``, run right after 5b, its masters the float32 draw
   that its served weights round, drawn on the card again and taken over
   with no copy; the float32 check's layers drawn afresh with ``layers=2``,
   the same numbers): ``h2o-danube-1.8b`` uncut, float32 master weights,
   bfloat16 compute with remat, ``runtime.build_train_step`` as
   ``launch.train`` builds it (AdamW, warmup 5 then cosine from lr 3e-4,
   clip 1.0) over 20 batches of 4 x 512 tokens of ``data.synthetic`` (vocab
   32000, seed 0).  First the three ``ops`` entries without a backward are
   each given a CUDA weight that requires grad: each must raise, naming its
   kernel, with its counter unchanged (``wkv_chunked``, given the same, must
   return ``WKVChunked``'s ``grad_fn`` after one launch).  The first step's gradients
   (``build_grad_fn``) launch 24 + 24 flash_attention (the forward and
   remat's recompute) and 24 flash_attention_bwd and nothing else; against
   the same step under ``kernels=ref.PLAIN`` (both bfloat16, so they
   differ in the 24 attention calls only): loss within 1e-2, every
   gradient leaf within a relative L2 error of 5e-2, the global norm
   within 1 %; run twice, the same bits; float32 on the first 2 layers of
   the same weights: every gradient leaf within 2e-3 (1 + |b|) of the plain
   step's.  Then TRAIN_EAGER_STEPS (WARMUP + 2) eager steps from the
   draw, each launching exactly 48 + 24 and 12 AdamW (one a leaf: the
   hand-written kernel, the clip's factor folded in), their state digested
   and freed; the draw again and the 20 steps through
   ``runtime.capture.captured_train_step`` (the port of the launcher's
   ``jit(train_step, donate_argnums=(0, 1))``: the first WARMUP steps
   eager, the next captured, the rest replayed), the counters set to 0
   before and read after ((1 + WARMUP) x (48 + 24 + 12): none at a replay),
   each timed by CUDA events and the host's clock: the first
   TRAIN_EAGER_STEPS losses, gradient norms and the state's digest equal
   the eager run's bit for bit; every loss and gradient norm finite, the
   mean loss of the last 5 steps below that of the first 5, peak memory of
   both runs; a checkpoint (``checkpoint.save_checkpoint``) after step 10,
   restored (``checkpoint.restore``, its template a tree on the meta
   device) into fresh tensors once the run is over and handed to the
   captured step, which copies them into its donated buffers, must give
   steps 10-19 again bit for bit with no launch (losses, gradient norms,
   and the final parameters and moments by digest); one more captured step
   traced (busy share, kernels a step); the capture's host seconds and the
   MiB its graph pool reserved.  Step ms is the median of the last 10
   (captured), beside the eager steps' median; tokens/s = 2048 / step;
5l. the encoder-decoder, the hybrid and the MoE trained (``family_phase``,
   ``train_path`` over FAMILIES): ``seamless-m4t-large-v2`` and
   ``recurrentgemma-2b`` uncut, ``qwen2-moe-a2.7b`` at 4 of its 24 layers
   (as 5c serves it), each on float32 masters drawn on the card from seed
   0 (the model's ``init_on_device``, taken over with no copy), bfloat16
   compute with remat, 5f's schedule, steps, batch and limits (20 steps of
   ``data.synthetic``; Seamless: 512 frames of ``inputs_embeds`` and 512
   decoder tokens).  The checks of 5f but the resume, the captured run
   held to its eager steps alike: each eager step launches exactly 144 +
   72 / 16 + 8 / 8 + 4 flash_attention + flash_attention_bwd (twice and
   once ``kernel_launches_per_prefill``) and 32 / 345 / 17 AdamW; the first step's
   gradients against the plain step (for the MoE also its cross entropy
   and aux loss, and the share of (token, choice) routings the two steps
   agree on, printed where a limit is missed); the same bits twice;
   float32 on the first layers drawn afresh (``f32_cut``: Seamless 2
   encoder and 2 decoder layers, RecurrentGemma 3, recurrent, recurrent,
   attention, the MoE 2), every gradient within 2e-3 (1 + |b|) of the
   plain step's; the mean loss of the last 5 steps below that of the first
   5; step ms (median of the last 10, events and host clock), tokens/s,
   peak memory (a run whose peak passes FIVE_PEAK_GIB fails, as one of 5f
   or 5g would); one more step traced.  For RecurrentGemma also
   ``rg_lru_cost``: one recurrent layer's RG-LRU (gates and scan) timed
   alone at the step's shape, forward and backward, and 18 x (2 forwards
   + 1 backward) as a share of the step.  Then ``multiarch_phase``:
   ``train_multiarch.run`` for each of the ten archs at reduced size on
   the card (12 steps of 4 x 48 tokens, float32, the attention kernels and
   their backward at D 16, RWKV-6's WKV kernels at K = V = 16, chunk 8),
   the counters set to 0 before each and read after: exactly (1 +
   WARMUP) x ``per_train_step`` (the example's steps captured; none at a
   replay), the losses finite and the last below the first.  Then
   ``quickstart_phase``: ``quickstart.run`` on the card at the example's
   120 steps (reduced h2o-danube-1.8b, 8 x 64 tokens, a save every 60
   steps, the last restored, 16 greedy tokens; the train step, the prefill
   and the decode step captured), exactly (1 + WARMUP) x a train step's and
   (1 + WARMUP) x one prefill's launches, 118 replays of the train step,
   the mean loss of the last 20 steps
   below that of the first 20, the restored tree equal to the run's last
   state bit for bit, the tokens teacher-forced through the plain steps
   (``kernels=ref.PLAIN``) on the restored weights: the last hidden state
   and every step's logits within 2e-3 (1 + |b|), the greedy agreement
   reported; and ``serve_lm_phase``: ``serve_lm.serve`` for each of the
   example's five archs (olmo-1b, qwen3-moe, RWKV-6, RecurrentGemma,
   Seamless, reduced; 4 x 48 prompts, 24 tokens from token 0; the steps
   captured), exactly (1 + WARMUP) x one prefill's launches, the tokens in
   the vocabulary, the same checks
   against the plain steps on the same seed's weights.  Lines
   ``train_audio ...``, ``train_hybrid ...``, ``train_moe ...``,
   ``train_multiarch <arch> ...``, ``quickstart ...`` and ``serve_lm ...``;
5i. the five LM configs that had run at reduced size on the CPU only
   (``five_phase``, ``five_path`` over ``FIVE``, each through ``lm_phase``),
   at full width on weights drawn on the card from seed 0
   (``init_on_device``, bfloat16 compute), starcoder2-15b and qwen3-moe cut
   to their first 10 and 12 layers (``reduced: num_layers``, for the
   script's time: 20 and 24 until phase 5l came), the other three uncut: ``starcoder2-15b`` (40 layers,
   d 6144, 48 / 4 heads of 128, LayerNorm and GELU, d_ff 24576),
   ``minitron-4b`` (32 layers, d 3072, 24 / 8 heads, squared ReLU, vocab
   256000), ``olmo-1b`` (16 layers, MHA, non-parametric LayerNorm, tied
   float32 head), ``qwen2-vl-2b`` (28 layers, 12 / 2 heads, M-RoPE 16 / 24 /
   24; ``inputs_embeds`` drawn after the tokens and
   ``layers.image_text_positions``: a 16 x 16 or 8 x 8 image, then text) and
   ``qwen3-moe-30b-a3b`` (48 layers, 32 / 4 heads, QK-norm, 128 experts top
   8 normalised, 61.7 GB as served).  Requests 4 x 512 with 32 greedy
   tokens and 1 x 200 (ragged against the 64-key tile) with 16; as in 5c:
   flash_attention the layers a prefill and none in decode, the captured
   steps bit for bit the eager ones with no launch at replay, prefill and
   decode ms eager and captured in turns, each time beside its bound
   (``lm_bounds``), peak memory, capture seconds, a trace of three captured
   prefills, the first and last request held to the plain model (with the
   routing agreement for the MoE), and ``hold_to_plain``'s noise floor:
   the plain composition with ``exact_attention``, and ``layer_gaps``
   (where the gap opens); then float32 on the first 2 layers of the same
   draw (``layers=2``, ``f32_check``).  A phase whose peak passes
   FIVE_PEAK_GIB fails;
5h. distributed (``dist_phase``), the port's distributed runtime in worlds
   of ranks spawned on this host (``launch.mesh.spawn_local``, each world
   with a time limit of DIST_WORLD_S), the parent's cached memory freed
   first; inputs made on the host from the seed and written to a fresh
   directory (``checkpoint.save_checkpoint``).  ``h2o-danube-1.8b`` runs at
   full width and 2 of its 24 layers (``reduced: num_layers 24 -> 2``: two
   processes share the card in (c) and (f); 4 layers until phase 5l
   came).  (a) a world of one rank under NCCL, mesh (1, 1): 3 steps of
   5f's schedule over 4 x 512 tokens through ``build_train_step(mesh=...)``
   and with no mesh, the same bits
   (metrics, parameters, moments), and an NCCL all-reduce and all-gather
   over each axis's group; it writes (c)'s and (f)'s references and counts
   one ``grad_fn``'s FLOPs (``FlopCounterMode``: the aten products).  Then
   a world of two ranks that share the card under gloo (every train step
   eager, as ``launch.train`` runs a mesh whose collectives cross ranks,
   AdamW's kernel on the rank's blocks, a launch a leaf): (b)
   ``pipeline.data_parallel`` of EdgeNeXt-S's forward over data = 2 at B =
   16 (8 images a rank through the three kernels) within 2e-3 (1 + |b|) of
   the one-process forward, each rank's launches those of one B = 8
   forward, B = 7 refused as not divisible; (c) the sharded step on (data
   2, model 1), profile '2d', 3 steps of 4 x 512 (2 x 512 a rank), its
   parameters restored onto the mesh from the host arrays
   (``restore_sharded``), each layer's leaves gathered at use and the
   gradients reduced onto the rank's blocks: each step's loss within 1e-2
   and gradient norm within 1 % of (a)'s one-process step, every leaf of
   the first step's gradients (gathered) within a relative L2 error of
   5e-2, 4 flash_attention and 2 flash_attention_bwd a step a rank; float32
   on the first 2 layers, every parameter after 3 steps within 2e-3 (1 +
   |b|) of the one-process float32 step and each leaf's change over the 3
   steps within a relative L2 error of 1e-2 of the one process's change
   (warmup moves a parameter by less than the first limit); step ms by CUDA
   events (two processes time-sharing one card with their collectives
   through the host: not a scaling number), each rank's peak memory, the
   bytes staged through the host and gathered at use a step, the gathered
   leaves alive at most; a checkpoint after step 3, restored onto a (1, 2)
   mesh in the same ranks, each block equal bit for bit to its slice of the
   gathered parameters; (f) the same step on (data 1, model 2): each rank
   half of the heads (16 query heads, 4 KV heads held), d_ff and
   vocabulary, the same checks as (c) but the checkpoint, the heads each
   attention launch ran, and one ``grad_fn``'s FLOPs at most DIST_TP_FLOPS
   of (a)'s; (d) one ``qwen2-moe-a2.7b`` MoE layer at full width (d 2048,
   64 padded experts, top 4, shared experts, bfloat16, 4 x 512 tokens) by
   ``moe_apply_sharded`` on (1, 2), 32 experts a rank, against the plain
   ``moe_apply`` in rank 0 alone: output within 2e-2 (1 + |b|), aux within
   1e-4 relative, the router / wi / wo gradients (the router's a rank's,
   the experts' summed over 'model': the layer is tensor-parallel) within
   a relative L2 error of 5e-2; (e) ``gpipe`` of an 8-layer tanh stack over
   2 stages on CUDA tensors against the sequential stack (2e-5 forward,
   2e-4 gradients), and ``compressed_pod_allreduce`` on (pod 2, data 1,
   model 1) against its definition (1e-6); (g) ``rwkv6-1.6b`` at full width
   and 2 of its 24 layers on (1, 2) in float32 (bfloat16's rounding alone
   moves the ``faaaa`` gradient by most of its norm there: reported),
   masters drawn on the card from the seed in each rank, 2 steps of 4 x 512
   against one process's in rank 0 alone (losses 1e-2, norms 1 %, the first step's gradients 5e-2
   relative L2), the WKV kernels on [4 x 16, 512, 64] (16 of 32 heads a
   rank), 4 wkv_chunked and 2 wkv_chunked_bwd a step a rank; (h) the cut
   dense model of (c) under 'cp' on (data 1, model 2): each rank 256 of a
   row's 512 tokens, the parameters whole over 'model', K / V gathered over
   'model' and each attention launch at the rank's query offset (0 and 256,
   forward and backward, read from every launch), every gradient summed over
   'model'; (c)'s checks but the checkpoint, the losses within 1e-4 of (a)'s,
   (f)'s FLOP count, the bytes staged a step; (i) (g)'s model under 'cp' on
   (1, 2): all 32 heads on 256 tokens a rank, rank 1's WKV launched from
   the state rank 0 left (read from every launch), the losses within 1e-5
   of one process's; (j) ``qwen2-moe-a2.7b`` at full width (d 2048, 16
   heads of 128, 60 experts padded to 64, top 4, 4 shared experts of d_ff
   5632 and the shared gate, vocab 151936) and 2 of its 24 layers
   (``reduced: num_layers 24 -> 2``) on (1, 2) under '2d' in float32, 2
   steps of 4 x 512: every MoE block through ``moe_apply_sharded`` (32
   experts a rank, half the shared experts' ff, every token on both ranks;
   recorded, and the plain ``moe_apply`` never called), the attention on 8
   of 16 heads, 4 flash_attention and 2 flash_attention_bwd a step a rank;
   held to one process's plain step in rank 0 alone (losses 1e-2, norms 1
   %, every first-step gradient leaf gathered one at a time within 5e-2
   relative L2), the first step twice the same bits on each rank, a rank's
   ``grad_fn`` FLOPs at most DIST_TP_FLOPS of one process's; one process's
   bfloat16 gradients against its float32 ones reported, not checked.  One JSON line ``{"dist": {...}}``.  ``--only 5h`` runs this phase alone after the
   build; ``--dist-vs DIR`` runs (a) to (c) of it from the checkout DIR and
   from this one, alternating (``dist_versus``); part (a)'s world of one
   rank also runs phase 5j's (1, 1) check;
5j. sharded serving (``mesh_serve_phase``): the serving steps
   (``build_prefill_step`` / ``build_decode_step`` with ``mesh=``) as a
   rank's program, driven through ``launch.serve``'s step builders.  In 5h
   (a)'s world of one rank under NCCL, a (1, 1) mesh serves
   ``h2o-danube-1.8b`` cut to 2 layers (a 4 x 512 prefill, 8 greedy
   tokens) with the no-mesh steps' bits, eager and captured
   (``mesh_serve_one_rank``).  Then one world of two gloo ranks sharing the
   card serves each part in turn, the weights drawn on the card from the
   seed in each rank and cut to the rank's blocks; rank 0 alone also serves
   one process's steps on the same draw (the yardstick).  Each part: a 4 x
   512 prefill and 8 greedy tokens of one process, the sharded steps
   teacher-forced on its tokens: the rank's cache exactly 1/n of one
   process's, bfloat16 logits within BF16_LOGITS_TOL and greedy agreement
   at least BF16_AGREEMENT, one prefill's kernel launches and none in
   decode, each launch on H/tp heads; then float32 on the first 2 layers of
   the same draw (the hybrid's 3), logits and last hidden within 2e-3 (1 +
   |b|).  Printed rank by rank: prefill ms and decode ms a token by CUDA
   events (eager: two ranks time-share the card, not a scaling number),
   the bytes staged through the host a prefill and a token
   (``collectives.host_staged_bytes``), the cache's bytes against one
   process's, peak memory, the heads a launch ran on.  Parts (MESH_SERVE_
   PARTS): (a) the cut h2o on (data 1, model 2) under 'tp', 16 of 32 query
   heads a rank, the cache's slots split (256 of 512 a rank), and a 1 x
   6140 prompt with 8 tokens: a ring of 4096 slots, 2048 a rank, whose
   decode writes (slots 2044 ... 2051) cross from rank 0's block to rank
   1's; (b) the same on (data 2, model 1) under '2d', the rows over 'data'
   and the weights gathered at use; (c) ``rwkv6-1.6b`` at full width, 2
   layers, on (1, 2): ``wkv_chunked`` on 16 of 32 heads a rank, the states
   and token shifts half a rank; (d) ``recurrentgemma-2b``'s first 3 layers
   (recurrent, recurrent, attention): the MQA ring split over slots,
   ``rec_h`` / ``conv_state`` half a rank; (e) ``seamless-m4t-large-v2``
   cut to 2 + 2 layers (its caches split over heads) and
   ``qwen2-moe-a2.7b`` cut to 2 layers (the expert-parallel MoE in
   prefill and decode); (f) the same five models on (1, 2) under 'cp'
   (``dense_cp`` ... ``moe_cp``): each rank prefills 256 of a row's 512
   positions with every head (the encoder-decoder its 256 of the frames,
   its one-token decoder prefix whole), each attention launch read at its
   query offset (0 on rank 0, T / 2 on rank 1; 0 for the encoder-decoder's)
   and each WKV launch at whether it started from a received state (rank
   1's), the last rank's states and last hidden state moved into the
   cache's blocks; the cut h2o also takes the 1 x 6140 ring request (its
   4096 slots from both ranks' positions) and the hybrid a 1 x 3072 one
   past its window of 2048 (MESH_SERVE_HYBRID_RING); each 'cp' part is
   printed beside the same model's 'tp' part from the same call (prefill
   ms, decode ms a token, bytes staged a prefill and a token, cache
   bytes), and the (1, 1) NCCL check runs under 'cp' too.  ``--only 5j``
   runs this phase alone after the build, the (1, 1) check in a world of
   its own;
5k. counts (``count_phase``): the dry-run's counter (``core.opcount``,
   ``launch.dryrun``) held to the real program on the card.  (a) In this
   process, on a (1, 1) mesh: the cut ``h2o-danube-1.8b`` (2 layers) of
   phase 5j part (a), its 4 x 512 prefill and one decode token on a cache
   of 512 slots (bf16 matrices, the dry-run's serving layout), and one
   train step of the uncut model at phase 5f's 4 x 512, each built by
   ``dryrun.build_cell`` and run once under the counter on the card and
   traced once on the meta device: FLOPs, bytes accessed, transcendentals,
   each kernel's calls and counts, argument, output and donated bytes
   must be equal.  Printed: the trace's peak of live bytes beside
   ``torch.cuda.max_memory_allocated`` (reset before the run) with their
   ratio, and beside that less what the process held before the run beside
   the step's arguments (earlier phases' tensors), and the step's time (CUDA events, median of 5 after 2 warm-up
   runs, without the counter) beside ``hloanalysis.Roofline.step_s`` of the
   counts at the H100 datasheet's peaks, as a share (AdamW counted by its
   formula on both routes, 28 bytes a parameter); the train step also
   captured (``captured_train_step``, its replays timed alike) beside the
   same roofline.  (b) A world of two
   gloo ranks sharing the card on phase 5j's (1, 2) mesh under 'tp': the
   cut h2o, ``rwkv6-1.6b`` (2 layers) and ``qwen2-moe-a2.7b`` (2 layers),
   and the cut h2o and RWKV-6 under 'cp' too (COUNT_PAIR_CP: the moves out
   of the last rank of 'model' among them), each rank's prefill and decode
   run for real and traced on meta: the
   collectives record (``runtime.collectives.record``) kind by kind, in
   count and bytes, and the FLOPs must be equal.  Every line carries the
   card's name and power limit.  No launch counts on a main path.  ``--only 5k`` runs this phase alone after the build;
6. lowered (the scheduler's path): ``auto_schedule`` of every registered
   workload, each schedule verified by ``repro_torch.check.verify_schedule``
   (the static checker and the Hopper launch lint; any finding fails the
   run and names the workload, code and key), and only then every
   ``lowered`` entry launched at the layer's true
   shapes with exactly the emitted ``block_*`` or ``chunk``
   (fused_ibn: M = b*ox*oy, D = c*fx*fy, F = k, Do = the projection's k;
   matmul_ln: M, K = c*fx*fy, N = k; flash_attention: B*H = b, Sq = ox,
   D = c, Sk = the softmax extent, non-causal; rwkv_chunk: BH = b, T =
   ox, K = c, V = k), each distinct (kernel, shapes, blocks) once,
   against its plain version with the tolerances above.  The launch
   counters are set to 0 before and read after: every kernel but the
   depthwise convolution (which is not lowered) launches here, matmul_ln
   only here; an entry whose kernel is not ported fails the run.  Then
   the checker is held to the kernels (``check_phase``): the mutation
   corpus (``check.mutations.run_corpus``) must catch 21 of 21, and for
   each kernel with a block menu (fused_ibn, flash_attention, matmul_ln)
   one emitted entry takes the corpus's ``oversize_block`` and
   ``non_pow2_block`` corruptions; the lint must flag each with
   ``lint.block_menu`` and the ``ops`` entry point must refuse it on
   CUDA tensors at the entry's launch shape with its launch counter
   unchanged.  ``rwkv_chunk`` at a chunk other than min(CHUNK, T) must
   be a ``lint.scan_chunk`` finding; ``ops.wkv_chunked`` runs any chunk
   (C = min(chunk, T) is a run-time argument of the kernel), so it is not
   asked to refuse it.  A lint finding that ``ops`` accepts, or the other
   way round, fails the run;
7. serve (``serve_phase``), the schedule store of ``repro_torch.serve``
   on the card's host: (1) a ``ServeStore(verify=True)`` warms EdgeNeXt-S
   and RWKV-6 at batch levels 1, 4, 16 and 64 over a pool of 4 spawned
   processes while this process holds the card's context: 8 entries, 8
   searched, no worker failed; (2) a fresh store on the same directory
   answers all 8 requests from disk (one ``cache.hit`` and one
   ``check.pass`` each, 0 findings), then from memory, and a store
   without the checker from disk: each hit timed on the host clock; (3)
   every lowered entry of the EdgeNeXt-S answers that the lowered phase
   did not run (deduplicated on kernel, launch shape and blocks across
   both phases: the batch-16 and batch-64 shapes) launched once against
   its plain version with the tolerances above, the counters set to 0
   before and read after, then each timed as phase 3 times a shape; a
   degraded answer is never launched, and RWKV-6's answers are verified
   only; (4) a chaos session (``serve.chaos_session``, every fault at 0.3
   with crashes that outlast the store's three search attempts, seed 0)
   over 24 EdgeNeXt-S requests at batches 1 and 4 on a store of its own:
   every request served, every answer verified (a degraded one with its
   marker), and no launch while it runs;
8. the ``{"dist": {...}}`` line, one JSON line ``{"check": {...}}`` (findings by workload, the corpus
   caught, the agreement cases), one JSON line ``{"kernels": [...]}``,
   the device line, and last ``{"ok": true, "device": {...}}``.

Per kernel the JSON line sums over one forward: ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` are each the sum over the forward's
launches of that kernel (per-shape time x how often the shape occurs):
a batch-16 EdgeNeXt-S forward for the first three, once each of the
three EdgeNeXt-S shapes matmul_ln is lowered at, and one 4 x 512 RWKV-6
prefill (24 launches at the served shape) for wkv_chunked, one train step
(24 launches at 4 x 32 x 512 x 80) for flash_attention_bwd and one RWKV-6
train step (24 launches at 128 x 512 x 64 x 64, chunk 64) for
wkv_chunked_bwd; ``shapes`` holds the per-shape numbers.  ``launches`` is
the count of the path the kernel is on: the EdgeNeXt-S requests for the
first three, the lowered phase for matmul_ln, the RWKV-6 requests for
wkv_chunked, the 20 dense train steps for flash_attention_bwd, the 20
RWKV-6 train steps for wkv_chunked_bwd (``launches_by_path`` has all
thirty-nine paths: the dense, MoE, encoder-decoder and hybrid requests as
``dense_serve``, ``moe_serve``, ``audio_serve`` and ``hybrid_serve``, phase
5i's as ``starcoder2_serve``, ``minitron_serve``, ``olmo_serve``,
``qwen2vl_serve`` and ``qwen3moe_serve``, the
train steps as ``dense_train`` and ``rwkv_train``, phase 5l's as
``audio_train``, ``hybrid_train``, ``moe_train`` and ``multiarch_train`` (the
ten reduced archs' 12 steps each), ``quickstart`` (its 120 steps and its
prefill) and ``serve_lm`` (the five archs' prefills), the serve phase's new
launches as ``serve_store``, and phase 5h's rank 0 as ``dist_serve``, one
B = 8 forward, ``dist_train``, one sharded step on (2, 1), ``dist_tp``, one
on (1, 2), ``dist_rwkv``, one RWKV-6 step on (1, 2), ``dist_cp`` and
``dist_cp_rwkv``, one step of each under 'cp' on (1, 2), ``dist_moe_train``,
one qwen2-moe step on (1, 2), and phase 5j's
rank 0 as ``mesh_serve_dense``, ``mesh_serve_dense_dp``,
``mesh_serve_rwkv``, ``mesh_serve_hybrid``, ``mesh_serve_audio``,
``mesh_serve_moe`` and the 'cp' parts' ``mesh_serve_dense_cp``,
``mesh_serve_rwkv_cp``, ``mesh_serve_hybrid_cp``, ``mesh_serve_audio_cp``
and ``mesh_serve_moe_cp``, each part's sharded prefills and decode
steps).  The WKV backward (``wkv_bwd_case``) is held
to autograd of ``ref.wkv_ref`` (2e-4 (1 + |b|) float32, 1e-3 at the
extreme decays, 2e-2 bfloat16 with a relative L2 of 2e-4 on the float32
dlogw and du) at the trained shape (bf16), a ragged 32 x 200 at chunk 64,
the extreme decays in float32 and bf16, a nonzero dS_T, two calls with
the same bits, chunk 128 (twice, same bits), chunk 8 at K = V = 16,
K = V = 40 at T = 130, and from a nonzero initial state (its gradient dS0
held as dlogw is: 4 x 130 at chunk 32, the tile instance at chunk 128, the
trained shape timed beside the same call from zero in turns,
``no_state_ms``); each record names the gradients-pass instance
``rwkv_chunk_bwd.plan`` gave it (``instance``: chunk 128 the tile one, the
others the chunk one) with its ``ptxas`` registers and spill bytes; it is
timed given the forward's workspace, its plain time
is autograd of ``wkv_ref``'s backward, ``plain_chunked_ms`` autograd of
``models.rwkv6.wkv_chunked`` (what ``jax.grad`` differentiates), no
library call; its operations are ``wkv_bwd_macs``.
The backward is held to autograd of ``ref.attention_ref`` (2e-3 (1 + |b|)
float32, 2e-2 bfloat16) at the trained heads (h2o 80, olmo 128,
Seamless 64 self and cross, RecurrentGemma 256; untimed, the reduced
configs' float32 D 16 at 4 x 48 that phase 5l's ``train_multiarch``
trains, causal, non-causal and under a window of 32) and at a query offset
(RecurrentGemma's 1 x 4608 split in two, timed beside the same call
without the offset in turns, ``no_offset_ms``; the whole-row forward's lse
and h2o's second 'cp' rank, 256 queries at 256, untimed), its ``library_ms`` is
SDPA's backward and each of its records also times the forward with and
without its lse and each of its three kernels (``kernel_ms``, by
``torch.profiler``), and names the instance it ran (``plan``, from
``flash_attention_bwd.instance``) with the ``ptxas`` registers and spill
bytes of its two kernels (``ptxas``; each instance's are also printed after
the build); its operations are five products of 2 Sq Sk D over the
unmasked pairs.  ``bound_ms`` is the larger
of bytes / 3.35 TB/s (each input read once, each output written once)
and operations / peak: 495 TFLOP/s (TF32 tensor cores, the card's rate
for a float32 matrix product) for the products of fused_ibn, attention,
matmul_ln and WKV (2 * ``core.workload.scan_macs`` at the run's chunk;
its sums are float32 whatever the input type), 67 TFLOP/s (float32
outside the tensor cores) for the depthwise convolution, which has no
matrix product; 989 TFLOP/s for bfloat16 products.  The matrix
products' shapes also carry ``bound_fp32_cuda_core_ms``, the same bound
at 67 TFLOP/s, the rate of the exact float32 multiply-adds attention's
online regime runs (fused_ibn, matmul_ln, attention's whole-row regime
and WKV run 3xTF32 on the tensor cores: three TF32 products for each one
counted here).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch import profile_flash_attention_bwd as fab_prof  # noqa: E402
from repro_torch.check import lint_doc, verify_schedule  # noqa: E402
from repro_torch.check.mutations import MUTATIONS, run_corpus  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint, restore,  # noqa: E402
                                    restore_sharded, save_checkpoint)
from repro_torch import quickstart, train_multiarch  # noqa: E402
from repro_torch import serve_lm as serve_lm_example  # noqa: E402
from repro_torch.configs import ARCHS, ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.configs.edgenext_s import CONFIG  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import adamw as adamw_mod  # noqa: E402
from repro_torch.kernels import depthwise_conv as dw_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab_mod  # noqa: E402
from repro_torch.kernels import fused_ibn as ibn_mod  # noqa: E402
from repro_torch.kernels import matmul_ln as mln_mod  # noqa: E402
from repro_torch.kernels import rwkv_chunk as wkv_mod  # noqa: E402
from repro_torch.kernels import rwkv_chunk_bwd as wkvb_mod  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.models import (edgenext, recurrentgemma, rwkv6,  # noqa: E402
                                seamless, transformer)
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import get_module  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.models.params import (count_params, init_params,  # noqa: E402
                                       per_layer, tree_leaves, tree_map)
from repro_torch.models.params import init_on_device as draw_on_device  # noqa: E402
from repro_torch.optim import adamw_init, global_norm, warmup_cosine  # noqa: E402
from repro_torch.optim.compression import (compressed_pod_allreduce,  # noqa: E402
                                           dequantize_int8, quantize_with_feedback)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import moe_sharded  # noqa: E402
from repro_torch.runtime import collectives, sharding  # noqa: E402
from repro_torch.runtime import pipeline as dist_pipeline  # noqa: E402
from repro_torch.runtime import (build_decode_step, build_grad_fn,  # noqa: E402
                                 build_prefill_step, build_train_step)
from repro_torch.runtime.capture import WARMUP, captured, captured_train_step  # noqa: E402
from repro_torch.search import (WORKLOADS, auto_schedule,  # noqa: E402
                                get_workload, lower)
from repro_torch.core.workload import NORM, PWCONV, SCAN, Layer, scan_macs  # noqa: E402
from repro_torch.core import hloanalysis, opcount  # noqa: E402
from repro_torch.core.opcount import unmasked_pairs, wkv_bwd_macs  # noqa: E402
from repro_torch.serve import (BATCH_LEVELS, ChaosPlan, ServeStore,  # noqa: E402
                               chaos_session)
from repro_torch.serve_edgenext import serve  # noqa: E402
from repro_torch.profile_edgenext import trace  # noqa: E402

MEM_BYTES_S = 3.35e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
BATCH = 16
SEED = 0

KERNELS = {
    "fused_ibn": dict(module=ibn_mod,
                      source="src/repro_torch/kernels/csrc/fused_ibn.cu",
                      replaces="src/repro/kernels/fused_ibn.py:102"),
    "depthwise_conv2d": dict(module=dw_mod,
                             source="src/repro_torch/kernels/csrc/depthwise_conv.cu",
                             replaces="src/repro/kernels/depthwise_conv.py:42"),
    "flash_attention": dict(module=fa_mod,
                            source="src/repro_torch/kernels/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:86"),
    "matmul_ln": dict(module=mln_mod,
                      source="src/repro_torch/kernels/csrc/matmul_ln.cu",
                      replaces="src/repro/kernels/matmul_ln.py:70"),
    "wkv_chunked": dict(module=wkv_mod,
                        source="src/repro_torch/kernels/csrc/wkv_chunked.cu",
                        replaces="src/repro/kernels/rwkv_chunk.py:88"),
    "flash_attention_bwd": dict(module=fab_mod,
                                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                replaces="src/repro/models/attention.py:111"),
    "wkv_chunked_bwd": dict(module=wkvb_mod,
                            source="src/repro_torch/kernels/csrc/wkv_chunked_bwd.cu",
                            replaces="src/repro/models/rwkv6.py:100"),
    "adamw": dict(module=adamw_mod, source="src/repro_torch/kernels/csrc/adamw.cu",
                  replaces="src/repro/optim/adamw.py:47 (upd, which XLA fuses under the "
                           "launcher's jit; it replaces no Pallas kernel)"),
}
# the path whose run gives each kernel's ``launches``: the EdgeNeXt-S
# forward launches the first three, the RWKV-6 prefill wkv_chunked, and
# matmul_ln runs only on the lowered path (flash_attention also runs on the
# dense path: ``launches_by_path``), the two backwards and AdamW only in
# training
MAIN_PATH = {"fused_ibn": "edgenext_serve", "depthwise_conv2d": "edgenext_serve",
             "flash_attention": "edgenext_serve", "matmul_ln": "lowered",
             "wkv_chunked": "rwkv6_serve", "flash_attention_bwd": "dense_train",
             "wkv_chunked_bwd": "rwkv_train", "adamw": "dense_train"}
# lowered kernel name -> the kernel that runs it
LOWERED = {"fused_ibn": "fused_ibn", "flash_attention": "flash_attention",
           "matmul_ln": "matmul_ln", "rwkv_chunk": "wkv_chunked"}

# RWKV-6 traffic: (batch, prompt tokens) per request, greedy tokens each
# the serve phase: the store warms these workloads at every batch level over
# a pool of SERVE_JOBS spawned processes, and launches the lowered entries of
# SERVE_LAUNCHED's answers; its chaos session arms every fault at 0.3, with
# crashes that outlast the store's three search attempts, so that some
# answers come off the degraded rungs
SERVE_WORKLOADS = ("edgenext-s", "rwkv6")
SERVE_LAUNCHED = "edgenext-s"
SERVE_JOBS = 4
CHAOS_PLAN = "all=0.3,crash_attempts=3"
CHAOS_REQUESTS = 24
CHAOS_BATCHES = (1, 4)
RWKV_REQUESTS = [(4, 512)] * 3 + [(1, 200)]
RWKV_GEN = 32
# rounds of prefill / decode timing of its first and last request, eager
# and captured in turns ((10, 5) until phase 5h's part (j) came: eager
# decode is ~52 ms a token here)
RWKV_ROUNDS = (10, 3)
RWKV_PARAMS = 1_599_873_024
# the dense phase: h2o-danube-1.8b uncut, (batch, prompt tokens, greedy
# tokens) per request; the 1 x 4608 prompt is longer than the window (4096):
# the banded prefill and a ring cache
DENSE_ARCH = "h2o-danube-1.8b"
DENSE_REQUESTS = [(4, 512, 32), (4, 512, 32), (1, 4608, 8)]
DENSE_PARAMS = 1_831_201_280
# the MoE phase: qwen2-moe-a2.7b at full width and MOE_LAYERS of its 24
# layers (every layer has the same shapes; 8 layers until phase 5h, whose
# time the cut to 4 pays for); its float32 check: (layers, batch, prompt
# tokens, greedy steps)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_LAYERS = 4
MOE_REQUESTS = [(4, 512, 32), (4, 512, 32), (1, 200, 16)]
MOE_PARAMS = 3_042_994_176
MOE_F32 = (2, 2, 256, 4)
# the encoder-decoder phase: seamless-m4t-large-v2 uncut; (batch, source
# frames, greedy tokens) per request, the decoder's prefix one token
AUDIO_ARCH = "seamless-m4t-large-v2"
AUDIO_REQUESTS = [(4, 512, 32), (4, 512, 32), (1, 1500, 16)]
AUDIO_PARAMS = 1_632_358_400
# the hybrid phase: recurrentgemma-2b uncut; (batch, prompt tokens, greedy
# tokens) per request; the 1 x 4608 prompt is longer than the window (2048):
# the banded prefill, a ring cache of 2048, the scan over 4608 rows; its
# float32 check: (layers, batch, prompt tokens, greedy steps), the first
# three layers (recurrent, recurrent, attention) of the served weights
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_REQUESTS = [(4, 512, 32), (4, 512, 32), (1, 4608, 8)]
HYBRID_PARAMS = 3_549_934_080
HYBRID_F32 = (3, 2, 300, 4)
# phase 5i: the five LM configs that had run only at reduced size on the CPU,
# each at full width (arch -> (tag, parameters served, layers served: None
# for all of them)), weights drawn on the card from the seed
# (``init_on_device``; a cut config serves the first layers of the uncut
# draw); starcoder2-15b and qwen3-moe-30b-a3b, the two slowest, cut to a
# quarter of their layers (half since phases 5h (h) and (i) were added, a
# quarter since 5l), to keep the script within its time (every layer has
# the same shapes); (batch, prompt tokens, greedy
# tokens) per request, the 1 x 200 prompt ragged against the 64-key tile;
# the float32 check on the first layers of the same draw (``layers=``):
# (layers, batch, prompt tokens, greedy steps).  A phase whose peak passes
# FIVE_PEAK_GIB fails (qwen3-moe holds 61.7 GB of bf16 weights; every layer
# has the same shapes, so such a peak would be met by cutting layers).
FIVE = {"starcoder2-15b": ("starcoder2", 4_442_025_984, 10),
        "minitron-4b": ("minitron", 4_190_509_056, None),
        "olmo-1b": ("olmo", 1_176_764_416, None),
        "qwen2-vl-2b": ("qwen2vl", 1_777_030_656, None),
        "qwen3-moe-30b-a3b": ("qwen3moe", 8_099_779_584, 12)}
FIVE_REQUESTS = [(4, 512, 32), (1, 200, 16)]
FIVE_F32 = (2, 2, 256, 4)
# rounds of prefill / decode timing, eager and captured in turns (5b-5e take
# (6, 3)): eager decode is bound by the host at 40-230 ms a token here, and
# one round of it (each a request's 32 or 16 tokens; two until phase 5h's
# part (j) came) keeps the script within its time
FIVE_ROUNDS = (6, 1)
FIVE_PEAK_GIB = 76
# the training phase: the dense phase's weights (h2o-danube-1.8b uncut) as
# float32 masters, bfloat16 compute with remat, TRAIN_STEPS steps of
# ``build_train_step`` as ``launch.train`` builds it over (batch, tokens)
# from ``data.synthetic``; a checkpoint after TRAIN_CKPT steps, restored
# into fresh tensors, must give the rest of the run bit for bit; the float32
# check on the first TRAIN_F32_LAYERS layers (RecurrentGemma's up to its
# first attention layer, 3).  A training run whose peak passes
# FIVE_PEAK_GIB fails.  The first step's gradients
# against the plain step's (both bfloat16; they differ in the 24 attention
# calls only): each leaf within a relative L2 error of TRAIN_GRAD_REL, the
# loss within TRAIN_LOSS_TOL, the global norm within TRAIN_NORM_REL.
TRAIN_STEPS = 20
# the first TRAIN_EAGER_STEPS steps run eagerly from the same draw before the
# captured run, which must repeat them bit for bit: the WARMUP eager steps,
# the capture and at least one more replay
TRAIN_EAGER_STEPS = WARMUP + 2
TRAIN_BATCH = (4, 512)
TRAIN_LR, TRAIN_WARMUP, TRAIN_CLIP = 3e-4, 5, 1.0
TRAIN_CKPT = 10
TRAIN_F32_LAYERS = 2
TRAIN_GRAD_REL, TRAIN_LOSS_TOL, TRAIN_NORM_REL = 5e-2, 1e-2, 1e-2
# phase 5l: the encoder-decoder, the hybrid and the MoE trained on the card
# (``train_path``) with 5f's schedule, steps, batch and limits (over 10
# steps the 4-layer MoE's loss did not fall: 20 steps show it); each part
# (tag, arch, layers: None for all of them, flash_attention launches a
# prefill, parameters trained), the MoE at 4 of its 24 layers as 5c serves
# it.  Then ``train_multiarch`` on the card: every arch of
# ``configs.ARCHS`` at reduced size, the example's 12 steps
FAMILIES = (("train_audio", AUDIO_ARCH, None, 72, AUDIO_PARAMS),
            ("train_hybrid", HYBRID_ARCH, None, 8, HYBRID_PARAMS),
            ("train_moe", MOE_ARCH, MOE_LAYERS, MOE_LAYERS, MOE_PARAMS))
# the second training phase: RWKV-6's served weights (rwkv6-1.6b uncut) as
# float32 masters, the same schedule, steps, batch and limits as the first;
# its plain step runs ``wkv_ref`` under autograd (about 512 saved [128, 64,
# 64] float32 states a layer while remat recomputes it: ~3 GB, ~0.2 s of
# backward a layer), so the full batch fits and no cut is needed
RWKV_ARCH = "rwkv6-1.6b"
# The served bfloat16 run against the plain bfloat16 model, teacher-forced
# with the served tokens.  The two differ only in the WKV: the kernel and
# ``wkv_ref`` take the same float32 sums in another order and round them to
# bfloat16 (2^-8 relative) at one place, so single-ulp flips of the WKV
# output enter each of 24 residual layers.  Logits here are O(1) (|logits|
# <= ~6 on random weights): a logit that moves by more than BF16_LOGITS_TOL
# (a few percent of that range) is a fault, not rounding.  Greedy tokens
# may flip where the top two logits are closer than the noise, so
# BF16_AGREEMENT asks for most, not all, of them.
BF16_LOGITS_TOL = 0.25
BF16_AGREEMENT = 0.75
# the distributed phase (5h): h2o-danube-1.8b at full width and DIST_LAYERS
# of its 24 layers (two processes share the card in part (c); phases 5j and
# 5k cut it alike; 4 layers until phase 5l's time was paid by this cut
# from 5h's and 5j's, the largest phases), DIST_STEPS (5 until then)
# steps of 5f's schedule and batch, the float32 check on (layers, steps)
# DIST_F32, each leaf's change over them within a relative L2 error of
# DIST_F32_MOVED_REL, a checkpoint after DIST_CKPT steps; EdgeNeXt-S at
# DIST_EDGE_BATCH images over data = 2, and DIST_EDGE_ODD, which 2 does not
# divide; one qwen2-moe-a2.7b MoE layer over (batch, tokens)
# DIST_MOE_TOKENS; each world's time limit DIST_WORLD_S
DIST_LAYERS = 2
DIST_STEPS = 3
DIST_F32 = (2, 3)
DIST_F32_MOVED_REL = 1e-2
DIST_CKPT = 3
DIST_EDGE_BATCH, DIST_EDGE_ODD = 16, 7
DIST_MOE_TOKENS = (4, 512)
DIST_MOE_TOL = 2e-2
DIST_WORLD_S = 300
# part (f): the same cut dense model on (data 1, model 2), each rank half of
# the heads, d_ff and vocabulary; its grad_fn's FLOPs (aten products, by
# FlopCounterMode) at most DIST_TP_FLOPS of one process's; part (g):
# rwkv6-1.6b at full width and DIST_RWKV_LAYERS layers on (1, 2),
# DIST_RWKV_STEPS steps against one process's in rank 0
DIST_TP_FLOPS = 0.55
DIST_RWKV_LAYERS, DIST_RWKV_STEPS = 2, 2
# parts (h) and (i): the same two models under 'cp' on (data 1, model 2),
# each rank 256 of a row's 512 tokens; the cut dense model's losses within
# DIST_CP_LOSS_TOL of one process's (part (a)), RWKV-6's (float32) within
# DIST_CP_RWKV_LOSS_TOL
DIST_CP_LOSS_TOL = 1e-4
DIST_CP_RWKV_LOSS_TOL = 1e-5
# part (j): qwen2-moe-a2.7b at full width and DIST_MOE_TRAIN_LAYERS of its
# 24 layers on (data 1, model 2) under '2d' (the MoE expert-parallel by
# ``moe_apply_sharded``), float32, DIST_MOE_TRAIN_STEPS steps of 5f's
# schedule and batch against one process's in rank 0 (part (f)'s limits
# and FLOP share)
DIST_MOE_TRAIN_LAYERS, DIST_MOE_TRAIN_STEPS = 2, 2
# phase 5j, sharded serving: each part's (part, path name, arch, layers,
# mesh, profile); a MESH_SERVE_PROMPT prefill and MESH_SERVE_GEN greedy
# tokens a part, part (a) also MESH_SERVE_RING (a ring of 4096 slots whose
# decode writes cross from rank 0's block to rank 1's); float32 on
# MESH_SERVE_F32 = (layers, decode steps) within MESH_SERVE_F32_TOL; each
# world's time limit MESH_SERVE_WORLD_S
MESH_SERVE_PARTS = (
    ("a", "dense", DENSE_ARCH, DIST_LAYERS, (1, 2), "tp"),
    ("b", "dense_dp", DENSE_ARCH, DIST_LAYERS, (2, 1), "2d"),
    ("c", "rwkv", RWKV_ARCH, 2, (1, 2), "tp"),
    ("d", "hybrid", HYBRID_ARCH, 3, (1, 2), "tp"),
    ("e", "audio", AUDIO_ARCH, 2, (1, 2), "tp"),
    ("e", "moe", MOE_ARCH, 2, (1, 2), "tp"),
    ("f", "dense_cp", DENSE_ARCH, DIST_LAYERS, (1, 2), "cp"),
    ("f", "rwkv_cp", RWKV_ARCH, 2, (1, 2), "cp"),
    ("f", "hybrid_cp", HYBRID_ARCH, 3, (1, 2), "cp"),
    ("f", "audio_cp", AUDIO_ARCH, 2, (1, 2), "cp"),
    ("f", "moe_cp", MOE_ARCH, 2, (1, 2), "cp"))
MESH_SERVE_PROMPT = (4, 512)
MESH_SERVE_GEN = 8
MESH_SERVE_RING = (1, 6140, 8)
# the hybrid's request past its window of 2048 under 'cp': 1536 positions a
# rank, the ring's positions 1024 ... 3071 from both ranks
MESH_SERVE_HYBRID_RING = (1, 3072, 8)
MESH_SERVE_EXTRA = {"dense": [MESH_SERVE_RING], "dense_cp": [MESH_SERVE_RING],
                    "hybrid_cp": [MESH_SERVE_HYBRID_RING]}
MESH_SERVE_F32 = (2, 4)
MESH_SERVE_F32_TOL = 2e-3
MESH_SERVE_WORLD_S = 400
# phase 5k, the counter (``core.opcount``) held to the real program: (a) in
# this process, the cut dense model's MESH_SERVE_PROMPT prefill and one
# decode token (phase 5j part (a)'s model and prompt; the decode on bf16
# matrices, the dry-run's serving layout) and one train step of the uncut
# dense model at TRAIN_BATCH (phase 5f's shape), each counted in a real run
# on the card and in a trace on the meta device; (b) a world of two gloo
# ranks sharing the card, phase 5j's (1, 2) mesh under 'tp', each rank's
# collectives in its real prefill and decode against its meta trace's, for
# COUNT_PAIR's (arch, layers); COUNT_REPS timed runs after COUNT_WARMUP
COUNT_PAIR = ((DENSE_ARCH, DIST_LAYERS), (RWKV_ARCH, 2), (MOE_ARCH, 2))
# the archs of COUNT_PAIR counted under 'cp' too
COUNT_PAIR_CP = (DENSE_ARCH, RWKV_ARCH)
COUNT_REPS, COUNT_WARMUP = 5, 2
COUNT_WORLD_S = 180


def fail(msg: str) -> None:
    """Ends the run with code 1, the reason on standard output and on
    standard error (where a caller that keeps only the error stream sees
    which check failed)."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run_text(cmd: list[str]) -> str:
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=True, timeout=120).stdout.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_flush = None


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of ``fn()``: one event pair around each call,
    the 50 MB L2 cache flushed (a 256 MB buffer zeroed) before each."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def both_clocks(fn):
    """(fn(), CUDA-event ms, host wall ms from the call to a synchronise)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return out, start.elapsed_time(end), wall


def alternate(forms: dict, rounds: int, per: int = 1) -> dict:
    """Each of ``forms`` (name -> fn) once a round, in turns whose order
    flips every round, under inference mode -> per form the medians of
    both clocks (each divided by ``per``), their difference (the host's
    time outside the device's span) and every reading."""
    names = list(forms)
    got = {n: ([], []) for n in names}
    with torch.inference_mode():
        for r in range(rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                _, ev, wall = both_clocks(forms[n])
                got[n][0].append(ev / per)
                got[n][1].append(wall / per)
    out = {}
    for n, (ev, wall) in got.items():
        e, w = statistics.median(ev), statistics.median(wall)
        out[n] = dict(event_ms=e, wall_ms=w, wall_minus_event_ms=w - e,
                      event_ms_all=ev, wall_ms_all=wall)
    return out


def peak_mib(fn) -> float:
    """Peak device memory allocated over ``fn()`` (inference mode), MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20


def capture_counted(fn) -> tuple:
    """Runs ``fn()`` (a first call that captures) with the launch counters
    set to 0 before and read after -> (its result, the counts, MiB the
    caching allocator reserved for it: the graph's pool and its static
    buffers)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    reset_counts()
    out = fn()
    counts = read_counts()
    return out, counts, (torch.cuda.memory_reserved() - before) / 2 ** 20


def first_difference(got: list, want: list) -> str | None:
    """None if each pair is bit for bit equal (shape, dtype, bits); else
    which pair differs first and by how much."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if g.shape != w.shape or g.dtype != w.dtype:
            return f"#{i}: {tuple(g.shape)} {g.dtype} against {tuple(w.shape)} {w.dtype}"
        if not torch.equal(g, w):
            d = (g.float() - w.float()).abs().max().item()
            return f"#{i} {tuple(g.shape)}: max |difference| {d:.3e}"
    return None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = bytes_moved / MEM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def online_ptxas(log: str) -> dict:
    """``ptxas -v``'s registers and spill bytes of each ``online_kernel``
    instance: "float32 128" / "bf16 256" -> (registers, spill stores, spill
    loads)."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            if m.group(1) != name:
                spill = (0, 0)
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        inst = name and re.search(r"online_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
        if m and inst:
            key = f"{'float32' if inst.group(1) == 'f' else 'bf16'} {inst.group(2)}"
            out[key] = (int(m.group(1)), *spill)
    return dict(sorted(out.items()))


def reset_counts() -> None:
    torch.cuda.synchronize()
    for info in KERNELS.values():
        info["module"].launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: info["module"].launches for name, info in KERNELS.items()}


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: got {tuple(got.shape)} {got.dtype}, "
             f"want {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: kernel output not finite")
    err = (g - w).abs()
    if not bool((err <= tol + tol * w.abs()).all()):
        fail(f"{name}: disagrees with the plain version, max abs err "
             f"{err.max().item():.3e} at tolerance {tol}")
    return err.max().item()


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed) and the per-kernel cases
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(SEED)


def randn(*shape, scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    a = (_rng.standard_normal(shape, dtype=np.float32) * scale)
    return torch.from_numpy(a).to(dtype).cuda()


def ibn_library(x, w1, w2, wg, act):
    """The same function as two library products around the activation."""
    act_fn = {"gelu": lambda t: F.gelu(t, approximate="tanh"), "silu": F.silu,
              "relu2": lambda t: torch.square(torch.relu(t))}[act]
    h = act_fn(torch.matmul(x, w1 if wg is None else wg))
    return torch.matmul(h if wg is None else h * torch.matmul(x, w1), w2)


def ibn_case(M, D, Fd, Do, *, gated=False, act="gelu", dtype=torch.float32,
             timed=False, blocks=None, w_scale=(0.1, 0.1), min_splits=1):
    x = randn(M, D, dtype=dtype)
    w1 = randn(D, Fd, scale=w_scale[0], dtype=dtype)
    w2 = randn(Fd, Do, scale=w_scale[1], dtype=dtype)
    wg = randn(D, Fd, scale=w_scale[0], dtype=dtype) if gated else None
    name = f"fused_ibn[{M}x{D}x{Fd}x{Do} {act}{' gated' if gated else ''} " \
           f"{str(dtype).split('.')[-1]}]"
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    plan = ibn_mod.plan(M, Fd, Do, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["splits"] < min_splits:
        fail(f"{name}: {plan['splits']} splits, the case needs at least {min_splits}")
    got = ops.fused_ibn(x, w1, w2, wg, activation=act, **(blocks or {}))
    want = ref.fused_ibn_ref(x, w1, w2, wg, activation=act)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol,
               splits=plan["splits"], ctas=plan["ctas"])
    if timed:
        flops = 2.0 * M * (D * Fd * (2 if gated else 1) + Fd * Do)
        moved = nbytes(x, w1, w2, wg, got)
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(moved, flops, peak)
        rec["bound_fp32_cuda_core_ms"] = bound(moved, flops, PEAK_FP32)[0]
        rec["ms"] = time_ms(lambda: ops.fused_ibn(x, w1, w2, wg, activation=act))
        rec["plain_ms"] = time_ms(
            lambda: ref.fused_ibn_ref(x, w1, w2, wg, activation=act))
        rec["library_ms"] = time_ms(lambda: ibn_library(x, w1, w2, wg, act))
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def ibn_rounding_case():
    """relu2(1 + 2^-7) rounds to 1 + 2^-6 in bfloat16, so against
    w2 = [1 + 2^-6, -1] the two terms cancel exactly: the kernel rounds T to
    the input type before the second product, or it returns -6.1e-5."""
    bf16 = torch.bfloat16
    x = torch.tensor([[1.0]], dtype=bf16, device="cuda")
    w1 = torch.tensor([[1.0, 1.0078125]], dtype=bf16, device="cuda")
    w2 = torch.tensor([[1.015625], [-1.0]], dtype=bf16, device="cuda")
    got = ops.fused_ibn(x, w1, w2, activation="relu2")
    name = "fused_ibn[rounding of T, relu2 bfloat16]"
    err = compare(name, got, ref.fused_ibn_ref(x, w1, w2, activation="relu2"), 0.0)
    if got.float().item() != 0.0:
        fail(f"{name}: {got.float().item()} instead of 0")
    return dict(case=name, max_abs_err=err, tol=2e-2)


def dw_case(B, H, W, C, k, *, dtype=torch.float32, slice_of=None, timed=False,
            repeat=False):
    """``k`` is the kernel's size, or (fy, fx)."""
    fy, fx = (k, k) if isinstance(k, int) else k
    if slice_of is None:
        x = randn(B, H, W, C, dtype=dtype)
    else:   # a channel slice of a wider activation, as the SDTA cascade gives
        total, start = slice_of
        x = randn(B, H, W, total, dtype=dtype)[..., start:start + C]
    w = randn(fy, fx, C, scale=0.2, dtype=dtype)
    b = randn(C, scale=0.1, dtype=dtype)
    size = f"k{fy}" if fy == fx else f"k{fy}x{fx}"
    name = f"depthwise_conv2d[{B}x{H}x{W}x{C} {size}" \
           f"{f' slice at {slice_of[1]} of {slice_of[0]}' if slice_of else ''} " \
           f"{str(dtype).split('.')[-1]}]"
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    plan = dw_mod.plan(B, H, W, C, fy, fx,
                       torch.cuda.get_device_properties(0).multi_processor_count,
                       itemsize=x.element_size(),
                       align=dw_mod.alignment(x, w, dw_mod._pixel_stride(x)))
    got = ops.depthwise_conv2d(x, w, b)
    want = ref.depthwise_conv2d_ref(x, w, b)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol,
               **{key: plan[key] for key in ("th", "tw", "cb", "cv", "ctas", "smem")})
    if repeat:
        again = ops.depthwise_conv2d(x, w, b)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{name}: two calls on the same inputs differ "
                 f"(max {(got - again).abs().max().item():.3e})")
        rec["case"] = name + " twice, same bits"
    if timed:
        flops = 2.0 * B * H * W * C * fy * fx
        rec["bound_ms"], rec["bound_by"] = bound(nbytes(x, w, b, got), flops,
                                                 PEAK_FP32)
        rec["ms"] = time_ms(lambda: ops.depthwise_conv2d(x, w, b))
        rec["plain_ms"] = time_ms(lambda: ref.depthwise_conv2d_ref(x, w, b),
                                  reps=5, warmup=1)
        x_nchw = x.permute(0, 3, 1, 2)            # channels_last memory, no copy
        w_oihw = w.permute(2, 0, 1)[:, None].contiguous()
        rec["library_ms"] = time_ms(
            lambda: F.conv2d(x_nchw, w_oihw, b, padding=(fy // 2, fx // 2), groups=C))
        rec["gbytes_s"] = nbytes(x, w, b, got) / rec["ms"] / 1e6
    return rec


def sdpa_library(q, k, v, causal, window, scale, q_offset: int = 0):
    """The library call of the same function: SDPA causal, with a boolean
    mask where a window or a query offset is set, else unmasked."""
    if window is None and not q_offset:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      scale=scale)
    Sq, Sk = q.shape[2], k.shape[2]
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = ((qp - kp < window) if window is not None else True) \
        & ((qp >= kp) if causal else True)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def paired_ms(fn, other, rounds: int = 2) -> tuple[float, float]:
    """``time_ms`` of two forms of a call in turns (fn, other, other, fn,
    ...): the median of each form's readings."""
    got = ([], [])
    for r in range(rounds):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            got[i].append(time_ms((fn, other)[i]))
    return statistics.median(got[0]), statistics.median(got[1])


def fa_case(B, H, Sq, Sk, D, *, causal=True, window=None, scale=None,
            dtype=torch.float32, xca=False, timed=False, blocks=None,
            repeat=False, kv_heads=None, q_offset=0):
    """``kv_heads``: k and v made with that many heads and repeated over
    the query heads' groups, as the LM's GQA hands them over; ``q_offset``:
    the queries of a sequence shard at that position (timed also beside
    the same call without it, in turns: ``no_offset_ms``)."""
    q = randn(B, H, Sq, D, dtype=dtype)
    hk = kv_heads or H
    k = randn(B, hk, Sk, D, dtype=dtype).repeat_interleave(H // hk, dim=1)
    v = randn(B, hk, Sk, D, dtype=dtype).repeat_interleave(H // hk, dim=1)
    if xca:     # as the model calls it: rows L2-normalised over D, scale 1
        q = (q / q.norm(dim=-1, keepdim=True)).contiguous()
        k = (k / k.norm(dim=-1, keepdim=True)).contiguous()
    name = f"flash_attention[{B}x{H}x{Sq}x{Sk}x{D} causal={causal} " \
           f"window={window} {str(dtype).split('.')[-1]}" \
           f"{f' gqa {H}/{hk}' if kv_heads else ''}" \
           f"{f' q_offset={q_offset}' if q_offset else ''}]"
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    kw = dict(causal=causal, window=window, scale=scale,
              **({"q_offset": q_offset} if q_offset else {}))
    plan = fa_mod.plan(B * H, Sq, Sk, D, torch.cuda.get_device_properties(0)
                       .multi_processor_count, itemsize=q.element_size())
    got = ops.flash_attention(q, k, v, **kw, **(blocks or {}))
    want = ref.attention_ref(q, k, v, **kw)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol,
               regime=plan["regime"], splits=plan["splits"],
               row_splits=plan["row_splits"], ctas=plan["ctas"])
    del want
    if repeat:
        again = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{name}: two calls on the same inputs differ "
                 f"(max {(got - again).abs().max().item():.3e})")
        rec["case"] = name + " twice, same bits"
    if timed:
        pairs = B * H * unmasked_pairs(Sq, Sk, causal, window, q_offset)
        flops = 4.0 * D * pairs
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(nbytes(q, k, v, got), flops, peak)
        rec["unmasked_pairs"] = pairs
        if q_offset:
            rec["ms"], rec["no_offset_ms"] = paired_ms(
                lambda: ops.flash_attention(q, k, v, **kw),
                lambda: ops.flash_attention(q, k, v, causal=causal, window=window,
                                            scale=scale))
        else:
            rec["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        rec["plain_ms"] = time_ms(lambda: ref.attention_ref(q, k, v, **kw))
        rec["library_ms"] = time_ms(sdpa_library(q, k, v, causal, window, scale,
                                                 q_offset))
        rec["gbytes_s"] = nbytes(q, k, v, got) / rec["ms"] / 1e6
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def bwd_case(B, H, Sq, Sk, D, *, causal=True, window=None, dtype=torch.bfloat16,
             kv_heads=None, timed=False, repeat=False, q_offset=0):
    """The attention backward kernel (``flash_attention_bwd``, given the
    forward kernel's out and lse) against autograd of ``ref.attention_ref``
    on the same inputs: dq, dk, dv within 2e-3 (1 + |b|) in float32 (the JAX
    test's tolerance) and 2e-2 in bfloat16; the forward's lse against
    ``ref.attention_fwd_lse_ref``'s within 2e-4.  Timed: the kernel, the
    plain version's backward (autograd of ``attention_ref``), SDPA's
    backward (the library call: timed only), the forward with and without
    its lse, and each of the call's three kernels by ``torch.profiler``.
    Every record names the compiled instance it ran (``plan``:
    ``flash_attention_bwd.PLAN``'s row) with the registers and spill bytes
    ``ptxas`` gave its two kernels.  ``q_offset``: the queries of a
    sequence shard at that position, timed also beside the same call without
    it (its own forward's out and lse), in turns: ``no_offset_ms``."""
    q = randn(B, H, Sq, D, dtype=dtype)
    hk = kv_heads or H
    k = randn(B, hk, Sk, D, dtype=dtype).repeat_interleave(H // hk, dim=1)
    v = randn(B, hk, Sk, D, dtype=dtype).repeat_interleave(H // hk, dim=1)
    dout = randn(B, H, Sq, D, dtype=dtype)
    name = f"flash_attention_bwd[{B}x{H}x{Sq}x{Sk}x{D} causal={causal} " \
           f"window={window} {str(dtype).split('.')[-1]}" \
           f"{f' gqa {H}/{hk}' if kv_heads else ''}" \
           f"{f' q_offset={q_offset}' if q_offset else ''}]"
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    kw = dict(causal=causal, window=window, **({"q_offset": q_offset} if q_offset else {}))
    out, lse = fa_mod.flash_attention(q, k, v, **kw, return_lse=True)
    lse_err = compare(name + " lse", lse, ref.attention_fwd_lse_ref(q, k, v, **kw)[1],
                      2e-4)
    got = fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    plain_out = ref.attention_ref(*leaves, **kw)
    want = torch.autograd.grad(plain_out, leaves, dout, retain_graph=timed)
    err = max(compare(f"{name} {n}", g, w, tol) for n, g, w in zip("qkv", got, want))
    inst = fab_mod.instance(D, dtype)
    rec = dict(case=name, max_abs_err=err, tol=tol, lse_err=lse_err, plan=inst,
               ptxas=fab_mod.ptxas_of(inst, _build.ptxas_log()))
    del want
    if repeat:
        again = fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name}: two calls on the same inputs differ")
        rec["case"] = name + " twice, same bits"
    if timed:
        pairs = B * H * unmasked_pairs(Sq, Sk, causal, window, q_offset)
        flops = 10.0 * D * pairs        # S, dP, dV, dK, dQ: 2 D flops a pair each
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(
            nbytes(q, k, v, out, dout, lse, *got), flops, peak)
        rec["unmasked_pairs"] = pairs
        call = (lambda: fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw))
        if q_offset:
            plain_kw = dict(causal=causal, window=window)
            out0, lse0 = fa_mod.flash_attention(q, k, v, **plain_kw, return_lse=True)
            rec["ms"], rec["no_offset_ms"] = paired_ms(call, lambda: fab_mod.flash_attention_bwd(
                q, k, v, out0, lse0, dout, **plain_kw))
        else:
            rec["ms"] = time_ms(call)
        rec["plain_ms"] = time_ms(lambda: torch.autograd.grad(
            plain_out, leaves, dout, retain_graph=True))
        lib_out = sdpa_library(*leaves, causal, window, None, q_offset)()
        rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True))
        rec["fwd_ms"] = time_ms(lambda: fa_mod.flash_attention(q, k, v, **kw))
        rec["fwd_lse_ms"] = time_ms(lambda: fa_mod.flash_attention(
            q, k, v, **kw, return_lse=True))
        rec["tflops"] = flops / rec["ms"] / 1e9
        # each of its three kernels by torch.profiler, the L2 flushed
        # before each call (as time_ms does)
        rec["kernel_ms"] = fab_prof.kernel_ms(lambda: fab_mod.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw), _flush)
        if sorted(rec["kernel_ms"]) != sorted(fab_prof.KINDS):
            fail(f"{name}: the profiler saw the kernels {sorted(rec['kernel_ms'])}")
    return rec


def bwd_text(rec: dict) -> str:
    """`` | delta / dkv / dq ms a, b, c | keys K stages S chunk C | dkv R
    registers, spill st / ld bytes; dq ...`` of a backward record."""
    p, regs = rec["plan"], rec["ptxas"]
    ms = (" | delta / dkv / dq ms " + ", ".join(
        f"{rec['kernel_ms'][k]:.4f}" for k in ("delta", "dkv", "dq"))
          if "kernel_ms" in rec else "")
    ptx = "; ".join(f"{k} {v[0]} registers, spill {v[1]} / {v[2]} bytes" if v else
                    f"{k} not in the ptxas log" for k, v in regs.items())
    return (f"{ms} | keys {p['keys']} stages {p['stages']} chunk {p['chunk']} "
            f"x{p['chunks']} | {ptx}")


def wkv_bwd_text(rec: dict) -> str:
    """`` | instance chunk | R registers, spill st / ld bytes`` of a WKV
    backward record: the gradients-pass instance ``rwkv_chunk_bwd.plan``
    gave the shape and its ``ptxas`` numbers."""
    regs = rec["ptxas"]
    ptx = (f"{regs[0]} registers, spill {regs[1]} / {regs[2]} bytes" if regs else
           "not in the ptxas log")
    return f" | instance {rec['instance']} | {ptx}"


def mln_blocks(M, K, N):
    """The blocks ``search.lower`` gives a matmul_ln of these extents
    (with the search's default tiles, 64 rows and 128 columns)."""
    lk = lower.lower_matmul_ln(Layer("mac", PWCONV, k=N, c=K, ox=M),
                               Layer("ln", NORM, c=N, ox=M),
                               tile_x=64, tile_c=128)
    return lk.params


def mln_case(M, K, N, *, dtype=torch.float32, blocks=None, timed=False,
             repeat=False):
    x = randn(M, K, dtype=dtype)
    w = randn(K, N, scale=K ** -0.5, dtype=dtype)
    b = randn(N, scale=0.1, dtype=dtype)
    g = (1.0 + randn(N, scale=0.1)).to(dtype)
    be = randn(N, scale=0.1, dtype=dtype)
    blocks = blocks or mln_blocks(M, K, N)
    name = f"matmul_ln[{M}x{K}->{N} block_m={blocks['block_m']} " \
           f"block_k={blocks['block_k']} {str(dtype).split('.')[-1]}]"
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    plan = mln_mod.plan(M, N, torch.cuda.get_device_properties(0).multi_processor_count,
                        block_m=blocks["block_m"])
    got = ops.matmul_ln(x, w, b, g, be, **blocks)
    want = ref.matmul_ln_ref(x, w, b, g, be)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol,
               splits=plan["splits"], ctas=plan["ctas"])
    if repeat:
        again = ops.matmul_ln(x, w, b, g, be, **blocks)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{name}: two calls on the same inputs differ "
                 f"(max {(got - again).abs().max().item():.3e})")
        rec["case"] = name + " twice, same bits"
    if timed:
        flops = 2.0 * M * N * K
        moved = nbytes(x, w, b, g, be, got)
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(moved, flops, peak)
        rec["bound_fp32_cuda_core_ms"] = bound(moved, flops, PEAK_FP32)[0]
        rec["ms"] = time_ms(lambda: ops.matmul_ln(x, w, b, g, be, **blocks))
        rec["plain_ms"] = time_ms(lambda: ref.matmul_ln_ref(x, w, b, g, be))
        rec["library_ms"] = time_ms(
            lambda: F.layer_norm(x @ w + b, (N,), g, be, 1e-6))
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def wkv_inputs(BH, T, K, V, dtype=torch.float32, decay="normal"):
    """r, k, v, u ~ N(0, 0.5^2), logw = -exp(N(0, 0.5^2)), as the JAX WKV
    tests draw them; r, k, v in ``dtype``, logw and u float32.  ``decay``
    "extreme": logw = -exp(N(2.5, 1)) (single steps near -40, a chunk's
    decay far past e^88), "zero": logw = 0, "tiny": logw = -1e-6."""
    r, k, v = (randn(BH, T, n, scale=0.5) for n in (K, K, V))
    logw = {"normal": lambda: -torch.exp(randn(BH, T, K, scale=0.5)),
            "extreme": lambda: -torch.exp(2.5 + randn(BH, T, K)),
            "zero": lambda: torch.zeros(BH, T, K, device="cuda"),
            "tiny": lambda: torch.full((BH, T, K), -1e-6, device="cuda")}[decay]()
    u = randn(BH, K, scale=0.5)
    return r.to(dtype), k.to(dtype), v.to(dtype), logw, u


def wkv_case(BH, T, K, V, chunk, *, dtype=torch.float32, inputs=None,
             timed=False, decay="normal", repeat=False, from_state=False):
    """``from_state``: from a nonzero float32 state [BH, K, V] (a sequence
    shard's), timed also beside the same call from zero, in turns
    (``no_state_ms``)."""
    r, k, v, logw, u = inputs or wkv_inputs(BH, T, K, V, dtype, decay)
    s0 = randn(BH, K, V, scale=0.5) if from_state else None
    C = min(chunk, T)
    name = f"wkv_chunked[{BH}x{T}x{K}->{V} chunk={chunk} " \
           f"{str(r.dtype).split('.')[-1]}{'' if decay == 'normal' else ' ' + decay}" \
           f"{' from a state' if from_state else ''}]"
    tol = 2e-4 if r.dtype == torch.float32 else 2e-2
    skw = {"state": s0} if from_state else {}
    out, state = ops.wkv_chunked(r, k, v, logw, u, chunk=chunk, **skw)
    want_out, want_state = ref.wkv_ref(r, k, v, logw, u, s0)
    err = max(compare(name, out, want_out, tol),
              compare(name + " state", state, want_state, 2e-4))
    if repeat:
        again = ops.wkv_chunked(r, k, v, logw, u, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(state, again[1])):
            fail(f"{name}: two calls give different bits")
        name += " twice, same bits"
    p = wkv_mod.plan(BH, T, K, V, C, r.element_size(),
                     logw_itemsize=logw.element_size(),
                     sms=torch.cuda.get_device_properties(0).multi_processor_count)
    rec = dict(case=name, max_abs_err=err, tol=tol,
               **{key: p[key] for key in ("wv", "warps", "rows", "ctas",
                                          "states_ctas")})
    if timed:
        flops = 2.0 * scan_macs(Layer("wkv", SCAN, b=BH, ox=T, c=K, k=V), C)
        moved = nbytes(r, k, v, logw, u, out, state, *skw.values())
        rec["bound_ms"], rec["bound_by"] = bound(moved, flops, PEAK_TF32)
        rec["bound_fp32_cuda_core_ms"] = bound(moved, flops, PEAK_FP32)[0]
        # the float32 workspace of the entering states, written once by the
        # states pass and read once by the outputs pass: bytes the design
        # adds to those of the bound
        rec["workspace_bytes"] = BH * -(-T // C) * K * V * 4
        if from_state:
            rec["ms"], rec["no_state_ms"] = paired_ms(
                lambda: ops.wkv_chunked(r, k, v, logw, u, chunk=chunk, **skw),
                lambda: ops.wkv_chunked(r, k, v, logw, u, chunk=chunk))
        else:
            rec["ms"] = time_ms(lambda: ops.wkv_chunked(r, k, v, logw, u, chunk=chunk))
        rec["plain_ms"] = time_ms(lambda: ref.wkv_ref(r, k, v, logw, u, s0),
                                  reps=5, warmup=1)
        rec["library_ms"] = None     # no single PyTorch call computes WKV6
        rec["gbytes_s"] = moved / rec["ms"] / 1e6
    return rec


def wkv_bwd_case(BH, T, K, V, chunk, *, dtype=torch.float32, decay="normal",
                 with_dstate=False, timed=False, repeat=False, from_state=False):
    """The WKV backward (``ops.wkv_chunked`` under autograd: the forward
    kernel, whose workspace of entering states the backward reads, then
    ``wkv_chunked_bwd``, one launch each) against autograd of
    ``ref.wkv_ref`` on the same inputs and cotangents: dr, dk, dv, dlogw,
    du within 2e-4 (1 + |b|) in float32 (the JAX tests' tolerance) and 1e-3
    at the "extreme" decays (the float32 cumsum reaches a thousand or more
    within a chunk: every exponent keeps less absolute precision, as in the
    forward); in bfloat16 2e-2 on dr, dk, dv and a relative L2 error of 2e-4
    on the float32 dlogw and du.  Timed: the kernel alone (given the
    forward's workspace), the plain version's backward (autograd of
    ``wkv_ref``) and, as a second yardstick, autograd of the port's chunked
    torch ``models.rwkv6.wkv_chunked`` (what ``jax.grad`` differentiates).
    ``from_state``: from a nonzero float32 state (a sequence shard's), its
    gradient dS0 held as dlogw is, the kernel timed also beside the same
    call from zero (its own forward's workspace), in turns
    (``no_state_ms``)."""
    r, k, v, logw, u = wkv_inputs(BH, T, K, V, dtype, decay)
    dout = randn(BH, T, V, dtype=dtype)
    ds = randn(BH, K, V) if with_dstate else None
    s0 = randn(BH, K, V, scale=0.5) if from_state else None
    name = f"wkv_chunked_bwd[{BH}x{T}x{K}->{V} chunk={chunk} " \
           f"{str(dtype).split('.')[-1]}{'' if decay == 'normal' else ' ' + decay}" \
           f"{' dS_T' if with_dstate else ''}{' from a state' if from_state else ''}]"
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-3 if decay == "extreme" else 2e-4
    outs = (lambda o: o if with_dstate else o[:1])
    cots = outs((dout, ds))
    inputs = (r, k, v, logw, u) + ((s0,) if from_state else ())
    leaves = [t.clone().requires_grad_() for t in inputs]
    before = (wkv_mod.launches, wkvb_mod.launches)
    got = torch.autograd.grad(outs(ops.wkv_chunked(
        *leaves[:5], chunk=chunk, **({"state": leaves[5]} if from_state else {}))),
        leaves, cots)
    torch.cuda.synchronize()
    if (wkv_mod.launches, wkvb_mod.launches) != (before[0] + 1, before[1] + 1):
        fail(f"{name}: launched {wkv_mod.launches - before[0]} forward and "
             f"{wkvb_mod.launches - before[1]} backward kernels, expected 1 and 1")
    plain = [t.clone().requires_grad_() for t in inputs]
    plain_out = outs(ref.wkv_ref(*plain[:5], *plain[5:]))
    want = torch.autograd.grad(plain_out, plain, cots, retain_graph=timed)
    err, rel_l2 = 0.0, 0.0
    for n, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "dS0"), got, want):
        if dtype == torch.bfloat16 and g.dtype == torch.float32:
            rel = ((g - w).norm() / w.norm()).item()
            if not (torch.isfinite(g).all() and rel <= 2e-4):
                fail(f"{name} {n}: relative L2 error {rel:.3e} (limit 2e-4)")
            rel_l2 = max(rel_l2, rel)
        else:
            err = max(err, compare(f"{name} {n}", g, w, tol))
    C = min(chunk, T)
    inst = wkvb_mod.plan(C, K, V, r.element_size())
    rec = dict(case=name, max_abs_err=err, tol=tol, instance=inst["instance"],
               ptxas=wkvb_mod.ptxas(_build.ptxas_log()).get(
                   f"{inst['instance']} {str(dtype).split('.')[-1]}"))
    if dtype == torch.bfloat16:
        rec["rel_l2_f32_grads"] = rel_l2
    _, state, ws = wkv_mod.forward_with_states(r, k, v, logw, u, chunk=chunk, state=s0)
    kw = dict(chunk=chunk, dstate=ds, state=state if with_dstate else None,
              ds0=from_state)
    if repeat:
        first = wkvb_mod.wkv_chunked_bwd(r, k, v, logw, u, dout, ws, **kw)
        again = wkvb_mod.wkv_chunked_bwd(r, k, v, logw, u, dout, ws, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"{name}: two calls on the same inputs differ")
        rec["case"] = name + " twice, same bits"
    if timed:
        flops = 2.0 * wkv_bwd_macs(BH, T, K, V, C)
        moved = nbytes(r, k, v, logw, u, dout, ds, s0, *got)
        rec["bound_ms"], rec["bound_by"] = bound(moved, flops, PEAK_TF32)
        rec["bound_fp32_cuda_core_ms"] = bound(moved, flops, PEAK_FP32)[0]
        # the float32 workspaces of the entering states (read) and of G'
        # (written, then read): bytes the design adds to those of the bound
        rec["workspace_bytes"] = 2 * BH * -(-T // C) * K * V * 4
        call = (lambda: wkvb_mod.wkv_chunked_bwd(r, k, v, logw, u, dout, ws, **kw))
        if from_state:
            _, state0, ws0 = wkv_mod.forward_with_states(r, k, v, logw, u, chunk=chunk)
            kw0 = dict(kw, ds0=False, state=state0 if with_dstate else None)
            rec["ms"], rec["no_state_ms"] = paired_ms(call, lambda: wkvb_mod.wkv_chunked_bwd(
                r, k, v, logw, u, dout, ws0, **kw0))
        else:
            rec["ms"] = time_ms(call)
        rec["plain_ms"] = time_ms(lambda: torch.autograd.grad(
            plain_out, plain, cots, retain_graph=True), reps=5, warmup=1)
        del plain_out, want
        # the port's chunked torch form ([B, T, H, K], u [H, K]) on the same
        # values, a second yardstick: B x H = BH with H = 32 where it divides
        H = 32 if BH % 32 == 0 else 1
        chunked = [t.reshape(BH // H, H, T, -1).transpose(1, 2).contiguous()
                   .requires_grad_() for t in (r, k, v, logw)]
        cu = u[:H].clone().requires_grad_()
        c_out = outs(rwkv6.wkv_chunked(*chunked, cu, torch.zeros(
            (BH // H, H, K, V), device="cuda"), chunk))
        c_cots = (dout.reshape(BH // H, H, T, V).transpose(1, 2),
                  *((ds.reshape(BH // H, H, K, V),) if with_dstate else ()))
        rec["plain_chunked_ms"] = time_ms(lambda: torch.autograd.grad(
            c_out, chunked + [cu], c_cots, retain_graph=True), reps=5, warmup=1)
        del c_out
        rec["library_ms"] = None     # no single PyTorch call computes it
        rec["gbytes_s"] = moved / rec["ms"] / 1e6
    return rec


def adamw_case(shape, *, offset: int = 0, scaled: bool = True, timed: bool = False,
               seed: int = 0) -> dict:
    """AdamW of one float32 leaf of ``shape``, each of its four arrays
    ``offset`` elements into its buffer (1: not 16-byte aligned, the scalar
    head before the float4 body), drawn on the card: three steps of the
    kernel against three of ``ref.adamw_ref`` on the same inputs, p, m and v
    the same bits (``scaled``: with the clip's factor 0.37).  Timed: the
    kernel, the plain update and ``torch._fused_adamw_`` (the call behind
    ``torch.optim.AdamW(fused=True)``, which applies the decay in another
    order: timed only) on the leaf, each by ``time_ms``; the bound is 28
    bytes a parameter at 3.35 TB/s (its ``opcount.ADAMW_OPS`` operations at
    67 TFLOP/s take less)."""
    n = math.prod(shape)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def leaf(scale, square=False):
        t = torch.randn(n + offset, generator=gen, device="cuda").mul_(scale)
        return (t.square_() if square else t)[offset:].view(shape)

    p, g, m, v = leaf(0.02), leaf(1e-2), leaf(1e-3), leaf(1e-3, square=True)
    scale = torch.tensor(0.37, device="cuda") if scaled else None
    want = [t.clone() for t in (p, m, v)]
    for step in (1, 2, 3):
        c = torch.tensor(float(step), device="cuda")
        kw = dict(lr=torch.tensor(3e-4 * step, device="cuda"), bc1=1.0 - torch.pow(0.9, c),
                  bc2=1.0 - torch.pow(0.95, c), scale=scale)
        ops.adamw_update(p, g, m, v, **kw)
        ref.adamw_ref(want[0], g, want[1], want[2], **kw)
    name = (f"adamw[{'x'.join(map(str, shape))}{f' +{offset}' if offset else ''}"
            f"{'' if scaled else ' no clip'}]")
    diff = first_difference([p, m, v], want)
    if diff is not None:
        fail(f"{name}: the kernel's p, m, v differ from the plain update's: {diff}")
    rec = dict(case=name, max_abs_err=0.0, tol=0.0, offset=offset)
    if timed:
        moved = 28 * n + 16
        rec["bound_ms"], rec["bound_by"] = bound(moved, opcount.ADAMW_OPS * n, PEAK_FP32)
        rec["ms"] = time_ms(lambda: ops.adamw_update(p, g, m, v, **kw))
        rec["plain_ms"] = time_ms(lambda: ref.adamw_ref(want[0], g, want[1], want[2], **kw))
        steps = [torch.tensor(3.0, device="cuda")]
        rec["library_ms"] = time_ms(lambda: torch._fused_adamw_(
            [want[0]], [g], [want[1]], [want[2]], [], steps, lr=3e-4, beta1=0.9,
            beta2=0.95, weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))
        rec["gb_per_s"] = moved / rec["ms"] / 1e6
    return rec


def update_leaves(cfg) -> list:
    """(shape, leaves of that shape) of ``cfg``'s parameter tree: what one
    train step's AdamW runs, a launch a leaf."""
    shapes: dict = {}
    for d in tree_leaves(get_module(cfg).param_defs(cfg)):
        shapes[tuple(d.shape)] = shapes.get(tuple(d.shape), 0) + 1
    return list(shapes.items())


def path_shapes(cfg, batch):
    """(kernel, arguments, launches per forward) for every shape one
    forward of ``cfg`` at ``batch`` gives each kernel."""
    ibn, dw, fa = [], [], []
    hw = cfg.img_size // 4
    for si in range(4):
        c, k = cfg.dims[si], cfg.kernel_sizes[si]
        if si:
            hw //= 2
        n_sdta = cfg.sdta_blocks[si]
        n_conv = cfg.depths[si] - n_sdta
        ibn.append(((batch * hw * hw, c + 1, cfg.expan_ratio * c, c),
                    cfg.depths[si]))
        if n_conv:
            dw.append(((batch, hw, hw, c, k, None), n_conv))
        if n_sdta:
            widths = edgenext._split_widths(c, cfg.sdta_scales[si])
            start = widths[0]
            for i, wd in enumerate(widths[1:]):
                # the first split is a channel slice of the activation, the
                # later ones are dense sums
                dw.append(((batch, hw, hw, wd, 3, (c, start) if i == 0 else None),
                           n_sdta))
                start += wd
            fa.append(((batch, cfg.heads, c // cfg.heads, hw * hw), n_sdta))
    return ibn, dw, fa


def merge_counts(items):
    """[(args, n), ...] -> the same with equal args merged."""
    out: dict = {}
    for args, n in items:
        out[args] = out.get(args, 0) + n
    return list(out.items())


def kernels_phase():
    ibn, dw, fa = path_shapes(CONFIG, BATCH)
    per_kernel = {name: dict(shapes=[], extra=[]) for name in KERNELS}

    # fused_ibn: the batch-16 shapes (in the sums), then outside the sums
    # the batch-1 shapes and RWKV-6's channel mix in bfloat16 (D = 2048,
    # F = 7168, relu^2), which the model leaves to two library products
    ibn1, _, _ = path_shapes(CONFIG, 1)
    cmix = get_config("rwkv6-1.6b")
    for (M, D, Fd, Do), n, batch, kw in (
            [(args, n, BATCH, {}) for args, n in merge_counts(ibn)]
            + [(args, 0, 1, {}) for args, _ in merge_counts(ibn1)]
            + [((RWKV_REQUESTS[0][0] * RWKV_REQUESTS[0][1], cmix.d_model, cmix.d_ff,
                 cmix.d_model), 0, RWKV_REQUESTS[0][0],
                dict(act="relu2", dtype=torch.bfloat16,
                     w_scale=(cmix.d_model ** -0.5, cmix.d_ff ** -0.5)))]):
        rec = ibn_case(M, D, Fd, Do, timed=True, **kw)
        rec.update(per_forward=n, batch=batch)
        per_kernel["fused_ibn"]["shapes"].append(rec)
    # depthwise_conv2d: the batch-16 shapes (in the sums), then the batch-1
    # ones outside the sums
    _, dw1, _ = path_shapes(CONFIG, 1)
    for (B, H, W, C, k, sl), n, batch in (
            [(args, n, BATCH) for args, n in merge_counts(dw)]
            + [(args, 0, 1) for args, _ in merge_counts(dw1)]):
        rec = dw_case(B, H, W, C, k, slice_of=sl, timed=True)
        rec.update(per_forward=n, batch=batch)
        per_kernel["depthwise_conv2d"]["shapes"].append(rec)
    # flash_attention: the batch-16 XCA shapes (in the sums), then the
    # batch-1 ones outside the sums
    _, _, fa1 = path_shapes(CONFIG, 1)
    for (B, H, S, D), n, batch in ([(args, n, BATCH) for args, n in merge_counts(fa)]
                                   + [(args, 0, 1) for args, _ in merge_counts(fa1)]):
        rec = fa_case(B, H, S, S, D, causal=False, scale=1.0, xca=True, timed=True)
        rec.update(per_forward=n, batch=batch)
        per_kernel["flash_attention"]["shapes"].append(rec)
    # ... and the dense path's prefill attention (the online regime,
    # outside the sums): h2o-danube-1.8b at 4 x 512 and at 1 x 4608 over
    # its window, olmo-1b at 4 x 512 (bfloat16, causal, GQA-expanded)
    for (B, H, S, D, window, hk), batch in (((4, 32, 512, 80, None, 8), 4),
                                            ((1, 32, 4608, 80, 4096, 8), 1),
                                            ((4, 16, 512, 128, None, None), 4)):
        rec = fa_case(B, H, S, S, D, causal=True, window=window, dtype=torch.bfloat16,
                      kv_heads=hk, timed=True)
        rec.update(per_forward=0, batch=batch)
        per_kernel["flash_attention"]["shapes"].append(rec)
    # ... and the encoder-decoder's (outside the sums): the Seamless encoder
    # at 4 x 512 and 1 x 1500 frames (non-causal, D 64, bfloat16; 1500 =
    # 23 x 64 + 28, a ragged last KV tile), and its prefill's cross-attention
    # of one decoder token (63 empty rows of a 64-row query tile) against
    # them; the library call is SDPA with ``is_causal=False``
    for (B, Sq, Sk), batch in (((4, 512, 512), 4), ((1, 1500, 1500), 1),
                               ((4, 1, 512), 4), ((1, 1, 1500), 1)):
        rec = fa_case(B, 16, Sq, Sk, 64, causal=False, dtype=torch.bfloat16,
                      timed=True)
        rec.update(per_forward=0, batch=batch)
        per_kernel["flash_attention"]["shapes"].append(rec)
    # ... and RecurrentGemma's local attention (outside the sums; each shape
    # launched once an attention block, 8 a prefill): 10 query heads over 1
    # KV head, D 256, bfloat16, causal, at the served 4 x 512, at 1 x 4608
    # under the window of 2048 (the banded prefill), and at a ragged 1 x 700
    rg_attn = get_config(HYBRID_ARCH).block_pattern.count("attention")
    for B, S, window in ((4, 512, None), (1, 4608, 2048), (1, 700, None)):
        rec = fa_case(B, 10, S, S, 256, causal=True, window=window,
                      dtype=torch.bfloat16, kv_heads=1, timed=True)
        rec.update(per_forward=0, batch=B, per_prefill=rg_attn)
        per_kernel["flash_attention"]["shapes"].append(rec)
    # ... and a sequence shard's queries at their offset (the 'cp' step,
    # outside the sums), each beside the same call without the offset:
    # RecurrentGemma's 1 x 4608 split in two (the second rank's 2304 queries
    # at 2304 against 4608 keys, its window of 2048 across the edge), and a
    # shard of whole rows (Sk <= 128) with its window across the edge
    for (B, H, Sq, Sk, D, window, hk, o, dtype) in (
            (1, 10, 2304, 4608, 256, 2048, 1, 2304, torch.bfloat16),
            (4, 16, 64, 128, 64, 96, None, 64, torch.bfloat16)):
        rec = fa_case(B, H, Sq, Sk, D, causal=True, window=window, dtype=dtype,
                      kv_heads=hk, timed=True, q_offset=o)
        rec.update(per_forward=0, batch=B)
        per_kernel["flash_attention"]["shapes"].append(rec)

    # matmul_ln: the EdgeNeXt-S lowered shapes at batch 16 (once each), then
    # the LM widths, ragged and bfloat16 cases (timed, outside the sums)
    mln = [((BATCH * hw * hw, c, c), 1) for hw, c in
           zip((32, 16, 8), CONFIG.dims[1:])]
    mln += [((512, 2048, 2048), 0), ((448, 2560, 2560), 0),
            ((197, 48, 160), 0), ((7, 13, 24), 0)]
    for (M, K, N), n in mln:
        rec = mln_case(M, K, N, timed=True)
        rec["per_forward"] = n
        per_kernel["matmul_ln"]["shapes"].append(rec)
    for M, K, N in ((197, 48, 160), (512, 2048, 2048)):
        rec = mln_case(M, K, N, dtype=torch.bfloat16, timed=True)
        rec["per_forward"] = 0
        per_kernel["matmul_ln"]["shapes"].append(rec)

    # wkv_chunked: the served shape once a layer (24 a prefill), bfloat16
    # r/k/v as served and a float32 copy of the same values; the B = 1 x 200
    # prompt's shape, the chunk sweep and RecurrentGemma's K = 1 shape
    # (timed, outside the sums)
    bf16 = torch.bfloat16
    served = wkv_inputs(128, 512, 64, 64)
    for dtype, n in ((bf16, rwkv6.kernel_launches_per_prefill(
            get_config("rwkv6-1.6b"))["wkv_chunked"]), (torch.float32, 0)):
        rec = wkv_case(128, 512, 64, 64, 64, timed=True, inputs=(
            *(t.to(dtype) for t in served[:3]), *served[3:]))
        rec["per_forward"] = n
        per_kernel["wkv_chunked"]["shapes"].append(rec)
    rec = wkv_case(32, 200, 64, 64, 64, dtype=bf16, timed=True)
    rec["per_forward"] = 0
    per_kernel["wkv_chunked"]["shapes"].append(rec)
    for BH, T, K, V, chunk in [(128, 512, 64, 64, c) for c in (8, 16, 32, 128, 256)] \
            + [(1, 448, 1, 2560, 64), (1, 448, 1, 2560, 256)]:
        rec = wkv_case(BH, T, K, V, chunk, timed=True)
        rec["per_forward"] = 0
        per_kernel["wkv_chunked"]["shapes"].append(rec)

    per_kernel["fused_ibn"]["extra"] = [
        ibn_case(197, 48, 160, 48),
        ibn_case(197, 48, 160, 48, gated=True, act="silu"),
        ibn_case(197, 48, 160, 48, act="relu2"),
        ibn_case(100, 64, 300, 400, gated=True, act="gelu"),   # Do over 2 blocks
        ibn_case(197, 48, 160, 48, dtype=bf16),
        ibn_case(197, 48, 160, 48, gated=True, act="silu", dtype=bf16),
        ibn_rounding_case(),
        # split F: the last share ends in a ragged F tile, a single row,
        # gated bfloat16 over several shares
        ibn_case(64, 49, 1000, 48, min_splits=2),
        ibn_case(197, 97, 330, 96, act="silu", min_splits=2),
        ibn_case(1, 305, 1216, 304, min_splits=2),
        ibn_case(64, 161, 640, 160, gated=True, act="silu", dtype=bf16, min_splits=2),
    ]
    per_kernel["matmul_ln"]["extra"] = [
        # N split unevenly over the cluster, rows far fewer than a tile
        mln_case(1024, 304, 304, blocks=dict(block_m=32, block_k=16)),
        mln_case(1, 2560, 2560), mln_case(7, 2560, 2560),
        mln_case(448, 2560, 2560, repeat=True),
    ]
    per_kernel["depthwise_conv2d"]["extra"] = [
        dw_case(1, 10, 14, 52, 5),
        dw_case(2, 9, 7, 33, 7),
        dw_case(2, 16, 16, 52, 5, dtype=bf16),
        # the generic instance (an even kernel padded as JAX pads it, 1x1,
        # 11x11), an image smaller than the kernel, one and three channels,
        # the stage-3 cascade slice (channel 54 of 160: 8-byte aligned in
        # float32, 4-byte in bf16) and two calls that must give the same bits
        dw_case(2, 10, 14, 52, (4, 2)),
        dw_case(2, 9, 7, 40, 1),
        dw_case(1, 16, 16, 24, 11),
        dw_case(2, 3, 5, 12, 7),
        dw_case(2, 9, 7, 1, 3),
        dw_case(2, 9, 7, 3, 5),
        dw_case(16, 16, 16, 54, 3, slice_of=(160, 54)),
        dw_case(16, 16, 16, 54, 3, slice_of=(160, 54), dtype=bf16),
        dw_case(16, 16, 16, 160, 7, repeat=True),
    ]
    per_kernel["flash_attention"]["extra"] = [
        fa_case(2, 2, 64, 64, 16, causal=True),
        fa_case(4, 4, 48, 48, 16, causal=True, kv_heads=2),  # train_multiarch's
        fa_case(2, 2, 64, 128, 16, causal=True, window=24),
        fa_case(1, 2, 160, 304, 16, causal=True, window=48),
        fa_case(1, 2, 197, 197, 16, causal=False),
        fa_case(1, 2, 128, 64, 8, causal=False),
        fa_case(1, 1, 100, 40, 8, causal=True, window=10),   # rows with no key
        fa_case(1, 2, 33, 77, 1500, causal=True),            # D over 8 slices
        fa_case(1, 2, 64, 64, 32, causal=True, dtype=bf16),
        # whole rows: Sk = S_MAX and S_MAX + 1 (the regime boundary), D
        # shared out unevenly (125 units over 8) with the query rows split,
        # rows with no key, bfloat16 XCA shapes, two calls with the same bits
        fa_case(1, 2, 40, 128, 64, causal=False),
        fa_case(1, 2, 40, 129, 64, causal=False),
        fa_case(1, 4, 70, 100, 1000, causal=True),
        fa_case(1, 2, 30, 10, 24, causal=True, window=4),
        fa_case(16, 4, 24, 24, 1024, causal=False, scale=1.0, xca=True, dtype=bf16),
        fa_case(16, 4, 76, 76, 64, causal=False, scale=1.0, xca=True, dtype=bf16),
        fa_case(16, 4, 40, 40, 256, causal=False, scale=1.0, xca=True, repeat=True),
        # the online regime at the LM's shapes: float32 causal ragged against
        # the 64-row tile, minitron-4b's D = 128 over 24 / 8 heads, a prompt
        # of the whole-row regime causal in bf16, D chunked over the grid,
        # and two calls with the same bits at the served shape
        fa_case(1, 4, 300, 300, 80, causal=True),
        fa_case(4, 24, 512, 512, 128, causal=True, dtype=bf16, kv_heads=8),
        fa_case(4, 32, 100, 100, 80, causal=True, dtype=bf16, kv_heads=8),
        fa_case(1, 2, 200, 300, 300, causal=True, dtype=bf16),
        fa_case(1, 2, 150, 200, 1024, causal=False),
        fa_case(4, 32, 512, 512, 80, causal=True, dtype=bf16, kv_heads=8, repeat=True),
        # the MoE and encoder-decoder paths: qwen3-moe's 32 query heads over
        # 4 KV heads at D 128, the decoder's first causal self-attention
        # (Sq = Sk = 1, whole rows), the cross-attention in float32 at a
        # ragged Sk, and the encoder's ragged tail twice with the same bits
        fa_case(4, 32, 512, 512, 128, causal=True, dtype=bf16, kv_heads=4),
        fa_case(4, 16, 1, 1, 64, causal=True, dtype=bf16),
        fa_case(2, 16, 1, 700, 64, causal=False),
        fa_case(1, 16, 1500, 1500, 64, causal=False, dtype=bf16, repeat=True),
        # a sequence shard's queries at their offset: the online regime
        # ragged in float32 with the window across the edge, the whole rows
        # likewise, a non-causal window
        fa_case(1, 2, 100, 300, 80, causal=True, window=64, q_offset=200),
        fa_case(1, 2, 40, 100, 64, causal=True, window=30, q_offset=60),
        fa_case(1, 2, 100, 300, 64, causal=False, window=50, q_offset=120),
    ]
    per_kernel["wkv_chunked"]["extra"] = [
        wkv_case(4, 50, 64, 64, 16),             # the JAX tests' ragged T
        wkv_case(4, 33, 64, 64, 8),
        wkv_case(4, 100, 64, 64, 64),
        wkv_case(4, 50, 64, 64, 64),             # T < chunk
        wkv_case(4, 100, 8, 40, 32),             # narrow K, V off the 32-column tile
        wkv_case(4, 100, 64, 64, 64, dtype=bf16),
        # decays at the extremes: single steps near -40 (a reference at the
        # chunk's start would overflow), none, and nearly none; two calls
        # that must give the same bits
        wkv_case(4, 200, 64, 64, 64, decay="extreme"),
        wkv_case(4, 200, 64, 64, 64, dtype=bf16, decay="extreme"),
        wkv_case(4, 130, 64, 64, 64, decay="zero"),
        wkv_case(4, 130, 64, 64, 64, decay="tiny"),
        wkv_case(128, 512, 64, 64, 64, dtype=bf16, repeat=True),
        # from a nonzero state (a sequence shard's), ragged at chunk 32
        wkv_case(4, 130, 64, 64, 32, from_state=True),
    ]
    # ... and from a nonzero state at the served shape (outside the sums),
    # beside the same call from zero
    rec = wkv_case(128, 512, 64, 64, 64, dtype=bf16, timed=True, from_state=True)
    rec["per_forward"] = 0
    per_kernel["wkv_chunked"]["shapes"].append(rec)
    # flash_attention_bwd: the trained shape (h2o-danube-1.8b's 32 query
    # heads over 8 KV heads of 80, 4 x 512, bf16, causal; 24 a train step, in
    # the sums), then outside the sums the other trained heads: olmo-1b's
    # 128, Seamless's 64 (non-causal, and its cross-attention with Sq != Sk),
    # RecurrentGemma's MQA 256 under its window
    for (B, H, Sq, Sk, D, causal, window, hk), n in (
            ((4, 32, 512, 512, 80, True, None, 8),
             transformer.kernel_launches_per_prefill(get_config(DENSE_ARCH))
             ["flash_attention"]),
            ((4, 16, 512, 512, 128, True, None, None), 0),
            ((4, 16, 512, 512, 64, False, None, None), 0),
            ((4, 16, 256, 512, 64, False, None, None), 0),
            ((4, 10, 512, 512, 256, True, 2048, 1), 0)):
        rec = bwd_case(B, H, Sq, Sk, D, causal=causal, window=window, kv_heads=hk,
                       timed=True)
        rec.update(per_forward=n, batch=B)
        per_kernel["flash_attention_bwd"]["shapes"].append(rec)
    per_kernel["flash_attention_bwd"]["extra"] = [
        # float32: a ragged tile, the whole-row forward regime's lse (Sk <=
        # 128), D over 64 columns under a window, Sq != Sk; two calls at the
        # trained shape with the same bits
        bwd_case(1, 4, 300, 300, 72, dtype=torch.float32),
        bwd_case(2, 4, 100, 100, 64, dtype=torch.float32),
        bwd_case(1, 2, 150, 150, 256, window=40, dtype=torch.float32),
        bwd_case(1, 2, 70, 130, 80, causal=False, dtype=torch.float32),
        bwd_case(1, 2, 200, 200, 128, causal=False, window=30),
        bwd_case(4, 32, 512, 512, 80, kv_heads=8, repeat=True),
        # a sequence shard's queries at their offset: the whole-row forward's
        # lse with the window across the edge, and the second rank's half of
        # h2o's trained shape under 'cp' (256 queries at 256)
        bwd_case(2, 4, 40, 100, 64, window=30, dtype=torch.float32, q_offset=60),
        bwd_case(4, 32, 256, 512, 80, kv_heads=8, q_offset=256),
        # train_multiarch's reduced configs (phase 5l): 4 x 48 tokens, D 16
        # in float32 (PLAN's D <= 64 row), causal over 2 KV heads,
        # non-causal (Seamless's encoder and cross) and under the window of 32
        bwd_case(4, 4, 48, 48, 16, dtype=torch.float32, kv_heads=2),
        bwd_case(4, 4, 48, 48, 16, causal=False, dtype=torch.float32),
        bwd_case(4, 4, 48, 48, 16, window=32, dtype=torch.float32),
    ]
    # ... and RecurrentGemma's 1 x 4608 split in two (outside the sums),
    # beside the same call without the offset
    rec = bwd_case(1, 10, 2304, 4608, 256, window=2048, kv_heads=1, timed=True,
                   q_offset=2304)
    rec.update(per_forward=0, batch=1)
    per_kernel["flash_attention_bwd"]["shapes"].append(rec)
    # wkv_chunked_bwd: RWKV-6's trained shape (4 x 32 heads of 64, T 512,
    # chunk 64, bf16 r/k/v/dout with float32 logw and u; 24 a train step, in
    # the sums), then the B = 1 x 200 prompt (ragged at chunk 64), the
    # extreme decays in float32 and bf16, a nonzero dS_T, two calls at the
    # trained shape with the same bits, chunk 128 (the tile instance; the
    # others run the chunk instance) twice with the same bits, the reduced
    # configs' chunk 8 at K = V = 16 and a ragged width, K = V = 40 at T = 130
    rec = wkv_bwd_case(128, 512, 64, 64, 64, dtype=bf16, timed=True)
    rec.update(per_forward=rwkv6.kernel_launches_per_prefill(
        get_config(RWKV_ARCH))["wkv_chunked"], batch=TRAIN_BATCH[0])
    per_kernel["wkv_chunked_bwd"]["shapes"].append(rec)
    per_kernel["wkv_chunked_bwd"]["extra"] = [
        wkv_bwd_case(32, 200, 64, 64, 64),
        wkv_bwd_case(4, 200, 64, 64, 64, decay="extreme"),
        wkv_bwd_case(4, 200, 64, 64, 64, dtype=bf16, decay="extreme"),
        wkv_bwd_case(4, 130, 64, 64, 32, with_dstate=True),
        wkv_bwd_case(128, 512, 64, 64, 64, dtype=bf16, with_dstate=True, repeat=True),
        wkv_bwd_case(4, 300, 64, 64, 128, with_dstate=True, repeat=True),
        wkv_bwd_case(16, 100, 16, 16, 8, with_dstate=True),
        wkv_bwd_case(4, 130, 40, 40, 64, with_dstate=True),
        # from a nonzero state: dS0, on the chunk and the tile instances
        wkv_bwd_case(4, 130, 64, 64, 32, with_dstate=True, from_state=True),
        wkv_bwd_case(4, 300, 64, 64, 128, from_state=True),
    ]
    # ... and from a nonzero state at the trained shape (outside the sums),
    # beside the same call from zero
    rec = wkv_bwd_case(128, 512, 64, 64, 64, dtype=bf16, timed=True, from_state=True)
    rec.update(per_forward=0, batch=TRAIN_BATCH[0])
    per_kernel["wkv_chunked_bwd"]["shapes"].append(rec)
    # flash_attention, last (the inputs of the cases above unchanged):
    # phase 5i's 4 x 512 prefills (outside the sums; olmo-1b's is
    # above): starcoder2-15b's 48 query heads over 4 KV heads (G 12),
    # minitron-4b's 24 / 8, qwen2-vl-2b's 12 / 2, qwen3-moe's 32 / 4, D 128
    for arch, H, hk in (("starcoder2-15b", 48, 4), ("minitron-4b", 24, 8),
                        ("qwen2-vl-2b", 12, 2), ("qwen3-moe-30b-a3b", 32, 4)):
        rec = fa_case(4, H, 512, 512, 128, causal=True, dtype=torch.bfloat16,
                      kv_heads=hk, timed=True)
        rec.update(per_forward=0, batch=4, per_prefill=get_config(arch).num_layers)
        per_kernel["flash_attention"]["shapes"].append(rec)
    # adamw: every leaf shape of h2o-danube-1.8b uncut (the sums: one train
    # step's update, a launch a leaf), then an odd length, a leaf not
    # 16-byte aligned, leaves of three elements and one with no clip
    for i, (shape, n) in enumerate(update_leaves(get_config(DENSE_ARCH))):
        rec = adamw_case(shape, timed=True, seed=i)
        rec.update(per_forward=n, batch=TRAIN_BATCH[0])
        per_kernel["adamw"]["shapes"].append(rec)
    per_kernel["adamw"]["extra"] = [
        adamw_case((1_000_003,), seed=20), adamw_case((100_001,), offset=1, seed=21),
        adamw_case((3,), offset=2, seed=22), adamw_case((4_099,), scaled=False, seed=23)]
    torch.cuda.empty_cache()
    return per_kernel


def lowered_phase():
    """Every registered workload's schedule verified by the static checker,
    then every ``lowered`` entry launched with the emitted blocks (or
    chunk) at the layer's true shapes and held against its plain version;
    identical (kernel, shapes, blocks) once.  Fails on any finding and on
    an entry whose kernel is not ported.  Returns the per-launch records,
    the entries per lowered kernel name, the entries per workload and
    lowered kernel, the launch counts, the findings per workload with the
    seconds the checker took on the host, and the first entry of each
    lowered kernel (workload, key, layers, groups, entry) for
    ``check_phase``."""
    distinct: dict = {}
    entries: dict = {name: 0 for name in LOWERED}
    by_workload: dict = {}
    findings: dict = {}
    samples: dict = {}
    verify_s = 0.0
    for wname in WORKLOADS:
        layers = get_workload(wname)
        sched = auto_schedule(layers, workload=wname)
        t0 = time.perf_counter()
        found = verify_schedule(layers, sched, source="chip_smoke")
        verify_s += time.perf_counter() - t0
        if found:
            fail(f"check: {wname} has {len(found)} findings, first "
                 f"{found[0].code} at {found[0].where}: {found[0].detail}")
        findings[wname] = len(found)
        for key, lk in sched.lowered.items():
            samples.setdefault(lk["kernel"], (wname, key, layers,
                                              sched.groups, lk))
            if lk["kernel"] not in LOWERED:
                fail(f"lowered: {wname}:{key} is lowered onto "
                     f"{lk['kernel']!r}, which no ported kernel runs")
            distinct.setdefault(launch_key(layers, key, lk), []).append(
                f"{wname}:{key}")
            entries[lk["kernel"]] += 1
            per = by_workload.setdefault(lk["kernel"], {})
            per[wname] = per.get(wname, 0) + 1

    reset_counts()
    records = []
    for dkey, where in distinct.items():
        rec = launch_entry(dkey)
        rec.update(entries=len(where), first=where[0])
        records.append(rec)
    launches = read_counts()
    for name in KERNELS:
        want = sum(1 for r in records if r["kernel"] == name)
        if launches[name] != want:
            fail(f"lowered: {name} launched {launches[name]} times for "
                 f"{want} distinct lowered launches")
        if name in LOWERED.values() and not launches[name]:
            fail(f"lowered: {name} was never launched")
    verified = dict(findings=findings, verify_s=verify_s)
    return records, entries, by_workload, launches, verified, samples, set(distinct)


def launch_key(layers, key: str, lk: dict) -> tuple:
    """(kernel, launch shape, blocks or chunk) of one lowered entry: what
    it launches, and what the lowered and serve phases dedupe on."""
    shape = lower.launch_shape(layers, key, lk)
    blocks = {k: v for k, v in lk.items() if k.startswith("block_") or k == "chunk"}
    return LOWERED[lk["kernel"]], tuple(shape.items()), tuple(sorted(blocks.items()))


def launch_entry(dkey: tuple, timed: bool = False) -> dict:
    """One lowered launch (a ``launch_key``) at the layer's true shapes with
    its blocks, held against its plain version; timed as ``kernels_phase``
    times a shape where ``timed``."""
    kern, shape, blocks = dkey
    s, blocks = dict(shape), dict(blocks)
    if kern == "fused_ibn":
        rec = ibn_case(s["m"], s["d"], s["f"], s["do"], blocks=blocks, timed=timed,
                       w_scale=(s["d"] ** -0.5, s["f"] ** -0.5))
    elif kern == "matmul_ln":
        rec = mln_case(s["m"], s["k"], s["n"], blocks=blocks, timed=timed)
    elif kern == "wkv_chunked":
        rec = wkv_case(s["bh"], s["t"], s["k"], s["v"], blocks["chunk"], timed=timed)
    else:
        rec = fa_case(1, s["bh"], s["q"], s["k"], s["d"], causal=False,
                      blocks=blocks, timed=timed)
    rec.update(kernel=kern, blocks=blocks)
    return rec


def refuse_case(kernel: str, shape: dict, blocks: dict):
    """Call the ``ops`` entry point of ``kernel`` on CUDA tensors at a
    lowered entry's launch shape with ``blocks``.  Returns the message it
    refused them with, or None where it ran; a refusal must leave the
    kernel's launch counter as it was."""
    before = read_counts()
    z = lambda *shape: torch.zeros(shape, device="cuda")  # noqa: E731
    try:
        if kernel == "fused_ibn":
            ops.fused_ibn(z(shape["m"], shape["d"]), z(shape["d"], shape["f"]),
                          z(shape["f"], shape["do"]), **blocks)
        elif kernel == "matmul_ln":
            n = shape["n"]
            ops.matmul_ln(z(shape["m"], shape["k"]), z(shape["k"], n), z(n),
                          z(n), z(n), **blocks)
        else:
            qkv = [z(1, shape["bh"], s, shape["d"])
                   for s in (shape["q"], shape["k"], shape["k"])]
            ops.flash_attention(*qkv, causal=False, **blocks)
    except ValueError as e:
        if read_counts() != before:
            fail(f"check: ops.{kernel} refused {blocks} after launching")
        return str(e)
    torch.cuda.synchronize()
    return None


def check_phase(samples: dict) -> dict:
    """The checker held to the kernels: the mutation corpus must catch all
    of its corruptions, and the lint and the ``ops`` entry points must
    agree on the corpus's off-menu blocks (see the module docstring,
    phase 6).  Fails on anything else.  Returns the corpus result, the
    agreement cases and the seconds the phase took on the host."""
    t0 = time.perf_counter()
    results, base = run_corpus()
    dirty = {w: [f.code for f in fs] for w, fs in base.items() if fs}
    if dirty:
        fail(f"check: corpus base artifacts not clean: {dirty}")
    missed = [r.mutation for r in results if not r.caught]
    if missed:
        fail(f"check: mutations not caught: {missed}")
    by_name = {m.name: m for m in MUTATIONS}
    cases = []
    for kernel in ("fused_ibn", "flash_attention", "matmul_ln"):
        wname, key, layers, groups, lk = samples[kernel]
        shape = lower.launch_shape(layers, key, lk)
        for mutation in ("oversize_block", "non_pow2_block"):
            doc = {"groups": [list(g) for g in groups],
                   "lowered": {key: json.loads(json.dumps(lk))}}
            if not by_name[mutation].apply(doc, layers):
                fail(f"check: {mutation} did not apply to {wname}:{key}")
            entry = doc["lowered"][key]
            codes = sorted({f.code for f in lint_doc(doc, layers)})
            blocks = {k: v for k, v in entry.items() if k.startswith("block_")}
            refused = refuse_case(kernel, shape, blocks)
            if "lint.block_menu" not in codes:
                fail(f"check: the lint passes {kernel} {blocks} at "
                     f"{wname}:{key} (codes {codes})")
            if refused is None:
                fail(f"check: disagreement: the lint flags {kernel} {blocks} "
                     f"at {wname}:{key} ({codes}), ops.{kernel} ran it")
            cases.append(dict(kernel=kernel, entry=f"{wname}:{key}",
                              mutation=mutation, blocks=blocks, lint=codes,
                              ops_refused=True, launches_unchanged=True))
    wname, key, layers, groups, lk = samples["rwkv_chunk"]
    off = dict(json.loads(json.dumps(lk)), chunk=2 * max(lk["chunk"], 1))
    doc = {"groups": [list(g) for g in groups], "lowered": {key: off}}
    codes = sorted({f.code for f in lint_doc(doc, layers)})
    if "lint.scan_chunk" not in codes:
        fail(f"check: the lint passes rwkv_chunk at chunk {off['chunk']} "
             f"at {wname}:{key} (codes {codes})")
    cases.append(dict(kernel="rwkv_chunk", entry=f"{wname}:{key}",
                      mutation="chunk", blocks={"chunk": off["chunk"]},
                      lint=codes, ops_refused=None,
                      note="ops.wkv_chunked runs any chunk"))
    return dict(corpus=dict(caught=sum(r.caught for r in results),
                            total=len(MUTATIONS)),
                agreement=cases, check_phase_s=time.perf_counter() - t0)


class RecordingStore(ServeStore):
    """A ``ServeStore`` that keeps every answer its ``request`` gives, so
    that each answer of a chaos session can be verified after it."""

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self.answers = []

    def request(self, *args, **kw):
        res = super().request(*args, **kw)
        self.answers.append(res)
        return res


def host_ms(fn) -> tuple:
    """(fn(), host milliseconds it took)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def serve_phase(launched: set) -> tuple[dict, dict]:
    """The schedule store on the card's host (module docstring, phase 7).
    ``launched`` holds the ``launch_key``s the lowered phase ran.  Fails on
    any miss.  Returns the launch counts of step 3 and the phase's record."""
    root = ROOT / "build" / "serve_store"
    shutil.rmtree(root, ignore_errors=True)
    grid = [(w, b) for w in SERVE_WORKLOADS for b in BATCH_LEVELS]

    # 1. warm over a spawned pool while this process holds the card's context
    if not torch.cuda.is_initialized():
        fail("serve: the card's context should be live before the warm")
    store = ServeStore(root / "store", verify=True)
    with obs.tracing() as tr:
        rep, warm_ms = host_ms(lambda: store.warm(SERVE_WORKLOADS, batches=BATCH_LEVELS,
                                                  jobs=SERVE_JOBS))
    warm = dict(entries=len(rep.entries), searched=rep.searched,
                worker_failed=rep.worker_failed, jobs=SERVE_JOBS, seconds=warm_ms / 1e3,
                counters=dict(tr.counters))
    if (warm["entries"], warm["searched"], warm["worker_failed"]) != (len(grid), len(grid), 0):
        fail(f"serve: warm gave {warm['entries']} entries, {warm['searched']} searched, "
             f"{warm['worker_failed']} workers failed; want {len(grid)}, {len(grid)}, 0")

    # 2. a fresh store on the same directory answers every request from disk,
    # each answer verified; then the same request from memory, and the same
    # replay without the checker
    fresh, bare = ServeStore(root / "store", verify=True), ServeStore(root / "store")
    answers, disk_ms, mem_ms, bare_ms = {}, [], [], []
    for w, b in grid:
        with obs.tracing() as tr:
            res, ms = host_ms(lambda: fresh.request(w, b))
        layers = get_workload(res.workload)
        found = verify_schedule(layers, res.schedule, source="chip_smoke")
        hits = (tr.counters.get("cache.hit", 0), tr.counters.get("check.pass", 0),
                tr.counters.get("cache.miss", 0))
        if res.outcome != "disk" or res.degraded or hits != (1, 1, 0) or found:
            fail(f"serve: {res.workload} answered {res.outcome!r} (degraded "
                 f"{res.degraded}), cache.hit/check.pass/cache.miss {hits}, "
                 f"{len(found)} findings; want a verified disk hit")
        disk_ms.append(ms)
        again, ms = host_ms(lambda: fresh.request(w, b))
        if again.outcome != "mem":
            fail(f"serve: {res.workload} again answered {again.outcome!r}, not from memory")
        mem_ms.append(ms)
        plain, ms = host_ms(lambda: bare.request(w, b))
        if plain.outcome != "disk":
            fail(f"serve: {res.workload} answered {plain.outcome!r} without the checker")
        bare_ms.append(ms)
        answers[(w, b)] = (layers, res)
    disk = dict(requests=len(grid), disk_hits=len(disk_ms), findings=0,
                disk_hit_ms=statistics.median(disk_ms), disk_hit_ms_max=max(disk_ms),
                disk_hit_unverified_ms=statistics.median(bare_ms),
                mem_hit_ms=statistics.median(mem_ms), mem_hit_ms_max=max(mem_ms))

    # 3. the lowered entries of the EdgeNeXt-S answers (none degraded, step 2)
    # that the lowered phase did not run, each once against its plain
    # version; RWKV-6's answers are verified only
    new: dict = {}
    served_entries, seen = 0, set()
    for (w, b), (layers, res) in answers.items():
        if w != SERVE_LAUNCHED:
            continue
        for key, lk in res.schedule.lowered.items():
            served_entries += 1
            dkey = launch_key(layers, key, lk)
            seen.add(dkey)
            if dkey not in launched:
                new.setdefault(dkey, []).append((b, f"{res.workload}:{key}"))
    reset_counts()
    records = []
    for dkey, where in new.items():
        rec = launch_entry(dkey)
        rec.update(entries=len(where), batch=where[0][0], first=where[0][1])
        records.append(rec)
    launches = read_counts()
    for name in KERNELS:
        want = sum(1 for r in records if r["kernel"] == name)
        if launches[name] != want:
            fail(f"serve: {name} launched {launches[name]} times for {want} "
                 f"new served launches")
    if not records:
        fail("serve: the lowered phase ran every served launch already; "
             "batches 16 and 64 should bring new ones")
    for rec, dkey in zip(records, new):
        timed = launch_entry(dkey, timed=True)
        rec.update({k: v for k, v in timed.items() if k not in rec},
                   max_abs_err=max(rec["max_abs_err"], timed["max_abs_err"]))
    launch = dict(workload=SERVE_LAUNCHED, entries=served_entries, distinct=len(seen),
                  already_launched=len(seen) - len(new), new=len(new),
                  new_by_batch={b: sum(1 for r in records if r["batch"] == b)
                                for b in sorted({r["batch"] for r in records})},
                  records=records)

    # 4. a deterministic chaos session over a store of its own: every request
    # served, every answer verified (a degraded one with its marker), and not
    # one launch while it runs
    chaos_store = RecordingStore(root / "chaos", verify=True)
    chaos_store.warm([SERVE_LAUNCHED], batches=CHAOS_BATCHES)
    chaos_store.answers.clear()
    reset_counts()
    with obs.tracing() as tr:
        rep = chaos_session(chaos_store, SERVE_LAUNCHED, n_requests=CHAOS_REQUESTS,
                            plan=ChaosPlan.parse(CHAOS_PLAN, seed=SEED),
                            batches=CHAOS_BATCHES)
    chaos_launches = read_counts()
    if not rep.all_served or len(chaos_store.answers) != rep.requests:
        fail(f"serve: chaos served {rep.served} of {rep.requests}")
    for res in chaos_store.answers:
        marker = getattr(res.schedule, "degraded", None)
        if res.degraded != (marker is not None) or (res.degraded and marker != res.outcome):
            fail(f"serve: chaos answer {res.outcome!r} carries the marker {marker!r}")
        found = verify_schedule(get_workload(res.workload), res.schedule,
                                source="chip_smoke")
        if found:
            fail(f"serve: chaos answer {res.workload} ({res.outcome}) has "
                 f"{len(found)} findings, first {found[0].code}: {found[0].detail}")
    if any(chaos_launches.values()):
        fail(f"serve: the chaos session launched {chaos_launches}")
    chaos = dict(plan=CHAOS_PLAN, seed=SEED, requests=rep.requests, served=rep.served,
                 degraded=rep.degraded, outcomes=rep.outcomes, faults=rep.faults,
                 findings=0, launches=chaos_launches,
                 counters={k: v for k, v in tr.counters.items()
                           if k.startswith(("serve.", "cache."))})
    shutil.rmtree(root, ignore_errors=True)
    return launches, dict(warm=warm, disk=disk, launch=launch, chaos=chaos)


def per_forward_sum(shapes, key):
    """Sum of ``key`` over one forward's launches; None where a shape has
    no such number (WKV has no library call)."""
    if any(s[key] is None for s in shapes):
        return None
    return sum(s[key] * s["per_forward"] for s in shapes)


def summarise(per_kernel, launches):
    rows = []
    for name, info in KERNELS.items():
        shapes = per_kernel[name]["shapes"]
        total = lambda key: per_forward_sum(shapes, key)  # noqa: E731
        by = {"bytes": 0.0, "operations": 0.0}
        for s in shapes:
            by[s["bound_by"]] += s["bound_ms"] * s["per_forward"]
        f32_errs = [s["max_abs_err"] for s in shapes + per_kernel[name]["extra"]
                    if s["tol"] < 1e-2]
        path = MAIN_PATH[name]
        rows.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=launches[path][name],
            launches_by_path={p: n[name] for p, n in launches.items()},
            max_abs_err=max(f32_errs), ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by=max(by, key=by.get), library_ms=total("library_ms"),
            launches_per_forward=sum(s["per_forward"] for s in shapes),
            batch={"wkv_chunked": RWKV_REQUESTS[0][0],
                   "flash_attention_bwd": TRAIN_BATCH[0],
                   "wkv_chunked_bwd": TRAIN_BATCH[0],
                   "adamw": TRAIN_BATCH[0]}.get(name, BATCH),
            shapes=shapes, extra=per_kernel[name]["extra"]))
    return rows


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def main_path():
    cfg = CONFIG
    params = init_params(SEED, edgenext.param_defs(cfg), perturb=0.05)
    model = edgenext.EdgeNeXt(cfg, params).eval()
    plain = edgenext.EdgeNeXt(cfg, params, kernels=ref.PLAIN).eval()
    rng = np.random.default_rng(SEED + 1)
    sizes = [BATCH] * 4 + [1] * 2
    batches = [torch.from_numpy(rng.standard_normal(
        (b, cfg.img_size, cfg.img_size, cfg.in_channels), dtype=np.float32)).cuda()
        for b in sizes]

    serve(model, [batches[0], batches[-1]])       # warm-up, one of each size
    reset_counts()
    logits, ms = serve(model, batches)
    launches = read_counts()

    want = edgenext.kernel_launches_per_forward(cfg)
    if want != {"fused_ibn": 18, "depthwise_conv2d": 21, "flash_attention": 3}:
        fail(f"EdgeNeXt-S should launch 18/21/3 a forward, model says {want}")
    for name, n in launches.items():
        if n != want.get(name, 0) * len(batches):
            fail(f"{name}: {n} launches over {len(batches)} requests, "
                 f"expected {want[name]} a forward")

    serve(plain, [batches[0], batches[-1]])
    plain_logits, plain_ms = serve(plain, batches)
    worst = 0.0
    for i, (got, ref_out) in enumerate(zip(logits, plain_logits)):
        if got.shape != (sizes[i], cfg.num_classes) or got.dtype != torch.float32:
            fail(f"request {i}: logits {tuple(got.shape)} {got.dtype}")
        if not torch.isfinite(got).all():
            fail(f"request {i}: logits not finite")
        worst = max(worst, (got - ref_out).abs().max().item())
    if worst > 2e-3:
        fail(f"logits differ from the plain versions on the card by {worst:.3e} "
             f"(limit 2e-3)")

    # one single-image request against the plain model on the CPU
    cpu_model = edgenext.EdgeNeXt(cfg, params, device="cpu").eval()
    with torch.inference_mode():
        cpu_logits = cpu_model(batches[-1].cpu())
    cpu_err = (logits[-1].cpu() - cpu_logits).abs().max().item()
    if cpu_err > 2e-3:
        fail(f"logits differ from the plain model on the CPU by {cpu_err:.3e} "
             f"(limit 2e-3)")

    # steadier request times: ten more of each size
    _, ms16 = serve(model, [batches[0]] * 10)
    _, ms1 = serve(model, [batches[-1]] * 10)
    _, pms16 = serve(plain, [batches[0]] * 5)
    _, pms1 = serve(plain, [batches[-1]] * 5)
    result = dict(
        requests=sizes, request_ms=ms, plain_request_ms=plain_ms,
        launches=launches, max_abs_err_vs_plain_on_card=worst,
        max_abs_err_vs_plain_on_cpu=cpu_err,
        logits_abs_max=max(x.abs().max().item() for x in logits),
        ms_per_request_b16=statistics.median(ms16),
        ms_per_request_b1=statistics.median(ms1),
        plain_ms_per_request_b16=statistics.median(pms16),
        plain_ms_per_request_b1=statistics.median(pms1),
        peak_memory_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    result["captured"] = edgenext_captured(cfg, model, plain, batches, logits,
                                           plain_logits, rng)
    return launches, result


def edgenext_captured(cfg, model, plain, batches, logits, plain_logits,
                      rng) -> dict:
    """EdgeNeXt-S as ``captured(model)``: each capture (B = 16, then B = 1,
    on images of its own) counts 18 / 21 / 3 launches for the capture and
    as many for each of the WARMUP eager runs before it; the replays of the
    six requests and one more single image (four fresh batches at B = 16,
    three at B = 1) count none and give the eager logits bit for bit;
    request ms eager and captured in turns, 10 rounds at each batch; peak
    memory of each form."""
    want = edgenext.kernel_launches_per_forward(cfg)
    per_capture = {k: (WARMUP + 1) * want.get(k, 0) for k in KERNELS}

    def images(b):
        return torch.from_numpy(rng.standard_normal(
            (b, cfg.img_size, cfg.img_size, cfg.in_channels),
            dtype=np.float32)).cuda()

    cap = captured(model)
    captures = {}
    for b in (BATCH, 1):
        x = images(b)
        _, n, reserved = capture_counted(lambda: cap(x))
        if n != per_capture:
            fail(f"EdgeNeXt-S capture at B={b}: launches {n}, expected "
                 f"{per_capture} ({WARMUP} warm-up forwards and the capture)")
        captures[b] = dict(launches=n, capture_s=cap.capture_s[-1],
                           reserved_mib=reserved)
    requests = batches + [images(1)]
    with torch.inference_mode():
        eager = logits + [model(requests[-1])]
        plain_all = plain_logits + [plain(requests[-1])]
    reset_counts()
    got, _ = serve(cap, requests)
    on_replay = read_counts()
    if any(on_replay.values()):
        fail(f"EdgeNeXt-S captured: launches {on_replay} counted over "
             f"{len(requests)} replays, expected none")
    diff = first_difference(got, eager)
    if diff:
        fail(f"EdgeNeXt-S captured: replayed logits differ from the eager "
             f"ones, request {diff}")
    err = max((g - w).abs().max().item() for g, w in zip(got, plain_all))
    if err > 2e-3:
        fail(f"EdgeNeXt-S captured: logits differ from the plain versions on "
             f"the card by {err:.3e} (limit 2e-3)")
    timing, peak = {}, {}
    for b, x in ((BATCH, batches[0]), (1, batches[-1])):
        forms = {"eager": lambda: model(x), "captured": lambda: cap(x)}
        timing[b] = alternate(forms, rounds=10)
        peak[b] = {name: peak_mib(fn) for name, fn in forms.items()}
    return dict(captures=captures, requests=[r.shape[0] for r in requests],
                launches_on_replay=on_replay, max_abs_err_vs_plain_on_card=err,
                timing=timing, peak_allocated_mib=peak)


def decode_inputs(tokens: torch.Tensor) -> torch.Tensor:
    """What a greedy run fed its decode steps: token 0, then its own
    tokens but the last."""
    return torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]], 1)


def forced_decode(decode, params, cache, inputs: torch.Tensor):
    """Decode steps fed ``inputs`` [B, n] (teacher forcing) -> (logits
    [B, n, Vp], cache)."""
    logits = []
    with torch.inference_mode():
        for i in range(inputs.shape[1]):
            _, lg, cache = decode(params, cache, {"tokens": inputs[:, i:i + 1]})
            logits.append(lg)
    return torch.stack(logits, 1), cache


def wkv_graph_edge() -> dict:
    """One ``ops.wkv_chunked`` call at the served prefill shape (bfloat16,
    chunk ``rwkv_chunk.CHUNK``) captured alone into a CUDA graph: the graph's
    kernel nodes and the types of its edges as the driver reports them
    (``cuGraphGetEdges_v2``: 1 = programmatic, the dependent launch of the
    outputs pass kept as such; 0 = a full dependency); a replay on new
    inputs against the eager call, bit for bit; the call's time eager and
    replayed (CUDA events, median of 20, in turns)."""
    BH, T, K = 128, 512, 64                    # 4 x 512 tokens, 32 heads of 64
    r, k, v = (randn(BH, T, K, dtype=torch.bfloat16) for _ in range(3))
    logw = -torch.exp(randn(BH, T, K, scale=0.5))
    u = randn(BH, K)

    def call():
        return ops.wkv_chunked(r, k, v, logw, u, chunk=wkv_mod.CHUNK)

    drv = ctypes.CDLL("libcuda.so.1")
    with torch.inference_mode():
        for _ in range(WARMUP):
            call()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            out, state = call()
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        nodes, n = ctypes.c_size_t(0), ctypes.c_size_t(0)
        errs = [drv.cuGraphGetNodes(raw, None, ctypes.byref(nodes)),
                drv.cuGraphGetEdges_v2(raw, None, None, None, ctypes.byref(n))]
        frm, to = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
        data = (ctypes.c_uint8 * (8 * n.value))()   # CUgraphEdgeData: 8 bytes
        errs.append(drv.cuGraphGetEdges_v2(raw, frm, to, data, ctypes.byref(n)))
        if any(errs):
            fail(f"wkv_chunked graph: driver calls returned {errs}")
        edges = [data[8 * i + 2] for i in range(n.value)]
        r.copy_(randn(BH, T, K, dtype=torch.bfloat16))
        want = call()
        graph.replay()
        diff = first_difference([out, state], list(want))
        if diff:
            fail(f"wkv_chunked graph: a replay on new inputs differs from the "
                 f"eager call at {diff}")
        times = {"eager": [], "graph": []}
        for i in range(20):
            for name in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if name == "eager":
                    call()
                else:
                    graph.replay()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
    return dict(kernel_nodes=nodes.value, edge_types=edges,
                programmatic_edges=edges.count(1), replay_follows_inputs=True,
                eager_ms=statistics.median(times["eager"]),
                graph_ms=statistics.median(times["graph"]))


def lm_batch(cfg, rng, B: int, T: int) -> dict:
    """A request's prefill batch on the card, drawn as ``launch.serve``
    draws it: tokens [B, T]; where the config takes embedding inputs also
    ``inputs_embeds`` [B, T, D] after them (an encoder-decoder's source
    frames, whose decoder prefix is the tokens' first column); for M-RoPE
    ``layers.image_text_positions``, an image then text."""
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T),
                                                     dtype=np.int32)).cuda()}
    if cfg.embedding_inputs:
        batch["inputs_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)).cuda()
    if cfg.family == "audio":
        batch["tokens"] = batch["tokens"][:, :1].contiguous()
    if cfg.rope == "mrope":
        # an image of side x side patches, side the largest power of two
        # with side^2 <= T / 2 (16 x 16 at T = 512, 8 x 8 at 200 and 256)
        side = 1 << int(math.log2(math.sqrt(T / 2)))
        batch["positions"] = lm_layers.image_text_positions(B, T, side, "cuda")
    return batch


def decode_len(cfg, T: int, gen: int):
    """The prefill's ``decode_len`` of a request, as ``launch.serve`` passes
    it: prompt + generated tokens for an encoder-decoder (its self cache's
    length), nothing for the others."""
    return T + gen if cfg.family == "audio" else None


def lm_prefill(prefill, batch: dict, dlen=None):
    """``launch.serve.run_prefill`` on a batch dict."""
    return lm_serve.run_prefill(prefill, batch["tokens"],
                                batch.get("inputs_embeds"), dlen,
                                positions=batch.get("positions"))


def lm_captured(cfg, mod, params, batches, served, rng, requests,
                rounds) -> tuple[dict, list, tuple]:
    """An LM through ``launch.serve.captured_steps``: each prefill capture
    (one a distinct (B, T) of ``requests``, on prompts of its own) counts
    ``mod.kernel_launches_per_prefill`` for the capture and as many for each
    of the WARMUP eager runs, each decode capture none; the served requests
    (their prefill ``batches``) replayed count none and give the eager
    steps' last hidden, prefill cache, every step's tokens and logits and
    the last cache bit for bit; prefill ms and decode ms a token eager and
    captured in turns (``rounds`` of each) at the first and the last
    request's shape.  Returns the numbers, the replayed records and the
    captured steps."""
    per = mod.kernel_launches_per_prefill(cfg)
    per_capture = {k: (WARMUP + 1) * per.get(k, 0) for k in KERNELS}
    pre_c, dec_c = lm_serve.captured_steps(cfg, params)
    pre_e, dec_e = lm_serve.eager_steps(cfg, params)
    dev = torch.device("cuda")
    captures = {}
    for B, T, gen in {(b, t): (b, t, g) for b, t, g in requests}.values():
        p = lm_batch(cfg, rng, B, T)
        (_, cache, _), n_pre, res_pre = capture_counted(
            lambda: lm_prefill(pre_c, p, decode_len(cfg, T, gen)))
        _, n_dec, res_dec = capture_counted(
            lambda: lm_serve.run_decode(dec_c, cache, B, 1, dev))
        if n_pre != per_capture or any(n_dec.values()):
            fail(f"{cfg.name} capture at {B} x {T}: launches {n_pre} in the "
                 f"prefill and {n_dec} in decode, expected {per_capture} "
                 f"({WARMUP} warm-up runs and the capture) and none")
        captures[f"{B}x{T}"] = dict(
            prefill_launches=n_pre, decode_launches=n_dec,
            prefill_capture_s=pre_c.capture_s[-1],
            decode_capture_s=dec_c.capture_s[-1],
            prefill_reserved_mib=res_pre, decode_reserved_mib=res_dec)
        del cache

    reset_counts()
    records = []
    for i, (p, r, (B, T, gen)) in enumerate(zip(batches, served, requests)):
        last, cache, _ = lm_prefill(pre_c, p, decode_len(cfg, T, gen))
        toks, logits, cache_end, _ = lm_serve.run_decode(dec_c, cache, B, gen, dev)
        logits = torch.stack(logits, 1)
        # the last cache is the decode graph's buffer: compared before the
        # next request overwrites it
        diff = first_difference(
            [last, *pytree.tree_leaves(cache), toks, logits,
             *pytree.tree_leaves(cache_end)],
            [r["last"], *pytree.tree_leaves(r["cache"]), r["tokens"], r["logits"],
             *pytree.tree_leaves(r["cache_end"])])
        if diff:
            fail(f"{cfg.name} captured request {i}: differs from the eager steps "
                 f"(last hidden, prefill cache, tokens, logits, last cache) "
                 f"at {diff}")
        records.append(dict(prompt=r["prompt"], last=last, tokens=toks,
                            logits=logits))
        del cache, cache_end
    on_replay = read_counts()
    if any(on_replay.values()):
        fail(f"{cfg.name} captured: launches {on_replay} counted over the "
             f"replayed requests, expected none")

    timing = {}
    for i in (0, -1):
        B, T, gen = requests[i]
        batch, dlen = batches[i], decode_len(cfg, T, gen)
        timing[f"prefill_{B}x{T}"] = alternate(
            {"eager": lambda: lm_serve.call_prefill(pre_e, batch, dlen),
             "captured": lambda: lm_serve.call_prefill(pre_c, batch, dlen)},
            rounds=rounds[0])
        with torch.inference_mode():
            c_e = lm_serve.call_prefill(pre_e, batch, dlen)[1]
            c_c = lm_serve.call_prefill(pre_c, batch, dlen)[1]
        timing[f"decode_b{B}_{T}"] = alternate(
            {"eager": lambda: lm_serve.run_decode(dec_e, c_e, B, gen, dev),
             "captured": lambda: lm_serve.run_decode(dec_c, c_c, B, gen, dev)},
            rounds=rounds[1], per=gen)
        del c_e, c_c
    return (dict(captures=captures, launches_on_replay=on_replay,
                 bitwise_equal_requests=len(records), timing=timing),
            records, (pre_e, dec_e, pre_c, dec_c))


def rwkv6_captured(cfg, params, prompts, served, rng) -> tuple[dict, list]:
    """RWKV-6 through ``lm_captured`` (4 x 512 and 1 x 200), then the peak
    memory of a 4 x 512 request in each form and ``wkv_graph_edge``."""
    requests = [(b, t, RWKV_GEN) for b, t in RWKV_REQUESTS]
    cap, records, (pre_e, dec_e, pre_c, dec_c) = lm_captured(
        cfg, rwkv6, params, [{"tokens": p} for p in prompts], served, rng,
        requests, rounds=RWKV_ROUNDS)
    dev = torch.device("cuda")
    p = prompts[0]
    cap["peak_allocated_mib_b4_t512"] = {
        name: peak_mib(lambda: lm_serve.run_decode(
            dec, pre({"tokens": p})[1], p.shape[0], RWKV_GEN, dev))
        for name, pre, dec in (("eager", pre_e, dec_e), ("captured", pre_c, dec_c))}
    cap["wkv_graph"] = wkv_graph_edge()
    return cap, records


def rwkv6_path():
    """RWKV-6 1.6B served through ``launch.serve``'s prefill and greedy
    decode at full width, then held against its plain versions (see the
    module docstring, phase 5).  Returns the launch counts of the served
    requests and the numbers."""
    cfg = get_config("rwkv6-1.6b")
    defs = rwkv6.param_defs(cfg)
    if count_params(defs) != RWKV_PARAMS:
        fail(f"rwkv6: {count_params(defs)} parameters, expected {RWKV_PARAMS}")
    want = rwkv6.kernel_launches_per_prefill(cfg)
    if want != {"wkv_chunked": 24}:
        fail(f"RWKV-6 1.6B should launch wkv_chunked 24 times a prefill, "
             f"model says {want}")
    t0 = time.perf_counter()
    params = rwkv6.load_params(cfg, rwkv6.init_on_device(cfg, SEED))  # as served
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, decode = lm_serve.eager_steps(cfg, params)
    rng = np.random.default_rng(SEED + 2)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t),
                                             dtype=np.int32)).cuda()
               for b, t in RWKV_REQUESTS]

    for p in (prompts[0], prompts[-1]):        # warm-up, one of each size
        _, cache, _ = lm_serve.run_prefill(prefill, p)
        lm_serve.run_decode(decode, cache, p.shape[0], 2, p.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served = []
    launches = {name: 0 for name in KERNELS}
    for i, p in enumerate(prompts):
        B = p.shape[0]
        reset_counts()
        last, cache, prefill_ms = lm_serve.run_prefill(prefill, p)
        n_prefill = read_counts()
        reset_counts()
        toks, logits, cache_end, decode_ms = lm_serve.run_decode(
            decode, cache, B, RWKV_GEN, p.device)
        n_decode = read_counts()
        for name in KERNELS:
            expect = want.get(name, 0)
            if n_prefill[name] != expect or n_decode[name]:
                fail(f"rwkv6 request {i}: {name} launched {n_prefill[name]} "
                     f"times in prefill and {n_decode[name]} in decode, "
                     f"expected {expect} and 0")
            launches[name] += n_prefill[name] + n_decode[name]
        logits = torch.stack(logits, 1)
        if logits.shape != (B, RWKV_GEN, cfg.padded_vocab) \
                or not torch.isfinite(logits).all():
            fail(f"rwkv6 request {i}: logits {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
        if toks.shape != (B, RWKV_GEN) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"rwkv6 request {i}: tokens {tuple(toks.shape)} out of range")
        served.append(dict(prompt=p, last=last, cache=cache,
                           cache_end=cache_end, tokens=toks, logits=logits,
                           prefill_ms=prefill_ms, decode_ms=decode_ms))
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    # the same requests through the captured steps
    cap, cap_records = rwkv6_captured(cfg, params, prompts, served, rng)

    # the served bfloat16 run against the plain bfloat16 model
    plain_prefill = build_prefill_step(cfg, kernels=ref.PLAIN)
    plain_decode = build_decode_step(cfg, kernels=ref.PLAIN)
    # the eager and the captured records, each against the plain model
    # teacher-forced with its own tokens (run once where the two agree)
    V = cfg.vocab_size
    bf16, forced = {}, {}
    for form, recs in (("eager", served), ("captured", cap_records)):
        bf16_err, bf16_hidden_err, agree, steps = 0.0, 0.0, 0, 0
        for i in (0, len(recs) - 1):
            r = recs[i]
            if i not in forced or not torch.equal(forced[i][0], r["tokens"]):
                with torch.inference_mode():
                    last_p, cache_p = plain_prefill(params, {"tokens": r["prompt"]})
                logits_p, _ = forced_decode(plain_decode, params, cache_p,
                                            decode_inputs(r["tokens"]))
                forced[i] = (r["tokens"], last_p, logits_p)
            _, last_p, logits_p = forced[i]
            bf16_err = max(bf16_err, (r["logits"][..., :V] - logits_p[..., :V])
                           .abs().max().item())
            bf16_hidden_err = max(bf16_hidden_err, (r["last"].float()
                                                    - last_p.float()).abs().max().item())
            agree += int((logits_p[..., :V].argmax(-1) == r["tokens"]).sum())
            steps += r["tokens"].numel()
        if bf16_err > BF16_LOGITS_TOL or agree < BF16_AGREEMENT * steps:
            fail(f"rwkv6 bfloat16 {form}: logits differ from the plain model by "
                 f"{bf16_err:.3e} (limit {BF16_LOGITS_TOL}), greedy tokens agree "
                 f"{agree}/{steps} (at least {BF16_AGREEMENT:.0%})")
        bf16[form] = (bf16_err, bf16_hidden_err, agree / steps)
    bf16_err, bf16_hidden_err, agreement = bf16["eager"]
    cap["bf16_vs_plain"] = dict(zip(("max_logits_err", "max_last_hidden_err",
                                     "greedy_agreement"), bf16["captured"]))
    del cap_records, forced
    del params, plain_prefill, plain_decode
    torch.cuda.empty_cache()

    # float32: the kernel model against the plain model on the card, on the
    # float32 draw that the served weights round
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tree = rwkv6.init_on_device(cfg32, SEED)
    params32 = rwkv6.load_params(cfg32, tree)
    pre32, dec32 = lm_serve.eager_steps(cfg32, params32)
    p = prompts[0]
    last_k, cache_k, _ = lm_serve.run_prefill(pre32, p)
    toks_k, logits_k, _, _ = lm_serve.run_decode(dec32, cache_k, p.shape[0], 8,
                                                 p.device)
    with torch.inference_mode():
        last_p, cache_p = build_prefill_step(cfg32, kernels=ref.PLAIN)(
            params32, {"tokens": p})
    logits_p, _ = forced_decode(build_decode_step(cfg32, kernels=ref.PLAIN),
                                params32, cache_p, decode_inputs(toks_k))
    f32_err = max(
        compare("rwkv6 float32 last hidden", last_k, last_p, 2e-3),
        compare("rwkv6 float32 WKV states", cache_k.state, cache_p.state, 2e-3),
        compare("rwkv6 float32 time-mix shifts", cache_k.shift_tm,
                cache_p.shift_tm, 2e-3),
        compare("rwkv6 float32 logits", torch.stack(logits_k, 1), logits_p, 2e-3))
    # the same through the float32 model's captured steps: the eager bits,
    # and so the same distance from the plain model
    pre32c, dec32c = lm_serve.captured_steps(cfg32, params32)
    last_c, cache_c, _ = lm_serve.run_prefill(pre32c, p)
    toks_c, logits_c, _, _ = lm_serve.run_decode(dec32c, cache_c, p.shape[0], 8,
                                                 p.device)
    diff = first_difference([last_c, *cache_c, toks_c, *logits_c],
                            [last_k, *cache_k, toks_k, *logits_k])
    if diff:
        fail(f"rwkv6 float32 captured: differs from the eager steps at {diff}")
    cap["f32_max_err_vs_plain_on_card"] = max(
        compare("rwkv6 float32 captured last hidden", last_c, last_p, 2e-3),
        compare("rwkv6 float32 captured WKV states", cache_c.state,
                cache_p.state, 2e-3),
        compare("rwkv6 float32 captured logits", torch.stack(logits_c, 1),
                logits_p, 2e-3))
    del pre32c, dec32c, cache_c

    # one 1 x 64 float32 request against the plain model on the CPU
    p64 = prompts[-1][:, :64]
    last_k, cache_k, _ = lm_serve.run_prefill(pre32, p64)
    toks_k, logits_k, _, _ = lm_serve.run_decode(dec32, cache_k, 1, 4,
                                                 p64.device)
    logits_k = torch.stack(logits_k, 1).cpu()
    del params32, cache_k, cache_p
    torch.cuda.empty_cache()
    params_cpu = rwkv6.load_params(cfg32, tree, device="cpu")
    pre_cpu, dec_cpu = build_prefill_step(cfg32), build_decode_step(cfg32)
    with torch.inference_mode():
        last_c, cache_c = pre_cpu(params_cpu, {"tokens": p64.cpu()})
    logits_c, _ = forced_decode(dec_cpu, params_cpu, cache_c,
                                decode_inputs(toks_k).cpu())
    cpu_err = max((last_k.cpu() - last_c).abs().max().item(),
                  (logits_k - logits_c).abs().max().item())
    bound_c = 2e-3 * (1 + max(last_c.abs().max().item(), logits_c.abs().max().item()))
    if not (torch.allclose(last_k.cpu(), last_c, rtol=2e-3, atol=2e-3)
            and torch.allclose(logits_k, logits_c, rtol=2e-3, atol=2e-3)):
        fail(f"rwkv6 float32: the card differs from the plain model on the CPU "
             f"by {cpu_err:.3e} (limit 2e-3 (1 + |b|), at most {bound_c:.3e})")

    b4 = served[:-1]
    result = dict(
        requests=RWKV_REQUESTS, gen=RWKV_GEN, parameters=RWKV_PARAMS,
        init_params_s=init_s, launches=launches,
        prefill_ms=[r["prefill_ms"] for r in served],
        decode_ms=[r["decode_ms"] for r in served],
        prefill_ms_b4_t512=statistics.median(r["prefill_ms"] for r in b4),
        prefill_ms_b1_t200=served[-1]["prefill_ms"],
        decode_ms_per_token_b4=statistics.median(r["decode_ms"] / RWKV_GEN for r in b4),
        decode_ms_per_token_b1=served[-1]["decode_ms"] / RWKV_GEN,
        peak_memory_mib=peak_mib,
        logits_abs_max=max(r["logits"].abs().max().item() for r in served),
        bf16_max_logits_err_vs_plain=bf16_err,
        bf16_max_last_hidden_err_vs_plain=bf16_hidden_err,
        bf16_greedy_agreement=agreement,
        f32_max_err_vs_plain_on_card=f32_err, f32_max_err_vs_plain_on_cpu=cpu_err,
        first_tokens=served[0]["tokens"][0, :16].tolist(), captured=cap)
    return launches, result


def dense_path():
    """``h2o-danube-1.8b`` uncut served through ``launch.serve``'s prefill
    and greedy decode, eager then captured, held to its plain model
    (``lm_phase``; module docstring, phase 5b).  Returns the launch counts
    of the served requests and the numbers."""
    t0 = time.perf_counter()
    cfg = get_config(DENSE_ARCH)
    defs = transformer.param_defs(cfg)
    if count_params(defs) != DENSE_PARAMS:
        fail(f"dense: {count_params(defs)} parameters, expected {DENSE_PARAMS}")
    want = transformer.kernel_launches_per_prefill(cfg)
    if want != {"flash_attention": 24}:
        fail(f"{DENSE_ARCH} should launch flash_attention 24 times a prefill, "
             f"model says {want}")
    t1 = time.perf_counter()
    params = transformer.load_params(cfg, transformer.init_on_device(cfg, SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    rng = np.random.default_rng(SEED + 3)
    launches, result = lm_phase("dense", cfg, transformer, params, DENSE_REQUESTS, rng)
    del params
    torch.cuda.empty_cache()
    result.update(arch=DENSE_ARCH, parameters=DENSE_PARAMS, init_on="card",
                  init_params_s=init_s, wall_s=time.perf_counter() - t0)
    return launches, result


def refusals() -> list:
    """Each ``ops`` entry without a backward, on CUDA inputs one of which
    (a weight) requires grad, under grad mode: a RuntimeError naming the
    kernel before any launch, its counter unchanged.  ``wkv_chunked`` has a
    backward (``WKVChunked``): the same call returns outputs with its
    ``grad_fn`` after one launch."""
    def ones(*shape):
        return torch.full(shape, 0.5, device="cuda")

    args = [ones(4, 32, 16), ones(4, 32, 16), ones(4, 32, 16), -ones(4, 32, 16),
            ones(4, 16)]
    args[1].requires_grad_()
    before = read_counts()["wkv_chunked"]
    out, state = ops.wkv_chunked(*args, chunk=16)
    if not (isinstance(out.grad_fn, wkv_mod.WKVChunked._backward_cls)
            and state.grad_fn is out.grad_fn
            and read_counts()["wkv_chunked"] == before + 1):
        fail(f"refusal: wkv_chunked under grad gave grad_fn {out.grad_fn} after "
             f"{read_counts()['wkv_chunked'] - before} launches, expected "
             f"WKVChunked's after 1")
    cases = {
        "fused_ibn": (ops.fused_ibn, [ones(64, 48), ones(48, 160), ones(160, 48)]),
        "matmul_ln": (ops.matmul_ln, [ones(64, 96), ones(96, 96), ones(96),
                                      ones(96), ones(96)]),
        "depthwise_conv2d": (ops.depthwise_conv2d,
                             [ones(1, 8, 8, 16), ones(3, 3, 16), ones(16)]),
    }
    out = []
    for name, (fn, args) in cases.items():
        args[1].requires_grad_()
        before = read_counts()
        try:
            fn(*args)
        except RuntimeError as e:
            if name not in str(e):
                fail(f"refusal: {name} raised without naming its kernel: {e}")
        else:
            fail(f"refusal: {name} took a CUDA input that requires grad")
        if read_counts() != before:
            fail(f"refusal: {name} launched before it refused")
        out.append(name)
    return out


def digest(tree) -> list:
    """Each leaf's bits summed as integers and its values summed in float64:
    equal digests of two runs' states mean the same bits, for a check that
    keeps only one state on the card."""
    def one(t):
        bits = t.detach().view(torch.int32) if t.dtype == torch.float32 else t
        return (int(bits.to(torch.int64).sum()), float(t.detach().double().sum()))
    return [one(t) for t in tree_leaves(tree)]


def leaf_names(tree) -> list:
    names = []
    tree_map(lambda leaf, path: names.append(path), tree)
    return names


def per_grads(cfg) -> dict:
    """The kernel launches of one train step's gradients of ``cfg``
    (remat): each kernel of a prefill twice (the forward and remat's
    recompute) and its backward once."""
    fwd = get_module(cfg).kernel_launches_per_prefill(cfg)
    return dict({k: 2 * n for k, n in fwd.items()},
                **{f"{k}_bwd": n for k, n in fwd.items()})


def per_train_step(cfg) -> dict:
    """The kernel launches of one train step of ``cfg``: its gradients'
    (``per_grads``) and AdamW's, one a leaf."""
    return dict(per_grads(cfg), adamw=len(tree_leaves(get_module(cfg).param_defs(cfg))))


def with_update(per_step: dict, defs) -> dict:
    """A sharded step's launches: its gradients' (``per_step``) and AdamW's,
    one a leaf of the rank's blocks of ``defs``."""
    return dict(per_step, adamw=len(tree_leaves(defs)))


def f32_cut(cfg) -> tuple:
    """(``cfg``'s first layers in float32, their weights drawn on the
    card): the same float32 numbers as the first layers of
    ``init_on_device(float32 cfg, SEED)``, the masters' draw.  A stacked
    tree takes TRAIN_F32_LAYERS, drawn with ``layers=`` from the uncut
    config (an encoder-decoder's encoder and decoder each cut to as many);
    RecurrentGemma's blocks are a list, each leaf drawn whole in tree
    order, so its config is cut with its ``block_pattern``, up to its first
    attention layer (recurrent, recurrent, attention), so that the
    attention and its backward are in the check."""
    mod = get_module(cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if cfg.block_pattern:
        n = cfg.block_pattern.index("attention") + 1
        cut = dataclasses.replace(cfg32, num_layers=n, block_pattern=cfg.block_pattern[:n])
        return cut, mod.init_on_device(cut, SEED)
    n = TRAIN_F32_LAYERS
    cut = dataclasses.replace(cfg32, num_layers=n, num_encoder_layers=min(
        n, cfg.num_encoder_layers))
    return cut, mod.init_on_device(cfg32, SEED, layers=n)


def train_path(cfg, *, parameters: int, resume: bool) -> tuple:
    """Training ``cfg`` on the card (module docstring, phases 5f, 5g and
    5l): float32 masters drawn on the card from the seed (the model's
    ``init_on_device``, the draw its served weights round) and taken over
    as they are, bfloat16 compute with remat, ``build_train_step`` as
    ``launch.train`` builds it and captures it on the card
    (``captured_train_step``), TRAIN_STEPS steps.  First TRAIN_EAGER_STEPS
    eager steps from the draw (each launching exactly
    ``per_train_step(cfg)``), their state digested and freed; then the draw
    again and the captured run, whose first TRAIN_EAGER_STEPS steps must
    repeat the eager ones bit for bit (every loss and grad norm, the state's
    digest) and whose launches over the run are (WARMUP + 1) x
    ``per_train_step(cfg)``: the eager warm-up steps and the capture, none
    at a replay.  ``resume``: a checkpoint after TRAIN_CKPT steps, restored
    into fresh tensors and handed to the captured step (which copies them
    into its donated buffers), repeats the rest of the run bit for bit (5f
    only: the store does not depend on the arch).  The float32 check runs
    on the first layers (``f32_cut``), one captured step is traced after
    the run.  Returns the launch counts of the timed run and the
    numbers."""
    t0 = time.perf_counter()
    B, T = TRAIN_BATCH
    mod = get_module(cfg)
    per_step = per_train_step(cfg)
    ds = make_dataset(cfg, ShapeConfig("train", "train", T, B), seed=SEED)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(s).items()}
               for s in range(TRAIN_STEPS)]
    res = dict(arch=cfg.name, layers=cfg.num_layers,
               layers_uncut=get_config(cfg.name).num_layers, parameters=parameters,
               steps=TRAIN_STEPS, batch=TRAIN_BATCH, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
               clip=TRAIN_CLIP, refused=refusals(), per_step=per_step)
    if count_params(mod.param_defs(cfg)) != parameters:
        fail(f"train {cfg.name}: {count_params(mod.param_defs(cfg))} parameters, "
             f"expected {parameters}")
    t1 = time.perf_counter()
    params = tree_map(lambda t, path: t.requires_grad_(), mod.init_on_device(
        dataclasses.replace(cfg, dtype="float32"), SEED))
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t1
    names = leaf_names(params)

    # the first step's gradients through the kernels and the plain versions
    # (the expert choices of both recorded: the forward's, then remat's)
    grad_k, grad_p = build_grad_fn(cfg), build_grad_fn(cfg, kernels=ref.PLAIN)
    with recording_routes() as routes_k:
        reset_counts()
        loss_k, parts_k, gk = grad_k(params, batches[0])
        first = read_counts()
    want_first = {n: 0 for n in KERNELS}
    want_first.update(per_grads(cfg))
    if first != want_first:
        fail(f"train {cfg.name}: one step launched {first}, expected {want_first} "
             f"(the forward, remat's recompute, the backward)")
    with recording_routes() as routes_p:
        loss_p, parts_p, gp = grad_p(params, batches[0])
    rel = {}
    for n, a, b in zip(names, tree_leaves(gk), tree_leaves(gp)):
        rel[n] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    norm_k = torch.sqrt(sum(torch.sum(g.square()) for g in tree_leaves(gk))).item()
    norm_p = torch.sqrt(sum(torch.sum(g.square()) for g in tree_leaves(gp))).item()
    del gp
    worst = max(rel, key=rel.get)
    routing = None
    if routes_k:
        same, claims = routing_agreement(routes_k, routes_p)
        routing = same / claims
    res.update(first_step_launches=first, loss_first=loss_k.item(),
               loss_first_plain=loss_p.item(), ce_first=parts_k["ce"].item(),
               aux_first=parts_k["aux"].item(), aux_first_plain=parts_p["aux"].item(),
               grad_rel_l2_vs_plain=rel, grad_rel_l2_worst=[worst, rel[worst]],
               grad_norm_first=norm_k, grad_norm_first_plain=norm_p,
               routing_agreement_first=routing)
    if not (abs(loss_k.item() - loss_p.item()) <= TRAIN_LOSS_TOL
            and rel[worst] <= TRAIN_GRAD_REL
            and abs(norm_k - norm_p) <= TRAIN_NORM_REL * norm_p):
        fail(f"train {cfg.name}: the first step against the plain step: loss "
             f"{loss_k.item():.5f} vs {loss_p.item():.5f}, worst leaf {worst} rel L2 "
             f"{rel[worst]:.3e}, grad norm {norm_k:.5f} vs {norm_p:.5f}"
             + ("" if routing is None else f"; the two steps' expert choices "
                f"agree on {routing:.4f} of the claims"))

    # the first step again: the same bits
    loss_k2, _, gk2 = grad_k(params, batches[0])
    same = torch.equal(loss_k, loss_k2) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(gk), tree_leaves(gk2)))
    if not same:
        diff = first_difference(tree_leaves(gk2), tree_leaves(gk))
        fail(f"train {cfg.name}: two runs of the first step differ: loss "
             f"{loss_k2.item()!r} vs {loss_k.item()!r}, gradients {diff}")
    del gk, gk2

    # float32 on the first layers of the same draw, kernels against plain
    cfg32, tree32 = f32_cut(cfg)
    _, _, g32k = build_grad_fn(cfg32)(tree32, batches[0])
    _, _, g32p = build_grad_fn(cfg32, kernels=ref.PLAIN)(tree32, batches[0])
    res["f32_layers"] = cfg32.num_layers
    res["f32_pattern"] = list(cfg32.block_pattern) or None
    res["f32_max_grad_err_vs_plain"] = max(
        compare(f"train {cfg.name} float32 {cfg32.num_layers} layers grad {n}", a, b,
                2e-3)
        for n, a, b in zip(leaf_names(tree32), tree_leaves(g32k), tree_leaves(g32p)))
    del tree32, g32k, g32p

    # the eager steps: TRAIN_EAGER_STEPS of them from the draw, launches
    # checked a step, then the state digested and freed
    K = TRAIN_EAGER_STEPS
    sched = warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)
    eager_fn = build_train_step(cfg, lr_schedule=sched, clip_norm=TRAIN_CLIP)
    opt = adamw_init(params)
    eager = dict(losses=[], grad_norms=[], event_ms=[], wall_ms=[])
    want = {n: 0 for n in KERNELS}
    want.update(per_step)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for s in range(K):
        reset_counts()
        (params, opt, m), ev, wall = both_clocks(lambda: eager_fn(params, opt, batches[s]))
        got = read_counts()
        if got != want:
            fail(f"train {cfg.name}: eager step {s} launched {got}, expected {want}")
        eager["losses"].append(m["loss"].item())
        eager["grad_norms"].append(m["grad_norm"].item())
        eager["event_ms"].append(ev)
        eager["wall_ms"].append(wall)
    eager["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    eager_digest = digest({"params": params, "m": opt.m, "v": opt.v})
    del params, opt, m
    torch.cuda.empty_cache()

    # the captured run from the same draw: TRAIN_STEPS steps; with
    # ``resume`` a checkpoint after TRAIN_CKPT of them
    t1 = time.perf_counter()
    params = tree_map(lambda t, path: t.requires_grad_(), mod.init_on_device(
        dataclasses.replace(cfg, dtype="float32"), SEED))
    torch.cuda.synchronize()
    res["redraw_s"] = time.perf_counter() - t1
    step_fn = captured_train_step(build_train_step(cfg, lr_schedule=sched,
                                                   clip_norm=TRAIN_CLIP))
    opt = adamw_init(params)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_")) if resume else None
    losses, gnorms, auxes, ev_ms, wall_ms = [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peak = 0.0
    try:
        reset_counts()
        for s in range(TRAIN_STEPS):
            if s == TRAIN_CKPT and resume:
                t1 = time.perf_counter()
                save_checkpoint(ckpt_dir, s, {"params": params, "opt": opt})
                res["checkpoint_save_s"] = time.perf_counter() - t1
            (params, opt, m), ev, wall = both_clocks(
                lambda: step_fn(params, opt, batches[s]))
            losses.append(m["loss"].item())
            gnorms.append(m["grad_norm"].item())
            auxes.append(m["aux"].item())
            ev_ms.append(ev)
            wall_ms.append(wall)
            if s == K - 1:
                # the state after K steps against the eager run's (the
                # digest's temporaries kept out of the run's peak)
                peak = torch.cuda.max_memory_allocated() / 2 ** 20
                captured_digest = digest({"params": params, "m": opt.m, "v": opt.v})
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
        launches = read_counts()
        peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 20)
        want = {n: 0 for n in KERNELS}
        want.update({n: c * (WARMUP + 1) for n, c in per_step.items()})
        if launches != want:
            fail(f"train {cfg.name}: {TRAIN_STEPS} captured steps launched {launches}, "
                 f"expected {want} (the {WARMUP} eager steps and the capture)")
        if (losses[:K] != eager["losses"] or gnorms[:K] != eager["grad_norms"]
                or captured_digest != eager_digest):
            moved = [n for n, a, b in zip(leaf_names({"params": params, "m": opt.m,
                                                      "v": opt.v}),
                                          captured_digest, eager_digest) if a != b]
            fail(f"train {cfg.name}: the captured run's first {K} steps differ from the "
                 f"eager run's: losses {losses[:K]} against {eager['losses']}, grad norms "
                 f"{gnorms[:K]} against {eager['grad_norms']}, {len(moved)} leaves of the "
                 f"state differ, first {moved[:3]}")
        if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
            fail(f"train {cfg.name}: losses {losses} grad norms {gnorms}")
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            fail(f"train {cfg.name}: the loss did not fall: {losses}")
        worst_peak = max(peak, eager["peak_mib"])
        if worst_peak > FIVE_PEAK_GIB * 1024:
            fail(f"train {cfg.name}: peak {worst_peak:.0f} MiB passes {FIVE_PEAK_GIB} GiB")
        del m
        if resume:
            final = digest({"params": params, "m": opt.m, "v": opt.v})
            like = tree_map(lambda t, path: torch.empty_like(
                t, device="meta").requires_grad_(), params)
            reset_counts()
            params, opt = resumed_run(res, like, step_fn, batches, losses,
                                      gnorms, final, ckpt_dir)
            if any(read_counts().values()):
                fail(f"train {cfg.name}: the resumed replays launched {read_counts()}")
        # where a step's time goes: one more captured step traced (the
        # profiler's reading of a step's ~10,000-40,000 kernels takes longer
        # than the step)
        res["trace_steps"] = trace(lambda b: step_fn(params, opt, b), batches[0], 1,
                                   inference=False)
        capture = dict(capture_s=step_fn.capture_s, pool_mib=step_fn.pool_mib,
                       replays=step_fn.replays, calls=step_fn.calls)
        del params, opt, step_fn
    finally:
        if ckpt_dir is not None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    step_ms = statistics.median(ev_ms[-10:])
    res.update(
        launches=launches, losses=losses, grad_norms=gnorms, aux_losses=auxes,
        step_event_ms=ev_ms, step_wall_ms=wall_ms, step_ms=step_ms,
        step_wall_ms_median=statistics.median(wall_ms[-10:]),
        tokens_per_s=B * T / step_ms * 1e3, peak_memory_mib=peak,
        eager=dict(eager, step_ms=statistics.median(eager["event_ms"]),
                   step_wall_ms=statistics.median(eager["wall_ms"])),
        held_to_eager_steps=K, capture=capture,
        resumed_from=TRAIN_CKPT if resume else None, resumed_bitwise=resume,
        wall_s=time.perf_counter() - t0)
    return launches, res


def resumed_run(res, fresh, step_fn, batches, losses, gnorms, final,
                ckpt_dir) -> tuple:
    """Phase 5f's resume: the checkpoint restored into fresh tensors in the
    structure, dtypes and ``requires_grad`` of ``fresh`` (a tree on the meta
    device) and handed to the captured step ``step_fn``, which copies them
    into its donated buffers; steps TRAIN_CKPT.. run again (replays), which
    must repeat the run's losses, gradient norms and final state
    (``final``, by digest) bit for bit.  Returns the step's parameters and
    optimizer state."""
    t1 = time.perf_counter()
    step0, restored = restore(ckpt_dir, {"params": fresh, "opt": adamw_init(fresh)},
                              "cuda")
    res["checkpoint_restore_s"] = time.perf_counter() - t1
    del fresh
    params, opt = restored["params"], restored["opt"]
    del restored
    resumed = []
    for s in range(step0, TRAIN_STEPS):
        params, opt, m = step_fn(params, opt, batches[s])
        resumed.append((m["loss"].item(), m["grad_norm"].item()))
    again = digest({"params": params, "m": opt.m, "v": opt.v})
    first = list(zip(losses[step0:], gnorms[step0:]))
    if step0 != TRAIN_CKPT or resumed != first or again != final:
        moved = [n for n, a, b in zip(leaf_names({"params": params, "m": opt.m,
                                                  "v": opt.v}), again, final)
                 if a != b]
        step = next((step0 + i for i, (a, b) in enumerate(zip(resumed, first))
                     if a != b), None)
        fail(f"train: resumed at step {step0}, steps {step0}-{TRAIN_STEPS - 1} "
             f"do not repeat the run bit for bit: first differing step {step} "
             f"(loss, grad norm {resumed[step - step0] if step is not None else '-'} "
             f"against {first[step - step0] if step is not None else '-'}), "
             f"{len(moved)} leaves differ at the end, first {moved[:3]}")
    return params, opt


def print_train(res: dict, tag: str = "train") -> None:
    """The lines of a training phase, each led by ``tag``."""
    B, T = res["batch"]
    step = " + ".join(f"{c} {n}" for n, c in res["per_step"].items())
    depth = ("uncut" if res["layers"] == res["layers_uncut"] else
             f"cut to {res['layers']} of {res['layers_uncut']} layers")
    print(f"{tag} {res['arch']} {depth}, {res['parameters']} parameters, float32 "
          f"masters drawn on the card in {res['init_s']:.1f} s, bfloat16 compute, "
          f"remat; {res['steps']} steps of {B}x{T} tokens, lr {res['lr']} warmup "
          f"{res['warmup']} clip {res['clip']}; launches {res['launches']} = "
          f"(1 + {WARMUP}) x ({step}) (forward, remat's recompute, backward, AdamW a "
          f"leaf; the {WARMUP} eager steps and the capture); first step's gradients "
          f"{res['first_step_launches']}")
    w, r = res["grad_rel_l2_worst"]
    routing = res["routing_agreement_first"]
    moe = ("" if routing is None else
           f"; ce {res['ce_first']:.5f} aux {res['aux_first']:.5f} (plain "
           f"{res['aux_first_plain']:.5f}), expert choices agree on {routing:.4f} "
           f"of the claims")
    pattern = "" if res["f32_pattern"] is None else f" ({'/'.join(res['f32_pattern'])})"
    print(f"{tag} first step vs plain: loss {res['loss_first']:.5f} vs "
          f"{res['loss_first_plain']:.5f} (limit {TRAIN_LOSS_TOL}), grad norm "
          f"{res['grad_norm_first']:.5f} vs {res['grad_norm_first_plain']:.5f} "
          f"(limit {100 * TRAIN_NORM_REL:.0f} %), worst leaf {w} rel L2 {r:.3e} "
          f"(limit {TRAIN_GRAD_REL}){moe}; twice, same bits; float32 "
          f"{res['f32_layers']} layers{pattern} every grad within "
          f"{res['f32_max_grad_err_vs_plain']:.2e} (limit 2e-3 (1+|b|))")
    ls = res["losses"]
    aux = ("" if routing is None else
           f", aux {res['aux_losses'][0]:.5f} -> {res['aux_losses'][-1]:.5f}")
    print(f"{tag} losses {ls[0]:.4f} -> {ls[-1]:.4f} (mean of the first 5 "
          f"{np.mean(ls[:5]):.4f}, last 5 {np.mean(ls[-5:]):.4f}){aux}, grad norms "
          f"{res['grad_norms'][0]:.3f} -> {res['grad_norms'][-1]:.3f}, all finite")
    ck = res["resumed_from"]
    resumed = (f"checkpoint at step {ck} saved in {res['checkpoint_save_s']:.1f} s, "
               f"restored into fresh tensors in {res['checkpoint_restore_s']:.1f} s and "
               f"copied into the donated ones, steps {ck}-{res['steps'] - 1} replayed "
               f"again bit for bit with no launch" if ck is not None
               else "resume not repeated (phase 5f shows it; the store does not "
               "depend on the arch)")
    e, cap, K = res["eager"], res["capture"], res["held_to_eager_steps"]
    print(f"{tag} captured step ms (median of the last 10) events "
          f"{res['step_ms']:.2f} wall {res['step_wall_ms_median']:.2f}, eager (median "
          f"of the first {K}, their own run) events {e['step_ms']:.2f} wall "
          f"{e['step_wall_ms']:.2f}; the captured run's first {K} steps equal the "
          f"eager run's bit for bit (losses, grad norms, state digest); capture "
          f"{cap['capture_s']:.2f} s (host clock), graph pool {cap['pool_mib']:.0f} MiB, "
          f"{cap['replays']} replays in {cap['calls']} calls, launches only at the "
          f"{WARMUP} eager steps and the capture; {res['tokens_per_s']:.0f} tokens/s; "
          f"peak memory captured {res['peak_memory_mib']:.0f} MiB, eager "
          f"{e['peak_mib']:.0f} MiB; {resumed}; refusals {res['refused']}; phase wall "
          f"{res['wall_s']:.1f} s")
    tr = res["trace_steps"]
    busy = tr["device_busy_share"]
    top = ", ".join(f"{k['name'][:40]} {k['ms']:.1f}" for k in tr["top"][:6])
    print(f"{tag} traced x{tr['traced_requests']} captured steps: window {tr['window_ms']:.1f} "
          f"ms, device busy {tr['device_busy_ms']:.1f} ms "
          f"({'not measured' if busy is None else f'{100 * busy:.1f} %'}), own kernels "
          f"{tr['own_kernels_ms']:.2f} ms, {tr['device_kernel_launches']} device "
          f"kernels; top: {top}", flush=True)
    lru = res.get("rg_lru")
    if lru is not None:
        print(f"{tag} RG-LRU (gates and scan) alone at {B}x{T}x{lru['width']}, one "
              f"layer: forward {lru['fwd_ms']:.3f} ms, backward {lru['bwd_ms']:.3f} "
              f"ms; {lru['layers']} layers x (2 forwards + 1 backward) = "
              f"{lru['step_ms']:.1f} ms, {100 * lru['share']:.1f} % of the step",
              flush=True)


@contextlib.contextmanager
def recording_routes():
    """Every expert choice ``layers.moe_route`` makes while open, in call
    order: a list of [N, k] index tensors."""
    got, route = [], lm_layers.moe_route

    def rec(*args, **kw):
        out = route(*args, **kw)
        got.append(out[2])
        return out

    lm_layers.moe_route = rec
    try:
        yield got
    finally:
        lm_layers.moe_route = route


def serve_lm(tag: str, cfg, mod, params, requests, rng) -> tuple:
    """An LM's eager requests through ``launch.serve``'s steps (prefill,
    then greedy decode from token 0), after a warm-up at the first and the
    last request's shape.  Around each prefill and each decode loop the
    counters are set to 0 and read: ``mod.kernel_launches_per_prefill`` in
    a prefill, nothing in decode.  Logits of their shape, finite over the
    vocabulary and -inf over its padding (the decode step masks it before
    the argmax), tokens in the vocabulary; an MoE model's expert choices
    recorded.  Returns (the prefill batches, the served records, the
    launches, the peak allocated MiB)."""
    prefill, decode = lm_serve.eager_steps(cfg, params)
    batches = [lm_batch(cfg, rng, b, t) for b, t, _ in requests]
    want = mod.kernel_launches_per_prefill(cfg)
    for i in (0, -1):
        B, T, gen = requests[i]
        _, cache, _ = lm_prefill(prefill, batches[i], decode_len(cfg, T, gen))
        lm_serve.run_decode(decode, cache, B, 2, batches[i]["tokens"].device)
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served, launches = [], {name: 0 for name in KERNELS}
    for i, (batch, (B, T, gen)) in enumerate(zip(batches, requests)):
        with recording_routes() as routes:
            reset_counts()
            last, cache, prefill_ms = lm_prefill(prefill, batch, decode_len(cfg, T, gen))
            n_prefill = read_counts()
            reset_counts()
            toks, logits, cache_end, decode_ms = lm_serve.run_decode(
                decode, cache, B, gen, last.device)
            n_decode = read_counts()
        for name in KERNELS:
            expect = want.get(name, 0)
            if n_prefill[name] != expect or n_decode[name]:
                fail(f"{tag} request {i}: {name} launched {n_prefill[name]} "
                     f"times in prefill and {n_decode[name]} in decode, "
                     f"expected {expect} and 0")
            launches[name] += n_prefill[name] + n_decode[name]
        logits = torch.stack(logits, 1)
        V = cfg.vocab_size
        finite = bool(torch.isfinite(logits[..., :V]).all())
        masked = bool((logits[..., V:] == float("-inf")).all())
        if logits.shape != (B, gen, cfg.padded_vocab) or not (finite and masked) \
                or last.shape != (B, cfg.d_model):
            fail(f"{tag} request {i}: logits {tuple(logits.shape)}, finite over "
                 f"the vocabulary {finite}, padding -inf {masked}, last hidden "
                 f"{tuple(last.shape)}")
        if toks.shape != (B, gen) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{tag} request {i}: tokens {tuple(toks.shape)} out of range")
        # the (self) K cache: [L, B, Hkv, S, D], S the decode budget of an
        # encoder-decoder, else the prompt (a ring of the window past it)
        S = decode_len(cfg, T, gen) or mod.cache_len(cfg, T)
        want_k = (cfg.block_pattern.count("attention") if cfg.block_pattern
                  else cfg.num_layers, B, cfg.num_kv_heads, S, cfg.head_dim)
        if k_cache_shape(cache) != want_k:
            fail(f"{tag} request {i}: K cache {k_cache_shape(cache)}, expected {want_k}")
        if cfg.family == "hybrid":
            n_rec = cfg.block_pattern.count("recurrent")
            got = {(tuple(h.shape), h.dtype) for h in cache.rec_h} | {
                (tuple(c.shape), c.dtype) for c in cache.conv_state}
            states = {((B, cfg.lru_width), torch.float32),
                      ((B, cfg.conv1d_width - 1, cfg.lru_width), cfg.compute_dtype)}
            if got != states or len(cache.rec_h) != n_rec or len(cache.conv_state) != n_rec:
                fail(f"{tag} request {i}: recurrent states {sorted(map(str, got))} x "
                     f"{len(cache.rec_h)}, expected {sorted(map(str, states))} x {n_rec}")
        served.append(dict(prompt=batch, last=last, cache=cache, cache_end=cache_end,
                           tokens=toks, logits=logits, prefill_ms=prefill_ms,
                           decode_ms=decode_ms, routes=routes))
    return batches, served, launches, torch.cuda.max_memory_allocated() / 2 ** 20


def k_cache_shape(cache) -> tuple:
    """[layers, B, Hkv, S, D] of a request's (self) K cache: the hybrid's
    list of attention layers, else the stacked first field."""
    if isinstance(cache, recurrentgemma.RGCache):
        return (len(cache.attn_k), *cache.attn_k[0].shape)
    return tuple(cache[0].shape)


def forced_run(cfg, params, batch: dict, dlen, tokens, kernels) -> tuple:
    """A request's prefill, then its decode steps fed the served tokens
    (teacher forcing), through ``kernels`` -> (last hidden, logits [B, n, Vp],
    the expert choices made on the way, the prefill's cache)."""
    with recording_routes() as routes:
        with torch.inference_mode():
            last, cache = build_prefill_step(cfg, decode_len=dlen, kernels=kernels)(
                params, batch)
        logits, _ = forced_decode(build_decode_step(cfg, kernels=kernels), params,
                                  cache, decode_inputs(tokens))
    return last, logits, routes, cache


def routing_agreement(got: list, want: list) -> tuple[int, int]:
    """(claims of ``got`` that the same token's choices in ``want`` hold,
    claims), over two runs' ``recording_routes``."""
    same = sum(int((a[:, :, None] == b[:, None, :]).any(-1).sum())
               for a, b in zip(got, want, strict=True))
    return same, sum(a.numel() for a in got)


def exact_attention(q, k, v, *, causal=True, window=None, scale=None, **_blocks):
    """``ref.attention_ref`` with every product and sum in float64, rounded
    once to q's dtype: the representable result nearest the exact one."""
    Sq, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * (
        scale if scale is not None else D ** -0.5)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    keep = (qp >= kp) if causal else torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if window is not None:
        keep = keep & (qp - kp < window)
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.double()).to(q.dtype)


# the plain composition with its attention exactly rounded: where the
# kernel model and the plain model differ by no more than either differs
# from it, their gap is the config's bf16 noise, not a fault
EXACT = types.SimpleNamespace(flash_attention=exact_attention)


def layer_gaps(cfg, params, batch: dict, a, b) -> list:
    """A prompt through the blocks of two compositions (``kernels`` ``a``
    and ``b``), each fed its own residual stream from one embedding: each
    layer's (max |x_a - x_b|, max |x_b|), which shows where a gap opens
    and how it grows."""
    x, positions = transformer._embed_inputs(cfg, params, batch)
    xa = xb = x
    out = []
    with torch.inference_mode():
        for bp in per_layer(params["blocks"], cfg.num_layers):
            xa = transformer._block(cfg, bp, xa, positions, kernels=a, ibn_chunks=0,
                                    moe_capacity=1.25)[0]
            xb = transformer._block(cfg, bp, xb, positions, kernels=b, ibn_chunks=0,
                                    moe_capacity=1.25)[0]
            out.append(((xa.float() - xb.float()).abs().max().item(),
                        xb.float().abs().max().item()))
    return out


def hold_to_plain(tag: str, cfg, params, served, requests, floor: bool = False) -> dict:
    """The first and the last served request against the plain model
    (``kernels=ref.PLAIN``), teacher-forced with the served tokens:
    ``BF16_LOGITS_TOL`` on the logits, ``BF16_AGREEMENT`` on the greedy
    tokens.  For an MoE model, also the share of (token, choice) routings
    of the served requests that the plain model's choices for that token
    hold (the greedy run, fed its own tokens, is the teacher-forced run).  ``floor``: also the same
    requests through the plain composition with ``exact_attention`` (the
    served and the plain logits each against it) and ``layer_gaps`` of the
    first prompt, kernels against plain and plain against exact.  Where
    the plain model itself is farther than BF16_LOGITS_TOL from exactly
    rounded attention (the config's bf16 noise floor is above the limit),
    the logits limit is BF16_LOGITS_TOL above that distance: olmo-1b's
    tied float32 head reads a bf16 hidden state into logits of up to
    ~2,000, where one ulp of the hidden moves a logit by ~0.03; the floor
    of an untied head is a hundredth or so, and the limit stays.  Measured
    before the limits are applied, and named in a failure."""
    V = cfg.vocab_size
    err, hidden_err, agree, steps, same, claims = 0.0, 0.0, 0, 0, 0, 0
    plain_exact, served_exact = 0.0, 0.0
    for i in (0, len(served) - 1):
        r, (_, T, gen) = served[i], requests[i]
        dlen = decode_len(cfg, T, gen)
        last_p, logits_p, routes_p, _ = forced_run(cfg, params, r["prompt"], dlen,
                                                   r["tokens"], ref.PLAIN)
        err = max(err, (r["logits"][..., :V] - logits_p[..., :V]).abs().max().item())
        hidden_err = max(hidden_err, (r["last"].float() - last_p.float())
                         .abs().max().item())
        agree += int((logits_p[..., :V].argmax(-1) == r["tokens"]).sum())
        steps += r["tokens"].numel()
        if cfg.moe.enabled:
            n_same, n = routing_agreement(r["routes"], routes_p)
            same, claims = same + n_same, claims + n
        if floor:
            logits_x = forced_run(cfg, params, r["prompt"], dlen, r["tokens"], EXACT)[1]
            plain_exact = max(plain_exact, (logits_p[..., :V] - logits_x[..., :V])
                              .abs().max().item())
            served_exact = max(served_exact, (r["logits"][..., :V] - logits_x[..., :V])
                               .abs().max().item())
            del logits_x
        del logits_p, routes_p
    out = dict(bf16_max_logits_err_vs_plain=err,
               bf16_max_last_hidden_err_vs_plain=hidden_err,
               bf16_greedy_agreement=agree / steps)
    noise = ""
    if floor:
        prompt = served[0]["prompt"]
        out.update(bf16_plain_vs_exact_logits_err=plain_exact,
                   bf16_served_vs_exact_logits_err=served_exact,
                   layer_gaps_kernel_vs_plain=layer_gaps(cfg, params, prompt, ops,
                                                         ref.PLAIN),
                   layer_gaps_plain_vs_exact=layer_gaps(cfg, params, prompt,
                                                        ref.PLAIN, EXACT))
        noise = (f"; against exactly rounded attention: plain {plain_exact:.3e}, "
                 f"served {served_exact:.3e}")
    # BF16_LOGITS_TOL, unless the plain model itself is farther than that
    # from exactly rounded attention: then BF16_LOGITS_TOL above its distance
    limit = BF16_LOGITS_TOL + (plain_exact if plain_exact > BF16_LOGITS_TOL else 0.0)
    out["bf16_logits_limit"] = limit
    if err > limit or agree < BF16_AGREEMENT * steps:
        fail(f"{tag} bfloat16: logits differ from the plain model by {err:.3e} "
             f"(limit {limit:.4g}), greedy tokens agree {agree}/{steps} "
             f"(at least {BF16_AGREEMENT:.0%}){noise}")
    if claims:
        out["bf16_routing_agreement"] = same / claims
        out["routing_claims"] = claims
    return out


def lm_result(served, requests, launches, peak, cap, vocab: int) -> dict:
    """The phase's numbers: each request's prefill and decode ms (eager),
    the medians at the first request's shape and the last request's, peak
    memory, |logits|, first tokens and the captured form's numbers."""
    first = [r for r, q in zip(served, requests) if q[:2] == requests[0][:2]]
    return dict(
        requests=requests, launches=launches,
        prefill_ms=[r["prefill_ms"] for r in served],
        decode_ms_per_token=[r["decode_ms"] / r["tokens"].shape[1] for r in served],
        prefill_ms_first=statistics.median(r["prefill_ms"] for r in first),
        decode_ms_per_token_first=statistics.median(
            r["decode_ms"] / r["tokens"].shape[1] for r in first),
        prefill_ms_last=served[-1]["prefill_ms"],
        decode_ms_per_token_last=served[-1]["decode_ms"] / served[-1]["tokens"].shape[1],
        peak_memory_mib=peak,
        logits_abs_max=max(r["logits"][..., :vocab].abs().max().item() for r in served),
        first_tokens=served[0]["tokens"][0, :16].tolist(), captured=cap)


def lm_phase(tag: str, cfg, mod, params, requests, rng, floor: bool = False,
             rounds: tuple = (6, 3)) -> tuple:
    """Serve ``requests`` eager (``serve_lm``), then captured
    (``lm_captured``, ``rounds`` of prefill / decode timing (three of decode
    since phase 5h's part (j) came, four before), and a trace of
    three captured prefills at the first request's shape), then hold the
    eager records to the plain model (``hold_to_plain``, ``floor``).
    Returns (launches, numbers)."""
    batches, served, launches, peak = serve_lm(tag, cfg, mod, params, requests, rng)
    cap, records, (_, _, pre_c, _) = lm_captured(cfg, mod, params, batches, served,
                                                 rng, requests, rounds=rounds)
    B, T, gen = requests[0]
    dlen = decode_len(cfg, T, gen)
    cap["trace_prefill_first"] = trace(
        lambda b: lm_serve.call_prefill(pre_c, b, dlen), batches[0], 3)
    if len(pre_c.graphs) != len({(b, t) for b, t, _ in requests}):
        fail(f"{tag}: the captured prefill holds {len(pre_c.graphs)} graphs, "
             f"one a request shape expected")
    del records, pre_c
    result = lm_result(served, requests, launches, peak, cap, cfg.vocab_size)
    result.update(hold_to_plain(tag, cfg, params, served, requests, floor=floor))
    return launches, result


def f32_check(tag: str, cfg32, mod, params, rng, shape) -> tuple:
    """``cfg32``, a float32 config cut to its first layers, on ``params``:
    a B x T prefill (``shape``: (layers, B, T, greedy steps)) through the
    kernels, ``mod.kernel_launches_per_prefill`` launches in it and no
    other, then greedy steps, held to the plain model fed the same tokens:
    last hidden, every cache leaf and the logits within 2e-3 (1 + |b|) (a
    routing that flips between the two moves a logit by more than
    rounding, which the bfloat16 limits alone would not tell apart).
    Returns (the largest error, the share of (token, choice) routings the
    two agree on; None without experts)."""
    _, B, T, steps = shape
    batch = lm_batch(cfg32, rng, B, T)
    pre, dec = lm_serve.eager_steps(cfg32, params)
    want = {k: mod.kernel_launches_per_prefill(cfg32).get(k, 0) for k in KERNELS}
    with recording_routes() as routes_k:
        reset_counts()
        last_k, cache_k, _ = lm_prefill(pre, batch)
        if read_counts() != want:
            fail(f"{tag} float32: launches {read_counts()} in its prefill, "
                 f"expected {want}")
        toks, logits_k, _, _ = lm_serve.run_decode(dec, cache_k, B, steps,
                                                   last_k.device)
    last_p, logits_p, routes_p, cache_p = forced_run(cfg32, params, batch, None,
                                                     toks, ref.PLAIN)
    errs = [compare(f"{tag} float32 last hidden", last_k, last_p, 2e-3),
            compare(f"{tag} float32 logits", torch.stack(logits_k, 1), logits_p, 2e-3)]
    for i, (a, b) in enumerate(zip(pytree.tree_leaves(cache_k),
                                   pytree.tree_leaves(cache_p), strict=True)):
        errs.append(compare(f"{tag} float32 cache leaf {i}", a, b, 2e-3))
    routing = None
    if cfg32.moe.enabled:
        # the greedy run's prefill routes come first in both lists
        same, claims = routing_agreement(routes_k, routes_p)
        routing = same / claims
    return max(errs), routing


def moe_path():
    """``qwen2-moe-a2.7b`` at full width and MOE_LAYERS of its 24 layers served
    through ``launch.serve``'s steps, eager then captured, held to its
    plain model (module docstring, phase 5c).  Returns (launches, numbers)."""
    t0 = time.perf_counter()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    print(f"moe {MOE_ARCH} reduced: num_layers {full.num_layers} -> "
          f"{cfg.num_layers} (every layer has the same shapes; cut for the "
          f"script's time, 8 layers until phase 5h came)", flush=True)
    defs = transformer.param_defs(cfg)
    if count_params(defs) != MOE_PARAMS:
        fail(f"moe: {count_params(defs)} parameters, expected {MOE_PARAMS}")
    want = transformer.kernel_launches_per_prefill(cfg)
    if want != {"flash_attention": MOE_LAYERS}:
        fail(f"moe: should launch flash_attention {MOE_LAYERS} times a prefill, "
             f"model says {want}")
    t1 = time.perf_counter()
    params = transformer.load_params(cfg, transformer.init_on_device(cfg, SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    rng = np.random.default_rng(SEED + 4)
    launches, result = lm_phase("moe", cfg, transformer, params, MOE_REQUESTS, rng)
    del params
    torch.cuda.empty_cache()
    n = MOE_F32[0]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = transformer.load_params(dataclasses.replace(cfg32, num_layers=n),
                                       transformer.init_on_device(cfg32, SEED, layers=n))
    f32_err, f32_routing = f32_check("moe", dataclasses.replace(cfg32, num_layers=n),
                                     transformer, params32, rng, MOE_F32)
    del params32
    torch.cuda.empty_cache()
    result.update(arch=MOE_ARCH, layers=MOE_LAYERS, parameters=MOE_PARAMS,
                  init_on="card", init_params_s=init_s,
                  f32_max_err_vs_plain_on_card=f32_err,
                  f32_routing_agreement=f32_routing,
                  wall_s=time.perf_counter() - t0)
    return launches, result


def audio_path():
    """``seamless-m4t-large-v2`` uncut served through ``launch.serve``'s
    steps, eager then captured, held to its plain model (module docstring,
    phase 5d).  Returns (launches, numbers)."""
    t0 = time.perf_counter()
    cfg = get_config(AUDIO_ARCH)
    defs = seamless.param_defs(cfg)
    if count_params(defs) != AUDIO_PARAMS:
        fail(f"audio: {count_params(defs)} parameters, expected {AUDIO_PARAMS}")
    want = seamless.kernel_launches_per_prefill(cfg)
    if want != {"flash_attention": 72}:
        fail(f"audio: should launch flash_attention 72 times a prefill, model "
             f"says {want}")
    t1 = time.perf_counter()
    params = seamless.load_params(cfg, seamless.init_on_device(cfg, SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    rng = np.random.default_rng(SEED + 5)
    launches, result = lm_phase("audio", cfg, seamless, params, AUDIO_REQUESTS, rng)
    del params
    torch.cuda.empty_cache()
    result.update(arch=AUDIO_ARCH, parameters=AUDIO_PARAMS, init_on="card",
                  init_params_s=init_s, wall_s=time.perf_counter() - t0)
    return launches, result


def hybrid_path():
    """``recurrentgemma-2b`` uncut served through ``launch.serve``'s steps,
    eager then captured, held to its plain model, then the float32 check on
    its first three layers (module docstring, phase 5e).  Returns
    (launches, numbers)."""
    t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    defs = recurrentgemma.param_defs(cfg)
    if count_params(defs) != HYBRID_PARAMS:
        fail(f"hybrid: {count_params(defs)} parameters, expected {HYBRID_PARAMS}")
    want = recurrentgemma.kernel_launches_per_prefill(cfg)
    if want != {"flash_attention": 8}:
        fail(f"hybrid: should launch flash_attention 8 times a prefill, model "
             f"says {want}")
    t1 = time.perf_counter()
    # drawn on the card from the seed (``init_on_device``), as served
    params = recurrentgemma.load_params(cfg, recurrentgemma.init_on_device(cfg, SEED))
    init_s = time.perf_counter() - t1
    rng = np.random.default_rng(SEED + 6)
    launches, result = lm_phase("hybrid", cfg, recurrentgemma, params,
                                HYBRID_REQUESTS, rng)
    del params
    torch.cuda.empty_cache()
    # the first layers (recurrent, recurrent, attention): the attention in
    # float32, D 256 in two chunks over the grid; the scan's and the
    # convolution's states among the cache leaves
    n = HYBRID_F32[0]
    cfg32 = dataclasses.replace(cfg, num_layers=n, block_pattern=cfg.block_pattern[:n],
                                dtype="float32")
    # the same draw cut to its first layers: each leaf's seed is its index in
    # tree order (the embedding, then the blocks), and the final norm is a
    # fill, so these are the served tree's float32 numbers
    params32 = recurrentgemma.load_params(cfg32, recurrentgemma.init_on_device(cfg32, SEED))
    f32_err, _ = f32_check("hybrid", cfg32, recurrentgemma, params32, rng, HYBRID_F32)
    del params32
    torch.cuda.empty_cache()
    result.update(arch=HYBRID_ARCH, parameters=HYBRID_PARAMS, init_on="card",
                  init_params_s=init_s, f32_max_err_vs_plain_on_card=f32_err,
                  wall_s=time.perf_counter() - t0)
    return launches, result


def rg_lru_cost(cfg, step_ms: float) -> dict:
    """What the RG-LRU (``recurrentgemma.rg_lru``: ``_gates``' float32
    products and the doubling ``linear_scan``) costs a train step of
    ``cfg``: one recurrent layer's, at the step's B x T and the LRU width,
    timed alone by CUDA events on inputs of its own (the gates' matrices in
    bfloat16 as the step casts them): the forward under autograd, and the
    backward (the gradients of u and of every gate leaf).  A step runs each
    recurrent layer's forward twice (the forward, in which remat saves
    nothing, and its recompute) and its backward once; the share is that
    sum over the step's median ms."""
    B, T = TRAIN_BATCH
    W = cfg.lru_width
    layers = sum(k == "recurrent" for k in cfg.block_pattern)
    lam = randn(W)
    rec = dict(gate_i=randn(W, W, scale=W ** -0.5, dtype=torch.bfloat16),
               gate_i_b=torch.zeros_like(lam),
               gate_r=randn(W, W, scale=W ** -0.5, dtype=torch.bfloat16),
               gate_r_b=torch.zeros_like(lam), lam=lam)
    leaves = [t.requires_grad_() for t in rec.values()]
    u = randn(B, T, W, dtype=torch.bfloat16).requires_grad_()
    dy = randn(B, T, W, dtype=torch.bfloat16)
    fwd = time_ms(lambda: recurrentgemma.rg_lru(rec, u)[0])
    y = recurrentgemma.rg_lru(rec, u)[0]
    bwd = time_ms(lambda: torch.autograd.grad(y, [u] + leaves, dy, retain_graph=True))
    total = layers * (2 * fwd + bwd)
    return dict(width=W, layers=layers, fwd_ms=fwd, bwd_ms=bwd, step_ms=total,
                share=total / step_ms)


def family_phase() -> tuple[dict, dict]:
    """Phase 5l's three parts (FAMILIES, module docstring): each trained on
    the card by ``train_path`` and printed.  Returns the launch counts of
    each timed run by path (``audio_train``, ``hybrid_train``,
    ``moe_train``) and the numbers by tag."""
    launches, out = {}, {}
    for tag, arch, layers, per_prefill, parameters in FAMILIES:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        got = get_module(cfg).kernel_launches_per_prefill(cfg)
        if got != {"flash_attention": per_prefill}:
            fail(f"{tag}: should launch flash_attention {per_prefill} times a "
                 f"prefill, model says {got}")
        n, res = train_path(cfg, parameters=parameters, resume=False)
        if cfg.block_pattern:
            res["rg_lru"] = rg_lru_cost(cfg, res["step_ms"])
        print_train(res, tag)
        launches[tag.split("_")[1] + "_train"], out[tag] = n, res
    return launches, out


def multiarch_phase() -> tuple[dict, dict]:
    """Phase 5l's ``train_multiarch`` on the card: every arch of
    ``configs.ARCHS`` at reduced size through ``train_multiarch.run`` (the
    example's 12 steps of 4 x 48 tokens, float32, the kernels at D 16), the
    counters set to 0 before each and read after: exactly (WARMUP + 1) x
    ``per_train_step`` (the example's steps captured: the eager warm-up
    steps and the capture launch, the replays do not); the losses finite
    and the last below the first.  Returns the launches summed over the
    archs (path ``multiarch_train``) and the numbers by arch."""
    out, counts = {}, []
    steps = train_multiarch.STEPS
    for arch in sorted(ARCHS):
        cfg = reduced(get_config(arch))
        t0 = time.perf_counter()
        reset_counts()
        losses = train_multiarch.run(arch, device="cuda")
        got = read_counts()
        want = {n: 0 for n in KERNELS}
        want.update({n: c * (WARMUP + 1) for n, c in per_train_step(cfg).items()})
        if got != want:
            fail(f"train_multiarch {arch}: {steps} captured steps launched {got}, "
                 f"expected {want}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"train_multiarch {arch}: losses {losses}")
        out[arch] = dict(family=cfg.family, losses=losses, launches=got,
                         wall_s=time.perf_counter() - t0)
        counts.append(got)
        shape = train_multiarch.SHAPE
        print(f"train_multiarch {arch:24s} [{cfg.family:6s}] loss {losses[0]:7.3f} -> "
              f"{losses[-1]:7.3f} (reduced, {steps} captured steps of "
              f"{shape.global_batch}x{shape.seq_len}); launches "
              f"{ {n: c for n, c in got.items() if c} } in "
              f"{out[arch]['wall_s']:.1f} s", flush=True)
    return {"multiarch_train": {n: sum(c[n] for c in counts) for n in KERNELS}}, out


def logits_gap(tag: str, got: list, want: list, vocab: int) -> float:
    """The largest gap between two runs' decode logits, step by step, over
    the vocabulary (its padding is -inf in both), held to 2e-3 (1 + |b|)."""
    return max(compare(f"{tag} decode step {i} logits", a[:, :vocab], b[:, :vocab], 2e-3)
               for i, (a, b) in enumerate(zip(got, want)))


def quickstart_phase() -> tuple[dict, dict]:
    """Phase 5l's ``quickstart`` on the card: ``quickstart.run`` at the
    example's 120 steps, captured as the example jits them, the counters set
    to 0 before and read after: exactly (WARMUP + 1) x ``per_train_step``
    and (WARMUP + 1) x one prefill's launches (the eager warm-up runs and the
    capture of each; none at a replay, none in decode).  The losses finite and the mean of the last 20 below that of
    the first 20; the restored checkpoint (the save after step 120) equal to
    the run's last parameters and moments bit for bit; the 16 generated
    tokens teacher-forced through the plain steps (``kernels=ref.PLAIN``) on
    the restored weights: the last hidden state and every step's logits
    within 2e-3 (1 + |b|), the greedy agreement reported.  Returns the
    launches (path ``quickstart``) and the numbers."""
    t0 = time.perf_counter()
    reset_counts()
    res = quickstart.run(device="cuda",
                         out=lambda s: print(f"quickstart {s}", flush=True))
    got = read_counts()
    cfg, steps, losses = res["cfg"], quickstart.STEPS, res["losses"]
    want = {n: 0 for n in KERNELS}
    want.update({n: c * (WARMUP + 1) for n, c in per_train_step(cfg).items()})
    for n, c in get_module(cfg).kernel_launches_per_prefill(cfg).items():
        want[n] += c * (WARMUP + 1)
    if got != want:
        fail(f"quickstart: {steps} captured steps and the captured generation launched "
             f"{got}, expected {want}")
    cap = res["train_step"]
    if cap.replays != steps - WARMUP:
        fail(f"quickstart: {cap.replays} replays of the train step, expected "
             f"{steps - WARMUP}")
    if not (np.isfinite(losses).all() and np.mean(losses[-20:]) < np.mean(losses[:20])):
        fail(f"quickstart: the loss did not fall: {losses}")
    restored, opt = res["restored"], res["opt"]
    pairs = (list(zip(tree_leaves(restored["params"]), tree_leaves(res["params"])))
             + list(zip(tree_leaves(restored["opt"].m), tree_leaves(opt.m)))
             + list(zip(tree_leaves(restored["opt"].v), tree_leaves(opt.v)))
             + [(restored["opt"].count, opt.count)])
    if res["restored_step"] != steps or not all(torch.equal(a, b.detach()) for a, b in pairs):
        fail(f"quickstart: the checkpoint restored at step {res['restored_step']} differs "
             f"from the run's state after step {steps}")
    last, toks, logits = quickstart.generate(cfg, restored["params"], res["prompt"],
                                             kernels=ref.PLAIN, tokens_in=res["generated"])
    hidden_err = compare("quickstart last hidden against plain", res["last_hidden"], last, 2e-3)
    err = logits_gap("quickstart", res["logits"], logits, cfg.vocab_size)
    agree = (toks == res["generated"]).float().mean().item()
    out = dict(arch=cfg.name, steps=steps, batch=[quickstart.SHAPE.global_batch,
                                                  quickstart.SHAPE.seq_len],
               losses=losses, launches=got, restored_step=res["restored_step"],
               restored_bitwise=True, generated=res["generated"].tolist(),
               bigram_hits=res["bigram_hits"], last_hidden_err_vs_plain=hidden_err,
               logits_err_vs_plain=err, greedy_agreement=agree,
               capture_s=cap.capture_s, pool_mib=cap.pool_mib, replays=cap.replays,
               wall_s=time.perf_counter() - t0)
    print(f"quickstart on the card: {steps} steps of {quickstart.SHAPE.global_batch}x"
          f"{quickstart.SHAPE.seq_len} ({WARMUP} eager, captured in {cap.capture_s:.2f} s, "
          f"{cap.replays} replays), loss {np.mean(losses[:20]):.4f} -> "
          f"{np.mean(losses[-20:]):.4f} (mean of the first / last 20); launches "
          f"{ {n: c for n, c in got.items() if c} }; checkpoint at step "
          f"{res['restored_step']} restored bit for bit; {quickstart.GEN} tokens "
          f"teacher-forced through the plain steps: last hidden {hidden_err:.2e}, logits "
          f"{err:.2e} (limit 2e-3 (1+|b|)), greedy agreement {agree:.3f}; "
          f"{out['wall_s']:.1f} s", flush=True)
    return {"quickstart": got}, out


def serve_lm_phase() -> tuple[dict, dict]:
    """Phase 5l's ``serve_lm`` on the card: ``serve_lm.serve`` for each of
    the example's five archs at reduced size (4 x 48 prompts, 24 greedy
    tokens; the steps captured as the example jits them), the counters set
    to 0 before and read after: exactly (WARMUP + 1) x one prefill's
    launches (``kernel_launches_per_prefill``: the eager warm-up runs and
    the capture), none in decode;
    the tokens in the vocabulary; the same prompts teacher-forced with the
    served tokens through the plain steps (``kernels=ref.PLAIN``) on the
    same seed's weights: the last hidden state and every step's logits
    within 2e-3 (1 + |b|), the greedy agreement reported.  Returns the
    launches summed over the archs (path ``serve_lm``) and the numbers by
    arch."""
    out, counts = {}, []
    for arch in serve_lm_example.ARCHS:
        t0 = time.perf_counter()
        reset_counts()
        res = serve_lm_example.serve(arch, device="cuda",
                                     out=lambda s: print(f"serve_lm {s}", flush=True))
        got = read_counts()
        cfg, toks = res["cfg"], res["tokens"]
        want = {n: 0 for n in KERNELS}
        want.update({n: c * (WARMUP + 1) for n, c in
                     get_module(cfg).kernel_launches_per_prefill(cfg).items()})
        if got != want:
            fail(f"serve_lm {arch}: a captured prefill and {serve_lm_example.GEN} decode "
                 f"steps launched {got}, expected (1 + {WARMUP}) prefills' {want}")
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"serve_lm {arch}: tokens outside the vocabulary: {toks.tolist()}")
        plain = serve_lm_example.serve(arch, device="cuda", kernels=ref.PLAIN,
                                       tokens_in=toks, out=None)
        hidden_err = compare(f"serve_lm {arch} last hidden against plain",
                             res["last_hidden"], plain["last_hidden"], 2e-3)
        err = logits_gap(f"serve_lm {arch}", res["logits"], plain["logits"], cfg.vocab_size)
        agree = (plain["tokens"] == toks).float().mean().item()
        out[arch] = dict(family=cfg.family, tokens_first_seq=toks[0].tolist(),
                         prefill_ms=res["prefill_ms"],
                         decode_ms_per_token=res["decode_ms_per_token"], launches=got,
                         last_hidden_err_vs_plain=hidden_err, logits_err_vs_plain=err,
                         greedy_agreement=agree, wall_s=time.perf_counter() - t0)
        counts.append(got)
        print(f"serve_lm {arch}: launches {got.get('flash_attention', 0)} flash_attention "
              f"+ {got.get('wkv_chunked', 0)} wkv_chunked = (1 + {WARMUP}) prefills' (the "
              f"capture's), 0 in decode; "
              f"tokens in the vocabulary; teacher-forced through the plain steps: last "
              f"hidden {hidden_err:.2e}, logits {err:.2e} (limit 2e-3 (1+|b|)), greedy "
              f"agreement {agree:.3f}; {out[arch]['wall_s']:.1f} s", flush=True)
    return {"serve_lm": {n: sum(c[n] for c in counts) for n in KERNELS}}, out


def lm_bounds(cfg, params, requests) -> dict:
    """The least time of each request's steps on the card, keyed as
    ``lm_captured``'s timing: a B x T prefill's operations over PEAK_BF16
    (2 x tokens x the elements of each block matrix, an expert's 2 x its
    capacity x them: every expert's capacity is computed, filled or not; the
    attention's two products over the causal pairs) against its weights'
    bytes, and a decode step's bytes over MEM_BYTES_S (every parameter read
    once, an untied embedding's B rows only; the K / V cache of the prompt)
    against its operations (B rows through every matrix but the
    embedding's).  Each -> {"ms": least time, "by": "bytes" | "operations"}."""
    leaves = {}
    tree_map(lambda t, path: leaves.__setitem__(path, t), params)
    tied = "embed.unembed" not in leaves
    weight_bytes = sum(nbytes(t) for p, t in leaves.items()
                       if tied or p != "embed.embedding")
    mats = {p: t.numel() for p, t in leaves.items()
            if p.startswith("blocks.") and t.dim() >= 3}
    head = cfg.d_model * cfg.padded_vocab
    experts = {p for p in mats if p.rsplit(".", 1)[1] in ("wi", "wg", "wo")
               and p.startswith("blocks.moe.") and ".shared." not in p}
    out = {}
    for B, T, _ in requests:
        for key, n, steps in ((f"prefill_{B}x{T}", B * T, T),
                              (f"decode_b{B}_{T}", B, 1)):
            m = cfg.moe
            cap = int(max(1, (m.top_k * n * 1.25) // m.num_experts_padded)) \
                if m.enabled else 0
            flops = sum(2 * (cap if p in experts else n) * k for p, k in mats.items())
            if steps == T:
                pairs = unmasked_pairs(T, T, True, cfg.window)
                flops += 4 * B * cfg.num_layers * cfg.num_heads * cfg.head_dim * pairs
                moved = weight_bytes
            else:
                flops += 2 * B * head
                cache = 2 * cfg.num_layers * B * cfg.num_kv_heads * T * cfg.head_dim
                moved = weight_bytes + cache * cfg.compute_dtype.itemsize
            ms, by = bound(moved, flops, PEAK_BF16)
            out[key] = dict(ms=ms, by=by)
    return out


def five_path(arch: str, rng) -> tuple:
    """``arch``, one of FIVE, served at the layers FIVE gives it through
    ``launch.serve``'s steps (``lm_phase``: eager, captured, traced, held to
    its plain model) on weights drawn on the card (``init_on_device``: the
    first layers of the uncut draw), then the float32 check on its first
    FIVE_F32 layers of the same draw (module docstring, phase 5i).  Returns
    (launches, numbers)."""
    t0 = time.perf_counter()
    tag, n_params, cut = FIVE[arch]
    full = get_config(arch)
    cfg = full if cut is None else dataclasses.replace(full, num_layers=cut)
    if count_params(transformer.param_defs(cfg)) != n_params:
        fail(f"{tag}: {count_params(transformer.param_defs(cfg))} parameters, "
             f"expected {n_params}")
    want = transformer.kernel_launches_per_prefill(cfg)
    if want != {"flash_attention": cfg.num_layers}:
        fail(f"{tag}: should launch flash_attention {cfg.num_layers} times a "
             f"prefill, model says {want}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params = transformer.load_params(cfg, transformer.init_on_device(full, SEED,
                                                                      layers=cut))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    init_peak = torch.cuda.max_memory_allocated()
    served_mib = sum(nbytes(t) for t in tree_leaves(params)) / 2 ** 20
    bounds = lm_bounds(cfg, params, FIVE_REQUESTS)
    launches, result = lm_phase(tag, cfg, transformer, params, FIVE_REQUESTS, rng,
                                floor=True, rounds=FIVE_ROUNDS)
    phase_peak = max(init_peak, torch.cuda.max_memory_allocated()) / 2 ** 30
    del params
    torch.cuda.empty_cache()
    if phase_peak > FIVE_PEAK_GIB:
        fail(f"{tag}: the phase's peak {phase_peak:.2f} GiB passed "
             f"{FIVE_PEAK_GIB} GiB")
    n = FIVE_F32[0]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = transformer.load_params(
        dataclasses.replace(cfg32, num_layers=n),
        transformer.init_on_device(cfg32, SEED, layers=n))
    f32_err, f32_routing = f32_check(tag, dataclasses.replace(cfg32, num_layers=n),
                                     transformer, params32, rng, FIVE_F32)
    del params32
    torch.cuda.empty_cache()
    result.update(arch=arch, layers=cfg.num_layers, layers_uncut=full.num_layers,
                  parameters=n_params,
                  init_on="card", init_params_s=init_s, served_weights_mib=served_mib,
                  phase_peak_gib=phase_peak, bounds=bounds,
                  f32_max_err_vs_plain_on_card=f32_err,
                  f32_routing_agreement=f32_routing,
                  wall_s=time.perf_counter() - t0)
    return launches, result


def print_lm(tag: str, res: dict, per_prefill: int) -> None:
    """The lines of an LM phase (``lm_phase``'s numbers)."""
    (B0, T0, g0), (B1, T1, g1) = res["requests"][0], res["requests"][-1]
    bounds = res.get("bounds", {})

    def bound_of(key):
        b = bounds.get(key)
        return f" (bound {b['ms']:.3f}, {b['by']})" if b else ""

    print(f"{tag} {res['arch']} requests {res['requests']} (batch, prompt, greedy "
          f"tokens), {res['parameters']} parameters (init on the "
          f"{res.get('init_on', 'host')} {res['init_params_s']:.1f} s), launches "
          f"{res['launches']} = {per_prefill} flash_attention a prefill, 0 in decode")
    print(f"{tag} prefill ms {B0}x{T0} {res['prefill_ms_first']:.3f}"
          f"{bound_of(f'prefill_{B0}x{T0}')} {B1}x{T1} {res['prefill_ms_last']:.3f}"
          f"{bound_of(f'prefill_{B1}x{T1}')}; decode ms/token B={B0} "
          f"{res['decode_ms_per_token_first']:.3f}{bound_of(f'decode_b{B0}_{T0}')} "
          f"B={B1} {res['decode_ms_per_token_last']:.3f}"
          f"{bound_of(f'decode_b{B1}_{T1}')} (eager); peak memory "
          f"{res['peak_memory_mib']:.0f} MiB")
    routing = (f", expert routings agree {res['bf16_routing_agreement']:.4f} of "
               f"{res['routing_claims']}" if "bf16_routing_agreement" in res else "")
    print(f"{tag} bfloat16 vs plain: max |dlogits| "
          f"{res['bf16_max_logits_err_vs_plain']:.3e} (limit "
          f"{res['bf16_logits_limit']:.4g}), "
          f"last hidden {res['bf16_max_last_hidden_err_vs_plain']:.3e}, greedy "
          f"agreement {res['bf16_greedy_agreement']:.3f} (at least "
          f"{BF16_AGREEMENT}){routing}; |logits| <= {res['logits_abs_max']:.3f}")
    cap = res["captured"]
    for shape, c in cap["captures"].items():
        print(f"{tag} captured {shape}: capture prefill {c['prefill_capture_s']:.2f} s "
              f"decode {c['decode_capture_s']:.2f} s (host clock, {WARMUP} warm-up "
              f"runs included), launches prefill "
              f"{c['prefill_launches']['flash_attention']} flash_attention = "
              f"(1 + {WARMUP}) x {per_prefill}, decode "
              f"{sum(c['decode_launches'].values())}; graph reserved "
              f"{c['prefill_reserved_mib']:.0f} + {c['decode_reserved_mib']:.0f} MiB")
    print(f"{tag} captured: {cap['bitwise_equal_requests']} requests replayed equal "
          f"the eager steps bit for bit (last hidden, prefill cache, tokens, "
          f"logits, last cache), launches on replay "
          f"{sum(cap['launches_on_replay'].values())}")
    for key, t in cap["timing"].items():
        unit = "ms/token" if key.startswith("decode") else "ms"
        print(f"{tag} {key} {unit} eager|captured (median, in turns): events "
              f"{t['eager']['event_ms']:.3f}|{t['captured']['event_ms']:.3f} wall "
              f"{t['eager']['wall_ms']:.3f}|{t['captured']['wall_ms']:.3f}"
              f"{bound_of(key)}")
    tr = cap["trace_prefill_first"]
    busy = tr["device_busy_share"]
    print(f"{tag} captured prefill {B0}x{T0} traced x{tr['traced_requests']}: window "
          f"{tr['window_ms']:.2f} ms, device busy {tr['device_busy_ms']:.2f} ms "
          f"({'not measured' if busy is None else f'{100 * busy:.1f} %'}), own "
          f"kernels {tr['own_kernels_ms']:.2f} ms, {tr['device_kernel_launches']} "
          f"device kernels; phase wall {res['wall_s']:.1f} s", flush=True)


def five_phase() -> tuple[dict, dict]:
    """Phase 5i: each of FIVE through ``five_path``, its lines printed as
    it ends.  Returns (launches by path, numbers by tag)."""
    t0 = time.perf_counter()
    launches, results = {}, {}
    for i, arch in enumerate(FIVE):
        tag = FIVE[arch][0]
        n, res = five_path(arch, np.random.default_rng(SEED + 7 + i))
        launches[f"{tag}_serve"], results[tag] = n, res
        print_lm(tag, res, res["layers"])
        routing = ("" if res["f32_routing_agreement"] is None else
                   f", expert routings agree {res['f32_routing_agreement']:.4f}")
        gaps = res["layer_gaps_kernel_vs_plain"]
        floor = res["layer_gaps_plain_vs_exact"]
        opens = next((j for j, (d, _) in enumerate(gaps) if d > 0), None)
        print(f"{tag} bfloat16 noise floor: logits of the plain model against its "
              f"attention exactly rounded {res['bf16_plain_vs_exact_logits_err']:.3e}, "
              f"served against it {res['bf16_served_vs_exact_logits_err']:.3e}; "
              f"residual stream max |dx| (max |x|) kernels vs plain from layer "
              f"{opens}: " + ", ".join(
                  f"L{j} {d:.3g} ({m:.3g})" for j, (d, m) in enumerate(gaps)
                  if j in (0, 1, len(gaps) // 2, len(gaps) - 1))
              + "; plain vs exact: " + ", ".join(
                  f"L{j} {d:.3g}" for j, (d, _) in enumerate(floor)
                  if j in (0, 1, len(floor) // 2, len(floor) - 1)), flush=True)
        print(f"{tag} float32 ({FIVE_F32[0]} layers of the same draw, "
              f"{FIVE_F32[1]}x{FIVE_F32[2]}, {FIVE_F32[3]} steps) err vs plain on "
              f"card {res['f32_max_err_vs_plain_on_card']:.2e} (limit 2e-3 "
              f"(1+|b|)){routing}; weights {res['served_weights_mib']:.0f} MiB as "
              f"served, phase peak {res['phase_peak_gib']:.2f} GiB (limit "
              f"{FIVE_PEAK_GIB}), {res['layers']} of {res['layers_uncut']} layers",
              flush=True)
    print(f"five: {len(FIVE)} configs served at full width, phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, results


def split_text(rec: dict) -> str:
    """`` [regime R] splits S ctas N`` from a record's plan, the depthwise
    tile ``tile THxTWxCB cv CV ctas N smem S``, or the WKV plan ``wv W
    warps N rows R ctas N | states ctas N``, if it has one."""
    if "states_ctas" in rec:
        return (f" wv {rec['wv']} warps {rec['warps']} rows {rec['rows']} ctas "
                f"{rec['ctas']} | states ctas {rec['states_ctas']}")
    if "cb" in rec:
        return (f" tile {rec['th']}x{rec['tw']}x{rec['cb']} cv {rec['cv']} "
                f"ctas {rec['ctas']} smem {rec['smem']}")
    if "splits" not in rec:
        return ""
    regime = f" regime {rec['regime']}" if "regime" in rec else ""
    return f"{regime} splits {rec['splits']} ctas {rec['ctas']}"


# ---------------------------------------------------------------------------
# 5h. the distributed runtime: worlds of ranks on the one card
# ---------------------------------------------------------------------------


def dist_dense_cfg(layers: int = DIST_LAYERS, dtype=None):
    """``h2o-danube-1.8b`` at full width and ``layers`` of its 24 layers."""
    cfg = dataclasses.replace(get_config(DENSE_ARCH), num_layers=layers)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def dist_batches(cfg, n: int) -> list:
    """The first ``n`` global batches of 5f's data (TRAIN_BATCH tokens)."""
    B, T = TRAIN_BATCH
    ds = make_dataset(cfg, ShapeConfig("train", "train", T, B), seed=SEED)
    return [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(s).items()}
            for s in range(n)]


def dist_step(cfg, mesh=None, profile: str = "2d"):
    """5f's step (its schedule and clipping), on ``mesh`` where given."""
    return build_train_step(cfg, lr_schedule=warmup_cosine(TRAIN_LR, TRAIN_WARMUP,
                                                           TRAIN_STEPS),
                            clip_norm=TRAIN_CLIP, mesh=mesh, profile=profile)


def dist_masters(tree):
    return tree_map(lambda a, path: torch.from_numpy(np.array(a)).cuda()
                    .requires_grad_(), tree)


def dist_f32_tree(tree):
    return dict(tree, blocks=tree_map(lambda a, path: a[:DIST_F32[0]], tree["blocks"]))


def dist_one_process(tmp: str, serve_too: bool = True) -> dict:
    """Part (a), a world of one rank under NCCL: the cut dense model's
    DIST_STEPS steps with no mesh and on the (1, 1) mesh must give the same
    bits (metrics, parameters, moments).  It also writes part (c)'s
    references to ``tmp``: the first step's gradients and the float32
    model's parameters after DIST_F32[1] steps; the metrics of the no-mesh
    steps are returned.  With ``serve_too`` the same world then runs phase
    5j's (1, 1) serving check (``mesh_serve_one_rank``)."""
    tmp = Path(tmp)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
    if mesh.backend != "nccl":
        fail(f"dist (a): a world of one rank with a card runs {mesh.backend}")
    cfg = dist_dense_cfg()
    tree = load_checkpoint(tmp / "dense", 0, like=transformer.param_defs(cfg))[1]
    batches = dist_batches(cfg, DIST_STEPS)

    def run(m, config, src, steps):
        params = dist_masters(src)
        opt = adamw_init(params)
        step = dist_step(config, m)
        metrics = []
        for b in batches[:steps]:
            params, opt, mt = step(params, opt, b)
            metrics.append(torch.stack([mt["loss"], mt["grad_norm"]]))
        return torch.stack(metrics).cpu(), params, opt

    def state(run_out):
        return (tree_leaves(run_out[1]) + tree_leaves(run_out[2].m)
                + tree_leaves(run_out[2].v))

    plain = run(None, cfg, tree, DIST_STEPS)
    meshed = run(mesh, cfg, tree, DIST_STEPS)
    if not (torch.equal(plain[0], meshed[0]) and all(
            torch.equal(a, b) for a, b in zip(state(plain), state(meshed)))):
        fail("dist (a): the (1, 1) mesh's steps differ from the no-mesh steps")
    metrics = plain[0].tolist()
    del plain, meshed
    # a collective over an axis of one rank sends nothing: NCCL itself is
    # held here, an all-reduce and an all-gather over each axis's group
    for axis, group in mesh.groups.items():
        x = torch.arange(1024, dtype=torch.float32, device="cuda")
        y, parts = x.clone(), [torch.empty_like(x)]
        dist.all_reduce(y, group=group)
        dist.all_gather(parts, x, group=group)
        if not (torch.equal(y, x) and torch.equal(parts[0], x)):
            fail(f"dist (a): NCCL's all-reduce or all-gather over {axis} changed its input")
    with FlopCounterMode(display=False) as flops:
        _, _, grads = build_grad_fn(cfg)(dist_masters(tree), batches[0])
    save_checkpoint(tmp / "grads", 0, grads)
    del grads
    cfg32 = dist_dense_cfg(DIST_F32[0], "float32")
    save_checkpoint(tmp / "f32", 0, run(None, cfg32, dist_f32_tree(tree), DIST_F32[1])[1])
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    serving = mesh_serve_one_rank() if serve_too else None
    return dict(backend=mesh.backend, mesh=mesh.sizes, steps=DIST_STEPS,
                mesh_serve=serving,
                nccl_collectives_checked=sorted(mesh.groups), losses=[m[0] for m in metrics], grad_norms=[m[1] for m in metrics],
                grad_fn_flops=flops.get_total_flops(), peak_mib=peak_mib,
                seconds=time.perf_counter() - t0)


def dist_serve(tmp: Path) -> dict:
    """Part (b): ``pipeline.data_parallel`` of EdgeNeXt-S's forward over
    data = 2, each rank 8 of the 16 images through the kernels."""
    mesh = mesh_lib.make_mesh((2, 1), ("data", "model"))
    params = init_params(SEED, edgenext.param_defs(CONFIG), perturb=0.05)
    model = edgenext.EdgeNeXt(CONFIG, params).eval()
    images = torch.from_numpy(np.load(tmp / "images.npy")).cuda()
    want = torch.from_numpy(np.load(tmp / "logits.npy")).cuda()
    dp = dist_pipeline.data_parallel(lambda p, x: model(x), mesh=mesh)
    with torch.inference_mode():
        dp(None, images)                         # warm-up
        reset_counts()
        got = dp(None, images)
        launches = read_counts()
        try:
            dp(None, images[:DIST_EDGE_ODD])
            refused = None
        except ValueError as e:
            refused = str(e)
    per = edgenext.kernel_launches_per_forward(CONFIG)
    if launches != {n: per.get(n, 0) for n in KERNELS}:
        fail(f"dist (b): a rank launched {launches}, expected one forward's {per}")
    if refused is None or "not divisible" not in refused:
        fail(f"dist (b): a batch of {DIST_EDGE_ODD} over data=2 was not refused "
             f"({refused})")
    err = compare("dist (b) EdgeNeXt-S logits, data=2 against one process", got,
                  want, 2e-3)
    return dict(batch=images.shape[0], rows_a_rank=images.shape[0] // 2,
                launches=launches, max_abs_err=err, refused=refused)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def recorded(name: str, shapes: list, keywords: list | None = None, module=ops):
    """A stand-in for ``module.<name>`` that appends the shapes of its first
    two operands to ``shapes`` (and its keyword arguments but tensors to
    ``keywords``, a tensor's as its shape) and calls the kernel's wrapper
    (which counts)."""
    real = getattr(module, name)

    def rec(a, b, *args, **kw):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        if keywords is not None:
            keywords.append({k: tuple(v.shape) if torch.is_tensor(v) else v
                             for k, v in kw.items()})
        return real(a, b, *args, **kw)
    return real, rec


def dist_train(tmp: Path, one: dict, shape=(2, 1), part: str = "c",
               profile: str = "2d") -> dict:
    """Part (c): the sharded step of the cut dense model on (data 2,
    model 1), its parameters restored onto the mesh from the host arrays,
    against part (a)'s one-process step; the float32 check; a checkpoint
    after DIST_CKPT steps restored onto (1, 2).  Part (f) runs the same on
    (data 1, model 2) with each rank's FLOPs of one ``grad_fn`` against
    one process's and the heads its attention kernels run, and no
    checkpoint.  Part (h) runs (f)'s checks under ``profile`` 'cp': each
    rank 256 of a row's 512 tokens, the losses within DIST_CP_LOSS_TOL of
    one process's, the query offset of each attention launch, forward and
    backward."""
    rank = dist.get_rank()
    cfg = dist_dense_cfg()
    defs = transformer.param_defs(cfg)
    mesh = mesh_lib.make_mesh(shape, ("data", "model"))
    step = dist_step(cfg, mesh, profile)
    like = tree_map(lambda d, path: torch.empty(0).requires_grad_(), defs)
    params = restore_sharded(tmp / "dense", like, step.pspecs, mesh)[1]
    opt = adamw_init(params)
    batches = dist_batches(cfg, DIST_STEPS)
    layers = cfg.num_layers
    per_step = {n: 0 for n in KERNELS}
    per_step.update(flash_attention=2 * layers, flash_attention_bwd=layers)
    tag = f"dist ({part})"

    # the first step's gradients against the one process's, the heads the
    # attention kernel runs on and (part f) the grad_fn's FLOPs
    heads, fwd_kw, bwd_kw = [], [], []
    real_fa, ops.flash_attention = recorded("flash_attention", heads, fwd_kw)
    real_bwd, fab_mod.flash_attention_bwd = recorded("flash_attention_bwd", [], bwd_kw,
                                                     fab_mod)
    try:
        reset_counts()
        loss0, _, grads = step.grad_fn(params, batches[0])
        first = read_counts()
    finally:
        ops.flash_attention, fab_mod.flash_attention_bwd = real_fa, real_bwd
    if first != per_step:
        fail(f"{tag}: the first step launched {first}, expected {per_step}")
    offsets = dict(forward=sorted({k.get("q_offset", 0) for k in fwd_kw}),
                   backward=sorted({k.get("q_offset", 0) for k in bwd_kw}))
    if profile == "cp":
        want_off = [mesh.coords["model"] * TRAIN_BATCH[1] // shape[1]]
        if offsets != dict(forward=want_off, backward=want_off):
            fail(f"{tag}: the attention launches ran at offsets {offsets}, expected "
                 f"{want_off} on this rank")
    flops = None
    if part in ("f", "h"):
        with FlopCounterMode(display=False) as fc:
            step.grad_fn(params, batches[0])
        flops = fc.get_total_flops()
        if flops > DIST_TP_FLOPS * one["grad_fn_flops"]:
            fail(f"{tag}: a rank's grad_fn counts {flops:.4g} FLOPs, more than "
                 f"{DIST_TP_FLOPS} of one process's {one['grad_fn_flops']:.4g}")
    grads = sharding.tree_gather_full(grads, step.pspecs, mesh)
    rel, norm = {}, global_norm(grads).item()
    if rank == 0:
        want = load_checkpoint(tmp / "grads", 0, like=defs)[1]
        tree_map(lambda g, w, path: rel.__setitem__(path, rel_l2(
            g, torch.from_numpy(w).cuda())), grads, want)
        del want
    del grads
    worst = max(rel, key=rel.get) if rel else None
    if rank == 0 and rel[worst] > TRAIN_GRAD_REL:
        fail(f"{tag}: first step's gradient {worst} rel L2 {rel[worst]:.3e} against "
             f"one process (limit {TRAIN_GRAD_REL})")

    times, staged, gathered, live, metrics = [], [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for s, b in enumerate(batches):
        before = collectives.host_staged_bytes
        sharding.reset_gather_counts()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t_host = time.perf_counter()
        start.record()
        params, opt, m = step(params, opt, b)
        end.record()
        end.synchronize()
        times.append(dict(event_ms=start.elapsed_time(end),
                          wall_ms=1e3 * (time.perf_counter() - t_host)))
        n = read_counts()
        if n != with_update(per_step, defs):
            fail(f"{tag}: step {s} launched {n}, expected {with_update(per_step, defs)}")
        staged.append(collectives.host_staged_bytes - before)
        gathered.append(sharding.gathered_bytes)
        live.append(sharding.peak_live_gathered_bytes)
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
        if part == "c" and s + 1 == DIST_CKPT:
            full = sharding.tree_gather_full(params, step.pspecs, mesh)
            if rank == 0:
                save_checkpoint(tmp / "ckpt", DIST_CKPT, full)
            dist.barrier()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    loss_tol = DIST_CP_LOSS_TOL if profile == "cp" else TRAIN_LOSS_TOL
    for s, (loss, gn) in enumerate(metrics):
        if not (abs(loss - one["losses"][s]) <= loss_tol
                and abs(gn - one["grad_norms"][s]) <= TRAIN_NORM_REL * one["grad_norms"][s]):
            fail(f"{tag}: step {s} loss {loss:.5f} grad norm {gn:.5f} against one "
                 f"process's {one['losses'][s]:.5f} {one['grad_norms'][s]:.5f}")

    res = dict(mesh=mesh.sizes, profile=profile, steps=DIST_STEPS,
               batch=TRAIN_BATCH, rows_a_rank=TRAIN_BATCH[0] // shape[0],
               tokens_a_row=TRAIN_BATCH[1] // (shape[1] if profile == "cp" else 1),
               launches_per_step=n, first_step_launches=first,
               attention_heads=sorted(set(heads)), attention_offsets=offsets,
               kv_heads_held=int(params["blocks"]["attn"]["wk"].shape[-2]),
               losses=[m[0] for m in metrics], grad_norms=[m[1] for m in metrics],
               loss_gap_max=max(abs(m[0] - one["losses"][s]) for s, m in enumerate(metrics)),
               grad_norm_first=norm, grad_rel_l2_worst=[worst, rel.get(worst)],
               step_ms=times, host_staged_bytes_per_step=staged,
               gathered_bytes_per_step=gathered, peak_live_gathered_bytes=live,
               peak_mib=peak, grad_fn_flops=flops,
               one_process_grad_fn_flops=one["grad_fn_flops"])
    if part == "c":
        # the checkpoint after DIST_CKPT steps onto a (1, 2) mesh in the same ranks
        mesh12 = mesh_lib.make_mesh((1, 2), ("data", "model"))
        specs12 = sharding.model_param_pspecs(cfg, mesh12, defs)
        got = restore_sharded(tmp / "ckpt", like, specs12, mesh12)[1]
        leaves = tree_map(lambda r, f, spec, path: torch.equal(
            r, sharding.local_shard(f, spec, mesh12)), got, full, specs12)
        if not all(tree_leaves(leaves)):
            fail("dist (c): a block restored onto (1, 2) differs from its slice of the "
                 "gathered parameters")
        del got, full
        res.update(restored_onto={"data": 1, "model": 2}, restore_bitwise=True)
    del params, opt

    # float32 on the first layers: DIST_F32[1] sharded steps against one process
    cfg32 = dist_dense_cfg(DIST_F32[0], "float32")
    step32 = dist_step(cfg32, mesh, profile)
    tree32 = dist_f32_tree(load_checkpoint(tmp / "dense", 0, like=defs)[1])
    p32 = tree_map(lambda a, spec, path: torch.from_numpy(np.array(
        sharding.local_shard(a, spec, mesh))).cuda().requires_grad_(), tree32, step32.pspecs)
    o32 = adamw_init(p32)
    for b in batches[:DIST_F32[1]]:
        p32, o32, _ = step32(p32, o32, b)
    full32 = sharding.tree_gather_full(p32, step32.pspecs, mesh)
    f32_err, f32_moved, moved_rel, worst32 = 0.0, 0.0, {}, None
    if rank == 0:
        want = load_checkpoint(tmp / "f32", 0, like=transformer.param_defs(cfg32))[1]
        errs = []
        tree_map(lambda g, w, path: errs.append(compare(
            f"{tag} float32 {path}", g, torch.from_numpy(w).cuda(), 2e-3)), full32, want)
        f32_err = max(errs)
        # warmup's first steps move a parameter by less than that limit, so
        # each leaf's change over the steps is held to the one process's
        # change too: an unchanged state reads 1 here
        def moved(g, w, a, path):
            nonlocal f32_moved
            a = torch.from_numpy(np.array(a)).cuda()
            one_change = torch.from_numpy(w).cuda() - a
            f32_moved = max(f32_moved, one_change.abs().max().item())
            moved_rel[path] = rel_l2(g - a, one_change)
        tree_map(moved, full32, want, tree32)
        worst32 = max(moved_rel, key=moved_rel.get)
        if moved_rel[worst32] > DIST_F32_MOVED_REL:
            fail(f"{tag}: float32 {worst32}'s change over {DIST_F32[1]} steps has rel L2 "
                 f"{moved_rel[worst32]:.3e} against one process's (limit {DIST_F32_MOVED_REL})")
    del tree32
    res.update(f32_max_err=f32_err, f32_max_change=f32_moved,
               f32_change_rel_l2_worst=[worst32, moved_rel.get(worst32)],
               f32_layers=DIST_F32[0], f32_steps=DIST_F32[1])
    return res


def dist_rwkv(profile: str = "2d") -> dict:
    """Part (g): rwkv6-1.6b at full width and DIST_RWKV_LAYERS layers on
    (data 1, model 2), each rank half of the heads (the WKV kernels on
    [B x 16, T, 64]), against one process's DIST_RWKV_STEPS steps in rank 0
    alone; each rank draws the float32 masters on the card from the seed
    (the same bits on both) and keeps its blocks.  It computes in float32:
    at this width and init, bfloat16's rounding alone moves one process's
    gradient of ``faaaa`` by most of its norm (``bf16_vs_f32_grad_rel_l2``,
    measured here on rank 0), so a bfloat16 comparison of two orders of
    summation could not tell a fault from rounding.  Part (i) runs the same
    under ``profile`` 'cp': each rank 256 of a row's 512 tokens and all
    32 heads, rank 1's WKV launched from the state rank 0 left, the losses
    within DIST_CP_RWKV_LOSS_TOL of one process's."""
    rank = dist.get_rank()
    cp = profile == "cp"
    tag = "dist (i)" if cp else "dist (g)"
    cfg = dataclasses.replace(get_config(RWKV_ARCH), num_layers=DIST_RWKV_LAYERS,
                              dtype="float32")
    defs = rwkv6.param_defs(cfg)
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    batches = dist_batches(cfg, DIST_RWKV_STEPS)
    layers = cfg.num_layers
    per_step = {n: 0 for n in KERNELS}
    per_step.update(wkv_chunked=2 * layers, wkv_chunked_bwd=layers)
    tree = draw_on_device(SEED, defs, device="cuda")          # float32 masters
    want, noise = None, {}
    if rank == 0:
        _, _, g_one = build_grad_fn(cfg)(tree, batches[0])
        if not cp:
            # why the part runs float32: one process's bfloat16 gradients
            # against its float32 ones, leaf by leaf (not checked)
            g16 = build_grad_fn(dataclasses.replace(cfg, dtype="bfloat16"))(
                tree, batches[0])[2]
            tree_map(lambda a, b, path: noise.__setitem__(path, rel_l2(a, b)), g16, g_one)
            del g16
        params = tree_map(lambda t, path: t.clone().requires_grad_(), tree)
        opt, step1, one = adamw_init(params), dist_step(cfg), []
        for b in batches:
            params, opt, m = step1(params, opt, b)
            one.append([m["loss"].item(), m["grad_norm"].item()])
        want = (one, g_one)
        del params, opt
    dist.barrier()
    step = dist_step(cfg, mesh, profile)
    params = tree_map(lambda t, spec, path: sharding.local_shard(t, spec, mesh).clone()
                      .requires_grad_(), tree, step.pspecs)
    del tree
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    shapes, wkv_kw = [], []
    real_wkv, ops.wkv_chunked = recorded("wkv_chunked", shapes, wkv_kw)
    try:
        reset_counts()
        _, _, grads = step.grad_fn(params, batches[0])
        first = read_counts()
    finally:
        ops.wkv_chunked = real_wkv
    if first != per_step:
        fail(f"{tag}: the first step launched {first}, expected {per_step}")
    from_state = sorted({"state" in kw for kw in wkv_kw})
    if from_state != [cp and mesh.coords["model"] > 0]:
        fail(f"{tag}: the WKV launches took a state {from_state} on rank "
             f"{mesh.coords['model']}")
    grads = sharding.tree_gather_full(grads, step.pspecs, mesh)
    rel = {}
    if rank == 0:
        tree_map(lambda g, w, path: rel.__setitem__(path, rel_l2(g, w)), grads, want[1])
    del grads
    worst = max(rel, key=rel.get) if rel else None
    if rank == 0 and rel[worst] > TRAIN_GRAD_REL:
        fail(f"{tag}: first step's gradient {worst} rel L2 {rel[worst]:.3e} against "
             f"one process (limit {TRAIN_GRAD_REL})")
    times, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    for s, b in enumerate(batches):
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, b)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        n = read_counts()
        if n != with_update(per_step, defs):
            fail(f"{tag}: step {s} launched {n}, expected {with_update(per_step, defs)}")
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    loss_tol = DIST_CP_RWKV_LOSS_TOL if cp else TRAIN_LOSS_TOL
    if rank == 0:
        for s, ((loss, gn), (l1, g1)) in enumerate(zip(metrics, want[0])):
            if not (abs(loss - l1) <= loss_tol and abs(gn - g1) <= TRAIN_NORM_REL * g1):
                fail(f"{tag}: step {s} loss {loss:.7f} grad norm {gn:.5f} against one "
                     f"process's {l1:.7f} {g1:.5f}")
    bh = sorted({a[0] for a, _ in shapes})
    heads = [x // TRAIN_BATCH[0] for x in bh]
    all_heads = cfg.d_model // cfg.wkv_head_dim
    if heads != [all_heads if cp else all_heads // 2]:
        fail(f"{tag}: the WKV kernel ran {heads} heads a rank, expected "
             f"{'all' if cp else 'half'} of {all_heads}")
    return dict(mesh=mesh.sizes, profile=profile, layers=layers, steps=DIST_RWKV_STEPS,
                batch=TRAIN_BATCH, wkv_from_state=from_state,
                loss_gap_max=None if want is None else max(
                    abs(m[0] - w[0]) for m, w in zip(metrics, want[0])),
                launches_per_step=n, first_step_launches=first, wkv_shapes=sorted(set(shapes)),
                heads_a_rank=heads[0], losses=[m[0] for m in metrics],
                grad_norms=[m[1] for m in metrics],
                one_process=None if want is None else want[0],
                grad_rel_l2_worst=[worst, rel.get(worst)], step_ms=times,
                bf16_vs_f32_grad_rel_l2=noise,
                peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)


def whole_on_rank0(g: torch.Tensor, spec, mesh):
    """A leaf's whole tensor on rank 0 of a (data 1, model 2) mesh, None on
    rank 1: rank 1 sends its block through the host (gloo) and rank 0
    joins it after its own along the dim that ``spec`` splits over 'model';
    a leaf not split over 'model' is rank 0's own.  Half the bytes of an
    all-gather, which would hand both ranks the whole leaf."""
    rank = mesh.coords["model"]
    dim = next((d for d, e in enumerate(spec)
                if "model" in ((e,) if isinstance(e, str) else (e or ()))), None)
    if dim is None:
        return g if rank == 0 else None
    if rank == 1:
        dist.send(g.cpu(), dst=0)
        return None
    other = torch.empty(g.shape, dtype=g.dtype)
    dist.recv(other, src=1)
    return torch.cat([g, other.to(g.device)], dim)


def dist_moe_train() -> dict:
    """Part (j): qwen2-moe-a2.7b at full width and DIST_MOE_TRAIN_LAYERS of
    its 24 layers on (data 1, model 2) under '2d', the MoE blocks through
    ``moe_sharded.moe_apply_sharded`` (each rank 32 of the 64 padded
    experts and half of the shared experts' ff, every token on both ranks,
    so one process's capacity), against one process's DIST_MOE_TRAIN_STEPS
    steps (the plain ``moe_apply``) in rank 0 alone, run before the ranks
    draw their blocks and freed after; each rank draws the float32 masters
    on the card from the seed (the same bits on both) and keeps its blocks.
    It computes in float32, as part (g) does: phase 5l's bfloat16 MoE
    already puts the router's first-step leaf near TRAIN_GRAD_REL, so a
    bfloat16 comparison of two orders of summation could not tell a fault
    from rounding (``bf16_vs_f32_grad_rel_l2``, one process's bfloat16
    gradients against its float32 ones, measured in rank 0, not checked).
    The first step twice gives the same bits on each rank; a third call
    counts the rank's ``grad_fn`` FLOPs, at most DIST_TP_FLOPS of one
    process's (each count a call of its own: ``FlopCounterMode``'s dispatch
    changes roundings)."""
    rank = dist.get_rank()
    tag = "dist (j)"
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=DIST_MOE_TRAIN_LAYERS,
                              dtype="float32")
    defs = get_module(cfg).param_defs(cfg)
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    batches = dist_batches(cfg, DIST_MOE_TRAIN_STEPS)
    layers = cfg.num_layers
    per_step = {n: 0 for n in KERNELS}
    per_step.update(flash_attention=2 * layers, flash_attention_bwd=layers)
    one, want, noise = [None, None, None, None], None, {}
    if rank == 0:
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        tree = draw_on_device(SEED, defs, device="cuda")           # float32 masters
        want = build_grad_fn(cfg)(tree, batches[0])[2]
        with FlopCounterMode(display=False) as fc:       # a call of its own: the
            build_grad_fn(cfg)(tree, batches[0])         # counter changes roundings
        g16 = build_grad_fn(dataclasses.replace(cfg, dtype="bfloat16"))(tree, batches[0])[2]
        tree_map(lambda a, b, path: noise.__setitem__(path, rel_l2(a, b)), g16, want)
        del g16
        params = tree_map(lambda t, path: t.requires_grad_(), tree)
        opt, step1, metrics = adamw_init(params), dist_step(cfg), []
        for b in batches:
            params, opt, m = step1(params, opt, b)
            metrics.append([m["loss"].item(), m["grad_norm"].item()])
        del tree, params, opt, m
        torch.cuda.empty_cache()
        one = [fc.get_total_flops(), metrics, torch.cuda.max_memory_allocated() / 2 ** 20,
               time.perf_counter() - t1]
    dist.broadcast_object_list(one, src=0)
    one_flops, one_metrics, one_peak, one_s = one

    step = dist_step(cfg, mesh)
    tree = draw_on_device(SEED, defs, device="cuda")
    params = tree_map(lambda t, spec, path: sharding.local_shard(t, spec, mesh).clone()
                      .requires_grad_(), tree, step.pspecs)
    del tree
    torch.cuda.empty_cache()
    opt = adamw_init(params)

    # the first step: its launches, the heads its attention ran, and which
    # MoE form each block took (the sharded one, on the rank's experts)
    heads, moe_calls, plain_calls = [], [], []
    real_fa, ops.flash_attention = recorded("flash_attention", heads)
    real_sharded, real_plain = moe_sharded.moe_apply_sharded, lm_layers.moe_apply

    def rec_sharded(cfg_, p, x, **kw):
        moe_calls.append((math.prod(x.shape[:-1]), int(p["wi"].shape[-3])))
        return real_sharded(cfg_, p, x, **kw)

    def rec_plain(*args, **kw):
        plain_calls.append(1)
        return real_plain(*args, **kw)

    moe_sharded.moe_apply_sharded, lm_layers.moe_apply = rec_sharded, rec_plain
    try:
        reset_counts()
        loss1, _, grads = step.grad_fn(params, batches[0])
        first = read_counts()
    finally:
        ops.flash_attention = real_fa
        moe_sharded.moe_apply_sharded, lm_layers.moe_apply = real_sharded, real_plain
    if first != per_step:
        fail(f"{tag}: the first step launched {first}, expected {per_step}")
    q_heads = sorted({q[1] for q, _ in heads})
    if q_heads != [cfg.num_heads // 2]:
        fail(f"{tag}: the attention kernels ran {q_heads} heads a rank, expected "
             f"{cfg.num_heads // 2} of {cfg.num_heads}")
    e_rank = cfg.moe.num_experts_padded // 2
    tokens = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    if plain_calls or moe_calls != [(tokens, e_rank)] * (2 * layers):
        fail(f"{tag}: the MoE blocks took moe_apply_sharded {moe_calls} (tokens, "
             f"experts held) and moe_apply {len(plain_calls)} times; expected "
             f"{2 * layers} sharded calls on {tokens} tokens and {e_rank} experts")
    first_bits = [loss1.item()] + digest(grads)

    # every leaf of the first step's gradients, gathered one at a time onto
    # rank 0, against one process's
    if mesh.coords["model"] != rank:
        fail(f"{tag}: rank {rank} holds block {mesh.coords['model']} of 'model'")
    t1 = time.perf_counter()
    rel, names = {}, leaf_names(grads)
    wants = tree_leaves(want) if rank == 0 else [None] * len(names)
    if rank == 0 and leaf_names(want) != names:
        fail(f"{tag}: the sharded gradients' leaves differ from one process's")
    for n, g, spec, w in zip(names, tree_leaves(grads), tree_leaves(step.pspecs), wants):
        full = whole_on_rank0(g, spec, mesh)
        if rank == 0:
            rel[n] = rel_l2(full, w)
        del full
    gather_s = time.perf_counter() - t1
    del grads, want, wants
    worst = max(rel, key=rel.get) if rel else None
    if rank == 0 and rel[worst] > TRAIN_GRAD_REL:
        fail(f"{tag}: first step's gradient {worst} rel L2 {rel[worst]:.3e} against "
             f"one process (limit {TRAIN_GRAD_REL})")

    # the first step again: the same bits; then once more under the FLOP
    # counter (its dispatch changes roundings)
    loss2, _, grads = step.grad_fn(params, batches[0])
    again = [loss2.item()] + digest(grads)
    del grads
    if again != first_bits:
        diff = [n for n, a, b in zip(["loss"] + names, again, first_bits) if a != b]
        fail(f"{tag}: two runs of the first step differ on rank {rank}: {diff[:5]}")
    with FlopCounterMode(display=False) as fc:
        step.grad_fn(params, batches[0])
    flops = fc.get_total_flops()
    if flops > DIST_TP_FLOPS * one_flops:
        fail(f"{tag}: a rank's grad_fn counts {flops:.4g} FLOPs, more than "
             f"{DIST_TP_FLOPS} of one process's {one_flops:.4g}")

    times, staged, metrics = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for s, b in enumerate(batches):
        before = collectives.host_staged_bytes
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, b)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        n = read_counts()
        if n != with_update(per_step, defs):
            fail(f"{tag}: step {s} launched {n}, expected {with_update(per_step, defs)}")
        staged.append(collectives.host_staged_bytes - before)
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    for s, ((loss, gn), (l1, g1)) in enumerate(zip(metrics, one_metrics)):
        if not (abs(loss - l1) <= TRAIN_LOSS_TOL and abs(gn - g1) <= TRAIN_NORM_REL * g1):
            fail(f"{tag}: step {s} loss {loss:.6f} grad norm {gn:.5f} against one "
                 f"process's {l1:.6f} {g1:.5f}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    del params, opt
    return dict(mesh=mesh.sizes, profile="2d", layers=layers, steps=DIST_MOE_TRAIN_STEPS,
                batch=TRAIN_BATCH, parameters=count_params(defs), experts_a_rank=e_rank,
                moe_sharded_calls_first_step=len(moe_calls), moe_plain_calls=len(plain_calls),
                attention_heads=q_heads, launches_per_step=n, first_step_launches=first,
                losses=[m[0] for m in metrics], grad_norms=[m[1] for m in metrics],
                one_process=one_metrics,
                loss_gap_max=max(abs(m[0] - w[0]) for m, w in zip(metrics, one_metrics)),
                grad_rel_l2_worst=[worst, rel.get(worst)], grad_gather_s=gather_s,
                same_bits_twice=True, grad_fn_flops=flops, one_process_grad_fn_flops=one_flops,
                step_ms=times, host_staged_bytes_per_step=staged, peak_mib=peak,
                one_process_peak_mib=one_peak, one_process_s=one_s,
                bf16_vs_f32_grad_rel_l2=noise)


def dist_moe(tmp: Path) -> dict:
    """Part (d): one ``qwen2-moe-a2.7b`` MoE layer at full width on (data 1,
    model 2), each rank 32 of the 64 padded experts, against the plain
    ``moe_apply`` in rank 0 alone; the ranks' gradients combined as the
    layer's tensor parallelism over 'model' hands them out."""
    rank = dist.get_rank()
    cfg = get_config(MOE_ARCH)
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    params = tree_map(lambda a, path: torch.from_numpy(a).cuda(),
                      load_checkpoint(tmp / "moe", 0, like=lm_layers.moe_defs(cfg))[1])
    x = torch.from_numpy(np.load(tmp / "moe_x.npy")).cuda().to(cfg.compute_dtype)
    w = torch.from_numpy(np.load(tmp / "moe_w.npy")).cuda()
    names = ("router", "wi", "wo")

    def run(fn):
        leaves = [params[n].requires_grad_() for n in names]
        out, aux = fn()
        grads = torch.autograd.grad((out.float() * w).sum() + aux, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return out.detach(), aux.detach(), grads

    plain = run(lambda: lm_layers.moe_apply(cfg, params, x)) if rank == 0 else None
    reset_counts()
    out, aux, grads = run(lambda: moe_sharded.moe_apply_sharded(cfg, params, x, mesh=mesh))
    # tensor-parallel over 'model': each rank's router gradient is the whole
    # one, its experts' the whole one of its block (zeros elsewhere)
    grads = [g if n == "router" else collectives.psum(g, mesh, "model")
             for n, g in zip(names, grads)]
    res = dict(mesh={"data": 1, "model": 2}, tokens=x.shape[0],
               experts_a_rank=cfg.moe.num_experts_padded // 2, launches=read_counts())
    if rank == 0:
        res["max_abs_err"] = compare("dist (d) MoE output against the plain layer",
                                     out, plain[0], DIST_MOE_TOL)
        res["aux_rel_err"] = abs(aux.item() - plain[1].item()) / abs(plain[1].item())
        res["grad_rel_l2"] = {n: rel_l2(g, p) for n, g, p in zip(names, grads, plain[2])}
        if res["aux_rel_err"] > 1e-4 or max(res["grad_rel_l2"].values()) > TRAIN_GRAD_REL:
            fail(f"dist (d): aux rel err {res['aux_rel_err']:.3e} (limit 1e-4), "
                 f"gradients rel L2 {res['grad_rel_l2']} (limit {TRAIN_GRAD_REL})")
    return res


def dist_rings() -> dict:
    """Part (e): ``gpipe`` of tests/test_pipeline.py's 8-layer tanh stack
    over 2 stages against the sequential stack, and
    ``compressed_pod_allreduce`` on (pod 2, data 1, model 1) against its own
    definition, on CUDA tensors."""
    rng = np.random.default_rng(SEED + 8)
    W = torch.from_numpy((rng.standard_normal((8, 16, 16)) * 0.5 / 4).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).cuda()

    def stack(ws, h):
        for w_ in ws:
            h = torch.tanh(h @ w_) + h
        return h

    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    Wg = W.clone().requires_grad_()
    out = dist_pipeline.gpipe(stack, dist_pipeline.split_stages(Wg, 2),
                              dist_pipeline.microbatch(x, 4), mesh=mesh).reshape(8, 16)
    g = collectives.mesh_mean(torch.autograd.grad((out ** 2).sum(), Wg)[0], mesh)
    Wr = W.clone().requires_grad_()
    ref_out = stack(Wr, x)
    g_ref = torch.autograd.grad((ref_out ** 2).sum(), Wr)[0]
    fwd = compare("dist (e) gpipe forward", out.detach(), ref_out.detach(), 2e-5)
    bwd = compare("dist (e) gpipe gradient", g, g_ref, 2e-4)

    pod = mesh_lib.make_mesh((2, 1, 1), ("pod", "data", "model"))
    grads = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32)).cuda()
    fb = torch.from_numpy((0.01 * rng.standard_normal((2, 4096))).astype(np.float32)).cuda()
    p = pod.coords["pod"]
    mean, new_fb = compressed_pod_allreduce({"g": grads[p:p + 1]}, {"g": fb[p:p + 1]}, pod)
    parts = [quantize_with_feedback(grads[i], fb[i]) for i in range(2)]
    want = sum(dequantize_int8(q, s) for q, s, _ in parts) / 2
    mean_err = compare("dist (e) compressed pod all-reduce mean", mean["g"][0], want, 1e-6)
    fb_err = compare("dist (e) compressed pod all-reduce feedback", new_fb["g"][0],
                     parts[p][2], 1e-6)
    return dict(gpipe=dict(stages=2, microbatches=4, layers=8, fwd_max_abs_err=fwd,
                           grad_max_abs_err=bwd),
                pod_allreduce=dict(pods=2, numel=4096, mean_max_abs_err=mean_err,
                                   feedback_max_abs_err=fb_err))


DIST_PARTS = ("serve", "train", "tp", "moe", "rings", "rwkv", "cp", "cp_rwkv",
              "moe_train")


def dist_pair(tmp: str, one: dict, parts=DIST_PARTS) -> dict:
    """Parts (b) to (j) (those of ``parts``) on one rank of a world of two
    that share the card (gloo)."""
    tmp = Path(tmp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    collectives.host_staged_bytes = 0
    out = dict(rank=dist.get_rank(), backend=dist.get_backend())
    fns = dict(serve=lambda: dist_serve(tmp), train=lambda: dist_train(tmp, one),
               tp=lambda: dist_train(tmp, one, shape=(1, 2), part="f"),
               moe=lambda: dist_moe(tmp), rings=dist_rings, rwkv=dist_rwkv,
               cp=lambda: dist_train(tmp, one, shape=(1, 2), part="h", profile="cp"),
               cp_rwkv=lambda: dist_rwkv("cp"), moe_train=dist_moe_train)
    for part in parts:
        fn = fns[part]
        t1 = time.perf_counter()
        out[part] = fn()
        out[part]["seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    out.update(host_staged_bytes=collectives.host_staged_bytes,
               peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
               seconds=time.perf_counter() - t0)
    return out


def dist_phase(parts=DIST_PARTS) -> tuple:
    """Phase 5h (module docstring): the inputs made on the host and written
    to a fresh directory, part (a) in a world of one rank under NCCL, parts
    (b) to (j) (those of ``parts``) in a world of two that share the card
    under gloo.  Returns the launches of each part's path by rank 0 and
    the numbers."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    try:
        cfg, moe_cfg = dist_dense_cfg(), get_config(MOE_ARCH)
        print(f"dist {DENSE_ARCH} reduced: num_layers {get_config(DENSE_ARCH).num_layers} "
              f"-> {cfg.num_layers} (two processes share the card in (c)); "
              f"{MOE_ARCH}: one MoE layer (d), {DIST_MOE_TRAIN_LAYERS} of its 24 "
              f"layers (j)", flush=True)
        save_checkpoint(tmp / "dense", 0, init_params(SEED, transformer.param_defs(cfg)))
        save_checkpoint(tmp / "moe", 0, init_params(SEED, lm_layers.moe_defs(moe_cfg)))
        rng = np.random.default_rng(SEED + 7)
        n_tok = DIST_MOE_TOKENS[0] * DIST_MOE_TOKENS[1]
        np.save(tmp / "moe_x.npy", rng.standard_normal((n_tok, moe_cfg.d_model),
                                                       dtype=np.float32))
        np.save(tmp / "moe_w.npy", rng.standard_normal((n_tok, moe_cfg.d_model),
                                                       dtype=np.float32))
        images = rng.standard_normal((DIST_EDGE_BATCH, CONFIG.img_size, CONFIG.img_size,
                                      CONFIG.in_channels), dtype=np.float32)
        model = edgenext.EdgeNeXt(CONFIG, init_params(SEED, edgenext.param_defs(CONFIG),
                                                      perturb=0.05)).eval()
        with torch.inference_mode():
            logits = model(torch.from_numpy(images).cuda())
        np.save(tmp / "images.npy", images)
        np.save(tmp / "logits.npy", logits.cpu().numpy())
        del model, logits
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        (one,) = mesh_lib.spawn_local(1, dist_one_process, str(tmp), parts == DIST_PARTS,
                                      timeout_s=DIST_WORLD_S)
        one["world_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        pair = mesh_lib.spawn_local(2, dist_pair, str(tmp), one, parts,
                                    timeout_s=DIST_WORLD_S)
        pair_s = time.perf_counter() - t1
    except RuntimeError as e:
        fail(f"dist: {e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = pair[0]
    for part, name in (("train", "c"), ("tp", "f"), ("rwkv", "g"), ("cp", "h"),
                       ("cp_rwkv", "i"), ("moe_train", "j")):
        if part in parts and pair[1][part]["losses"] != r0[part]["losses"]:
            fail(f"dist ({name}): the two ranks' losses differ: "
                 f"{pair[1][part]['losses']} vs {r0[part]['losses']}")
    res = dict(one_process=one, ranks=pair, pair_world_s=pair_s, setup_s=setup_s,
               layers=DIST_LAYERS, reduced=f"num_layers 24 -> {DIST_LAYERS}; "
               f"{RWKV_ARCH} num_layers 24 -> {DIST_RWKV_LAYERS}; {MOE_ARCH} "
               f"num_layers 24 -> {DIST_MOE_TRAIN_LAYERS}",
               wall_s=time.perf_counter() - t0, parts=list(parts),
               note="two processes time-share one card and cross the host for every "
                    "collective: not a scaling number")
    paths = {"dist_serve": ("serve", "launches"), "dist_train": ("train", "launches_per_step"),
             "dist_tp": ("tp", "launches_per_step"), "dist_rwkv": ("rwkv", "launches_per_step"),
             "dist_cp": ("cp", "launches_per_step"),
             "dist_cp_rwkv": ("cp_rwkv", "launches_per_step"),
             "dist_moe_train": ("moe_train", "launches_per_step")}
    launches = {path: r0[part][key] for path, (part, key) in paths.items() if part in parts}
    return launches, res


def print_dist(d: dict) -> None:
    one, r = d["one_process"], d["ranks"]
    r0 = r[0]
    print(f"dist (a) NCCL world of 1, mesh {one['mesh']}: {one['steps']} steps of "
          f"{DENSE_ARCH} ({d['reduced']}) equal the no-mesh steps bit for bit "
          f"(metrics, parameters, moments); losses {[round(x, 5) for x in one['losses']]}; "
          f"{one['world_s']:.1f} s")
    s = r0["serve"]
    print(f"dist (b) gloo 2 ranks: EdgeNeXt-S data_parallel B={s['batch']} "
          f"({s['rows_a_rank']} a rank), err vs one process {s['max_abs_err']:.2e} "
          f"(limit 2e-3 (1+|b|)), launches a rank {s['launches']}, B={DIST_EDGE_ODD} refused")
    t = r0["train"]
    ev = [x["event_ms"] for x in t["step_ms"]]
    print(f"dist (c) gloo 2 ranks, mesh {t['mesh']} profile {t['profile']}: "
          f"{t['steps']} steps, losses {[round(x, 5) for x in t['losses']]} vs one process "
          f"{[round(x, 5) for x in one['losses']]}, grad norms within 1 %, worst first-"
          f"step gradient {t['grad_rel_l2_worst'][0]} rel L2 {t['grad_rel_l2_worst'][1]:.3e}; "
          f"launches a step {t['launches_per_step']}; float32 {t['f32_layers']} layers x "
          f"{t['f32_steps']} steps max err {t['f32_max_err']:.2e} (one process moved a "
          f"parameter by at most {t['f32_max_change']:.2e}), worst change rel L2 "
          f"{t['f32_change_rel_l2_worst'][0]} {t['f32_change_rel_l2_worst'][1]:.3e} "
          f"(limit {DIST_F32_MOVED_REL}); restore onto "
          f"{t['restored_onto']} bit for bit")
    print(f"dist (c) step ms (CUDA events; two processes time-share the card, "
          f"collectives through the host: not a scaling number) rank 0 {ev} "
          f"median {statistics.median(ev):.1f}; host-staged MB a step "
          f"{[round(b / 1e6, 1) for b in t['host_staged_bytes_per_step']]}; peak MiB "
          f"by rank {[round(x['train']['peak_mib']) for x in r]}")
    print(f"dist (c) 8e: bytes gathered at use a step and a rank "
          f"{[round(b / 1e6, 1) for b in t['gathered_bytes_per_step']]} MB, gathered "
          f"leaves alive at most {max(t['peak_live_gathered_bytes']) / 1e6:.1f} MB")
    f = r0["tp"]
    fev = [x["event_ms"] for x in f["step_ms"]]
    print(f"dist (f) gloo 2 ranks, mesh {f['mesh']} profile {f['profile']}: "
          f"{f['steps']} steps, losses {[round(x, 5) for x in f['losses']]} (largest gap to "
          f"one process {f['loss_gap_max']:.2e}, limit {TRAIN_LOSS_TOL}), grad norms within "
          f"1 %, worst first-step gradient {f['grad_rel_l2_worst'][0]} rel L2 "
          f"{f['grad_rel_l2_worst'][1]:.3e}; float32 {f['f32_layers']} layers x "
          f"{f['f32_steps']} steps max err {f['f32_max_err']:.2e}, worst change rel L2 "
          f"{f['f32_change_rel_l2_worst'][0]} {f['f32_change_rel_l2_worst'][1]:.3e}")
    print(f"dist (f) a rank: attention kernels on (q, k) shapes {f['attention_heads']} "
          f"({f['kv_heads_held']} KV heads held), launches a step {f['launches_per_step']}; "
          f"grad_fn FLOPs {f['grad_fn_flops']:.4g} = "
          f"{f['grad_fn_flops'] / f['one_process_grad_fn_flops']:.3f} of one process's "
          f"{f['one_process_grad_fn_flops']:.4g} (limit {DIST_TP_FLOPS}); step ms "
          f"{fev} median {statistics.median(fev):.1f}; host-staged MB a step "
          f"{[round(b / 1e6, 1) for b in f['host_staged_bytes_per_step']]}; peak MiB "
          f"by rank {[round(x['tp']['peak_mib']) for x in r]}")
    g = r0["rwkv"]
    print(f"dist (g) gloo 2 ranks, mesh {g['mesh']}: {RWKV_ARCH} {g['layers']} layers, "
          f"{g['steps']} steps, losses {[round(x, 5) for x in g['losses']]} vs one process "
          f"{[round(x[0], 5) for x in g['one_process']]}, worst first-step gradient "
          f"{g['grad_rel_l2_worst'][0]} rel L2 {g['grad_rel_l2_worst'][1]:.3e}; WKV on "
          f"{g['wkv_shapes'][0]} ({g['heads_a_rank']} heads a rank), launches a step "
          f"{g['launches_per_step']}; step ms {[round(x, 1) for x in g['step_ms']]}; "
          f"peak MiB by rank {[round(x['rwkv']['peak_mib']) for x in r]}; one process's "
          f"bfloat16 gradients against its float32 ones: faaaa rel L2 "
          f"{g['bf16_vs_f32_grad_rel_l2'].get('blocks.tm.faaaa', float('nan')):.3e}, median "
          f"leaf {statistics.median(g['bf16_vs_f32_grad_rel_l2'].values()):.3e}")
    h = r0["cp"]
    hev = [x["event_ms"] for x in h["step_ms"]]
    print(f"dist (h) gloo 2 ranks, mesh {h['mesh']} profile {h['profile']}: "
          f"{h['steps']} steps of {h['batch'][0]} x {h['batch'][1]}, {h['tokens_a_row']} "
          f"tokens of a row a rank, losses {[round(x, 6) for x in h['losses']]} (largest "
          f"gap to one process {h['loss_gap_max']:.2e}, limit {DIST_CP_LOSS_TOL}), grad "
          f"norms within 1 %, worst first-step gradient {h['grad_rel_l2_worst'][0]} rel L2 "
          f"{h['grad_rel_l2_worst'][1]:.3e}; float32 {h['f32_layers']} layers x "
          f"{h['f32_steps']} steps max err {h['f32_max_err']:.2e}, worst change rel L2 "
          f"{h['f32_change_rel_l2_worst'][0]} {h['f32_change_rel_l2_worst'][1]:.3e}")
    print(f"dist (h) a rank: attention launches a step {h['launches_per_step']}, query "
          f"offsets by rank {[x['cp']['attention_offsets'] for x in r]}, (q, k) shapes "
          f"{h['attention_heads']}; grad_fn FLOPs {h['grad_fn_flops']:.4g} = "
          f"{h['grad_fn_flops'] / h['one_process_grad_fn_flops']:.3f} of one process's "
          f"(by rank {[round(x['cp']['grad_fn_flops'] / h['one_process_grad_fn_flops'], 3) for x in r]}); "
          f"step ms {hev} median {statistics.median(hev):.1f}; host-staged MB a step "
          f"{[round(b / 1e6, 1) for b in h['host_staged_bytes_per_step']]}; peak MiB "
          f"by rank {[round(x['cp']['peak_mib']) for x in r]}")
    i = r0["cp_rwkv"]
    print(f"dist (i) gloo 2 ranks, mesh {i['mesh']} profile {i['profile']}: {RWKV_ARCH} "
          f"{i['layers']} layers float32, {i['steps']} steps, losses "
          f"{[round(x, 7) for x in i['losses']]} (largest gap to one process "
          f"{i['loss_gap_max']:.2e}, limit {DIST_CP_RWKV_LOSS_TOL}), worst first-step "
          f"gradient {i['grad_rel_l2_worst'][0]} rel L2 {i['grad_rel_l2_worst'][1]:.3e}; WKV "
          f"on {i['wkv_shapes'][0]} ({i['heads_a_rank']} heads a rank), from a received "
          f"state by rank {[x['cp_rwkv']['wkv_from_state'] for x in r]}, launches a step "
          f"{i['launches_per_step']}; step ms {[round(x, 1) for x in i['step_ms']]}; peak "
          f"MiB by rank {[round(x['cp_rwkv']['peak_mib']) for x in r]}")
    j = r0["moe_train"]
    noise = j["bf16_vs_f32_grad_rel_l2"]
    loud = max(noise, key=noise.get)
    print(f"dist (j) gloo 2 ranks, mesh {j['mesh']} profile {j['profile']}: {MOE_ARCH} "
          f"{j['layers']} layers float32 ({j['parameters']} parameters), {j['steps']} steps "
          f"of {j['batch'][0]} x {j['batch'][1]}, losses {[round(x, 6) for x in j['losses']]} "
          f"(largest gap to one process {j['loss_gap_max']:.2e}, limit {TRAIN_LOSS_TOL}), "
          f"grad norms within 1 %, worst first-step gradient {j['grad_rel_l2_worst'][0]} "
          f"rel L2 {j['grad_rel_l2_worst'][1]:.3e} (limit {TRAIN_GRAD_REL}; gathered onto "
          f"rank 0 leaf by leaf in {j['grad_gather_s']:.1f} s); the first step twice the "
          f"same bits on each rank")
    print(f"dist (j) a rank: {j['moe_sharded_calls_first_step']} moe_apply_sharded calls "
          f"a step (forward and remat) on {j['experts_a_rank']} experts, moe_apply "
          f"{j['moe_plain_calls']}; attention on {j['attention_heads']} heads, launches a "
          f"step {j['launches_per_step']}; grad_fn FLOPs {j['grad_fn_flops']:.4g} = "
          f"{j['grad_fn_flops'] / j['one_process_grad_fn_flops']:.4f} of one process's "
          f"{j['one_process_grad_fn_flops']:.4g} (by rank "
          f"{[round(x['moe_train']['grad_fn_flops'] / j['one_process_grad_fn_flops'], 4) for x in r]}"
          f", limit {DIST_TP_FLOPS}); step ms (CUDA events; two processes time-share the "
          f"card: not a scaling number) {[round(x, 1) for x in j['step_ms']]}; host-staged "
          f"MB a step {[round(b / 1e6, 1) for b in j['host_staged_bytes_per_step']]}; peak "
          f"MiB by rank {[round(x['moe_train']['peak_mib']) for x in r]} (one process "
          f"{j['one_process_peak_mib']:.0f}, {j['one_process_s']:.1f} s); one process's "
          f"bfloat16 gradients against its float32 ones (not checked): worst {loud} rel L2 "
          f"{noise[loud]:.3e}, router {noise.get('blocks.moe.router', float('nan')):.3e}, "
          f"median leaf {statistics.median(noise.values()):.3e}")
    m = r0["moe"]
    print(f"dist (d) gloo 2 ranks: {MOE_ARCH} MoE layer, {m['tokens']} tokens, "
          f"{m['experts_a_rank']} experts a rank: err {m['max_abs_err']:.2e} (limit "
          f"{DIST_MOE_TOL} (1+|b|)), aux rel {m['aux_rel_err']:.2e}, gradients rel L2 "
          f"{ {k: round(v, 5) for k, v in m['grad_rel_l2'].items()} }")
    e = r0["rings"]
    print(f"dist (e) gloo 2 ranks: gpipe 2 stages err fwd {e['gpipe']['fwd_max_abs_err']:.2e} "
          f"grad {e['gpipe']['grad_max_abs_err']:.2e}; pod all-reduce mean err "
          f"{e['pod_allreduce']['mean_max_abs_err']:.2e} feedback "
          f"{e['pod_allreduce']['feedback_max_abs_err']:.2e}")
    print(f"dist: parts {[(k, round(r0[k]['seconds'], 1)) for k in d['parts']]} s "
          f"rank 0; host-staged {r0['host_staged_bytes'] / 1e9:.2f} GB; worlds "
          f"{one['world_s']:.1f} + {d['pair_world_s']:.1f} s; phase {d['wall_s']:.1f} s",
          flush=True)


# one process of ``dist_versus``: the checkout's own phase 5h (its parts
# (b) and (c) where it takes ``parts``, all of them where it does not, as a
# parent of this commit does), printed as one line
DIST_VS_CODE = """
import inspect, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
c._build.library()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kw = {"parts": ("serve", "train")} if "parts" in inspect.signature(c.dist_phase).parameters else {}
res = c.dist_phase(**kw)[-1]
t = [r["train"] for r in res["ranks"]]
print("DIST_VS " + json.dumps(dict(
    peak_mib=[x["peak_mib"] for x in t], staged=t[0]["host_staged_bytes_per_step"],
    step_ms=[x["event_ms"] for x in t[0]["step_ms"]], losses=t[0]["losses"],
    one_losses=res["one_process"]["losses"], phase_s=res["wall_s"])))
"""


def dist_versus(other: Path) -> list:
    """Part (c) of phase 5h (the sharded step on (data 2, model 1)) in the
    checkout ``other`` and in this one, alternating: other, this, this,
    other, each in a fresh process that builds nothing new (the kernels'
    sources are the same, so both read this checkout's build).  Prints each
    round's peak MiB a rank, bytes staged a step and step ms."""
    env = dict(os.environ, REPRO_TORCH_BUILD_DIR=str(ROOT / "build"))
    rounds = []
    for where in (other, ROOT, ROOT, other):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", DIST_VS_CODE], cwd=where, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        line = [x for x in out.stdout.splitlines() if x.startswith("DIST_VS ")]
        if out.returncode != 0 or not line:
            fail(f"dist-vs: {where} exited {out.returncode}:\n{out.stdout[-3000:]}")
        rec = dict(json.loads(line[0][len("DIST_VS "):]), checkout=str(where),
                   tree="this" if where == ROOT else "other",
                   seconds=time.perf_counter() - t0)
        rounds.append(rec)
        print(f"dist-vs {rec['tree']} ({where}): peak MiB by rank "
              f"{[round(x, 1) for x in rec['peak_mib']]}; staged MB a step "
              f"{[round(b / 1e6, 1) for b in rec['staged']]}; step ms "
              f"{[round(x, 1) for x in rec['step_ms']]} median "
              f"{statistics.median(rec['step_ms']):.1f}; losses "
              f"{[round(x, 5) for x in rec['losses']]}; {rec['seconds']:.1f} s", flush=True)
    same = all(r["losses"] == rounds[0]["losses"]
               and r["one_losses"] == rounds[0]["one_losses"] for r in rounds)
    print(f"dist-vs: the losses of part (c) and of part (a)'s one-process steps are "
          f"{'the same bits' if same else 'NOT the same bits'} in every round", flush=True)
    return rounds


# ---------------------------------------------------------------------------
# 5j. sharded serving: the serving steps as a rank's program on the one card
# ---------------------------------------------------------------------------


def mesh_cut_cfg(arch: str, layers: int, dtype=None):
    """``arch`` at full width cut to its first ``layers`` layers (the
    encoder-decoder's encoder too, the hybrid's block pattern with them)."""
    cfg = get_config(arch)
    kw = dict(num_layers=layers)
    if cfg.family == "hybrid":
        kw["block_pattern"] = cfg.block_pattern[:layers]
    if cfg.family == "audio":
        kw["num_encoder_layers"] = layers
    if dtype is not None:
        kw["dtype"] = dtype
    return dataclasses.replace(cfg, **kw)


def mesh_drawn(cfg):
    """``cfg``'s weights drawn on the card from SEED, as ``launch.serve``
    draws them."""
    mod = get_module(cfg)
    return mod.load_params(cfg, mod.init_on_device(cfg, SEED))


def mesh_blocks(cfg, whole, mesh, profile: str):
    """The rank's block of each leaf of ``whole`` (a copy, so that the whole
    tree can be freed), as ``launch.serve`` keeps it."""
    pspecs = sharding.model_param_pspecs(cfg, mesh, get_module(cfg).param_defs(cfg),
                                         profile=profile)
    return tree_map(lambda x, spec, path: sharding.local_shard(x, spec, mesh)
                    .clone(memory_format=torch.contiguous_format), whole, pspecs)


def cache_nbytes(cache) -> int:
    """The bytes of a cache's leaves but its step counter (a replicated
    scalar)."""
    return nbytes(*[t for t in pytree.tree_leaves(cache) if t.dim() > 0])


def mesh_one_process(cfg, whole, batch: dict, dlen, gen: int) -> dict:
    """One process's eager prefill and ``gen`` greedy steps: the yardstick."""
    pre, dec = lm_serve.eager_steps(cfg, whole)
    last, cache, pre_ms = lm_prefill(pre, batch, dlen)
    B = last.shape[0]
    toks, logits, _, dec_ms = lm_serve.run_decode(dec, cache, B, gen, last.device)
    return dict(last=last, tokens=toks, logits=torch.stack(logits, 1),
                cache_bytes=cache_nbytes(cache), prefill_ms=pre_ms,
                decode_ms_per_token=dec_ms / gen)


def mesh_forced(cfg, params, mesh, profile: str, batch: dict, dlen, inputs):
    """The sharded prefill of ``batch`` and its decode steps fed ``inputs``
    [B, n] (teacher forcing), eager: (the gathered last hidden and logits
    [B, n, Vp], the rank's cache, prefill ms, each step's ms, the bytes
    staged through the host by the prefill and by the steps)."""
    struct = lm_serve.prefill_cache_struct(cfg, batch, dlen)
    pre, dec = lm_serve.eager_steps(cfg, params, mesh, profile, struct)
    rows = sharding.batch_pspecs(cfg, mesh, batch, profile)[
        "inputs_embeds" if "inputs_embeds" in batch else "tokens"][0]
    vocab = sharding.P(rows, "model" if profile != "fsdp" else None)
    collectives.host_staged_bytes = 0
    last, cache, pre_ms = lm_prefill(pre, batch, dlen)
    pre_bytes = collectives.host_staged_bytes
    step_ms, step_bytes, logits = [], 0, []
    with torch.inference_mode():
        for i in range(inputs.shape[1]):
            before = collectives.host_staged_bytes
            (_, lg, cache), ms = lm_serve.timed(
                lambda: dec(cache, {"tokens": inputs[:, i:i + 1]}), last.device)
            step_bytes += collectives.host_staged_bytes - before
            step_ms.append(ms)
            logits.append(lg)
        cache_bytes = cache_nbytes(cache)
        logits = torch.stack([sharding.gather_full(lg, vocab, mesh) for lg in logits], 1)
        last = sharding.gather_full(last, sharding.P(rows, None), mesh)
    return last, logits, cache_bytes, pre_ms, step_ms, pre_bytes, step_bytes


def mesh_broadcast(t: torch.Tensor | None, shape, dtype) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (through the host: gloo)."""
    buf = (t.cpu() if dist.get_rank() == 0 else torch.zeros(shape, dtype=dtype))
    dist.broadcast(buf, 0)
    return buf.cuda()


def mesh_serve_part(part: str, name: str, arch: str, layers: int, shape,
                    profile: str) -> dict:
    """One part of phase 5j on this rank (module docstring): ``arch`` cut
    to ``layers`` layers on ``shape`` under ``profile``, bfloat16 requests
    against one process's in rank 0, then float32 on its first layers."""
    rank = dist.get_rank()
    tag = f"mesh_serve ({part}) {name}"
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = mesh_cut_cfg(arch, layers)
    mod = get_module(cfg)
    mesh = mesh_lib.make_mesh(shape, ("data", "model"))
    tp = mesh.sizes["model"] if profile in ("2d", "tp") else 1
    cp = profile == "cp"
    whole = mesh_drawn(cfg)
    params = mesh_blocks(cfg, whole, mesh, profile)
    if rank != 0:
        del whole
    torch.cuda.empty_cache()
    requests = [(*MESH_SERVE_PROMPT, MESH_SERVE_GEN)] + MESH_SERVE_EXTRA.get(name, [])
    rng = np.random.default_rng(SEED + 11)
    V = cfg.vocab_size
    kernel = "wkv_chunked" if cfg.family == "ssm" else "flash_attention"
    heads_of = (lambda a: a[0] // MESH_SERVE_PROMPT[0]) if kernel == "wkv_chunked" \
        else (lambda a: a[1])
    per_prefill = {k: mod.kernel_launches_per_prefill(cfg).get(k, 0) for k in KERNELS}
    out = dict(part=part, name=name, arch=arch, layers=layers, mesh=mesh.sizes,
               profile=profile, rank=rank, requests=[])
    launches = {k: 0 for k in KERNELS}
    for B, T, gen in requests:
        batch = lm_batch(cfg, rng, B, T)
        dlen = decode_len(cfg, T, gen)
        one = mesh_one_process(cfg, whole, batch, dlen, gen) if rank == 0 else None
        toks = mesh_broadcast(None if one is None else one["tokens"], (B, gen),
                              torch.int32)
        shapes, keywords = [], []
        real, rec = recorded(kernel, shapes, keywords)
        setattr(ops, kernel, rec)
        try:
            reset_counts()
            last, logits, cache_bytes, pre_ms, step_ms, pre_bytes, step_bytes = \
                mesh_forced(cfg, params, mesh, profile, batch, dlen, decode_inputs(toks))
            got = read_counts()
        finally:
            setattr(ops, kernel, real)
        if got != per_prefill:
            fail(f"{tag} {B}x{T}: launches {got}, expected one prefill's "
                 f"{per_prefill} and none in decode")
        for k in launches:
            launches[k] += got[k]
        heads = sorted({heads_of(a) for a, _ in shapes})
        full_heads = cfg.d_model // cfg.wkv_head_dim if kernel == "wkv_chunked" \
            else cfg.num_heads
        if heads != [full_heads // tp]:
            fail(f"{tag} {B}x{T}: {kernel} ran on {heads} heads a launch, expected "
                 f"{full_heads // tp} of {full_heads}")
        req = dict(shape=[B, T, gen], prefill_ms=pre_ms,
                   decode_ms_per_token=statistics.median(step_ms),
                   host_staged_bytes_prefill=pre_bytes,
                   host_staged_bytes_per_token=step_bytes / gen,
                   cache_bytes=cache_bytes, heads_per_launch=heads,
                   of_heads=full_heads, launches=got)
        if cp:      # the rank's positions: the kernels' offsets, the states
            r_m = mesh.coords["model"]
            if kernel == "wkv_chunked":
                req["from_received_state"] = sorted({"state" in kw for kw in keywords})
                want = [r_m > 0]
                seen = req["from_received_state"]
            else:
                req["q_offsets"] = sorted({kw.get("q_offset", 0) for kw in keywords})
                # the encoder-decoder's attentions take every key (offset 0);
                # a causal self-attention's queries sit at r T / n
                want = [0] if cfg.family == "audio" else [r_m * T // mesh.sizes["model"]]
                seen = req["q_offsets"]
            what = ("started from a received state" if kernel == "wkv_chunked"
                    else "the query offset")
            if seen != want:
                fail(f"{tag} {B}x{T}: rank {rank}'s {kernel} launches saw {seen}, "
                     f"expected {want} ({what})")
        if rank == 0:
            err = (logits[..., :V].float() - one["logits"][..., :V].float()).abs().max().item()
            agree = (logits[..., :V].argmax(-1) == one["tokens"]).float().mean().item()
            hidden = (last.float() - one["last"].float()).abs().max().item()
            n = mesh.sizes["data"] * mesh.sizes["model"]
            req.update(one_process_cache_bytes=one["cache_bytes"],
                       one_process_prefill_ms=one["prefill_ms"],
                       one_process_decode_ms_per_token=one["decode_ms_per_token"],
                       bf16_max_logits_err=err, bf16_greedy_agreement=agree,
                       bf16_max_last_hidden_err=hidden)
            if cache_bytes * n != one["cache_bytes"]:
                fail(f"{tag} {B}x{T}: the rank's cache is {cache_bytes} bytes, one "
                     f"process's {one['cache_bytes']}: not 1/{n}")
            if err > BF16_LOGITS_TOL or agree < BF16_AGREEMENT:
                fail(f"{tag} {B}x{T} bfloat16: logits differ from one process's by "
                     f"{err:.3e} (limit {BF16_LOGITS_TOL}), greedy agreement "
                     f"{agree:.3f} (at least {BF16_AGREEMENT})")
        out["requests"].append(req)
        del logits, last, one
    del params
    if rank == 0:
        del whole
    torch.cuda.empty_cache()
    # float32 on the first layers of the same draw
    f32_layers = min(layers, MESH_SERVE_F32[0]) if cfg.family != "hybrid" else layers
    cfg32 = mesh_cut_cfg(arch, f32_layers, "float32")
    whole32 = mesh_drawn(cfg32)
    params32 = mesh_blocks(cfg32, whole32, mesh, profile)
    B, T = MESH_SERVE_PROMPT
    batch = lm_batch(cfg32, rng, B, T)
    dlen = decode_len(cfg32, T, MESH_SERVE_F32[1])
    one = (mesh_one_process(cfg32, whole32, batch, dlen, MESH_SERVE_F32[1])
           if rank == 0 else None)
    del whole32
    toks = mesh_broadcast(None if one is None else one["tokens"], (B, MESH_SERVE_F32[1]),
                          torch.int32)
    last, logits = mesh_forced(cfg32, params32, mesh, profile, batch, dlen,
                               decode_inputs(toks))[:2]
    if rank == 0:
        out["f32_layers"] = f32_layers
        out["f32_max_err"] = max(
            compare(f"{tag} float32 last hidden", last, one["last"], MESH_SERVE_F32_TOL),
            compare(f"{tag} float32 logits", logits[..., :V], one["logits"][..., :V],
                    MESH_SERVE_F32_TOL))
    del params32, last, logits, one
    torch.cuda.empty_cache()
    out.update(launches=launches, peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
               seconds=time.perf_counter() - t0)
    return out


def mesh_serve_pair() -> dict:
    """Phase 5j's world of two gloo ranks sharing the card: every part in
    turn."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = dict(rank=dist.get_rank(), backend=dist.get_backend(), parts={})
    for part, name, arch, layers, shape, profile in MESH_SERVE_PARTS:
        out["parts"][name] = mesh_serve_part(part, name, arch, layers, shape, profile)
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_serve_one_rank() -> dict:
    """A (1, 1) NCCL mesh serves the cut dense model with the same bits as
    no mesh, eager and captured: a 4 x 512 prefill and MESH_SERVE_GEN
    greedy steps (last hidden, tokens, logits, the last cache).  Run in
    phase 5h part (a)'s world of one rank."""
    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
    if mesh.backend != "nccl":
        fail(f"mesh_serve (1, 1): a world of one rank with a card runs {mesh.backend}")
    cfg = mesh_cut_cfg(DENSE_ARCH, DIST_LAYERS)
    params = mesh_drawn(cfg)
    B, T = MESH_SERVE_PROMPT
    batch = lm_batch(cfg, np.random.default_rng(SEED + 12), B, T)
    struct = lm_serve.prefill_cache_struct(cfg, batch)
    rows = sharding.P("data")
    gather = lambda t: sharding.gather_full(t, rows, mesh)   # noqa: E731
    runs = {}
    for form in ("eager", "captured"):
        for m, profile in ((None, None), (mesh, "2d"), (mesh, "cp")):
            steps = (lm_serve.captured_steps if form == "captured"
                     else lm_serve.eager_steps)(cfg, params, m, profile or "2d",
                                                None if m is None else struct)
            pre, dec = steps
            last, cache, _ = lm_prefill(pre, batch)
            toks, logits, cache, _ = lm_serve.run_decode(
                dec, cache, B, MESH_SERVE_GEN, last.device, None if m is None else gather)
            runs[(form, profile)] = [last, toks, *logits, *pytree.tree_leaves(cache)]
    equal = {f"{form} {profile}": all(
        torch.equal(a, b) for a, b in zip(runs[(form, None)], runs[(form, profile)],
                                          strict=True))
        for form in ("eager", "captured") for profile in ("2d", "cp")}
    if not all(equal.values()):
        fail(f"mesh_serve (1, 1): the NCCL mesh's serving differs from no mesh: {equal}")
    return dict(backend=mesh.backend, equal=equal, shape=[B, T, MESH_SERVE_GEN],
                seconds=time.perf_counter() - t0)


def mesh_serve_phase(one_rank: dict | None = None) -> tuple:
    """Phase 5j (module docstring): the world of two gloo ranks serving
    parts (a) to (e); ``one_rank`` the (1, 1) NCCL check that phase 5h part
    (a)'s world made (a world of one of its own where it is None).  Returns
    the launches of each part's path by rank 0 and the numbers."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    try:
        if one_rank is None:
            (one_rank,) = mesh_lib.spawn_local(1, mesh_serve_one_rank,
                                               timeout_s=MESH_SERVE_WORLD_S)
        pair = mesh_lib.spawn_local(2, mesh_serve_pair, timeout_s=MESH_SERVE_WORLD_S)
    except RuntimeError as e:
        fail(f"mesh_serve: {e}")
    launches = {f"mesh_serve_{name}": pair[0]["parts"][name]["launches"]
                for _, name, *_ in MESH_SERVE_PARTS}
    return launches, dict(one_rank=one_rank, ranks=pair, wall_s=time.perf_counter() - t0,
                          note="two processes time-share one card, eager, every "
                               "collective through the host: not a scaling number")


def print_mesh_serve(d: dict) -> None:
    one = d["one_rank"]
    print(f"mesh_serve (1, 1) {one['backend']} world of 1: {DENSE_ARCH} cut to "
          f"{DIST_LAYERS} layers, {one['shape'][0]}x{one['shape'][1]} + "
          f"{one['shape'][2]} tokens, the same bits as no mesh under '2d' and "
          f"'cp', eager and captured: {one['equal']}")
    for name in d["ranks"][0]["parts"]:
        for r in d["ranks"]:
            p = r["parts"][name]
            for q in p["requests"]:
                B, T, gen = q["shape"]
                line = (f"mesh_serve ({p['part']}) {name} {p['arch']} {p['layers']} layers "
                        f"mesh {p['mesh']} {p['profile']} rank {p['rank']} {B}x{T}+{gen}: "
                        f"prefill {q['prefill_ms']:.1f} ms, decode "
                        f"{q['decode_ms_per_token']:.2f} ms/token (events, eager); staged "
                        f"{q['host_staged_bytes_prefill'] / 1e6:.2f} MB a prefill, "
                        f"{q['host_staged_bytes_per_token'] / 1e6:.3f} MB a token; cache "
                        f"{q['cache_bytes'] / 1e6:.2f} MB; {q['heads_per_launch']} of "
                        f"{q['of_heads']} heads a launch; launches {q['launches']}")
                if "q_offsets" in q:
                    line += f"; attention q_offset {q['q_offsets']}"
                if "from_received_state" in q:
                    line += f"; WKV from a received state {q['from_received_state']}"
                if "one_process_cache_bytes" in q:
                    line += (f"; one process: cache {q['one_process_cache_bytes'] / 1e6:.2f} "
                             f"MB, prefill {q['one_process_prefill_ms']:.1f} ms, decode "
                             f"{q['one_process_decode_ms_per_token']:.2f} ms/token; bf16 "
                             f"logits err {q['bf16_max_logits_err']:.3e} (limit "
                             f"{BF16_LOGITS_TOL}), agreement {q['bf16_greedy_agreement']:.3f}")
                print(line)
            extra = (f"; float32 on {p['f32_layers']} layers err {p['f32_max_err']:.2e} "
                     f"(limit {MESH_SERVE_F32_TOL} (1+|b|))" if "f32_max_err" in p else "")
            print(f"mesh_serve ({p['part']}) {name} rank {p['rank']}: peak "
                  f"{p['peak_mib']:.0f} MiB, {p['seconds']:.1f} s{extra}")
    parts = d["ranks"][0]["parts"]
    for name, p in parts.items():
        if p["profile"] != "cp" or name[:-3] not in parts:
            continue
        tp = parts[name[:-3]]
        for q, t in zip(p["requests"], tp["requests"]):
            B, T, gen = q["shape"]
            print(f"mesh_serve {p['arch']} rank 0 {B}x{T}+{gen} cp | tp: prefill "
                  f"{q['prefill_ms']:.1f} | {t['prefill_ms']:.1f} ms, decode "
                  f"{q['decode_ms_per_token']:.2f} | {t['decode_ms_per_token']:.2f} "
                  f"ms/token; staged {q['host_staged_bytes_prefill'] / 1e6:.2f} | "
                  f"{t['host_staged_bytes_prefill'] / 1e6:.2f} MB a prefill, "
                  f"{q['host_staged_bytes_per_token'] / 1e6:.3f} | "
                  f"{t['host_staged_bytes_per_token'] / 1e6:.3f} MB a token; cache "
                  f"{q['cache_bytes'] / 1e6:.2f} | {t['cache_bytes'] / 1e6:.2f} MB "
                  f"(one process {q['one_process_cache_bytes'] / 1e6:.2f} MB)")
    print(f"mesh_serve wall {d['wall_s']:.1f} s", flush=True)


def count_shapes() -> dict:
    """Phase 5k (a)'s programs: name -> (config, shape, serve_bf16)."""
    B, T = MESH_SERVE_PROMPT
    cut = mesh_cut_cfg(DENSE_ARCH, DIST_LAYERS)
    tb, tt = TRAIN_BATCH
    return {
        f"prefill {DENSE_ARCH} {DIST_LAYERS} layers {B}x{T}":
            (cut, ShapeConfig("prefill", "prefill", T, B), False),
        f"decode {DENSE_ARCH} {DIST_LAYERS} layers {B}x1 on {T} slots, bf16 matrices":
            (cut, ShapeConfig("decode", "decode", T, B), True),
        f"train {DENSE_ARCH} {tb}x{tt}":
            (get_config(DENSE_ARCH), ShapeConfig("train", "train", tt, tb), False)}


def count_one(cfg, shape, serve_bf16: bool) -> dict:
    """One program (``launch.dryrun.build_cell`` on a (1, 1) mesh) counted
    twice: traced on meta, and run on the card under the counter with the
    peak reset before; then timed (CUDA events, warmed up) without it.  The
    counts, the kernels' breakdown and the argument / output / donated
    bytes must be equal."""
    axes = ("data", "model")
    coords = {"data": 0, "model": 0}
    train = shape.kind == "train"
    meta = dryrun.trace(cfg, shape, mesh_lib.abstract_mesh((1, 1), axes, coords,
                                                           device="meta"),
                        serve_bf16=serve_bf16)
    cell = dryrun.build_cell(cfg, shape, mesh_lib.abstract_mesh(
        (1, 1), axes, coords, device="cuda"), serve_bf16=serve_bf16, seed=SEED)
    torch.cuda.synchronize()
    # what the process holds beside the step's arguments (earlier phases'
    # tensors, the L2 flush buffer) is in max_memory_allocated but not in
    # the trace's peak
    residue = torch.cuda.memory_allocated() - opcount.nbytes(*opcount.tensors(cell[1][:-1]))
    torch.cuda.reset_peak_memory_stats()
    real = dryrun.count(*cell, train=train)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for key in ("cost_analysis", "kernels"):
        if real[key] != meta[key]:
            fail(f"count {shape.kind}: the card's {key} {real[key]} differs from "
                 f"the meta trace's {meta[key]}")
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        if real["memory_analysis"][key] != meta["memory_analysis"][key]:
            fail(f"count {shape.kind}: the card's {key} "
                 f"{real['memory_analysis'][key]} differs from the meta trace's "
                 f"{meta['memory_analysis'][key]}")
    step, args = cell[0], cell[1]
    with torch.set_grad_enabled(train):
        ms = time_ms(lambda: step(*args), reps=COUNT_REPS, warmup=COUNT_WARMUP)
    captured_ms = None
    if train:
        # the same step captured, as the launchers run it on the card: its
        # warm-up steps and capture, then replays timed alike
        cap = captured_train_step(step)
        for _ in range(WARMUP + 1):
            cap(*args)
        captured_ms = time_ms(lambda: cap(*args), reps=COUNT_REPS, warmup=COUNT_WARMUP)
        del cap
    del cell, step, args
    torch.cuda.empty_cache()
    ca = meta["cost_analysis"]
    roof = hloanalysis.Roofline(ca["flops"], ca["bytes accessed"], 0.0)
    return dict(counts=ca, kernels=meta["kernels"], memory=meta["memory_analysis"],
                trace_peak_bytes=meta["peak_bytes"], card_peak_bytes=peak,
                residue_bytes=residue,
                card_trace_s=real["trace_s"], meta_trace_s=meta["trace_s"], ms=ms,
                step_s=roof.step_s, bound=roof.bound,
                roofline_share=roof.step_s * 1e3 / ms, captured_ms=captured_ms,
                captured_roofline_share=(None if captured_ms is None
                                         else roof.step_s * 1e3 / captured_ms))


def count_pair() -> dict:
    """Phase 5k (b)'s world of two gloo ranks sharing the card: each
    rank's collectives record in its real prefill and decode and in its
    meta trace of the same step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    meta_mesh = mesh_lib.abstract_mesh(mesh.shape, mesh.axis_names, mesh.coords,
                                       device="meta")
    B, T = MESH_SERVE_PROMPT
    out = dict(rank=dist.get_rank(), backend=mesh.backend, coords=mesh.coords, runs={})
    for arch, layers in COUNT_PAIR:
        cfg = mesh_cut_cfg(arch, layers)
        for kind, profile in [(k, p) for p in ("tp", "cp") for k in ("prefill", "decode")
                              if p == "tp" or arch in COUNT_PAIR_CP]:
            shape = ShapeConfig(kind, kind, T, B)
            kw = dict(profile=profile, serve_bf16=kind == "decode")
            real = dryrun.trace(cfg, shape, mesh, seed=SEED, **kw)
            meta = dryrun.trace(cfg, shape, meta_mesh, **kw)
            out["runs"][f"{kind} {arch} {layers} layers {profile}"] = dict(
                real=real["collectives"], meta=meta["collectives"],
                real_flops=real["cost_analysis"]["flops"],
                meta_flops=meta["cost_analysis"]["flops"])
            torch.cuda.empty_cache()
    return out


def count_phase(smi: str) -> dict:
    """Phase 5k: (a) ``count_one`` for each of ``count_shapes``, (b)
    ``count_pair``'s world; any difference fails the run.  Prints each
    program's counts, the trace's peak beside the card's, and its time
    beside the roofline's, with the card's name and power limit."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    one = {name: count_one(*spec) for name, spec in count_shapes().items()}
    for name, r in one.items():
        c = r["counts"]
        kern = ", ".join(f"{k} {v['calls']} calls {v['flops']:.4e} flops"
                         for k, v in r["kernels"].items()) or "no kernel"
        print(f"count (a) {name}: the card's run equals the meta trace: flops "
              f"{c['flops']} bytes accessed {c['bytes accessed']} transcendentals "
              f"{c['transcendentals']}; kernels {kern} [{smi}]")
        own = r["card_peak_bytes"] - r["residue_bytes"]
        print(f"count (a) {name}: peak trace {r['trace_peak_bytes'] / 2 ** 20:.1f} MiB, "
              f"card max_memory_allocated {r['card_peak_bytes'] / 2 ** 20:.1f} MiB "
              f"(card / trace {r['card_peak_bytes'] / r['trace_peak_bytes']:.3f}), "
              f"{r['residue_bytes'] / 2 ** 20:.1f} MiB of it held before the step "
              f"beside its arguments: the step's own {own / 2 ** 20:.1f} MiB "
              f"(/ trace {own / r['trace_peak_bytes']:.3f}); "
              f"{r['ms']:.3f} ms (events, median of {COUNT_REPS}) against the "
              f"roofline's {r['step_s'] * 1e3:.3f} ms ({r['bound']}, H100 datasheet "
              f"peaks): {100 * r['roofline_share']:.1f} % [{smi}]", flush=True)
        if r["captured_ms"] is not None:
            print(f"count (a) {name}: captured (captured_train_step, replays) "
                  f"{r['captured_ms']:.3f} ms against the roofline's "
                  f"{r['step_s'] * 1e3:.3f} ms: {100 * r['captured_roofline_share']:.1f} % "
                  f"(eager above {r['ms']:.3f} ms) [{smi}]", flush=True)
    try:
        pair = mesh_lib.spawn_local(2, count_pair, timeout_s=COUNT_WORLD_S)
    except RuntimeError as e:
        fail(f"count (b): {e}")
    for r in pair:
        for name, run in r["runs"].items():
            if run["real"] != run["meta"] or run["real_flops"] != run["meta_flops"]:
                fail(f"count (b) rank {r['rank']} {name}: the collectives of the real "
                     f"run {run['real']} (flops {run['real_flops']}) differ from the "
                     f"meta trace's {run['meta']} (flops {run['meta_flops']})")
            kinds = ", ".join(f"{k} x{v['count']} {v['result_bytes']} B"
                              for k, v in run["real"].items())
            print(f"count (b) rank {r['rank']} {r['coords']} {r['backend']} {name}: "
                  f"collectives equal the meta trace's: {kinds} [{smi}]")
    out = dict(one=one, pair=pair, wall_s=time.perf_counter() - t0, device=smi)
    print(f"count wall {out['wall_s']:.1f} s", flush=True)
    return out


def write_out(path: str, numbers: dict) -> None:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(numbers, indent=1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--only", choices=["5i", "5h", "5j", "5k", "5l"],
                    help="device, build and this phase alone, then stop (no "
                         "result lines)")
    ap.add_argument("--dist-vs", metavar="DIR",
                    help="device, build, then part (c) of phase 5h in four fresh "
                         "processes, alternating the checkout DIR (another commit) "
                         "and this one: DIR, this, this, DIR; then stop")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA device only", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    walls, mark = {}, [t_start]

    def lap(phase: str) -> None:
        """The wall seconds since the last lap, under ``phase``."""
        now = time.perf_counter()
        walls[phase] = now - mark[0]
        mark[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    nvcc = run_text([_build._nvcc(), "--version"]).splitlines()[-2:]
    print(f"device {smi}")
    print(f"versions python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {' | '.join(nvcc)}", flush=True)

    # 2. build
    want_sources = sorted(ROOT / info["source"] for info in KERNELS.values())
    if _build.sources() != want_sources:
        fail(f"build: sources {[str(p) for p in _build.sources()]}, expected "
             f"the {len(want_sources)} of KERNELS")
    _build.library()
    built = _build.build_seconds
    print(f"build {len(_build.sources())} sources -> {_build.build_dir()} in "
          f"{'(reused)' if built is None else f'{built:.1f} s'} (set-up)")
    for line in _build.ptxas_log().splitlines():
        if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            print(f"ptxas {line.strip()}")
    regs = [int(tok) for line in _build.ptxas_log().splitlines() if "Used" in line
            for tok in [line.split("Used")[1].split()[0]]]
    print(f"ptxas {len(regs)} kernels, registers {min(regs)}..{max(regs)} a thread",
          flush=True)
    for inst, (n_regs, stores, loads) in online_ptxas(_build.ptxas_log()).items():
        print(f"ptxas online_kernel<{inst}>: {n_regs} registers a thread, spill "
              f"stores {stores} loads {loads} bytes")
    for inst, (n_regs, stores, loads) in fab_mod.ptxas(_build.ptxas_log()).items():
        print(f"ptxas attn_bwd {inst}: {n_regs} registers a thread, spill stores "
              f"{stores} loads {loads} bytes")
    for inst, (n_regs, stores, loads) in wkvb_mod.ptxas(_build.ptxas_log()).items():
        print(f"ptxas wkv_grads {inst}: {n_regs} registers a thread, spill stores "
              f"{stores} loads {loads} bytes")
    lap("1-2 device, build")

    if args.only == "5h":
        launches, distributed = dist_phase()
        print_dist(distributed)
        lap("5h distributed")
        if args.out:
            write_out(args.out, dict(dist=distributed, dist_launches=launches, walls=walls))
        print(f"phase wall s {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
        print(f"total {time.perf_counter() - t_start:.1f} s (phase 5h alone)")
        return
    if args.only == "5j":
        mesh_launches, mesh_serving = mesh_serve_phase()
        print_mesh_serve(mesh_serving)
        lap("5j sharded serving")
        if args.out:
            write_out(args.out, dict(mesh_serve=mesh_serving, mesh_serve_launches=mesh_launches,
                                     walls=walls))
        print(f"phase wall s {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
        print(f"total {time.perf_counter() - t_start:.1f} s (phase 5j alone)")
        return
    if args.only == "5k":
        counted = count_phase(smi)
        lap("5k counts")
        if args.out:
            write_out(args.out, dict(count=counted, walls=walls))
        print(f"phase wall s {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
        print(f"total {time.perf_counter() - t_start:.1f} s (phase 5k alone)")
        return
    if args.dist_vs:
        rounds = dist_versus(Path(args.dist_vs).resolve())
        if args.out:
            write_out(args.out, dict(dist_vs=rounds, walls=walls))
        print(f"total {time.perf_counter() - t_start:.1f} s (--dist-vs)")
        return

    if args.only == "5l":
        family_launches, families = family_phase()
        multi_launches, multiarch = multiarch_phase()
        lap("5l train three families, train_multiarch")
        quick_launches, quick = quickstart_phase()
        lm_launches, served_lm = serve_lm_phase()
        lap("5l quickstart, serve_lm")
        if args.out:
            write_out(args.out, dict(families=families, multiarch=multiarch,
                                     quickstart=quick, serve_lm=served_lm,
                                     launches=dict(family_launches, **multi_launches,
                                                   **quick_launches, **lm_launches),
                                     walls=walls))
        print(f"phase wall s {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
        print(f"total {time.perf_counter() - t_start:.1f} s (phase 5l alone)")
        return
    if args.only == "5i":
        five_launches, five = five_phase()
        lap("5i five configs")
        if args.out:
            write_out(args.out, dict(five=five, five_launches=five_launches,
                                     walls=walls))
        print(f"phase wall s {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
        print(f"total {time.perf_counter() - t_start:.1f} s (phase 5i alone)")
        return

    # 3. kernels against their plain versions
    per_kernel = kernels_phase()
    for name, rec in per_kernel.items():
        for s in rec["shapes"]:
            lib = "none" if s["library_ms"] is None else f"{s['library_ms']:.4f}"
            split = split_text(s)
            pre = f" ({s['per_prefill']} a prefill)" if "per_prefill" in s else ""
            fwd = (f" | forward ms {s['fwd_ms']:.4f}, with lse {s['fwd_lse_ms']:.4f}"
                   if "fwd_ms" in s else "")
            bwd = bwd_text(s) if "plan" in s else wkv_bwd_text(s) if "instance" in s else ""
            beside = "".join(f" | {label} {s[key]:.4f}" for key, label in (
                ("no_offset_ms", "without the offset ms"), ("no_state_ms", "from zero ms"))
                if key in s)
            print(f"kernel {s['case']} x{s['per_forward']}{pre}: err "
                  f"{s['max_abs_err']:.2e} ms {s['ms']:.4f} plain {s['plain_ms']:.4f} "
                  f"library {lib} bound {s['bound_ms']:.4f} ({s['bound_by']}){beside}"
                  f"{split}{fwd}{bwd}")
        for s in rec["extra"]:
            split = split_text(s) + (bwd_text(s) if "plan" in s else
                                     wkv_bwd_text(s) if "instance" in s else "")
            print(f"kernel {s['case']}: err {s['max_abs_err']:.2e} (tol {s['tol']}){split}")
    sys.stdout.flush()
    lap("3 kernels")

    # 4. main path, EdgeNeXt-S
    launches, served = main_path()
    print(f"main_path EdgeNeXt-S requests {served['requests']} launches {launches} "
          f"err_vs_plain {served['max_abs_err_vs_plain_on_card']:.2e} "
          f"err_vs_cpu {served['max_abs_err_vs_plain_on_cpu']:.2e} "
          f"|logits| <= {served['logits_abs_max']:.3f}")
    print(f"main_path ms/request B=16 {served['ms_per_request_b16']:.3f} "
          f"(plain {served['plain_ms_per_request_b16']:.3f}) "
          f"B=1 {served['ms_per_request_b1']:.3f} "
          f"(plain {served['plain_ms_per_request_b1']:.3f}) "
          f"peak memory {served['peak_memory_mib']:.0f} MiB", flush=True)
    cap = served["captured"]
    c16, c1 = cap["captures"][BATCH], cap["captures"][1]
    print(f"main_path captured EdgeNeXt-S: capture B=16 {c16['capture_s']:.2f} s "
          f"B=1 {c1['capture_s']:.2f} s (host clock, {WARMUP} warm-up forwards "
          f"included), launches at each capture {c16['launches']} = "
          f"(1 + {WARMUP} warm-up) x 18/21/3, over {len(cap['requests'])} "
          f"replays {cap['launches_on_replay']}; logits equal the eager ones "
          f"bit for bit on requests {cap['requests']}, err vs plain "
          f"{cap['max_abs_err_vs_plain_on_card']:.2e}")
    for b in (BATCH, 1):
        t, m = cap["timing"][b], cap["peak_allocated_mib"][b]
        print(f"main_path B={b} ms/request eager|captured (median of 10, in "
              f"turns): events {t['eager']['event_ms']:.3f}|"
              f"{t['captured']['event_ms']:.3f} wall "
              f"{t['eager']['wall_ms']:.3f}|{t['captured']['wall_ms']:.3f}; "
              f"peak allocated {m['eager']:.0f}|{m['captured']:.0f} MiB, graph "
              f"reserved {cap['captures'][b]['reserved_mib']:.0f} MiB", flush=True)
    lap("4 EdgeNeXt-S")

    # 5. main path, RWKV-6 1.6B
    rwkv_launches, rwkv = rwkv6_path()
    print(f"rwkv6 requests {rwkv['requests']} x {rwkv['gen']} tokens, "
          f"{rwkv['parameters']} parameters (init on the card "
          f"{rwkv['init_params_s']:.1f} s), launches {rwkv_launches} = "
          f"24 wkv_chunked a prefill, 0 in decode")
    print(f"rwkv6 prefill ms B=4 T=512 {rwkv['prefill_ms_b4_t512']:.3f} "
          f"B=1 T=200 {rwkv['prefill_ms_b1_t200']:.3f}; decode ms/token B=4 "
          f"{rwkv['decode_ms_per_token_b4']:.3f} B=1 "
          f"{rwkv['decode_ms_per_token_b1']:.3f}; peak memory "
          f"{rwkv['peak_memory_mib']:.0f} MiB")
    print(f"rwkv6 bfloat16 vs plain: max |dlogits| "
          f"{rwkv['bf16_max_logits_err_vs_plain']:.3e} (limit {BF16_LOGITS_TOL}), "
          f"last hidden {rwkv['bf16_max_last_hidden_err_vs_plain']:.3e}, greedy "
          f"agreement {rwkv['bf16_greedy_agreement']:.3f} (at least "
          f"{BF16_AGREEMENT}); |logits| <= {rwkv['logits_abs_max']:.3f}")
    print(f"rwkv6 float32 err vs plain on card {rwkv['f32_max_err_vs_plain_on_card']:.2e}, "
          f"vs CPU {rwkv['f32_max_err_vs_plain_on_cpu']:.2e} (limit 2e-3 (1+|b|))",
          flush=True)
    cap = rwkv["captured"]
    for shape, c in cap["captures"].items():
        print(f"rwkv6 captured {shape}: capture prefill {c['prefill_capture_s']:.2f} s "
              f"decode {c['decode_capture_s']:.2f} s (host clock, {WARMUP} warm-up "
              f"runs included), launches prefill {c['prefill_launches']['wkv_chunked']} "
              f"wkv_chunked = (1 + {WARMUP}) x 24, decode "
              f"{sum(c['decode_launches'].values())}; graph reserved "
              f"{c['prefill_reserved_mib']:.0f} + {c['decode_reserved_mib']:.0f} MiB")
    bf = cap["bf16_vs_plain"]
    print(f"rwkv6 captured: {cap['bitwise_equal_requests']} requests replayed equal "
          f"the eager steps bit for bit (last hidden, prefill cache, {RWKV_GEN} "
          f"steps of tokens and logits, last cache), launches on replay "
          f"{sum(cap['launches_on_replay'].values())}; bfloat16 vs plain "
          f"{bf['max_logits_err']:.3e}, agreement {bf['greedy_agreement']:.3f}; "
          f"float32 (bit for bit the eager) vs plain "
          f"{cap['f32_max_err_vs_plain_on_card']:.2e}")
    for key, t in cap["timing"].items():
        unit = "ms/token" if key.startswith("decode") else "ms"
        print(f"rwkv6 {key} {unit} eager|captured (median, in turns): events "
              f"{t['eager']['event_ms']:.3f}|{t['captured']['event_ms']:.3f} wall "
              f"{t['eager']['wall_ms']:.3f}|{t['captured']['wall_ms']:.3f}")
    m, w = cap["peak_allocated_mib_b4_t512"], cap["wkv_graph"]
    print(f"rwkv6 4x512 request peak allocated eager|captured {m['eager']:.0f}|"
          f"{m['captured']:.0f} MiB; wkv_chunked alone in a graph: "
          f"{w['kernel_nodes']} kernel nodes, edge types {w['edge_types']} "
          f"(1 = programmatic), replay follows new inputs bit for bit, ms eager "
          f"{w['eager_ms']:.4f} graph {w['graph_ms']:.4f}", flush=True)
    lap("5 RWKV-6")

    # 5g. training RWKV-6 on the float32 draw that its served weights
    # round: the WKV backward kernel
    rwkv_train_launches, rwkv_train = train_path(get_config(RWKV_ARCH),
                                                 parameters=RWKV_PARAMS, resume=False)
    print_train(rwkv_train, "train_rwkv")
    lap("5g train RWKV-6")

    # 5b. the dense path, h2o-danube-1.8b uncut
    dense_launches, dense = dense_path()
    print_lm("dense", dense, 24)
    lap("5b dense")

    # 5f. training on the float32 draw that the dense path's weights round
    train_launches, train = train_path(get_config(DENSE_ARCH), parameters=DENSE_PARAMS,
                                       resume=True)
    print_train(train)
    lap("5f train dense")

    # 5c. the MoE path, qwen2-moe-a2.7b at MOE_LAYERS of its 24 layers
    moe_launches, moe = moe_path()
    print_lm("moe", moe, MOE_LAYERS)
    print(f"moe float32 ({MOE_F32[0]} layers, {MOE_F32[1]}x{MOE_F32[2]}, "
          f"{MOE_F32[3]} steps) err vs plain on card "
          f"{moe['f32_max_err_vs_plain_on_card']:.2e} (limit 2e-3 (1+|b|)), expert "
          f"routings agree {moe['f32_routing_agreement']:.4f}", flush=True)
    lap("5c MoE")

    # 5d. the encoder-decoder, seamless-m4t-large-v2 uncut
    audio_launches, audio = audio_path()
    print_lm("audio", audio, 72)
    lap("5d encoder-decoder")

    # 5e. the hybrid, recurrentgemma-2b uncut
    hybrid_launches, hybrid = hybrid_path()
    print_lm("hybrid", hybrid, 8)
    print(f"hybrid float32 ({HYBRID_F32[0]} layers {'/'.join(get_config(HYBRID_ARCH).block_pattern[:HYBRID_F32[0]])}, "
          f"{HYBRID_F32[1]}x{HYBRID_F32[2]}, {HYBRID_F32[3]} steps) err vs plain on "
          f"card {hybrid['f32_max_err_vs_plain_on_card']:.2e} (limit 2e-3 (1+|b|))",
          flush=True)
    lap("5e hybrid")

    # 5l. the encoder-decoder, the hybrid and the MoE trained on the card,
    # then train_multiarch's ten reduced archs
    family_launches, families = family_phase()
    multi_launches, multiarch = multiarch_phase()
    lap("5l train three families, train_multiarch")
    quick_launches, quick = quickstart_phase()
    lm_launches, served_lm = serve_lm_phase()
    lap("5l quickstart, serve_lm")

    # 5i. the five configs that had run on the CPU only, uncut, on weights
    # drawn on the card
    five_launches, five = five_phase()
    lap("5i five configs")

    # 5h. the distributed runtime: a world of one rank under NCCL, then two
    # ranks sharing the card under gloo
    dist_launches, distributed = dist_phase()
    print_dist(distributed)
    lap("5h distributed")

    # 5j. sharded serving: the (1, 1) check from 5h (a)'s world, then two
    # ranks sharing the card under gloo
    mesh_launches, mesh_serving = mesh_serve_phase(distributed["one_process"]["mesh_serve"])
    print_mesh_serve(mesh_serving)
    lap("5j sharded serving")

    # 5k. the counter of the dry-run held to the real program on the card
    counted = count_phase(smi)
    lap("5k counts")

    # 6. the scheduler's path: every lowered entry onto its kernel
    lowered, entries, by_workload, lowered_launches, verified, samples, launched = \
        lowered_phase()
    for name, kern in LOWERED.items():
        recs = [r for r in lowered if r["kernel"] == kern]
        print(f"lowered {name}: {entries[name]} entries over {len(WORKLOADS)} "
              f"workloads, {len(recs)} distinct launches, all passed, max err "
              f"{max(r['max_abs_err'] for r in recs):.2e} (tol {recs[0]['tol']})")
    print(f"lowered rwkv_chunk entries by workload: {by_workload['rwkv_chunk']}; "
          f"0 waiting", flush=True)
    check = dict(verified, **check_phase(samples))
    found = check["findings"]
    print(f"check: {len(found)} workloads verified, {sum(found.values())} "
          f"findings ({check['verify_s']:.2f} s on the host); mutation corpus "
          f"{check['corpus']['caught']}/{check['corpus']['total']} caught; "
          f"{sum(1 for c in check['agreement'] if c['ops_refused'])} "
          f"lint-flagged blocks refused by ops with no launch "
          f"({check['check_phase_s']:.2f} s)", flush=True)
    lap("6 lowered, check")

    # 7. the schedule store: warm, disk hits, its new launches, chaos
    serve_launches, store = serve_phase(launched)
    w, d, ln, ch = store["warm"], store["disk"], store["launch"], store["chaos"]
    print(f"serve warm: {w['entries']} entries ({', '.join(SERVE_WORKLOADS)} at "
          f"batches {list(BATCH_LEVELS)}), {w['searched']} searched, "
          f"{w['worker_failed']} workers failed; a spawned pool of {w['jobs']} "
          f"with the card's context live, {w['seconds']:.2f} s on the host")
    print(f"serve disk: a fresh store answered {d['disk_hits']}/{d['requests']} "
          f"requests from disk, each a cache.hit verified with 0 findings; host ms "
          f"a disk hit verified {d['disk_hit_ms']:.3f} (median, max "
          f"{d['disk_hit_ms_max']:.3f}), unverified {d['disk_hit_unverified_ms']:.3f}, "
          f"a memory hit {d['mem_hit_ms']:.4f} (max {d['mem_hit_ms_max']:.4f})")
    print(f"serve launch: {ln['workload']} answers carry {ln['entries']} lowered "
          f"entries, {ln['distinct']} distinct, {ln['already_launched']} run by the "
          f"lowered phase, {ln['new']} new by batch {ln['new_by_batch']} all passed, "
          f"max err {max(r['max_abs_err'] for r in ln['records']):.2e}; launches "
          f"{serve_launches}")
    for r in ln["records"]:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"serve kernel {r['case']} B={r['batch']}: err {r['max_abs_err']:.2e} "
              f"(tol {r['tol']}) ms {r['ms']:.4f} plain {r['plain_ms']:.4f} library "
              f"{lib} bound {r['bound_ms']:.4f} ({r['bound_by']}){split_text(r)}")
    print(f"serve chaos: {ch['served']}/{ch['requests']} served ({ch['plan']}, seed "
          f"{ch['seed']}), {ch['degraded']} degraded, outcomes {ch['outcomes']}, "
          f"faults {ch['faults']}; every answer verified with 0 findings (a degraded "
          f"one with its marker); launches during the session {ch['launches']}",
          flush=True)
    lap("7 serve store")

    # 8. results
    rows = summarise(per_kernel, {"edgenext_serve": launches,
                                  "rwkv6_serve": rwkv_launches,
                                  "dense_serve": dense_launches,
                                  "dense_train": train_launches,
                                  "rwkv_train": rwkv_train_launches,
                                  "moe_serve": moe_launches,
                                  "audio_serve": audio_launches,
                                  "hybrid_serve": hybrid_launches,
                                  **family_launches,
                                  **multi_launches,
                                  **quick_launches,
                                  **lm_launches,
                                  "lowered": lowered_launches,
                                  "serve_store": serve_launches,
                                  **dist_launches,
                                  **mesh_launches,
                                  **five_launches})
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        write_out(args.out, dict(
            device=device, nvidia_smi=smi, torch=torch.__version__,
            cuda=torch.version.cuda, nvcc=nvcc, build_seconds=built,
            kernels=rows, main_path=served, rwkv6=rwkv, dense=dense, train=train,
            train_rwkv=rwkv_train, families=families, multiarch=multiarch,
            quickstart=quick, serve_lm=served_lm, moe=moe,
            audio=audio, hybrid=hybrid, five=five, check=check, dist=distributed,
            mesh_serve=mesh_serving, count=counted,
            serve=store, walls=walls,
            lowered=dict(records=lowered, entries=entries,
                         by_workload=by_workload)))
    print(f"phase wall s {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"dist": distributed}))
    print(json.dumps({"check": check}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
