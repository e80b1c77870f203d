#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` and drives its
main paths: serving at full GPT-2-small width and depth (12 layers,
hidden 768, vocab 50257, seeded random weights), the BERT-base pretraining
step at full width and depth, Switch-MoE training at switch-base-8's
widths (hidden 768, FFN 3072, 8 experts) through `TrainStep` and the gluon
`Trainer`, GPT-2-small causal-LM training at full width (6 of its 12
layers), the
same with Mistral 7B's attention (RoPE, grouped K/V, a sliding window)
and with Gemma 2B's (heads of 256 over one kv head, RoPE), serving with
speculative decoding and the prefix cache plus beam search,
the Transformer translation model (``transformer_base``), the BERT-base
step again under the rest of the optimizer family and its schedulers,
the Gluon front end (BERT-base fine-tuned, an MLP quantized) and the
models as Gluon blocks, all through the examples' ``mx.np`` code, the
tensor front end's kernel-routed ``npx`` ops, and
``examples/bert_pretraining.py``'s loop under the operations plane:

1. prints the card (name and power limit from ``nvidia-smi``) and the
   torch / CUDA versions;
2. holds each kernel against its plain PyTorch version at the slice's
   shapes — K1 ragged paged attention (f32/bf16, decode C=1 and prefill
   C=16, MHA and GQA rep 4, ragged context lengths with an empty slot and
   non-page-aligned lengths, with and without a window; f32 queries over a
   bf16 pool at C=1 and C=16, MHA, held to the bf16 tolerance; the
   speculative verification width C=5, MHA and GQA, with two slots'
   tables sharing a 7-page prefix; the wide heads of `K1_WIDE`: D 256 at
   3 heads over one kv head, C=1 and 16, Gemma 2B's 8 over one at C=1,
   and D 72 and 24 at C=1, f32 and bf16; a 4096-token context, 8 slots
   decoding, f32; each with its launch plan), K1's int8 variant (k1_int8:
   an int8 pool with one f32 scale a stored vector under f32 and bf16
   queries, C=1, 5 and 16, MHA and GQA rep 4, with and without a window;
   D 256 at 3 and 8 heads over one kv head, D 72 and 24, at C=1; the
   4096-token context; held to the plain version with the scales at the
   query dtype's tolerance, SDPA over a dequantized copy beside it), K1
   over an f16 pool (k1_f16: f32 queries, an f16 model's serving step,
   and f16 queries, at C=1, 5 and 16, MHA and GQA rep 4, with and
   without a window, and D 256 at 3 heads over one; f32 queries at the
   f32 tolerance, f16 ones at f16's) and
   K2 int8/int4 dequant-matmul (f32/bf16/f16 activations, M
   in {8, 128}, the four GPT-2 projection shapes, and the tied head (8,
   50257, 768) at int8 f32) — two calls bit-equal, within max-abs 1e-4
   (f32) / 2e-2 (bf16) of the output scale, and times kernel, plain
   version, a one-call library yardstick (never used by the port; each
   case's kernel / library ratio printed) and the card's bound; the K1
   and K2 cases and their library calls also give the device-only time
   and the host µs a call;
3. serves 16 greedy requests (prompts of 16-256 tokens, 32 new tokens,
   staggered arrivals) through ``InferenceEngine`` with
   ``ServeConfig(max_slots=8, max_len=512, page_size=16, prefill_chunk=16)``
   in float32, checks K1 launched 12 times per fused step, and holds every
   stream against the same engine built on the plain versions and against
   ``GPTForCausalLM.generate`` — a divergence is accepted only where the
   plain path's top-2 logit gap is below 1e-4;
4. the same at ``quant_bits=8`` and ``quant_bits=4`` (K2 must launch);
   then over an int8 KV pool (``kv_dtype="int8"``), alone and with
   ``quant_bits=8`` under ``MXTPU_QUANT_ACT=1`` at thresholds a
   `LayerCalibrator` took over 4 held-out prompts (int8 activations: K2
   must not launch): K1's int8 variant 12 times a fused step and the float
   K1 never; the int8 pool's streams held to the plain engine over the
   same pool (the near-tie gap taken over int8 K/V); under int8
   activations the streams are reported and the plain engine's first 4
   fed back teacher-forced, the kernel path's logits within 10 one-ulp
   floors of the plain path's and a planted fault (V read at the K scales)
   outside (`forced_check`); the pool's bytes and pages, and the share of
   generated tokens equal to the f32-pool streams (reported);
5. bfloat16 end to end, reporting the share of streams equal to the plain
   path's: the decode step computes in f32 after the first LayerNorm's f32
   gain, as JAX's does, so K1 reads f32 queries over the bf16 pool; then
   (5b) ``gpt_small(dropout=0.0, dtype="float16")`` over an f16 pool: K1
   with f32 queries over the f16 pool 12 times a fused step (counted
   under float16), the streams held to the plain engine's as phase 3
   holds them, tokens/s, TTFT, step ms and the pool's bytes beside the
   f32 and bf16 runs';
6. (k3) flash attention, forward and forward + backward, against its plain
   version at BERT's attention shape (B 64, H 12, L 128, D 64) in f32 and
   bf16 with no mask, a key-padding bias from seeded ``valid_length``
   (0.85 L - L), a per-row bias, causal, and the padding bias with dropout
   0.1 (one seed on both sides, so the keep masks coincide) — max-abs
   1e-4 (f32) / 2e-2 (bf16) of the scale of O, lse, dQ, dK and dV, two
   forward and two backward calls bit-equal, the forward's plan (blocks
   and their source) recorded; then GPT-2 small's attention (B 8, H 12, L
   1024, D 64, causal, dropout 0.1) the same way, beside
   ``scaled_dot_product_attention(is_causal=True)``; timed against
   ``scaled_dot_product_attention`` with the same float mask, each
   direction also device-only and its host µs a call, beside SDPA's; both
   directions' f32 bounds at the 3xTF32 rate (a third of 495 TFLOP/s);
   then the band and the fold (`FLASH_BAND_CASES`), f32 and bf16: the
   gpt_gqa phase's attention (B 8, 12 heads over 3 kv heads folded onto
   the rows, L 1024, causal window 256, dropout 0.1), the same over one kv
   head (MQA), BERT's with a symmetric window of 32 beside its padding and
   dropout, and an odd fold (lq 150, lk 260, rep 3, window 40, padding)
   whose q tiles straddle two heads -- each through the kernels' wrappers
   against the plain versions, two calls bit-equal, the launches counted,
   timed beside SDPA (``enable_gqa``, the band and padding as a float mask)
   and beside the bound of the pairs the band keeps; then the nmt phase's
   three attentions (`FLASH_NMT_CASES`: the encoder's padded
   self-attention with dropout, the decoder's causal one, cross-attention
   with Lq 96 over Lk 128) the same way; then the wide heads
   (`FLASH_WIDE_CASES`: the gpt_d256 phase's (8, 3 over 1 kv head, 1024,
   256) causal with dropout, Gemma 2B's (2, 8 over 1, 2048, 256) causal,
   BERT's padded batch at (64, 3, 128, 256) with dropout, and (4, 4 over
   2, 512, 192) under a causal window of 128) the same way;
7. (k4) the streaming softmax cross-entropy, forward and backward, against
   its plain version at (1280, 30522) in f32 and bf16, at the odd V 50257,
   at the gpt phase's logits (8192, 50257) and the nmt phase's (3072,
   32000) in f32 and bf16, timed against ``cross_entropy(x.float(), y)``,
   the forward's host µs a call and launch plan recorded; the forward's
   loss and lse within 1e-4 of their scale in either dtype (f32 on both
   sides), dx within its dtype's limit; then `XENT_EDGES` (V 1 and 9, and
   V 50257 in 16 rows that start at every 16-byte phase), labels outside
   [0, V) at both ends, a masked column and a row that is -inf over every
   thread's first reads, checked only;
8. (k5) the fused LayerNorm / RMSNorm row kernel, with and without a
   residual, against its plain version in f32 and bf16 (f32 gamma and
   beta, as BERT keeps them) at (8192, 768) and (1280, 768) — the step's
   norms — (37, 200) and the nmt phase's (4096, 512), within 1e-4 / 2e-2 of the output scale, two
   calls bit-equal, each case's launch plan and its source recorded;
   timed (also device-only, and the host µs a call) against
   ``F.layer_norm`` / ``F.rms_norm`` with the parameters cast to x's
   dtype, and at (8192, 768) LayerNorm at every block_rows of JAX's menu;
9. (k6) the optimizer kernels over BERT-base's real parameter list at
   `OPTIM_LAYERS` of its 12 layers (every leaf shape of the model, 63
   tensors, 76.8 M elements; f32 model: one dtype group, bf16 model: bf16
   weights and f32 LayerNorm parameters) — the multi-tensor chunk for Adam,
   AdamW, SGD with momentum, NAG, Signum with and without momentum,
   AdaBelief, Adamax, AdaDelta and FTML (its three state slots), LAMB
   phases A and B (each once per dtype group; each phase's plan
   recorded) — against the per-leaf
   plain version, ``kernel_plain`` (each state within 1e-5 of its scale;
   each weight within its rounding plus 1e-5 of its update's scale, and at
   most 1e-4 of the bf16 weights' elements off the plain value), with
   planted faults built from the kernel's results (state not stored,
   weights unchanged) that the comparison must reject, ``skip=True``
   bit-identical on the card; device times from ``torch.profiler``,
   beside ``torch._fused_adam_`` / ``_fused_adamw_`` /
   ``_fused_sgd_`` over the same tensors as the nearest library call
   (torch's Adam puts epsilon after the bias correction, MXNet's before;
   none for LAMB and the six rules after SGD, each with its reason,
   `NO_LIBRARY`);
   then AdamW over GPT-2 small's parameters and Adam over
   ``transformer_base``'s; then f16 (`OPT_F16`): AdamW over GPT-2 small's
   f16 leaves with f32 state and with f16 state, LAMB over BERT-base's
   f16 leaves, each 16-bit value within one step of its type;
10. (train) ``bench.py``'s BERT-base pretraining step (batch 64 x 128, 20
   masked positions, padded by ``valid_length``, dropout 0.1) through
   ``TrainStep`` for 20 steps on the default kernel route
   (``MXTPU_PALLAS=auto``): bf16 and f32 weights with Adam lr 1e-4 and
   with LAMB lr 1e-3 — every LayerNorm through the fused norm (26 launches
   a step), the optimizer through the chunk kernel (once per dtype group a
   step) or LAMB's phases (A and B each once per dtype group) —
   and slice 2's
   ``MXTPU_PALLAS=reference`` bf16 Adam step (no norm or optimizer
   launch).  The flash kernels launch 12 times a step each way and the
   cross-entropy kernels once.  Each run's loss trajectory equals that of
   the same step built on the plain versions from the same seed (relative
   1e-4; 1e-3 for bf16 on the kernel route, see `traj_tol`), and the loss
   falls; prints samples/s, step ms and TFLOP/s
   (``bench.py``'s count) and the share of the card's dense bf16 peak.
   Two controls plant a fault in the bf16 Adam kernel-route step (Adam
   without bias correction; LayerNorm on the norm kernel's RMS branch),
   and each must depart from that run's oracle by more than the limit.
11. (k7) the MoE row gather against its plain version, bit for bit: the
   slice's dispatch (8192 tokens into 8 x 1280 slots, H 768) and combine
   (scaled by gate * kept in f32) in f32, bf16 and f16, and at H 100 in
   bf16 (rows of 200 bytes: 8-byte pieces), with routing from a
   seeded skewed router (tokens overflow, slots stay empty), and an odd
   case (T 53, E 4, C 6, H 256) through ``moe_dispatch`` / ``moe_combine``
   with ``use_kernel=True``; dropped tokens and empty slots exactly zero;
   two planted faults (the scale ignored, ``kept`` ignored) must be
   rejected; timed beside ``torch.index_select`` (combine: index_select
   and a multiply, two calls) and the bound, with the host µs a call and
   the launch plan;
12. (tune) the autotuner's trial launches of the chunk kernel (row 10),
   each trial timed by CUDA events after an L2 flush (`time_callable`
   with the card's device; every trial's ms and the pick printed),
   with ``MXTPU_AUTOTUNE_CACHE`` in a temporary directory: a cold
   ``tune("fused_optimizer", (n,), "float32")`` for the MoE layer's
   parameters (37.8 M) and BERT-base's (133.6 M) runs trials that the
   chunk kernel counts, every candidate block size gives the bits of the
   static ``CHUNK`` (which k6's tolerances hold to the plain update), a
   warm call is a hit with 0 trials, and the next ``apply_updates``
   launches with the tuned chunk; the tuned configs are dropped after the
   phase, so the phases that follow launch at ``CHUNK``; then the same for
   K2 (``tune("quantized_matmul", (8, 2304, 768), "int8")`` over its whole
   plan menu: every candidate's launch within 1e-4 of the plain version's
   scale, the next call on the tuned plan), and for K1's page size
   (``tune("paged_attention", (8, 12, 12, 64, 512), "float32")``: the
   trials launch K1, every candidate page size's decode step within 1e-4
   of the plain version's scale, a warm call a hit with 0 trials, and
   ``ServeConfig()`` then takes the tuned page size; later phases serve
   at page 16 as before), and for the flash forward's blocks
   (``tune("flash_attention", (64, 12, 128, 128, 64), "bfloat16")``: the
   trials launch the CUDA forward, every candidate (block_q, block_k)
   within 2e-2 of the plain version's scale, a warm call a hit with 0
   trials, the next call's plan on the tuned blocks), and for the fused
   norm's rows a block (``tune("fused_norm", (8192, 768), "bfloat16")``
   over JAX's whole block_rows menu: the trials launch the CUDA kernel,
   every candidate within 2e-2 of the plain version's scale, a warm call
   a hit with 0 trials, the next call's plan on the tuned block_rows; a
   second cold search records whether it picks the same block_rows); and
   under float16 keys: the chunk over GPT-2 small's f16 leaves (f32
   moments), K2's ``int8_float16`` (f16 activations) and K1's page size
   over an f16 pool (in a cache of its own), each trial counted under
   float16;
13. (moe) ``MoEFeedForward(768, 3072, num_experts=8, capacity_factor=1.25)``
   trained 20 steps on a seeded (64, 128, 768) batch, loss MSE + 0.01 aux,
   Adam lr 1e-4, through ``TrainStep`` and through ``gluon.Trainer``
   (``loss.backward(); trainer.step(8192)`` on the batch's summed loss), in
   f32 and bf16: the gather launches twice a step (dispatch, combine), the
   chunk kernel once, nothing else; each loss trajectory is held against
   the same run on the plain versions (``MXTPU_PALLAS=reference``, per-leaf
   optimizer) within `moe_tol`, tokens routed apart from the oracle
   counted per step, the loss falls, and a planted fault (combine without
   the gate) must depart by more than the limit.  Prints tokens/s, step ms, TFLOP/s
   of the expert products and the share of the dense peak.
14. (gpt) ``gpt_small(num_layers=GPT_LAYERS)`` (GPT-2 small's widths:
   vocab 50257, hidden 768, 12 heads, FFN 3072, 1024 positions, tied
   head; 6 of its 12 layers, 82 M parameters; seed 0, dropout 0.1) on a
   seeded (8, 1025) token stream
   (inputs ``[:, :-1]``, labels ``[:, 1:]``), the causal-LM loss
   (``gluon.loss.SoftmaxCrossEntropyLoss`` over the (8192, 50257) logits),
   AdamW lr 3e-4 weight decay 0.1, 20 steps on the default kernel route:
   ``TrainStep`` in bf16 and f32, bf16 under ``remat="full"`` and
   ``remat="dots_saveable"``, ``gluon.Trainer`` in bf16, and
   ``TrainStep`` over ``gpt_small(dtype="float16")`` (f16 weights, f32
   LayerNorm parameters and optimizer state; held to `gpt_tol` with f16's
   own one-ulp floor; flash, cross-entropy and the norm counted under
   float16, the chunk once under float16 and once under float32 a step;
   the share of f16 gradient elements that are zero after step 1's
   backward reported for the run and its oracle).  Launches a
   step are exact (flash forward 6, 12 under remat; backward 6;
   cross-entropy 1 + 1; fused norm 13, 25 under remat; the chunk once per
   dtype group); each trajectory is held against the same run on the plain
   versions (`traj_tol`; a remat run shares the bf16 run's oracle, the
   plain math being the same with or without remat), the loss falls,
   each remat run is within 1e-5 of the bf16 run without remat and lower
   in peak memory; two planted faults
   (every attention non-causal; a remat recompute that does not put the
   dropout generators back) must depart by more than their limits.  The
   f16 run's step 1 is held to its oracle's (`gpt_step1_check`: the
   update fed the same gradients, exact; the AdamW state in the L2 norm
   within `gpt_step1_limit`); two f16 controls (`GPT_F16_FAULTS`: every
   attention non-causal, AdamW without its bias correction) are reported
   against the f16 trajectory limit and must fail the step-1 check; the
   f16 model also trains on the reference route (statistics in f16): its
   losses finite and falling.  Prints tokens/s, step ms, TFLOP/s
   (``GPTForCausalLM.flops_per_token``: the causal half counted, a mean
   key span of (L + 1) / 2) and the share of the dense bf16 peak.
15. (gpt_gqa) the gpt phase's model, batch and optimizer with Mistral 7B's
   attention (Jiang et al. 2023, Table 1: grouped K/V, a one-sided
   sliding window, RoPE) at GPT-2 small's widths and 6 of its 12 layers
   (`ARCH_LAYERS`), ``GQA_ARCH``: RoPE, 3 kv heads for the 12 query
   heads, window 256; 20 steps through ``TrainStep`` in bf16 and f32 and
   ``gluon.Trainer`` in bf16, flash one launch a layer each way a step
   (the band and the fold inside the kernels), each
   trajectory held to its plain oracle (`gpt_tol`, the bf16 floor measured
   for this model), two planted faults in f32 (the kernels without the
   window; their masks reading the folded row instead of its position)
   that must depart from the f32 oracle by more than 1e-4; then the model
   in f32 served as phase 3
   serves (streams equal to the plain engine's) and four prompts through
   ``generate(use_cache=False)`` (the folded windowed flash forward over
   the whole context) equal to the cached stream.
16. (gpt_d256) the gpt phase's model, batch and optimizer with Gemma 2B's
   attention (Gemma Team 2024, arXiv 2403.08295, Table 1: head size 256,
   one kv head, RoPE) at GPT-2 small's widths and 6 of its 12 layers
   (`ARCH_LAYERS`), ``D256_ARCH``: 3 query heads of 256 over one kv head,
   RoPE; 20 steps through ``TrainStep`` in bf16 and f32, ``gluon.Trainer``
   in bf16 and ``TrainStep`` in bf16 under ``remat="full"``, flash one
   launch a layer each way a step (the forward twice under remat),
   each trajectory held to its plain oracle (`gpt_tol`, the bf16 floor
   measured for this model), remat within 1e-5 of no remat, two planted
   faults in f32 (the kernels see only the first 128 columns of q, k and
   v; the kernels get a softmax scale of 1 / sqrt(128)) that must depart
   from the f32 oracle by more than 1e-4; then the model in f32 served as
   phase 3 serves (K1 at D 256 over one kv head; streams equal to the
   plain engine's) and four prompts through ``generate(use_cache=False)``
   equal to the cached stream and to the plain engine's.  Prints its
   seconds.
17. (spec_prefix) ``gpt_small(dropout=0.0)`` in f32 served through
   ``ServeConfig(max_slots=8, max_len=512, page_size=16, prefill_chunk=16,
   spec_tokens=4, prefix_cache=True)``: one primer request (a 100-token
   prefix) run to idle, then 16 greedy requests extending it with
   distinct periodic suffixes of 8-64 tokens and 2 sampled ones
   (temperature 1.0), 32 new tokens each, arriving as in phase 3.  K1
   launches 12 times a fused step, verify-width (C=5) steps among them;
   the accept rate, prefix hits and COW forks are above 0; the sampled
   slots draft nothing; after ``drain()`` and ``prefix_index.clear()``
   every page is free.  The greedy streams are held, near ties aside, to
   the same engine with neither feature and to the plain engine with
   both; a planted fault (``copy_page`` a no-op) must change a stream.
   The same drive with speculation alone, the cache alone and neither
   gives tokens/s with speculation on and off and TTFT with the cache on
   and off.  Then both features over an int8 KV pool: K1's int8 variant
   12 times a fused step, a COW fork (the scale planes copied with the
   rows), streams held to the plain int8 engine's, near ties aside.
   Then ``generate(num_beams=4, eos_token_id=...)`` on two
   32-token prompts, 16 new tokens, equal to the same call on a CPU copy
   of the model, or apart only where the two winners' length-normalised
   scores (one ``forward``) are within 1e-4.
18. (nmt) ``transformer_base()`` (Vaswani et al. 2017, Table 3 "base":
   d_model 512, 6 + 6 layers, 8 heads, d_ff 2048, vocabularies 32000;
   pre-LN; seed 0, dropout 0.1) on a seeded batch of 32 sources of 128
   tokens padded by ``src_valid_length`` (64-128) and 96 target tokens:
   20 Adam steps (lr 1e-4) through ``TrainStep`` in f32 and bf16, each
   trajectory held to the plain route's within `nmt_tol` (the larger of
   `traj_tol` and ten one-ulp floors measured in the same call: the run
   is chaotic even in f32), a planted fault (the decoder's self-attention
   non-causal) departing by more; flash 18 + 18 launches a
   step (encoder, decoder causal, cross-attention), the norm 32, the
   cross-entropy 1 + 1, the chunk once per dtype group; then
   ``greedy_translate(max_len=32)`` of 8 sources against the plain route,
   near ties aside.  Prints step ms, target tokens/s and TFLOP/s from
   `nmt_flops_per_step`.
19. (optim) the train phase's BERT-base step (full width, 4 of its 12
   layers, `OPTIM_LAYERS`; the default route) under the chunk kernel's six
   new rules (`OPTIM_RULES`: NAG, Signum with and without momentum,
   AdaBelief, Adamax, AdaDelta, FTML), 20 steps each through ``TrainStep``
   in bf16 and f32, and NAG and AdaDelta through the gluon ``Trainer``
   (bf16 model, bf16 state) under a ``CosineScheduler`` with linear warmup,
   the rate each step used recorded beside the scheduler's. Each run is
   held to its oracle, the same step with only the optimizer kernel
   replaced by its plain version (``update=kernel_plain``; the `Trainer`'s
   update the same way): the weights and state after the first step (the
   same gradients on both sides) within `_opt_err`'s limits, the loss
   trajectory within `traj_tol`; launches exact (the chunk once per dtype
   group a step, none in the oracle), the loss falls. The per-leaf rules
   (`OPTIM_PER_LEAF`: LARS, AdaGrad, GroupAdaGrad, RMSProp, Ftrl, LANS
   through ``TrainStep``; Nadam, SGLD, DCASGD, which it refuses by name,
   through the ``Trainer``) run 3 steps each: finite losses, no optimizer
   kernel, state in the declared dtypes. Two planted faults
   (`OPTIM_FAULTS`), each a copy of the kernel's source with one mutation
   built beside the kernels — AdaDelta without the 16-bit rounding of
   ``acc_delta + eps`` (through the ``Trainer``'s bf16 state) and FTML with
   its v and z slots exchanged — must each fail the first-step check or the
   trajectory.  Then LAMB over BERT-base in f16 (`OPTIM_F16`, f32 state)
   through ``TrainStep``: phases A and B once under float16 and once under
   float32 a step, held to its oracle as the rules above (`traj_tol`
   1e-3).
20. (amp) the train phase's BERT-base configuration (full width and depth,
   seed 0, 64 x 128, 20 masked, dropout 0.1, Adam lr 1e-4, 20 steps) under
   mixed precision (`AMP_RUNS`): fp16 AMP over f32 weights through the
   gluon ``Trainer`` with ``amp.init_trainer`` and the user's loop (``with
   amp.scale_loss(loss, trainer) as s: s.backward()``, then
   ``trainer.step(1)``); the same with the weights cast to f16
   (``amp.convert_hybrid_block``) and ``multi_precision=True``; bf16 AMP
   over f32 weights through ``TrainStep``.  The fp16 runs' loss is
   multiplied by inf at step `AMP_POISON_STEP` (JAX's overflow drill).
   Launches exact by kernel and input dtype (`amp_want_launches`: flash
   and cross-entropy in the AMP dtype, the norm in f32, the chunk once an
   applied step, none under ``multi_precision``); each run against its
   oracle (the plain versions behind the same casts, no launch): the loss
   trajectory within the larger of 1e-3 and ten one-ulp floors measured
   in the same call (one weight element one AMP-dtype ulp away), the same
   skipped steps (the poisoned one among them), the weights in their
   declared dtypes with f32 masters under ``multi_precision``, the loss
   falls; a planted fault (the ``Trainer`` applying an overflowed step)
   must fail the gate.  Prints samples/s, step ms, peak memory, the loss
   scales and the skipped steps.  k3 and k4 hold the f16 kernels at
   BERT's and GPT-2's shapes and at D 256 (`FLASH_F16`, f16 `XENT_SHAPES`)
   within 5e-3 of the output scale, beside SDPA and ``cross_entropy`` on
   the f16 inputs.
21. (gluon) the Gluon front end, through the examples' ``mx.np`` code as
   written (``mx.np.array`` batches, ``loss.backward()`` on the per-sample
   loss, ``.asnumpy()`` reads): ``examples/bert_finetune.py``'s
   ``BertClassifier`` with ``BertModel(bert_base())`` as its direct child
   ``bert`` (full width and depth, seed 0, N(0, 0.02), dropout 0.1), the
   backbone a ``BertModel`` written by ``save_parameters`` and read back
   by ``net.bert.load_parameters`` bit for bit,
   ``hybridize()``, 8 steps of 32 x 128 (valid_length in [102, 128])
   under ``autograd.record`` with ``SoftmaxCrossEntropyLoss`` and
   ``gluon.Trainer(net.collect_params(), "adam")`` with the layer-wise
   ``lr_mult`` and a warm-up ``PolyScheduler``, ``metric.Accuracy`` and
   ``metric.F1`` each step (held to numpy on the same predictions);
   launches a step exact (flash 12 + 12, the norm 25, the cross-entropy
   1 + 1, no chunk: the per-parameter route); losses and each weight
   tensor (L2) within `traj_tol` of the same loop on the plain versions.
   Then ``examples/quantization_int8.py``'s MLP at BERT's FFN widths
   (768 -> 3072 -> LayerNorm -> 768 -> 2): 20 Adam steps through the
   ``Trainer`` (the chunk, the norm and the cross-entropy once a step),
   ``quantize_net`` after 4 calibration batches, naive then entropy: K2 3
   times a forward, the output within 1e-4 of its scale of the same net on
   the plain route, the f32 / int8 agreement printed; under
   ``MXTPU_QUANT_ACT=1`` no K2.  Card cases no other phase has: the
   cross-entropy at 2 and 3 classes, K2 at the MLP's three products
   (timed beside cuBLAS and the bound) and at N = 2, K = 16.
22. (gluon_gpt) the models as Gluon blocks, through the Gluon calls of
   ``examples/gpt_generation.py`` and ``examples/serve_gpt.py`` and their
   ``mx.np`` code as written: (a) the example as written, both its
   configurations (V 64, hidden 64, 2 layers; classic, and RoPE with 2 kv
   heads and window 8): ``GPTForCausalLM(cfg)``, ``initialize()``, the
   first call, 120 Adam steps at 3e-3 of 8 x 24 grammar tokens through
   ``gluon.Trainer(model.collect_params())`` under ``autograd.record``,
   then greedy (rule accuracy > 0.6), sampled and 4-beam decodes; (b)
   ``gpt_small(dropout=0.1, dtype="bfloat16")`` (124 M, no cut) built and
   trained the same way, Adam 1e-4 over 20 batches of 8 x 1024 grammar
   tokens, against its plain twin (`_plain_twin`, the plain loss and
   update) within `gpt_tol` (the gpt phase's bf16 one-ulp floor, measured
   at that phase's depth), step 1 by `gpt_step1_check` at bf16's
   limit, launches a step exact (flash 12 + 12, the norm 25, the
   cross-entropy 1 + 1, the chunk 2), greedy and 4-beam decodes equal to
   the twin's over the trained weights, and ``save_parameters`` into a
   fresh model, ``initialize()``, ``load_parameters``: logits bit-equal;
   the same 20 steps again fed raw tensors in place of the arrays (the
   loop before the array front end), from the same seed and batches: the
   largest loss difference and bit equality printed, the losses
   bit-equal (so within `gpt_tol`), the launches equal;
   (c) ``examples/serve_gpt.py``'s engine (2 slots, 6 pages of 4) over
   that Block: its six prompts, at least one eviction, every stream equal
   to an unbatched ``generate`` (near ties of the plain path aside), K1
   12 times a fused step.  The example's telemetry snapshot waits for
   ROADMAP.md A14 part 2.
23. (np) the tensor front end on the card: ``npx.layer_norm``,
   ``layer_norm_residual`` and ``rms_norm`` on 8 x 1024 x 768,
   ``npx.softmax_cross_entropy`` on (8192, 50257) logits,
   ``npx.multi_head_attention`` at GPT-2 small's (8 x 1024 x 768, 12
   heads, causal) and gpt_gqa's (3 kv heads, window 256, RoPE), f32 and
   bf16, forward and backward through ``attach_grad`` / ``record`` /
   ``backward``, each against its plain version on the same inputs within
   ``TOL`` with its launches exact (the norm once, the cross-entropy and
   flash kernels once each way); a two-layer MLP (768 -> 3072 -> 10)
   written in ``mx.np`` alone (``np.dot``, ``np.maximum``,
   ``npx.log_softmax``, ``npx.pick``, 20 steps of SGD over ``w.grad``)
   against the same program on raw tensors within f32's ``TOL``; the
   front end's host µs an op (``a + b`` on arrays and ``np.add``) beside
   the bare torch op over the same 1000 calls.
24. (elastic) ``examples/bert_pretraining.py``'s loop on the port:
   ``PretrainNet`` over BERT-base in bf16 (full width and depth, seed 0,
   dropout 0.1 from the model's generator), Adam lr 1e-4 through
   ``make_train_step``, 8 x 128 with 20 masked positions, 12 seeded
   batches with a NaN planted in the loss at step 5, health and recovery
   on (`ELASTIC_*`).  The plane's cost: the 12 steps on a step built with
   it off and on one built with it on, in turns (off, on, on, off; host
   clock over steps 3-12), the CUDA kernels a step each way
   (``torch.profiler``), the FLOPs `tracing.FlopCount` counted at warmup
   beside `bench_flops_per_step` and the ``mfu_estimate``; the first "on"
   run is the reference R, and R again from the seed must be bit-equal.
   Then R under ``ElasticLoop(save_every=4, keep=2, async_save=True)``:
   step 5's dispatch under ``torch.cuda.set_sync_debug_mode("error")``,
   its probes reading non-finite gradients and every weight and Adam
   state bit-equal to step 4's, one tier-1 skip; a real SIGTERM after
   step 7 (status ``preempted``, checkpoint and resume marker at 7); a
   fresh step and loop that resume at 7, meet an injected failure at step
   9 and restore step 8, ending bit-equal to R, the chunk 2 launches a
   step over the 12 dispatched; the saves' ms from the run journal and
   the checkpoint's bytes; one byte flipped in the newest checkpoint:
   quarantined, the restore lands on the one before.  The plane is off
   again after the phase.

Every count is reset just before a run it reports and read just after.
The last three stdout lines are the ``nvidia-smi`` card line, the
``kernels`` JSON and ``{"ok": true, "device": {...}}``; the full per-case
results go to ``--out``.  Any failed phase exits non-zero without
that last line; so does a machine without a CUDA device, or a directory
that holds this script alone.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
GAP = 1e-4            # near-tie threshold on the plain path's top-2 gap
# max-abs / output scale; f16 keeps 3 more mantissa bits than bf16
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3}
HBM_BPS = 3.35e12     # H100 SXM HBM3
# FMA f32 / dense bf16 tensor cores / two TF32 tensor-core products a
# multiply-add (f32 x split hi + lo, K2's exact f32 route): half of 495 /
# three (both operands split, 3xTF32: the flash backward's f32 route): a
# third of 495
PEAK = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
        "tf32x2": 247.5e12, "tf32x3": 165e12}
TRAIN_STEPS = 20
OPT_RTOL = 1e-5       # optimizer kernels vs plain, of each tensor's scale
OPT_MISMATCH = 1e-4   # share of bf16 weight elements off the plain value


def traj_tol(dtype, route):
    """Loss trajectory limit, relative, kernel step vs its plain oracle.
    f32 on either route, and bf16 on the reference route (f32 activations
    after the first LayerNorm): the sound runs deviate by at most 1.3e-7
    and 1.6e-6, so 1e-4.  bf16 on the kernel route keeps bf16 activations,
    where a kernel and its plain version round differently and one changed
    rounding spreads through every later layer: the sound runs reach 1.4e-4
    in 20 steps, so 1e-3 there; f16 weights and activations (the optim
    phase's f16 LAMB run) are held to the same 1e-3.  The train phase's
    controls (planted faults, `TRAIN_FAULTS`) show every run how far above
    it a wrong kernel lands."""
    return 1e-3 if dtype in ("bfloat16", "float16") and \
        route != "reference" else 1e-4


def traj_dev(losses, oracle):
    """Largest relative departure of a loss trajectory from its oracle's
    (infinite where a loss is not finite)."""
    return max(abs(a - b) / abs(b) if math.isfinite(a - b) else math.inf
               for a, b in zip(losses, oracle))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

SLEEP_CYCLES = 400_000    # ~0.2 ms of device time at the H100's clocks


def time_ms(fn, iters=30, warm=3, device_only=False):
    """Median time of one call (CUDA events around each call), with the
    50 MB L2 flushed before each: the serving loop finds weights and K/V
    pages cold, so a timing that reuses warm inputs would flatter.  The
    start event is recorded on the host after the flush is enqueued, so a
    call whose host time outlasts the flush (~80 us) shows that excess too.
    ``device_only`` sleeps the card after the flush, long enough that the
    host has enqueued the call before the start event runs: the events
    then time the device's work alone."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in evs)
    return ts[len(ts) // 2]


def host_us(fn, iters=100, repeats=5):
    """Host microseconds of one call: the host clock over `iters` calls
    enqueued behind a device sleep (so no call waits on the card), the
    least of `repeats` such loops."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda._sleep(50 * SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return best


def bound(nbytes, flops, dtype):
    """Least time (ms) for the work: bytes over HBM rate vs operations
    over the peak rate of the input type; whichever is larger."""
    tb = nbytes / HBM_BPS * 1e3
    to = flops / PEAK[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# (query dtype, pool dtype): each route, and f32 queries over a bf16 pool
# (a bf16 model's serving step: f32 activations after the first LayerNorm)
K1_TYPES = (("float32", "float32"), ("bfloat16", "bfloat16"),
            ("float32", "bfloat16"))
K1_VERIFY_C = 5       # spec_prefix's verification width, spec_tokens 4 + 1


K1_B, K1_PS, K1_MAXP = 8, 16, 32   # slots, page size, table entries
K1_START = (0, 37, 100, 255, 300, 0, 470, 16)
# the wide heads: (D, H, kv heads, C) -- gpt_d256's serving (3 heads
# of 256 over one kv head) at decode and at the prefill chunk, Gemma 2B's
# 8 query heads over one kv head at decode, and two widths that are not a
# multiple of 16 (72, 24) at decode; each f32 and bf16, no window
K1_WIDE = ((256, 3, 1, 1), (256, 3, 1, 16), (256, 8, 1, 1), (72, 12, 12, 1),
           (24, 12, 12, 1))
# a long context: 8 slots decoding at position 4095 of 4096-token tables
# (GPT-2 small's heads), where the f32 pool moves ~201 MB a call and the
# int8 one ~53 MB
K1_LONG_MAXP = 256
K1_LONG_START = (4095,) * 8
# the int8 pool's query dtypes: f32 (a f32 model's step) and bf16
K1_INT8_Q = ("float32", "bfloat16")
# (query dtype, pool dtype) over an f16 pool: f32 queries (type 5, an f16
# model's serving step) and f16 queries (type 6, JAX's kernel on f16
# inputs)
K1_F16_TYPES = (("float32", "float16"), ("float16", "float16"))


def k1_cases(dev):
    """K1 at the main path's shapes: 8 slots, 12 heads, D 64, page 16, a
    257-page pool, 32 table entries per slot (max_len 512); f32 queries
    over a bf16 pool at GPT-2's MHA, no window, held to the bf16
    tolerance; and the spec_prefix phase's verification width C = 5
    (`K1_VERIFY_C`), f32 and bf16, MHA and GQA rep 4, where slot 4's table
    shares its first 7 pages with slot 2's (a cached prefix attached to
    two sequences), so the bound counts each shared K/V row once; then
    the wide heads of `K1_WIDE`."""
    import numpy as np
    rng = np.random.RandomState(0)
    out = []
    for dtype, pool in K1_TYPES:
        mixed = pool != dtype
        for C in (1, 16) if mixed else (1, K1_VERIFY_C, 16):
            verify = C == K1_VERIFY_C
            for Hkv in (12,) if mixed else (12, 3):
                for window in (None,) if mixed or verify else (None, 64):
                    out.append(_k1_case(dev, rng, dtype, pool, C, 12, Hkv,
                                        64, window, verify))
    for D, H, Hkv, C in K1_WIDE:
        for dtype in ("float32", "bfloat16"):
            out.append(_k1_case(dev, rng, dtype, dtype, C, H, Hkv, D, None,
                                False))
    # the long context, f32 pool: the int8 variant's yardstick (k1_int8)
    out.append(_k1_case(dev, rng, "float32", "float32", 1, 12, 12, 64, None,
                        False, long=True))
    return out


def k1_int8_cases(dev):
    """K1's int8 variant (an int8 pool with one f32 scale a stored
    vector, `quantize_kv` of seeded f32 pools) at the main path's shapes:
    f32 and bf16 queries (`K1_INT8_Q`) at decode C = 1, the verification
    width C = 5 and the prefill chunk C = 16, MHA and GQA rep 4, with and
    without a window of 64; the wide heads of `K1_WIDE` at decode (D 256
    at 3 and 8 heads over one kv head, D 72 and 24); and the long context
    (`K1_LONG_MAXP`).  Each held to the plain version with scales at the
    query dtype's tolerance, timed beside SDPA over a dequantized copy of
    the context in the query dtype."""
    import numpy as np
    rng = np.random.RandomState(8)
    out = []
    for dtype in K1_INT8_Q:
        for C in (1, K1_VERIFY_C, 16):
            for Hkv in (12, 3):
                for window in (None, 64):
                    out.append(_k1_case(dev, rng, dtype, "int8", C, 12, Hkv,
                                        64, window, C == K1_VERIFY_C))
        for D, H, Hkv, C in K1_WIDE:
            if C == 1:
                out.append(_k1_case(dev, rng, dtype, "int8", C, H, Hkv, D,
                                    None, False))
        out.append(_k1_case(dev, rng, dtype, "int8", 1, 12, 12, 64, None,
                            False, long=True))
    return out


def k1_f16_cases(dev):
    """K1 over an f16 pool (`K1_F16_TYPES`) at the main path's shapes:
    decode C = 1, the verification width C = 5 over a shared prefix and
    the prefill chunk C = 16, MHA and GQA rep 4, with and without a window
    of 64; then D 256 at 3 heads over one kv head, C = 1 and 16.  f32
    queries are held to the f32 tolerance (f16 K/V widen exactly into the
    f32 route's arithmetic), f16 queries to f16's; SDPA over the pages
    gathered in the query's dtype beside each."""
    import numpy as np
    rng = np.random.RandomState(16)
    out = []
    for dtype, pool in K1_F16_TYPES:
        for C in (1, K1_VERIFY_C, 16):
            for Hkv in (12, 3):
                for window in (None, 64):
                    out.append(_k1_case(dev, rng, dtype, pool, C, 12, Hkv,
                                        64, window, C == K1_VERIFY_C))
        for C in (1, 16):
            out.append(_k1_case(dev, rng, dtype, pool, C, 3, 1, 256, None,
                                False))
    return out


def _k1_case(dev, rng, dtype, pool, C, H, Hkv, D, window, verify,
             long=False):
    """One K1 case: seeded queries and pools from `rng`, the kernel against
    its plain version over the valid rows, two calls bit-equal, timed
    beside SDPA over a pre-gathered, head-expanded context, with the
    bound of the bytes and products this data needs.  ``pool="int8"``
    quantizes seeded f32 pools (`quantize_kv`) and passes the scale planes
    (K1's int8 variant, held to the query dtype's tolerance; the context
    SDPA reads is dequantized); ``long`` takes `K1_LONG_MAXP` pages a slot,
    every slot decoding at `K1_LONG_START`."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.contrib.quantization import quantize_kv
    from mxnet_tpu_torch.ops import paged_attention as pa

    B, ps = K1_B, K1_PS
    maxp = K1_LONG_MAXP if long else K1_MAXP
    npages = B * maxp + 1
    start = np.array(K1_LONG_START if long else K1_START, np.int32)
    quantized = pool == "int8"
    dt = getattr(torch, dtype)
    pdt = torch.float32 if quantized else getattr(torch, pool)
    nt = np.ones(B, np.int32) if long else \
        np.array([C, C, min(C, 5), C, 1, 0, C, C], np.int32)
    ctx = start + nt
    q = torch.from_numpy(rng.randn(B, H, C, D).astype(
        np.float32)).to(dev, dt)
    kp = torch.from_numpy(rng.randn(npages, ps, Hkv, D)
                          .astype(np.float32)).to(dev, pdt)
    vp = torch.from_numpy(rng.randn(npages, ps, Hkv, D)
                          .astype(np.float32)).to(dev, pdt)
    sc = {}
    if quantized:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        sc = dict(k_scales=ks, v_scales=vs)
    pt_np = (rng.permutation(npages - 1) + 1).reshape(
        B, maxp).astype(np.int32)
    if verify:
        pt_np[4, :7] = pt_np[2, :7]    # a shared prefix
    pt = torch.from_numpy(pt_np).to(dev)
    ctx_t = torch.from_numpy(ctx).to(dev)
    st_t = torch.from_numpy(start).to(dev)
    args = (q, kp, vp, pt, ctx_t, st_t)
    got = pa.ragged_paged_attention(*args, window=window, **sc)
    ref = pa.paged_attention_reference(*args, window=window, **sc)
    torch.cuda.synchronize()
    err = scale = 0.0
    for b in range(B):
        n = int(nt[b])
        if n == 0:
            continue
        d = (got[b, :, :n].float() - ref[b, :, :n].float())
        err = max(err, float(d.abs().max()))
        scale = max(scale, float(ref[b, :, :n].float().abs().max()))
    # library yardstick: SDPA over a pre-gathered, head-expanded (and
    # dequantized) context with the same boolean mask
    L = maxp * ps
    kc = pa.gather_pages(kp, pt, sc.get("k_scales")).permute(0, 2, 1, 3)
    vc = pa.gather_pages(vp, pt, sc.get("v_scales")).permute(0, 2, 1, 3)
    kc = kc.repeat_interleave(H // Hkv, 1).to(dt).contiguous()
    vc = vc.repeat_interleave(H // Hkv, 1).to(dt).contiguous()
    t_idx = torch.arange(L, device=dev)
    qpos = st_t[:, None] + torch.arange(C, device=dev)
    mask = (t_idx[None, None, :] <= qpos[:, :, None]) & \
        (t_idx[None, None, :] < ctx_t[:, None, None])
    if window is not None:
        mask &= t_idx[None, None, :] >= qpos[:, :, None] - window
    mask = mask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    again = pa.ragged_paged_attention(*args, window=window, **sc)
    plan = pa._plan(B, H, Hkv, C, D, ps, maxp, kp.dtype,
                    pa._kernels.sm_count(q.device))
    # an int8 or an f16 pool takes the query's tolerance (f16 K/V widen
    # exactly into f32 queries' arithmetic), a bf16 pool bf16's
    case = dict(dtype=dtype, pool_dtype=pool, C=C, H=H, Hkv=Hkv, D=D,
                window=window, shared_pages=7 if verify else 0,
                context=maxp * ps, plan=dict(plan._asdict()),
                max_abs_err=err, out_scale=scale,
                tol=TOL[dtype if quantized or pool == "float16"
                        else pool] * scale,
                bit_equal_calls=bool(torch.equal(got, again)))
    case["ok"] = err <= case["tol"] and case["bit_equal_calls"]

    def kern():
        return pa.ragged_paged_attention(*args, window=window, **sc)

    def lib():
        return sdpa(q, kc, vc, attn_mask=mask)

    case["ms"] = time_ms(kern)
    case["device_ms"] = time_ms(kern, device_only=True)
    case["host_us"] = host_us(kern)
    case["plain_ms"] = time_ms(
        lambda: pa.paged_attention_reference(*args, window=window, **sc))
    case["library_ms"] = time_ms(lib)
    case["library_device_ms"] = time_ms(lib, device_only=True)
    case["library_host_us"] = host_us(lib)
    case["vs_library"] = case["ms"] / case["library_ms"]
    # the work this data needs: q + the distinct K/V rows below ctx (from
    # the window's floor; a shared page's rows once; an int8 row with its
    # f32 scale) + out + indices
    item = q.element_size()
    pitem = kp.element_size() + (4 / D if quantized else 0)
    keys = len({(int(pt_np[b, p // ps]), p % ps)
                for b, (s, c) in enumerate(zip(start, ctx))
                for p in range(max(0, int(s) - window)
                               if window is not None else 0, int(c))})
    attended = 0
    for s, n in zip(start, nt):
        for c in range(int(n)):
            p = int(s) + c
            lo = max(0, p - window) if window is not None else 0
            attended += p - lo + 1
    nbytes = 2 * q.numel() * item + 2 * keys * Hkv * D * pitem \
        + 4 * (B * maxp + 2 * B)
    flops = 4.0 * attended * H * D
    case["bound_ms"], case["bound_by"] = bound(nbytes, flops, dtype)
    return case


K2_SHAPES = [(2304, 768), (768, 768), (3072, 768), (768, 3072)]
K2_HEAD = (8, 50257, 768)     # the tied LM head at decode, int8 f32


def k2_cases(dev):
    """K2 at GPT-2 small's projection shapes (N, K) for M in {8, 128}, f32,
    bf16 and f16 activations (f16: no serving path sends them, JAX's
    `quantized_matmul` takes them on a direct call), and the tied head's
    (8, 50257, 768) at int8 f32; each with its launch plan, two calls
    bit-equal, and kernel time over library time (cuBLAS in x's dtype over
    a dequantized copy)."""
    import torch
    from mxnet_tpu_torch.ops import quantized_matmul as qm

    g = torch.Generator().manual_seed(1)
    grid = [(bits, dtype, M, N, K) for bits in (8, 4)
            for dtype in ("float32", "bfloat16", "float16") for M in (8, 128)
            for N, K in K2_SHAPES] + [(8, "float32") + K2_HEAD]
    out = []
    for bits, dtype, M, N, K in grid:
        dt = getattr(torch, dtype)
        qt = qm.quantize_weight(
            torch.randn(N, K, generator=g) * 0.02, bits).to(dev)
        x = torch.randn(M, K, generator=g).to(dev, dt)
        got = qm.quantized_matmul(x, qt)
        again = qm.quantized_matmul(x, qt)
        ref = qm.quantized_matmul_reference(x, qt)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        wd = qm.dequantize_weight(qt, dt)
        plan = qm._tuned_plan(M, N, K, bits, dt, x.device)
        case = dict(bits=bits, dtype=dtype, M=M, N=N, K=K,
                    plan=dict(plan._asdict()), max_abs_err=err,
                    out_scale=scale, tol=TOL[dtype] * scale,
                    bit_equal_calls=bool(torch.equal(got, again)))
        case["ok"] = err <= case["tol"] and case["bit_equal_calls"]

        def kern():
            return qm.quantized_matmul(x, qt)

        def lib():
            return x @ wd.T

        case["ms"] = time_ms(kern)
        case["device_ms"] = time_ms(kern, device_only=True)
        case["host_us"] = host_us(kern)
        case["plain_ms"] = time_ms(
            lambda: qm.quantized_matmul_reference(x, qt))
        case["library_ms"] = time_ms(lib)
        case["library_device_ms"] = time_ms(lib, device_only=True)
        case["library_host_us"] = host_us(lib)
        case["vs_library"] = case["ms"] / case["library_ms"]
        nbytes = x.numel() * x.element_size() + qt.nbytes() \
            + M * N * x.element_size()
        # f32 x: the weight is exact in TF32, so two TF32 products (x's hi
        # and lo halves) give the f32 result; that rate bounds it
        case["bound_ms"], case["bound_by"] = bound(
            nbytes, 2.0 * M * N * K,
            "tf32x2" if dtype == "float32" else dtype)
        out.append(case)
        del qt, x, wd, got, again, ref
    return out


# ---------------------------------------------------------------------------
# phases 3-5: the serving main path end to end
# ---------------------------------------------------------------------------

def make_prompts(vocab, n=16, lo=16, hi=256, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, n)
    lens[0], lens[1] = lo, hi             # both ends of the range
    return [rng.randint(0, vocab, int(k)).tolist() for k in lens]


def drive(engine, prompts, max_new, sampled=()):
    """Serve `prompts` with staggered arrivals (a burst of 8, then one
    every other step) so prefill and decode mix and slots churn; the
    prompts whose index is in `sampled` sample at temperature 1.0.
    Returns (streams, stats)."""
    import torch
    handles, step_ms = [], []
    t0 = time.perf_counter()

    def submit(i, p):
        handles.append(engine.submit(p, max_new_tokens=max_new,
                                     greedy=i not in sampled))
    for i, p in enumerate(prompts[:8]):
        submit(i, p)
    arrivals = iter(enumerate(prompts[8:], 8))
    polls = 0
    while True:
        ts = time.perf_counter()
        progressed = engine.step()
        if progressed:
            step_ms.append((time.perf_counter() - ts) * 1e3)
        polls += 1
        if polls % 2 == 0:
            nxt = next(arrivals, None)
            if nxt is not None:
                submit(*nxt)
        if not progressed and len(handles) == len(prompts) and \
                engine.scheduler.queue_depth == 0:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(h.tokens) for h in handles)
    ttft = sorted(h.ttft_s * 1e3 for h in handles)
    st = sorted(step_ms)

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(p * (len(xs) - 1)))]

    stats = dict(generated_tokens=toks, wall_s=wall,
                 tokens_per_s=toks / wall, ttft_p50_ms=pct(ttft, 0.5),
                 ttft_p99_ms=pct(ttft, 0.99), steps=len(step_ms),
                 step_ms_mean=sum(st) / len(st), step_ms_p50=pct(st, 0.5),
                 step_ms_p99=pct(st, 0.99),
                 evictions=sum(h.evictions for h in handles))
    return [h.result(timeout=0) for h in handles], stats


def top2_gap(P, cfg, prefix, kv_int8=False):
    """Top-2 logit gap of the plain path for the token after `prefix`;
    ``kv_int8`` rounds each new K/V row through `quantize_kv`, as an int8
    pool stores it."""
    import torch
    from mxnet_tpu_torch.contrib.quantization import (dequantize_kv,
                                                      quantize_kv)
    from mxnet_tpu_torch.ops.quantized_matmul import matmul_nt_reference
    from mxnet_tpu_torch.serve.decode import (dense_kv_fn, lm_logits,
                                              transformer_step)
    dev = P["embed"].device
    T = len(prefix)
    Hkv = cfg.num_kv_heads or cfg.num_heads
    D = cfg.hidden_size // cfg.num_heads
    with torch.inference_mode():
        tok = torch.tensor([prefix], dtype=torch.int32, device=dev)
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
        kc = torch.zeros((cfg.num_layers, 1, Hkv, T, D),
                         dtype=P["embed"].dtype, device=dev)
        kv = dense_kv_fn(kc, torch.zeros_like(kc), pos, cfg.window)
        if kv_int8:
            dense = kv

            def kv(li, q, k, v):
                k, v = (dequantize_kv(*quantize_kv(x), dtype=x.dtype)
                        for x in (k, v))
                return dense(li, q, k, v)
        h = transformer_step(P, cfg, tok, pos, kv,
                             matmul=matmul_nt_reference)
        logits = lm_logits(P, h[:, -1], matmul=matmul_nt_reference)[0]
        top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


ACT_FLOOR_X = 10    # an int8-activation run's logit limit, in floors
ACT_FORCED = 4      # streams the teacher-forced check reads


def forced_logits(P, cfg, seq, plain, attend=None, nudge=False):
    """The logits at every position of `seq`, fed as one chunk through
    the decode core over a fresh int8 pool: K1's int8 variant and the
    engine's products, or (`plain`) their plain versions.  `attend`
    replaces the attention (a planted fault); ``nudge`` moves every
    layer's attention output one f32 ulp up."""
    import torch
    from mxnet_tpu_torch.ops.paged_attention import (
        paged_attention_reference, ragged_paged_attention)
    from mxnet_tpu_torch.ops.quantized_matmul import (matmul_nt,
                                                      matmul_nt_reference)
    from mxnet_tpu_torch.serve.decode import lm_logits, transformer_step
    from mxnet_tpu_torch.serve.kv_cache import KVPools, make_paged_kv_fn
    dev = P["embed"].device
    T, ps = len(seq), 16
    pages = -(-T // ps)
    pools = KVPools(cfg.num_layers, pages + 1, ps,
                    cfg.num_kv_heads or cfg.num_heads,
                    cfg.hidden_size // cfg.num_heads, torch.int8, dev)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    attend = attend or (paged_attention_reference if plain
                        else ragged_paged_attention)
    if nudge:
        inner = attend

        def attend(*a, **kw):
            c = inner(*a, **kw)
            return torch.nextafter(c, c.new_tensor(math.inf))
    kv = make_paged_kv_fn(pools, i32([list(range(1, pages + 1))]), i32([0]),
                          i32([T]), i32([T]), window=cfg.window,
                          attend=attend)
    mm = matmul_nt_reference if plain else matmul_nt
    with torch.inference_mode():
        h = transformer_step(P, cfg, i32([seq]), i32([list(range(T))]), kv,
                             matmul=mm)
        return lm_logits(P, h[0], matmul=mm).float()


def forced_check(P, cfg, seqs):
    """The gate of an int8-activation run.  Rounding activations to int8
    makes the decode chaotic: one f32 ulp in an attention output can flip
    a rounding, a whole int8 step, and free-running greedy streams part
    at gaps no near-tie rule separates from a wrong kernel.  So the plain
    engine's streams are fed back teacher-forced: the kernel path's logits
    at every position must stay within `ACT_FLOOR_X` floors of the plain
    path's, a floor being how far the plain path's logits move when every
    attention output moves one ulp; a planted fault (V read at the K
    scales) must land outside."""
    from mxnet_tpu_torch.ops.paged_attention import ragged_paged_attention

    def swapped(*a, k_scales=None, v_scales=None, **kw):
        return ragged_paged_attention(*a, k_scales=k_scales,
                                      v_scales=k_scales, **kw)
    floor = dev = ctl = 0.0
    agree = total = 0
    for seq in seqs:
        want = forced_logits(P, cfg, seq, True)
        floor = max(floor, float((forced_logits(P, cfg, seq, True,
                                                nudge=True)
                                  - want).abs().max()))
        got = forced_logits(P, cfg, seq, False)
        dev = max(dev, float((got - want).abs().max()))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
        total += len(seq)
        ctl = max(ctl, float((forced_logits(P, cfg, seq, False,
                                            attend=swapped)
                              - want).abs().max()))
    limit = max(GAP, ACT_FLOOR_X * floor)
    return dict(act_floor=floor, limit=limit, max_logit_dev=dev,
                argmax_agree=agree / total, control_v_scales_from_k=ctl,
                ok=dev <= limit, control_caught=ctl > limit)


def compare_streams(got, want, P, cfg, what, kv_int8=False):
    """Every stream in `got` equals `want`, except where the plain path's
    top-2 gap at the first differing token is below GAP (over int8 K/V
    for an int8 pool's streams).  Returns the number of such accepted
    near-tie divergences; raises on any other."""
    near = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        k = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        gap = top2_gap(P, cfg, w[:k], kv_int8)
        if gap >= GAP:
            raise AssertionError(
                f"{what}: stream {i} diverges at token {k} ({g[k]} vs "
                f"{w[k]}) where the plain path's top-2 gap is {gap:.3g} "
                f">= {GAP}")
        near += 1
    return near


def serve_phase(model, prompts, max_new, quant_bits, check_generate=False,
                kv_dtype="", act_thresholds=None):
    """Kernel engine vs plain-version engine on the same weights; the
    pool's dtype is the model's unless `kv_dtype` says ``"int8"``;
    `act_thresholds` go to both engines."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig

    def engine(plain):
        sc = ServeConfig(max_slots=8, max_len=512, page_size=16,
                         prefill_chunk=16, quant_bits=quant_bits,
                         kv_dtype=kv_dtype)
        eng = InferenceEngine(model, sc, device=model.device, seed=0,
                              act_thresholds=act_thresholds,
                              plain_ops=plain)
        eng.warmup()
        return eng

    eng = engine(False)
    kernels.reset_launch_counts()
    streams, stats = drive(eng, prompts, max_new)
    launches = kernels.launch_counts()
    by_dtype = {f"{n}:{d}": v
                for (n, d), v in sorted(kernels.DTYPE_LAUNCHES.items())}
    fused = eng.stats()["steps_executed"]
    stats.update(launches=launches, dtype_launches=by_dtype,
                 fused_steps=fused,
                 weight_bytes=eng.weight_bytes(), quant_bits=quant_bits,
                 bonus_pages=eng.bonus_pages,
                 kv_dtype=eng.stats()["kv_dtype"],
                 pool_bytes=eng.pools.nbytes(),
                 pool_pages=eng.allocator.num_pages,
                 page_bytes=eng._page_nbytes(),
                 kv_bytes_per_token=eng._page_nbytes()
                 // eng.serve_config.page_size,
                 act_quant=bool(os.environ.get("MXTPU_QUANT_ACT")))
    del eng
    plain = engine(True)
    pstreams, pstats = drive(plain, prompts, max_new)
    stats["plain_tokens_per_s"] = pstats["tokens_per_s"]
    stats["plain_step_ms_mean"] = pstats["step_ms_mean"]
    return streams, pstreams, plain, stats


# phase 4b's runs: (results key, quant_bits, MXTPU_QUANT_ACT at
# calibrated thresholds)
INT8_SERVE_RUNS = (("int8_kv", 0, False), ("int8_kv_act8", 8, True))
INT8_SERVE = tuple(k for k, _, _ in INT8_SERVE_RUNS)
CALIB_PROMPTS = dict(n=4, seed=7)    # held-out prompts for the calibrator


def calibrate(model, prompts):
    """Activation thresholds of every projection, as a user calibrates
    for ``MXTPU_QUANT_ACT``: a naive `LayerCalibrator` over the input
    each projection sees in the plain decode core (a dense cache) over
    `prompts`, keyed ``layers.<i>.<name>``."""
    import torch
    from mxnet_tpu_torch.contrib.quantization import LayerCalibrator
    from mxnet_tpu_torch.serve.decode import (dense_kv_fn,
                                              extract_decode_weights,
                                              transformer_step)
    cfg = model.cfg
    P = extract_decode_weights(model)
    Hkv = cfg.num_kv_heads or cfg.num_heads
    cal = LayerCalibrator()

    def observing(names):
        def mm(x, w):
            cal.observe(next(names), x)
            return x @ w.T
        return mm

    for p in prompts:
        T = len(p)
        tok = torch.tensor([p], device=model.device)
        pos = torch.arange(T, device=model.device)[None]
        kc = torch.zeros((cfg.num_layers, 1, Hkv, T,
                          cfg.hidden_size // cfg.num_heads),
                         device=model.device)
        names = iter(f"layers.{i}.{k}" for i in range(cfg.num_layers)
                     for k in ("wqkv", "wo", "w1", "w2"))
        with torch.inference_mode():
            transformer_step(P, cfg, tok, pos, dense_kv_fn(
                kc, torch.zeros_like(kc), pos, cfg.window),
                matmul=observing(names))
    return cal.thresholds()


@contextlib.contextmanager
def env(**kw):
    """Set (a value) or unset (None) environment variables for a block."""
    old = {k: os.environ.get(k) for k in kw}
    try:
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_e2e(dev, results):
    import torch
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small

    cfg = gpt_small(dropout=0.0)
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    prompts = make_prompts(cfg.vocab_size)
    max_new = 32
    L = cfg.num_layers

    # phase 3: dense f32
    streams, pstreams, plain, st = serve_phase(model, prompts, max_new, 0)
    f32_streams = streams
    if st["launches"]["ragged_paged_attention"] != L * st["fused_steps"]:
        raise AssertionError(
            f"K1 launched {st['launches']['ragged_paged_attention']} times "
            f"over {st['fused_steps']} fused steps (want {L} per step)")
    st["near_ties_vs_plain"] = compare_streams(streams, pstreams, plain.P,
                                               cfg, "f32 kernel vs plain")
    gen = [model.generate(torch.tensor([p]), max_new_tokens=max_new)[0]
           .tolist() for p in prompts]
    st["near_ties_vs_generate"] = compare_streams(
        streams, gen, plain.P, cfg, "f32 engine vs generate")
    for s, p in zip(streams, prompts):
        if len(s) != len(p) + max_new or not all(
                0 <= t < cfg.vocab_size for t in s):
            raise AssertionError("malformed stream")
    results["e2e"]["float32"] = st
    print(f"[e2e f32] {json.dumps(st)}", flush=True)
    del plain

    # phase 4: int8 and int4 weights
    for bits in (8, 4):
        streams, pstreams, plain, st = serve_phase(model, prompts, max_new,
                                                   bits)
        if st["launches"]["quantized_matmul"] <= 0:
            raise AssertionError(f"K2 never launched at quant_bits={bits}")
        if st["launches"]["ragged_paged_attention"] != L * st["fused_steps"]:
            raise AssertionError(f"K1 launch count off at int{bits}")
        st["near_ties_vs_plain"] = compare_streams(
            streams, pstreams, plain.P, cfg, f"int{bits} kernel vs plain")
        results["e2e"][f"int{bits}"] = st
        print(f"[e2e int{bits}] {json.dumps(st)}", flush=True)
        del plain

    # phase 4b: the int8 KV pool (K1's int8 variant), alone and with int8
    # weights under int8 activations at calibrated thresholds (no K2).  A
    # dynamic amax a call is taken over every row of the batch, padded
    # rows too, where K1 writes zeros for a row with no key and the plain
    # version an average: the two engines would round real rows at
    # different scales.
    thresholds = calibrate(model, make_prompts(cfg.vocab_size,
                                               **CALIB_PROMPTS))
    for key, bits, act in INT8_SERVE_RUNS:
        with env(MXTPU_QUANT_ACT="1" if act else None):
            streams, pstreams, plain, st = serve_phase(
                model, prompts, max_new, bits, kv_dtype="int8",
                act_thresholds=thresholds if act else None)
            st["calibrated_thresholds"] = len(thresholds) if act else 0
            n = st["launches"]
            if n["ragged_paged_attention_int8"] != L * st["fused_steps"] \
                    or n["ragged_paged_attention"]:
                raise AssertionError(
                    f"{key}: K1's int8 variant launched "
                    f"{n['ragged_paged_attention_int8']} times (float K1 "
                    f"{n['ragged_paged_attention']}) over "
                    f"{st['fused_steps']} fused steps (want {L} a step)")
            if act and n["quantized_matmul"]:
                raise AssertionError(f"{key}: K2 launched "
                                     f"{n['quantized_matmul']} times under "
                                     f"MXTPU_QUANT_ACT")
            st["equal_streams_vs_plain"] = sum(
                a == b for a, b in zip(streams, pstreams))
            if act:
                st["forced"] = f = forced_check(plain.P, cfg,
                                                pstreams[:ACT_FORCED])
                if not (f["ok"] and f["control_caught"]):
                    raise AssertionError(f"{key}: teacher-forced logits "
                                         f"{json.dumps(f)}")
            else:
                st["near_ties_vs_plain"] = compare_streams(
                    streams, pstreams, plain.P, cfg,
                    f"{key} kernel vs plain", kv_int8=True)
        for s_, p in zip(streams, prompts):
            if len(s_) != len(p) + max_new or not all(
                    0 <= t < cfg.vocab_size for t in s_):
                raise AssertionError(f"{key}: malformed stream")
        # reported, not gated: how far int8 storage moves the f32 streams
        gen = [(a[len(p):], b[len(p):])
               for a, b, p in zip(streams, f32_streams, prompts)]
        st["equal_token_share_vs_f32"] = sum(
            x == y for a, b in gen for x, y in zip(a, b)) / sum(
            len(a) for a, _ in gen)
        st["f32_pool_bytes"] = results["e2e"]["float32"]["pool_bytes"]
        st["f32_tokens_per_s"] = results["e2e"]["float32"]["tokens_per_s"]
        results["e2e"][key] = st
        print(f"[e2e {key}] {json.dumps(st)}", flush=True)
        del plain
    del model
    torch.cuda.empty_cache()

    # phase 5: bfloat16 (no equality demanded)
    cfg16 = gpt_small(dropout=0.0, dtype="bfloat16")
    model16 = GPTForCausalLM(cfg16, device=dev, seed=0)
    streams, pstreams, plain, st = serve_phase(model16, prompts, max_new, 0)
    st["equal_stream_share"] = sum(a == b for a, b in zip(
        streams, pstreams)) / len(streams)
    results["e2e"]["bfloat16"] = st
    print(f"[e2e bf16] {json.dumps(st)}", flush=True)
    del model16, plain
    torch.cuda.empty_cache()

    # phase 5b: float16 over an f16 pool.  The kernel engine and its plain
    # twin write the same f16 pages (K/V rounded into the pool as JAX's
    # .astype rounds), so only K1's f32 sum order parts them: the streams
    # are held to the plain engine's, near ties aside, as in phase 3
    cfgh = gpt_small(dropout=0.0, dtype="float16")
    modelh = GPTForCausalLM(cfgh, device=dev, seed=0)
    streams, pstreams, plain, st = serve_phase(modelh, prompts, max_new, 0)
    want = {"ragged_paged_attention:float16": L * st["fused_steps"]}
    if st["dtype_launches"] != want:
        raise AssertionError(f"f16 serving: launches {st['dtype_launches']},"
                             f" want {want} (K1 over the f16 pool, {L} a "
                             f"fused step)")
    st["near_ties_vs_plain"] = compare_streams(streams, pstreams, plain.P,
                                               cfgh, "f16 kernel vs plain")
    st["equal_stream_share"] = sum(a == b for a, b in zip(
        streams, pstreams)) / len(streams)
    for s_, p in zip(streams, prompts):
        if len(s_) != len(p) + max_new or not all(
                0 <= t < cfgh.vocab_size for t in s_):
            raise AssertionError("f16 serving: malformed stream")
    for k in ("float32", "bfloat16"):
        for m in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                  "step_ms_mean", "kv_bytes_per_token", "pool_bytes"):
            st[f"{k}_{m}"] = results["e2e"][k][m]
    results["e2e"]["float16"] = st
    print(f"[e2e f16] {json.dumps(st)}", flush=True)


# ---------------------------------------------------------------------------
# phases 6-7: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def _scale_err(got, want):
    """(max-abs error, scale) of `got` against `want`, in f32."""
    return (float((got.float() - want.float()).abs().max()),
            float(want.float().abs().max()))


def bert_batch(vocab, batch=64, seq=128, n_mask=20, seed=0):
    """``bench.py``'s batch (bench.py:96-110): ids, valid_length in
    [0.85 seq, seq], sorted masked positions, MLM labels."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    vlen = rng.randint(int(0.85 * seq), seq + 1, (batch,)).astype(np.int32)
    mpos = np.sort(rng.rand(batch, seq).argsort(axis=1)[:, :n_mask],
                   axis=1).astype(np.int32)
    labels = rng.randint(0, vocab, (batch, n_mask)).astype(np.int32)
    return ids, vlen, mpos, labels


FLASH_CASES = ("none", "pad", "row", "causal", "pad_dropout")
# (B, H, L, D) and cases: BERT-base's attention, then GPT-2 small's in the
# gpt phase (causal, dropout 0.1)
FLASH_GROUPS = (((64, 12, 128, 64), FLASH_CASES),
                ((8, 12, 1024, 64), ("gpt_causal_dropout",)))
# the cases k3 also runs in f16 (fp16 AMP's attention): BERT's padding with
# and without dropout (the amp phase's), GPT-2 small's, and two wide heads
FLASH_F16 = ("pad", "pad_dropout", "gpt_causal_dropout", "d256_mqa",
             "d256_pad")


# the band and the fold: (case, B, H, kv heads, Lq, Lk, causal, window,
# symmetric, pad bias, dropout) -- the gpt_gqa phase's attention (12 heads
# over 3 kv heads, causal window 256 at L 1024), the same as MQA (one kv
# head), BERT-base's with a symmetric window of 32 beside its padding, and
# an odd fold whose q tiles straddle two heads (lq 150, rep 3)
FLASH_BAND_CASES = (
    ("gqa_window", 8, 12, 3, 1024, 1024, True, 256, False, False, 0.1),
    ("mqa_window", 8, 12, 1, 1024, 1024, True, 256, False, False, 0.1),
    ("bert_pad_dropout_window", 64, 12, 12, 128, 128, False, 32, True, True,
     0.1),
    ("odd_fold", 2, 12, 4, 150, 260, False, 40, True, True, 0.0))
# the nmt phase's three attentions (B 32, 8 heads, D 64): the encoder's
# self-attention over 128 padded source keys with dropout, the decoder's
# causal self-attention at 96 with dropout, and cross-attention of the 96
# target rows over the 128 padded source keys; no window, no fold
FLASH_NMT_CASES = (
    ("nmt_encoder", 32, 8, 8, 128, 128, False, None, True, True, 0.1),
    ("nmt_decoder", 32, 8, 8, 96, 96, True, None, True, False, 0.1),
    ("nmt_cross", 32, 8, 8, 96, 128, False, None, True, True, 0.0))
# the wide heads, the band cases' fields then D: the gpt_d256
# phase's attention (3 heads of 256 over one kv head at L 1024, causal,
# dropout 0.1), Gemma 2B's own (8 heads of 256 over one kv head at L 2048,
# causal), BERT's batch at 3 heads of 256 with its padding and dropout
# (MHA, not causal), and a width JAX's kernel does not take (192: 4 heads
# over 2 kv heads at L 512, causal window 128)
FLASH_WIDE_CASES = (
    ("d256_mqa", 8, 3, 1, 1024, 1024, True, None, False, False, 0.1, 256),
    ("gemma2b", 2, 8, 1, 2048, 2048, True, None, False, False, 0.0, 256),
    ("d256_pad", 64, 3, 3, 128, 128, False, None, True, True, 0.1, 256),
    ("d192_window", 4, 4, 2, 512, 512, True, 128, False, False, 0.0, 192))


def k3_cases(dev):
    """The flash kernels at BERT-base's attention shape, one (b, h) per
    bh: B 64, H 12, L 128, D 64; then at GPT-2 small's: B 8, H 12, L 1024,
    D 64, causal with dropout 0.1; then `FLASH_BAND_CASES`,
    `FLASH_NMT_CASES` (source lengths as the nmt phase draws them) and
    the wide heads, `FLASH_WIDE_CASES`."""
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator().manual_seed(3)
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    out = []
    for (B, H, L, D), names in FLASH_GROUPS:
        out.extend(_flash_group(dev, fa, kernels, sdpa, g, seed, B, H, L, D,
                                names))
    for case in FLASH_BAND_CASES:
        for dtype in ("float32", "bfloat16"):
            out.append(_flash_band_case(dev, fa, kernels, sdpa, g, seed,
                                        dtype, *case))
    for case in FLASH_NMT_CASES:
        for dtype in ("float32", "bfloat16"):
            out.append(_flash_band_case(dev, fa, kernels, sdpa, g, seed,
                                        dtype, *case,
                                        pad_lo=NMT_VL[0] / NMT_VL[1]))
    for case in FLASH_WIDE_CASES:
        for dtype in ("float32", "bfloat16") + (
                ("float16",) if case[0] in FLASH_F16 else ()):
            out.append(_flash_band_case(dev, fa, kernels, sdpa, g, seed,
                                        dtype, *case))
    return out


def _flash_band_case(dev, fa, kernels, sdpa, g, seed, dtype, name, B, H, G,
                     Lq, Lk, causal, window, symmetric, pad, rate, D=64,
                     pad_lo=0.85):
    """One case of `FLASH_BAND_CASES`: q (B, H, Lq, D) folded onto G kv
    heads, K/V (B, G, Lk, D), through the kernels' wrappers against the
    plain versions on the same inputs, two calls of each bit-equal, and
    timed beside SDPA computing the same function (``enable_gqa``, the band
    and the padding as a float mask, or ``is_causal`` where the band is the
    whole causal triangle) and beside the bound of the pairs the band
    keeps."""
    import torch
    dt = getattr(torch, dtype)
    rep, scale = H // G, 1.0 / D ** 0.5
    q, do = (torch.randn(B, H, Lq, D, generator=g).to(dev, dt)
             for _ in range(2))
    k, v = (torch.randn(B, G, Lk, D, generator=g).to(dev, dt)
            for _ in range(2))
    qf, dof = (t.reshape(B, G, rep * Lq, D) for t in (q, do))
    bias = bias3 = None
    vlen = torch.full((B,), Lk, dtype=torch.int64)
    if pad:
        vlen = torch.randint(int(pad_lo * Lk), Lk + 1, (B,), generator=g)
        bias = torch.where(torch.arange(Lk)[None] < vlen[:, None], 0.0,
                           fa.MASK_VALUE).to(dev)
        bias3 = fa.normalize_bias(bias, B, H, Lq, Lk)[0]
    flags = (scale, causal, rate, False, False)
    kw = dict(window=window, window_symmetric=symmetric, lq=Lq)
    a = (qf, k, v, bias3, seed) + flags
    kernels.reset_launch_counts()
    o1, l1 = fa._flash_fwd_cuda(*a, **kw)
    o2, l2 = fa._flash_fwd_cuda(*a, **kw)
    g1 = fa._flash_bwd_cuda(qf, k, v, bias3, seed, o1, l1, dof, *flags, **kw)
    g2 = fa._flash_bwd_cuda(qf, k, v, bias3, seed, o1, l1, dof, *flags, **kw)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    op, lp = fa.flash_fwd_reference(*a, **kw)
    gp = fa.flash_bwd_reference(qf, k, v, bias3, seed, op, lp, dof, *flags,
                                **kw)
    errs = {nm: _scale_err(x, y) for nm, x, y in zip(
        ("out", "lse", "dq", "dk", "dv"), (o1, l1) + tuple(g1),
        (op, lp) + tuple(gp))}
    bit_equal = torch.equal(o1, o2) and torch.equal(l1, l2) and all(
        torch.equal(x, y) for x, y in zip(g1, g2))
    want_launches = {"flash_attention_fwd": 2, "flash_attention_bwd": 2}
    got_launches = {n: launches[n] for n in want_launches}
    case = dict(dtype=dtype, case=name, B=B, H=H, kv_heads=G, Lq=Lq, Lk=Lk,
                D=D, causal=causal, window=window, symmetric=symmetric,
                pad=pad, rate=rate,
                max_abs_err=max(e for e, _ in errs.values()),
                errors={nm: {"err": e, "scale": sc}
                        for nm, (e, sc) in errs.items()},
                bit_equal_calls=bit_equal, launches=got_launches,
                fwd_plan=fa._planned_fwd(B, H, Lq, Lk, D, dt, dev,
                                         kv_heads=G)._asdict(),
                bwd_plan=fa._bwd_plan(B, H, Lq, Lk, D, dt,
                                      kernels.sm_count(dev),
                                      kv_heads=G)._asdict(),
                ok=bit_equal and got_launches == want_launches
                and all(e <= TOL[dtype] * sc for e, sc in errs.values()))
    del op, lp, gp, o2, l2, g2
    # the band as the plain version masks it, (Lq, Lk): the pairs the work
    # needs, and SDPA's mask
    live = fa._scores(torch.zeros(1, 1, Lq, 1, device=dev),
                      torch.zeros(1, 1, Lk, 1, device=dev), None, 1.0,
                      causal, False, window, symmetric, Lq)[0, 0] \
        > 0.5 * fa.MASK_VALUE
    keys = (torch.arange(Lk)[None] < vlen[:, None]).to(dev)       # (B, Lk)
    pairs = H * int((live[None] & keys[:, None]).sum())
    whole_causal = causal and not pad and bool(
        live.equal(torch.ones_like(live).tril()))
    mask = None
    if not whole_causal:
        mask = torch.where(live[None, None] & keys[:, None, None],
                           0.0, fa.MASK_VALUE).to(dt)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

    def lib_fwd():
        return sdpa(qs, ks, vs, attn_mask=mask, dropout_p=rate,
                    is_causal=whole_causal, enable_gqa=True)
    o_lib = lib_fwd()
    bwd_in = (qf, k, v, bias3, seed, o1, l1, dof) + flags
    case["library"] = "sdpa is_causal" if whole_causal else "sdpa mask"
    case["ms"] = time_ms(lambda: fa._flash_fwd_cuda(*a, **kw))
    case["plain_ms"] = time_ms(lambda: fa.flash_fwd_reference(*a, **kw),
                               iters=5, warm=1)
    case["library_ms"] = time_ms(lib_fwd)
    case["bwd_ms"] = time_ms(lambda: fa._flash_bwd_cuda(*bwd_in, **kw))
    case["bwd_plain_ms"] = time_ms(
        lambda: fa.flash_bwd_reference(*bwd_in, **kw), iters=5, warm=1)
    case["bwd_library_ms"] = time_ms(lambda: torch.autograd.grad(
        o_lib, (qs, ks, vs), do, retain_graph=True))
    item = q.element_size()
    qb, kvb = B * H * Lq * D * item, B * G * Lk * D * item
    lse_b = B * H * Lq * 4
    bias_b = 0 if bias3 is None else bias3.numel() * 4
    prod = "tf32x3" if dtype == "float32" else dtype
    # each input read once, each output written once: q, K, V in, O and
    # lse out; the backward q, K, V, O, dO, lse in, dQ, dK, dV out
    case["pairs"] = pairs
    case["bound_ms"], case["bound_by"] = bound(
        2 * qb + 2 * kvb + lse_b + bias_b, 4.0 * pairs * D, prod)
    case["bwd_bound_ms"], case["bwd_bound_by"] = bound(
        4 * qb + 4 * kvb + lse_b + bias_b, 10.0 * pairs * D, prod)
    del o_lib, qs, ks, vs
    return case


def _flash_group(dev, fa, kernels, sdpa, g, seed, B, H, L, D, names):
    """k3's cases `names` at one (B, H, L, D), f32 then bf16, then those of
    `FLASH_F16` in f16."""
    import torch
    scale = 1.0 / D ** 0.5
    vlen = torch.from_numpy(bert_batch(30522, batch=B, seq=L)[1]).to(dev)
    out = []
    every = names
    for dtype in ("float32", "bfloat16", "float16"):
        names = [n for n in every if dtype != "float16" or n in FLASH_F16]
        if not names:
            continue
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(B, H, L, D, generator=g).to(dev, dt)
                       for _ in range(4))
        pad = torch.where(torch.arange(L, device=dev)[None] < vlen[:, None],
                          0.0, fa.MASK_VALUE)                     # (B, L)
        row = torch.randn(B, L, L, generator=g).to(dev) \
            if "row" in names else None
        for name in names:
            bias = {"pad": pad, "pad_dropout": pad, "row": row}.get(name)
            causal = name in ("causal", "gpt_causal_dropout")
            rate = 0.1 if name in ("pad_dropout", "gpt_causal_dropout") \
                else 0.0
            bias3, per_head, per_row = (None, False, False) if bias is None \
                else fa.normalize_bias(bias, B, H, L, L)
            a = (q, k, v, bias3, seed, scale, causal, rate, per_head,
                 per_row)
            ok_, lk_ = fa._flash_fwd_cuda(*a)
            ok2, lk2 = fa._flash_fwd_cuda(*a)
            op_, lp_ = fa.flash_fwd_reference(*a)
            gk = fa._flash_bwd_cuda(q, k, v, bias3, seed, ok_, lk_, do,
                                    scale, causal, rate, per_head, per_row)
            again = fa._flash_bwd_cuda(q, k, v, bias3, seed, ok_, lk_, do,
                                       scale, causal, rate, per_head,
                                       per_row)
            gp = fa.flash_bwd_reference(q, k, v, bias3, seed, op_, lp_, do,
                                        scale, causal, rate, per_head,
                                        per_row)
            torch.cuda.synchronize()
            bit_equal = all(torch.equal(a_, b_) for a_, b_ in zip(gk, again))
            fwd_bit_equal = torch.equal(ok_, ok2) and torch.equal(lk_, lk2)
            plan = fa._bwd_plan(B, H, L, L, D, dt,
                                kernels.sm_count(dev))._asdict()
            # the forward's plan as the main path takes it, with its source
            fwd_plan = fa._planned_fwd(B, H, L, L, D, dt, dev)._asdict()
            errs = {}
            for nm, x, y in zip(("out", "lse", "dq", "dk", "dv"),
                                (ok_, lk_) + tuple(gk),
                                (op_, lp_) + tuple(gp)):
                errs[nm] = _scale_err(x, y)
            case = dict(dtype=dtype, case=name, B=B, H=H, L=L, D=D,
                        max_abs_err=max(e for e, _ in errs.values()),
                        errors={nm: {"err": e, "scale": sc}
                                for nm, (e, sc) in errs.items()},
                        bit_equal_calls=bit_equal,
                        fwd_bit_equal_calls=fwd_bit_equal,
                        fwd_plan=fwd_plan, bwd_plan=plan,
                        ok=bit_equal and fwd_bit_equal
                        and all(e <= TOL[dtype] * sc
                                for e, sc in errs.values()))
            # timings: kernel, plain version, SDPA with the same float mask
            mask = None if bias is None else (
                bias[:, None, None, :] if bias.dim() == 2
                else bias[:, None]).to(dt)
            qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

            def lib_fwd():
                return sdpa(qs, ks, vs, attn_mask=mask, dropout_p=rate,
                            is_causal=causal)
            o_lib = lib_fwd()

            def kern_fwd():
                return fa._flash_fwd_cuda(*a)
            case["ms"] = time_ms(kern_fwd)
            case["device_ms"] = time_ms(kern_fwd, device_only=True)
            case["host_us"] = host_us(kern_fwd)
            case["plain_ms"] = time_ms(lambda: fa.flash_fwd_reference(*a))
            case["library_ms"] = time_ms(lib_fwd)
            case["library_device_ms"] = time_ms(lib_fwd, device_only=True)
            case["library_host_us"] = host_us(lib_fwd)
            bwd_args = (q, k, v, bias3, seed)
            tail = (scale, causal, rate, per_head, per_row)

            def kern_bwd():
                return fa._flash_bwd_cuda(*bwd_args, ok_, lk_, do, *tail)

            def lib_bwd():
                return torch.autograd.grad(o_lib, (qs, ks, vs), do,
                                           retain_graph=True)
            case["bwd_ms"] = time_ms(kern_bwd)
            case["bwd_device_ms"] = time_ms(kern_bwd, device_only=True)
            case["bwd_host_us"] = host_us(kern_bwd)
            case["bwd_plain_ms"] = time_ms(lambda: fa.flash_bwd_reference(
                *bwd_args, op_, lp_, do, *tail))
            case["bwd_library_ms"] = time_ms(lib_bwd)
            case["bwd_library_device_ms"] = time_ms(lib_bwd,
                                                    device_only=True)
            case["bwd_library_host_us"] = host_us(lib_bwd)

            def kernel_fb():
                o_, l_ = fa._flash_fwd_cuda(*a)
                return fa._flash_bwd_cuda(*bwd_args, o_, l_, do, *tail)

            def plain_fb():
                o_, l_ = fa.flash_fwd_reference(*a)
                return fa.flash_bwd_reference(*bwd_args, o_, l_, do, *tail)
            case["fwd_bwd_ms"] = time_ms(kernel_fb)
            case["fwd_bwd_plain_ms"] = time_ms(plain_fb)
            case["fwd_bwd_library_ms"] = time_ms(lambda: torch.autograd.grad(
                lib_fwd(), (qs, ks, vs), do))
            # the work this data needs: (query, key) pairs not masked
            if causal:
                pairs = B * H * L * (L + 1) // 2
            elif bias is pad:
                pairs = H * L * int(vlen.sum())
            else:
                pairs = B * H * L * L
            item = q.element_size()
            tensor = B * H * L * D * item
            bias_b = 0 if bias3 is None else bias3.numel() * 4
            # both directions' f32 products run as 3xTF32 on the tensor
            # cores
            case["bound_ms"], case["bound_by"] = bound(
                4 * tensor + B * H * L * 4 + bias_b, 4.0 * pairs * D,
                "tf32x3" if dtype == "float32" else dtype)
            case["bwd_bound_ms"], case["bwd_bound_by"] = bound(
                8 * tensor + B * H * L * 4 + bias_b, 10.0 * pairs * D,
                "tf32x3" if dtype == "float32" else dtype)
            out.append(case)
            del o_lib, qs, ks, vs
    return out


XENT_SHAPES = [("float32", 1280, 30522), ("bfloat16", 1280, 30522),
               ("float32", 1280, 50257), ("float32", 8192, 50257),
               ("bfloat16", 8192, 50257), ("float32", 3072, 32000),
               ("bfloat16", 3072, 32000), ("float16", 1280, 30522),
               ("float16", 8192, 50257)]
# (dtype, rows, V): edges checked, not timed -- one column, a vocabulary
# shorter than two vectors, and an odd bf16 vocabulary whose rows start at
# every 16-byte phase; each with labels outside [0, V) at both ends and,
# where V > 8, a masked column and a row whose first reads are all -inf
XENT_EDGES = [("float32", 37, 1), ("bfloat16", 37, 1), ("float32", 37, 9),
              ("bfloat16", 37, 9), ("bfloat16", 16, 50257),
              ("float32", 16, 50257), ("float16", 37, 9),
              ("float16", 16, 50257)]


def xent_edge_inputs(dtype, N, V, g):
    """`XENT_EDGES`' logits and labels: row 1 is -inf over every thread's
    first reads (its head or tail scalar and its first batch of vectors),
    all but the last column, which row 1's label takes."""
    import torch
    from mxnet_tpu_torch.ops import softmax_xent as sx
    x = 3 * torch.randn(N, V, generator=g)
    lab = torch.randint(0, V, (N,), generator=g)
    lab[0], lab[2] = -1, V
    if V > 8:
        per = 16 // (torch.finfo(getattr(torch, dtype)).bits // 8)
        x[:, 7] = float("-inf")
        x[1, :min(V - 1, per + sx.FWD_UNROLL * sx.FWD_THREADS * per)] = \
            float("-inf")
        lab[lab == 7] = 8
        lab[1] = V - 1
    return x, lab


def _xent_errs(sx, x, lab, gr):
    """Forward and backward against the plain versions: {name: (max-abs
    error, scale, limit)} -- loss and lse, f32 on both sides from the same
    values, at the f32 limit in either dtype; dx at its dtype's."""
    import torch
    dtype = str(x.dtype)[6:]
    lk_, sk_ = sx._xent_fwd_cuda(x, lab)
    lp_, sp_ = sx.xent_fwd_reference(x, lab)
    dk_ = sx._xent_bwd_cuda(x, lab, sk_, gr)
    dp_ = sx.xent_bwd_reference(x, lab, sp_, gr)
    torch.cuda.synchronize()
    return {"loss": (*_scale_err(lk_, lp_), TOL["float32"]),
            "lse": (*_scale_err(sk_, sp_), TOL["float32"]),
            "dx": (*_scale_err(dk_, dp_), TOL[dtype])}, sk_, sp_


def _xent_case(dtype, N, V, errs):
    return dict(dtype=dtype, N=N, V=V,
                max_abs_err=max(e for e, _, _ in errs.values()),
                errors={nm: {"err": e, "scale": sc, "limit": lim}
                        for nm, (e, sc, lim) in errs.items()},
                ok=all(e <= lim * sc for e, sc, lim in errs.values()))


def k4_cases(dev):
    """The cross-entropy kernels at the MLM head's logits (64 x 20 masked
    rows, vocab 30522), at an odd vocabulary, at the GPT phase's logits
    (8 x 1024 rows, vocab 50257) and at the nmt phase's (32 x 96 target
    rows, vocab 32000), timed, with the forward's host µs a call and plan;
    the MLM head's and GPT's also in f16 (fp16 AMP's logits; the library
    call then takes the f16 logits as they are); then `XENT_EDGES`,
    checked only."""
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import softmax_xent as sx

    g = torch.Generator().manual_seed(4)
    out = []
    for dtype, N, V in XENT_SHAPES:
        dt = getattr(torch, dtype)
        x = (2.0 * torch.randn(N, V, generator=g)).to(dev, dt)
        lab = torch.randint(0, V, (N,), generator=g).to(dev, torch.int32)
        gr = torch.rand(N, generator=g).to(dev)
        errs, sk_, sp_ = _xent_errs(sx, x, lab, gr)
        case = _xent_case(dtype, N, V, errs)
        case["plan"] = sx._fwd_plan(N, kernels.sm_count(x.device))._asdict()
        x32 = x.clone().requires_grad_() if dtype == "float16" \
            else x.float().requires_grad_()
        y64 = lab.long()
        lib = tF.cross_entropy(x32, y64, reduction="none")
        case["ms"] = time_ms(lambda: sx._xent_fwd_cuda(x, lab))
        case["host_us"] = host_us(lambda: sx._xent_fwd_cuda(x, lab))
        case["plain_ms"] = time_ms(lambda: sx.xent_fwd_reference(x, lab))
        # f16 logits go to the library as they are (it sums in f32)
        xl = x if dtype == "float16" else x.float()
        case["library_ms"] = time_ms(lambda: tF.cross_entropy(
            xl, y64, reduction="none"))
        case["bwd_ms"] = time_ms(lambda: sx._xent_bwd_cuda(x, lab, sk_, gr))
        case["bwd_plain_ms"] = time_ms(
            lambda: sx.xent_bwd_reference(x, lab, sp_, gr))
        case["bwd_library_ms"] = time_ms(lambda: torch.autograd.grad(
            lib, x32, gr, retain_graph=True))
        item = x.element_size()
        case["bound_ms"], case["bound_by"] = bound(
            N * V * item + 3 * N * 4, 3.0 * N * V, dtype)
        case["bwd_bound_ms"], case["bwd_bound_by"] = bound(
            2 * N * V * item + 3 * N * 4, 3.0 * N * V, dtype)
        out.append(case)
        del x32, lib
    for dtype, N, V in XENT_EDGES:
        x, lab = xent_edge_inputs(dtype, N, V, g)
        x = x.to(dev, getattr(torch, dtype))
        lab = lab.to(dev, torch.int32)
        gr = torch.rand(N, generator=g).to(dev)
        errs, sk_, _ = _xent_errs(sx, x, lab, gr)
        case = dict(_xent_case(dtype, N, V, errs), edge=True)
        case["finite"] = bool(torch.isfinite(sk_).all())
        case["ok"] = case["ok"] and case["finite"]
        out.append(case)
    return out


# BERT's step rows, its MLM head's, a ragged one, and the nmt phase's
# encoder rows (32 x 128 at hidden 512)
NORM_SHAPES = [(8192, 768), (1280, 768), (37, 200), (4096, 512)]
NORM_VARIANTS = (("ln", False, False), ("rms", True, False),
                 ("ln_res", False, True), ("rms_res", True, True))


def k5_cases(dev):
    """The fused norm at the BERT step's shapes (64 x 128 tokens and the
    1280 masked rows of the MLM head, hidden 768) and a ragged one; f32
    gamma and beta, as BERT's LayerNorms keep them.  Each case: its plan
    and the plan's source, two calls bit-equal, the time with the L2
    flushed, the device-only time and the host µs a call (the library call
    device-only too); at (8192, 768) LayerNorm the time at each of JAX's
    block_rows candidates (what set the card's default); and plain
    copies of the same bytes under the same timer (``copy_ms``), whose L2
    flush leaves dirty lines that a small call pays to write back."""
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.ops import fused_norm as fn

    g = torch.Generator().manual_seed(7)
    out = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for rows, h in NORM_SHAPES:
            x = torch.randn(rows, h, generator=g).to(dev, dt)
            r = torch.randn(rows, h, generator=g).to(dev, dt)
            gamma = (torch.rand(h, generator=g) + 0.5).to(dev)
            beta = torch.randn(h, generator=g).to(dev)
            g16, b16 = gamma.to(dt), beta.to(dt)
            for name, rms, res in NORM_VARIANTS:
                rr = r if res else None
                bb = None if rms else beta
                eps = 1e-6 if rms else 1e-12
                a = (x, rr, gamma, bb, eps, rms)
                got = fn._norm_cuda(*a)
                again = fn._norm_cuda(*a)
                want = fn.norm_plain(*a)
                torch.cuda.synchronize()
                pairs = list(zip(got, want)) if res else [(got, want)]
                errs = [_scale_err(u, v) for u, v in pairs]
                bits = all(torch.equal(u, v) for u, v in (
                    zip(got, again) if res else [(got, again)]))
                plan = fn._planned(rows, h, dt, gamma.dtype, x.device,
                                   fn._aligned(x, rr))
                case = dict(dtype=dtype, rows=rows, h=h, case=name,
                            plan=plan._asdict(),
                            max_abs_err=max(e for e, _ in errs),
                            errors=[{"err": e, "scale": sc}
                                    for e, sc in errs],
                            bit_equal=bits,
                            ok=bits and all(e <= TOL[dtype] * sc
                                            for e, sc in errs))

                def kern():
                    fn._norm_cuda(*a)
                case["ms"] = time_ms(kern)
                case["device_ms"] = time_ms(kern, device_only=True)
                case["host_us"] = host_us(kern)
                case["plain_ms"] = time_ms(lambda: fn.norm_plain(*a))
                # the floor of the card under this timer for the call's
                # bytes: plain copies of x (and the residual) into fresh
                # outputs
                ys = [torch.empty_like(x) for _ in range(1 + res)]
                case["copy_ms"] = time_ms(lambda: [
                    yy.copy_(src) for yy, src in zip(ys, (x, r))])
                lib = None
                if rms and not res:
                    def lib():
                        tF.rms_norm(x, (h,), g16, eps)
                elif not res:  # no one library call adds and normalises
                    def lib():
                        tF.layer_norm(x, (h,), g16, b16, eps)
                case["library_ms"] = None if lib is None else time_ms(lib)
                case["library_device_ms"] = None if lib is None else \
                    time_ms(lib, device_only=True)
                if rows == 8192 and name == "ln":
                    case["block_rows_ms"] = {
                        c.block_rows: time_ms(lambda: fn._norm_cuda(
                            *a, block_rows=c.block_rows))
                        for c in fn._candidates((rows, h), dtype)}
                item = x.element_size()
                nbytes = rows * h * item * (2 + 2 * res) + \
                    h * 4 * (1 + (not rms))
                case["bound_ms"], case["bound_by"] = bound(
                    nbytes, (5 if rms else 8) * rows * h, dtype)
                out.append(case)
    return out


def profile_ms(fn, iters=5):
    """Device time of one call of `fn`, by kernel name and in total (ms),
    from ``torch.profiler`` over `iters` calls after one warm call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = 0.0
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            us = float(getattr(e, attr, 0.0) or 0.0)
            if us:
                break
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / iters
    return sum(by_name.values()), by_name


OPT_RULES = (("adam", "Adam", {}), ("adamw", "AdamW", {}),
             ("sgd_momentum", "SGD", {"momentum": 0.9}), ("lamb", "LAMB", {}),
             ("nag", "NAG", {}), ("signum_momentum", "Signum", {}),
             ("signum", "Signum", {"momentum": 0.0}),
             ("adabelief", "AdaBelief", {}), ("adamax", "Adamax", {}),
             ("adadelta", "AdaDelta", {}), ("ftml", "FTML", {}))
# the chunk kernel's nine rules (JAX's `fused_elementwise` optimizers)
CHUNK_RULE_NAMES = ("Adam", "AdamW", "SGD", "NAG", "Signum", "AdaBelief",
                    "Adamax", "AdaDelta", "FTML")


def bert_leaves(dtype, layers=None):
    """(name, shape, dtype) of every parameter of BERT-base for
    pretraining in `dtype` (LayerNorm parameters stay f32), at `layers` of
    its 12 layers where given."""
    from mxnet_tpu_torch.models import BertForPretraining, bert_base
    cfg = bert_base(dtype=dtype) if layers is None else \
        bert_base(dtype=dtype, num_layers=layers)
    m = BertForPretraining(cfg, device="cpu", seed=0)
    return [(n, tuple(p.shape), p.dtype) for n, p in m.named_parameters()]


def bert_optim_leaves(dtype):
    """`bert_leaves` at the optim phase's depth, `OPTIM_LAYERS`: every
    leaf shape of the full model, a third of its layers."""
    return bert_leaves(dtype, OPTIM_LAYERS)


def nmt_leaves(dtype):
    """(name, shape, dtype) of every parameter of `transformer_base` in
    `dtype` (94.3 M elements; LayerNorm parameters stay f32)."""
    from mxnet_tpu_torch.models import TransformerNMT, transformer_base
    m = TransformerNMT(transformer_base(dtype=dtype), device="cpu", seed=0)
    return [(n, tuple(p.shape), p.dtype) for n, p in m.named_parameters()]


def gpt_leaves(dtype):
    """(name, shape, dtype) of every parameter of `gpt_small` in `dtype`
    (124 M elements, the head tied to the embedding; LayerNorm parameters
    stay f32)."""
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small
    m = GPTForCausalLM(gpt_small(dtype=dtype), device="cpu", seed=0)
    return [(n, tuple(p.shape), p.dtype) for n, p in m.named_parameters()]


# k6's parameter lists and the rules over each: BERT-base under every rule,
# GPT-2 small under the gpt phases' AdamW, transformer_base under the nmt
# phase's Adam
OPT_MODELS = (("bert_base", bert_optim_leaves, None),
              ("gpt_small", gpt_leaves, ("adamw",)),
              ("transformer_base", nmt_leaves, ("adam",)))
# k6's f16 cases, (model, leaves, rule, state dtype): GPT-2 small's f16
# leaves under AdamW with f32 state (the f16 gpt run's `TrainStep`) and
# with f16 state (a `Trainer` of the f16 model), BERT-base's f16 leaves
# under LAMB (the optim phase's f16 run)
OPT_F16 = (("gpt_small", gpt_leaves, "adamw", "float32"),
           ("gpt_small", gpt_leaves, "adamw", "float16"),
           ("bert_base", bert_optim_leaves, "lamb", "float32"))
# one step of each 16-bit type, relative to the value
STEP16 = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _opt_tree(leaves, opt, dev, seed, state_dtype="float32"):
    """Weights N(0, 0.02), gradients N(0, 1e-3), Adam-like state: slot 0
    N(0, 1e-4) (U(0, 1e-4) for AdaDelta, whose acc_g takes a root), the
    others U(0, 1e-8); the state in `state_dtype` for the 16-bit leaves
    (an f32 LayerNorm leaf keeps f32 state)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    pos0 = type(opt).__name__ == "AdaDelta"
    params, grads, states = {}, {}, {}
    for n, shape, dt in leaves:
        params[n] = (0.02 * torch.randn(shape, generator=g, device=dev)
                     ).to(dt)
        grads[n] = (1e-3 * torch.randn(shape, generator=g, device=dev)
                    ).to(dt)
        st = opt.create_state(params[n], dtype=torch.float32)
        sdt = getattr(torch, state_dtype) if dt != torch.float32 \
            else torch.float32
        states[n] = tuple(
            (1e-4 * (torch.rand if pos0 else torch.randn)(
                shape, generator=g, device=dev)).to(sdt) if k == 0
            else (1e-8 * torch.rand(shape, generator=g, device=dev)).to(sdt)
            for k in range(len(st)))
    return params, grads, states


def _opt_err(new_p, new_s, want_p, want_s, old_p):
    """(max-abs error, share of 16-bit elements off the plain value, ok)
    of an update against the plain version's.  An f32 state tensor is held
    within OPT_RTOL of its own scale, max |plain|.  A weight is held
    within its rounding (2 ulps in f32, one step in bf16 or f16: at most
    2**-22, 2**-7 and 2**-10 of the value, or f16's subnormal step 2**-24)
    plus OPT_RTOL of its update's scale, max |plain - old|; a 16-bit state
    tensor (the `Trainer`'s state of a 16-bit model) within one step plus
    OPT_RTOL of its scale.  An update below one 16-bit step moves only
    some of a 16-bit tensor's elements, so at most OPT_MISMATCH of the
    16-bit elements, weights and state together, may differ from the plain
    value at all."""
    err, ok, off, n16 = 0.0, True, 0, 0
    for n in new_p:
        a, b = new_p[n].float(), want_p[n].float()
        d = (a - b).abs()
        step = STEP16.get(str(new_p[n].dtype)[6:])
        lim = (step or 2.0 ** -22) * b.abs() + (2.0 ** -24 if step else 0.0) \
            + OPT_RTOL * float((b - old_p[n].float()).abs().max())
        ok = ok and bool((d <= lim).all())
        err = max(err, float(d.max()))
        if step:
            off += int((d > 0).sum())
            n16 += d.numel()
        for s, w in zip(new_s[n], want_s[n]):
            sd = (s.float() - w.float()).abs()
            scale = float(w.float().abs().max())
            sstep = STEP16.get(str(s.dtype)[6:])
            if sstep:
                ok = ok and bool((sd <= sstep * w.float().abs() + 2.0 ** -24
                                  + OPT_RTOL * scale).all())
                off += int((sd > 0).sum())
                n16 += sd.numel()
            else:
                ok = ok and float(sd.max()) <= OPT_RTOL * scale
            err = max(err, float(sd.max()))
    share = off / n16 if n16 else 0.0
    return err, share, ok and share <= OPT_MISMATCH


def _opt_controls(new_p, new_s, want_p, want_s, old_p, old_s):
    """Planted faults built from the kernel's own results, no launch: each
    must fail `_opt_err`.  The last state slot (Adam's v, SGD's momentum,
    FTML's z) left unstored, where the rule keeps state, and each weight
    dtype's weights left unchanged.  Returns {fault: caught}."""
    faults = {}
    if any(new_s.values()):
        faults["last_state_not_stored"] = (new_p, {
            n: tuple(new_s[n][:-1]) + (old_s[n][-1],) for n in new_s})
    for dt in sorted({str(p.dtype) for p in new_p.values()}):
        faults[f"{dt[6:]}_weights_unchanged"] = ({
            n: old_p[n] if str(p.dtype) == dt else p
            for n, p in new_p.items()}, new_s)
    return {k: not _opt_err(p, s, want_p, want_s, old_p)[2]
            for k, (p, s) in faults.items()}


# the rules that no one PyTorch call computes, and why (k6 records
# ``library_ms`` None with the reason)
NO_LIBRARY = {
    "lamb": "no fused LAMB in PyTorch",
    "nag": "torch._fused_sgd_(nesterov=True) keeps its buffer in other "
           "units than NAG's mom (g-sums, not lr-scaled steps) and steps "
           "with lr * (g + mu * buf): another state, not the same function",
    "signum": "no signSGD in PyTorch",
    "signum_momentum": "no signSGD in PyTorch",
    "adabelief": "no AdaBelief in PyTorch",
    "adamax": "torch.optim.Adamax has no fused kernel: its foreach path is "
              "several calls",
    "adadelta": "torch.optim.Adadelta has no fused kernel: its foreach path "
                "is several calls",
    "ftml": "no FTML in PyTorch"}


def _library_call(rule, opt, params, grads, states, hp_vals):
    """The nearest one-call PyTorch multi-tensor update on the same
    tensors, grouped by weight dtype, with its state in the weight's dtype
    (as torch keeps it); None for the rules of `NO_LIBRARY`."""
    import torch
    if rule in NO_LIBRARY:
        return None
    groups = {}
    for n, p in params.items():
        groups.setdefault(p.dtype, []).append(n)
    lists = []
    for names in groups.values():
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        ss = [[s.to(params[n].dtype) for s in states[n]] for n in names]
        steps = [torch.full((), 3.0, device=ps[0].device) for _ in ps]
        lists.append((ps, gs, ss, steps))
    lr, wd = hp_vals["lr"], hp_vals["wd"]

    def call():
        for ps, gs, ss, steps in lists:
            if rule == "sgd_momentum":
                torch._fused_sgd_(ps, gs, [s[0] for s in ss],
                                  weight_decay=wd, momentum=opt.momentum,
                                  lr=lr, dampening=0.0, nesterov=False,
                                  maximize=False, is_first_step=False)
            else:
                fused = torch._fused_adam_ if rule == "adam" else \
                    torch._fused_adamw_
                fused(ps, gs, [s[0] for s in ss], [s[1] for s in ss], [],
                      steps, lr=lr, beta1=opt.beta1, beta2=opt.beta2,
                      weight_decay=wd, eps=opt.epsilon, amsgrad=False,
                      maximize=False)
    return call


# (bytes per element given the weight's itemsize w and the state's s, f32
# operations per element): each input read once and each output written
# once
_OPT_WORK = {
    "adam": (lambda w, s: 3 * w + 4 * s, 14),     # w g m v in; w m v out
    "adamw": (lambda w, s: 3 * w + 4 * s, 15),
    "sgd_momentum": (lambda w, s: 3 * w + 2 * s, 6),  # w g mom; w mom
    "nag": (lambda w, s: 3 * w + 2 * s, 10),
    "signum_momentum": (lambda w, s: 3 * w + 2 * s, 10),
    "signum": (lambda w, s: 3 * w, 5),            # w g in; w out
    "adabelief": (lambda w, s: 3 * w + 4 * s, 17),
    "adamax": (lambda w, s: 3 * w + 4 * s, 13),
    "adadelta": (lambda w, s: 3 * w + 4 * s, 19),
    "ftml": (lambda w, s: 3 * w + 6 * s, 20),     # w g d v z; w d v z
    "lamb_a": (lambda w, s: 2 * w + 4 * s + 4, 17),   # w g m v; m v r
    "lamb_b": (lambda w, s: 2 * w + 4, 3)}        # w r in; w out


def _opt_bound(rule, params, phase=None, states=None):
    """`bound` of one update of `params` by `rule` (LAMB: one phase), the
    state f32 unless `states` says otherwise."""
    per, ops = _OPT_WORK[f"lamb_{phase}" if rule == "lamb" else rule]
    n = sum(p.numel() for p in params.values())
    nbytes = sum(per(p.element_size(),
                     states[k][0].element_size() if states and states[k]
                     else 4) * p.numel() for k, p in params.items())
    return bound(nbytes, ops * n, "float32")


def k6_cases(dev):
    """The optimizer kernels over BERT-base's parameter list, f32 and bf16
    models: each rule's kernel route against its plain version, the
    device time of each, and the skip flag's bit identity; then AdamW
    over GPT-2 small's (`OPT_MODELS`); then the f16 cases (`OPT_F16`)."""
    from mxnet_tpu_torch import optimizer as topt

    out = []
    for (model, leaves_of, rules), dtype in (
            (m, d) for m in OPT_MODELS for d in ("float32", "bfloat16")):
        leaves = leaves_of(dtype)
        for rule, cls, kw in OPT_RULES:
            if rules is not None and rule not in rules:
                continue
            out.append(_k6_case(dev, model, leaves, dtype, rule,
                                getattr(topt, cls), kw))
    rules = {r: (cls, kw) for r, cls, kw in OPT_RULES}
    for model, leaves_of, rule, sdt in OPT_F16:
        cls, kw = rules[rule]
        out.append(_k6_case(dev, model, leaves_of("float16"), "float16",
                            rule, getattr(topt, cls), kw, sdt))
    return out


def _k6_case(dev, model, leaves, dtype, rule, cls, kw,
             state_dtype="float32"):
    """One k6 case: `rule` over `leaves` (`state_dtype` state for the
    16-bit leaves) through the kernel route against `kernel_plain`, the
    planted faults, the skip flag, device times beside the plain version
    and the nearest library call."""
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import fused_optimizer as fo

    lr = 1e-3 if rule == "lamb" else 1e-4
    opt = cls(learning_rate=lr, **kw)
    hp_vals = {"lr": lr, "wd": 0.01, "rescale_grad": 1.0, "t": 3.0}
    hp = {k: torch.full((), v, device=dev) for k, v in hp_vals.items()}
    hp["clip_gradient"] = None
    params, grads, states = _opt_tree(leaves, opt, dev, seed=8,
                                      state_dtype=state_dtype)
    want_p, want_s = fo.kernel_plain(opt, params, grads, states, hp)
    kp = {n: t.clone() for n, t in params.items()}
    ks = {n: tuple(t.clone() for t in st) for n, st in states.items()}
    kernels.reset_launch_counts()
    fo.apply_updates(opt, kp, grads, ks, hp, use_kernel=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    by_dtype = {f"{n}:{d}": v
                for (n, d), v in sorted(kernels.DTYPE_LAUNCHES.items())}
    err, share, ok = _opt_err(kp, ks, want_p, want_s, params)
    controls = _opt_controls(kp, ks, want_p, want_s, params, states)
    ok = ok and all(controls.values())
    n_groups = len({p.dtype for p in params.values()})
    # LAMB: phases A and B once per (weight, state) dtype group, each
    # counted under its group's weight dtype
    names = ("lamb_phase_a", "lamb_phase_b") if rule == "lamb" \
        else ("fused_optimizer_chunk",)
    want_l = {k: n_groups for k in names}
    want_d = {f"{k}:{str(p.dtype)[6:]}": 1 for k in names
              for p in params.values()}
    lamb_plans = list(fo.last_lamb_plans)
    ok = ok and all(launches[k] == v for k, v in want_l.items()) and \
        by_dtype == want_d
    # skip=True leaves every weight and state bit-identical
    sp = {n: t.clone() for n, t in params.items()}
    ss = {n: tuple(t.clone() for t in st) for n, st in states.items()}
    fo.apply_updates(opt, sp, grads, ss, hp, use_kernel=True,
                     skip=torch.ones((), dtype=torch.bool, device=dev))
    skip_ok = all(torch.equal(sp[n], params[n]) and all(
        torch.equal(a, b) for a, b in zip(ss[n], states[n]))
        for n in params)
    del sp, ss, want_p, want_s
    case = dict(model=model, dtype=dtype, state_dtype=state_dtype,
                rule=rule, tensors=len(params),
                elements=sum(p.numel() for p in params.values()),
                groups=n_groups, launches=launches, dtype_launches=by_dtype,
                max_abs_err=err, bf16_weight_mismatch_share=share,
                controls_caught=controls,
                skip_bit_identical=skip_ok, ok=ok and skip_ok)
    if rule == "lamb":
        # each phase's plan: one launch a group over the group's leaf
        # table, persistent blocks (occupancy x SMs, at most one an entry,
        # as each entry chose); phase B walks the codes in phase A's
        # order, 16-byte steps on aligned leaves
        groups = fo._groups(sorted(kp), kp, ks)
        base = [dict(weight_dtype=str(kp[gr[0]].dtype)[6:],
                     tensors=len(gr), chunk=fo.LAMB_CHUNK,
                     block_entries=p.block_entries,
                     sm_count=kernels.sm_count(dev))
                for gr, p in zip(groups, lamb_plans)]
        case["phase_a_plan"] = [dict(b, grid=p.grid_a) for b, p in
                                zip(base, lamb_plans)]
        case["phase_b_plan"] = [dict(
            b, grid=p.grid_b, code_order="forward",
            vector_leaves=p.vector_leaves, element_leaves=p.element_leaves)
            for b, p in zip(base, lamb_plans)]
        case["phase_a_launches"] = launches["lamb_phase_a"]
        case["phase_b_launches"] = launches["lamb_phase_b"]

    def kernel_call():
        fo.apply_updates(opt, kp, grads, ks, hp, use_kernel=True)

    def plain_call():
        fo.kernel_plain(opt, params, grads, states, hp)
    case["device_ms"], by_name = profile_ms(kernel_call)
    case["kernel_device_ms"] = {k: v for k, v in by_name.items()
                                if "kernel" in k}
    # one profiled call: the plain version's ~10 ms of device time needs no
    # average, and its thousands of launches a call make the profiler's
    # own work most of the phase
    case["plain_ms"], _ = profile_ms(plain_call, iters=1)
    case["call_ms"] = time_ms(kernel_call, iters=10, warm=2)
    case["plain_call_ms"] = time_ms(plain_call, iters=10, warm=2)
    lib = _library_call(rule, opt, kp, grads, ks, hp_vals)
    case["library_ms"] = None if lib is None else profile_ms(lib)[0]
    if lib is None:
        case["library_none_reason"] = NO_LIBRARY[rule]
    elif any(s.dtype != p.dtype for n, p in kp.items() for s in ks[n]):
        case["library_note"] = (
            "torch's fused call keeps its state in the weight's dtype "
            "(f16 or bf16 moments), the kernel in f32 here: not the same "
            "function")
    if rule == "lamb":
        for ph in ("a", "b"):
            ms = sum(v for k, v in by_name.items()
                     if f"lamb_{ph}_kernel" in k)
            case[f"phase_{ph}_ms"] = ms
            case[f"phase_{ph}_bound_ms"], case[f"phase_{ph}_bound_by"] = \
                _opt_bound(rule, params, ph, states)
        case["ms"] = case["phase_a_ms"] + case["phase_b_ms"]
        case["bound_ms"] = case["phase_a_bound_ms"] + \
            case["phase_b_bound_ms"]
        case["bound_by"] = "bytes"
    else:
        case["ms"] = sum(v for k, v in by_name.items()
                         if "chunk_kernel" in k)
        case["bound_ms"], case["bound_by"] = _opt_bound(rule, params,
                                                        states=states)
    del kp, ks, params, grads, states, lib
    torch.cuda.empty_cache()
    return case


# ---------------------------------------------------------------------------
# phase 8: the BERT-base pretraining step end to end
# ---------------------------------------------------------------------------

def bench_flops_per_step(cfg, batch, seq, n_mask):
    """``bench.py``'s train FLOPs (bench.py:184-189): 3x the forward's
    matmul FLOPs, the MLM head on the masked positions only."""
    h, l, i, V = (cfg.hidden_size, cfg.num_layers, cfg.intermediate_size,
                  cfg.vocab_size)
    fwd_per_token = 2 * l * (4 * h * h + 2 * h * i) + 4 * l * seq * h
    fwd_per_masked = 2 * (h * h + h * V)
    return 3 * batch * (fwd_per_token * seq + fwd_per_masked * n_mask)


def pallas_mode(mode):
    """``MXTPU_PALLAS=mode`` for the duration of the block."""
    return env(MXTPU_PALLAS=mode)


OPT_LR = {"Adam": 1e-4, "LAMB": 1e-3}
# planted faults for the train phase's controls, each one kernel's math
# gone wrong on the bf16 kernel route: the trajectory check against the
# sound bf16 Adam run's oracle must reject every one
TRAIN_FAULTS = ("adam_without_bias_correction", "layernorm_as_rmsnorm")


def _layernorm_as_rmsnorm(x, gamma, beta, eps):
    """A LayerNorm whose row kernel takes its RMS branch: no centring."""
    from mxnet_tpu_torch.ops import fused_norm as fn
    return fn._kernel_route(x, None, gamma, beta, eps, True,
                            x.device.type == "cuda")


def bert_bench(dev, dtype, layers=None):
    """Full-width BERT-base for pretraining (seed 0, dropout 0.1; `layers`
    of its 12 where given) behind ``bench.py``'s positional adapter (ids,
    valid_length, masked_positions)."""
    import torch
    from mxnet_tpu_torch.models import BertForPretraining, bert_base
    cfg = bert_base(dtype=dtype) if layers is None else \
        bert_base(dtype=dtype, num_layers=layers)

    class Bench(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = BertForPretraining(cfg, device=dev, seed=0)

        def forward(self, ids, vl, mp):
            return self.model(ids, valid_length=vl, masked_positions=mp)

    return Bench()


def bert_train_step(dev, dtype, plain=False, opt="Adam", route="auto",
                    fault=None):
    """``bench.py``'s pretraining step: full-width BERT-base (seed 0)
    behind its positional adapter (ids, valid_length, masked_positions),
    the mean MLM cross-entropy, `opt` (Adam lr 1e-4 or LAMB lr 1e-3) in a
    `TrainStep`, built under ``MXTPU_PALLAS=route`` (the step resolves its
    optimizer route once, at construction; the norms read the policy at
    each call, so run it under the same mode).  ``plain=True`` builds the
    oracle, which launches no kernel: every attention swaps in
    `multi_head_attention_reference`, the loss is
    `softmax_cross_entropy_reference`, on the kernel route every LayerNorm
    swaps in `fused_layer_norm_reference` (the fused kernel's plain
    version) and the optimizer update is the kernels' plain version
    `ops.fused_optimizer.kernel_plain`, leaf by leaf (LAMB's trust ratio in
    f32, as the kernels keep it); on the reference route the optimizer
    takes that route's per-leaf update, which rounds the ratio to a bf16
    weight's dtype, as JAX's does.  `fault`
    plants one of `TRAIN_FAULTS` in a kernel-route Adam step: the chunk
    kernel's AdamW rule with ``correct_bias=False`` and no weight decay,
    or every LayerNorm on the norm kernel's RMS branch."""
    import torch
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.models.layers import _plain_twin
    from mxnet_tpu_torch.ops.fused_optimizer import kernel_plain
    from mxnet_tpu_torch.ops.softmax_xent import (
        softmax_cross_entropy, softmax_cross_entropy_reference)
    from mxnet_tpu_torch.parallel import TrainStep

    bench = bert_bench(dev, dtype)
    xent = softmax_cross_entropy
    if plain:
        _plain_twin(bench, norms=route != "reference")
        xent = softmax_cross_entropy_reference
    optimizer = getattr(topt, opt)(learning_rate=OPT_LR[opt])
    update = None
    if plain and route != "reference":
        update = kernel_plain
    if fault == "adam_without_bias_correction":
        optimizer = topt.AdamW(learning_rate=OPT_LR[opt], correct_bias=False)
    elif fault == "layernorm_as_rmsnorm":
        for m in bench.modules():
            if isinstance(m, nn.LayerNorm):
                m._norm = _layernorm_as_rmsnorm

    def loss_fn(out, ids, vl, mp, lab):
        return xent(out[0], lab).mean()

    with pallas_mode("reference" if plain else route):
        return TrainStep(bench, optimizer, loss_fn, num_model_args=3,
                         update=update)


def train_run(dev, dtype, plain, batch, opt="Adam", route="auto",
              fault=None):
    """`TRAIN_STEPS` steps of the pretraining step under
    ``MXTPU_PALLAS=route``; returns its stats, the step time and the
    step's parameter counts (tensors, dtype groups)."""
    import torch
    from mxnet_tpu_torch import kernels

    step = bert_train_step(dev, dtype, plain, opt, route, fault)
    params = [step.params[n] for n in step.diff_names]
    counts = (len(params), len({p.dtype for p in params}))
    with pallas_mode(route):
        warm_s = step.warmup(*batch)
        losses = []
        kernels.reset_launch_counts()
        for i in range(TRAIN_STEPS):
            losses.append(step.dispatch(*batch).loss)
            if i == 1:        # time the steady steps 3..N
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 2)
        launches = kernels.launch_counts()
    return dict(losses=[float(x) for x in losses], step_ms=step_s * 1e3,
                warmup_s=warm_s, launches=launches,
                fused_opt_kernel=step._fused_opt_kernel,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), \
        step_s, counts


# (weights, optimizer, MXTPU_PALLAS): the default kernel route in bf16 and
# f32 with each optimizer (f32 holds the kernels to the tight trajectory
# limit), and slice 2's reference route
TRAIN_RUNS = (("bfloat16", "Adam", "auto"), ("float32", "Adam", "auto"),
              ("bfloat16", "LAMB", "auto"), ("float32", "LAMB", "auto"),
              ("bfloat16", "Adam", "reference"))


def want_launches(opt, route, n_groups, layers):
    """Exact launches over `TRAIN_STEPS` steps: 26 norms a step (embed,
    2 per layer, the MLM head) and the optimizer on the kernel route only
    (the chunk, or LAMB's phases A and B, once per dtype group); flash
    and cross-entropy on both."""
    kr = route != "reference"
    lamb = kr and opt == "LAMB"
    per_step = {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
                "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                "fused_norm": 2 * layers + 2 if kr else 0,
                "fused_optimizer_chunk": n_groups if kr and not lamb else 0,
                "lamb_phase_a": n_groups if lamb else 0,
                "lamb_phase_b": n_groups if lamb else 0}
    return {k: v * TRAIN_STEPS for k, v in per_step.items()}


def run_train(dev, results, card):
    import torch
    from mxnet_tpu_torch.models import bert_base

    cfg = bert_base()
    B, S, M = 64, 128, 20
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in bert_batch(cfg.vocab_size, B, S, M))
    flops = bench_flops_per_step(cfg, B, S, M)
    for dtype, opt, route in TRAIN_RUNS:
        key = f"{dtype}_{opt.lower()}_{route}"
        torch.cuda.reset_peak_memory_stats()
        st, step_s, (n_t, n_g) = train_run(dev, dtype, False, batch, opt,
                                           route)
        torch.cuda.empty_cache()
        pst, pstep_s, _ = train_run(dev, dtype, True, batch, opt, route)
        torch.cuda.empty_cache()
        want = want_launches(opt, route, n_g, cfg.num_layers)
        got = {k: st["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"train {key}: kernel launches {got}, "
                                 f"want {want} over {TRAIN_STEPS} steps")
        if any(pst["launches"].values()):
            raise AssertionError(f"train {key}: the plain run launched "
                                 f"kernels {pst['launches']}")
        dev_rel = traj_dev(st["losses"], pst["losses"])
        ls = st["losses"]
        if not all(math.isfinite(x) for x in ls):
            raise AssertionError(f"train {key}: non-finite loss {ls}")
        st.update(plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
                  trajectory_rel_dev=dev_rel,
                  trajectory_tol=traj_tol(dtype, route),
                  samples_per_s=B / step_s,
                  plain_samples_per_s=B / pstep_s, tensors=n_t,
                  dtype_groups=n_g, flops_per_step=flops,
                  tflops=flops / step_s / 1e12,
                  bf16_peak_share=flops / step_s / PEAK["bfloat16"])
        results["train"][key] = st
        print(f"[train {key}] {json.dumps(st)}", flush=True)
        print(f"[train {key}] {B / step_s:.1f} samples/s, "
              f"{st['step_ms']:.2f} ms/step, {st['tflops']:.2f} TFLOP/s = "
              f"{100 * st['bf16_peak_share']:.2f}% of the dense bf16 peak "
              f"(989 TFLOP/s) of {card}", flush=True)
        tol = traj_tol(dtype, route)
        if dev_rel > tol:
            raise AssertionError(
                f"train {key}: loss trajectory departs from the plain "
                f"path's by {dev_rel:.3g} > {tol} ({ls} vs {pst['losses']})")
        if not ls[-1] < ls[0]:
            raise AssertionError(f"train {key}: loss did not fall {ls}")

    # the controls: how far a wrong kernel moves the trajectory, read
    # against the limit the sound bf16 run is held to
    oracle = results["train"]["bfloat16_adam_auto"]["plain_losses"]
    tol = traj_tol("bfloat16", "auto")
    for fault in TRAIN_FAULTS:
        st, _, _ = train_run(dev, "bfloat16", False, batch, "Adam", "auto",
                             fault)
        torch.cuda.empty_cache()
        dev_rel = traj_dev(st["losses"], oracle)
        results["train_controls"][fault] = c = dict(
            losses=st["losses"], trajectory_rel_dev=dev_rel,
            trajectory_tol=tol, over_tol=dev_rel / tol, caught=dev_rel > tol)
        print(f"[train control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            raise AssertionError(
                f"train control {fault}: the planted fault departs from the "
                f"oracle by only {dev_rel:.3g} <= {tol}; the trajectory "
                f"check cannot see it")


# ---------------------------------------------------------------------------
# phase amp: BERT-base under mixed precision
# ---------------------------------------------------------------------------

# (key, AMP dtype, weights, entry): fp16 AMP over f32 weights through the
# gluon `Trainer` with the dynamic loss scaler; the same with the weights
# cast to f16 (`convert_hybrid_block`) and f32 master copies
# (``multi_precision``); bf16 AMP through `TrainStep`, no scaler
AMP_RUNS = (("fp16_amp", "float16", "float32", "trainer"),
            ("fp16_weights", "float16", "float16", "trainer_mp"),
            ("bf16_amp", "bfloat16", "float32", "step"))
# the fp16 runs' loss is multiplied by inf at this step (JAX's overflow
# drill, tests/unittest/test_amp.py): its gradients overflow, so every
# fp16 run and its oracle must skip it, whatever the data overflows
AMP_POISON_STEP = 3
# planted fault: the Trainer applies an overflowed step (its scaler's
# check always says the gradients are finite)
AMP_FAULTS = ("overflowed_step_applied",)
AMP_LR = 1e-4           # bench.py's Adam rate, as the train phase


def _amp_norm_reference(x, gamma, beta, eps=1e-5):
    """The oracle's LayerNorm: the fused kernel's plain version behind the
    AMP hook, as `ops.nn.layer_norm` calls the kernel (f32 under AMP)."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.ops.fused_norm import fused_layer_norm_reference
    x, gamma, beta = amp.cast_inputs("layer_norm", x, gamma, beta)
    return fused_layer_norm_reference(x, gamma, beta, eps=eps)


def amp_run(dev, run, plain, batch, nudge=False, fault=None):
    """`TRAIN_STEPS` steps of BERT-base (`bert_bench`, seed 0) under
    ``amp.init(AMP dtype)``: the gluon `Trainer` loop a user writes --
    ``with amp.scale_loss(loss, trainer) as s: s.backward()``, then
    ``trainer.step(1)`` (the loss is already a mean) -- or `TrainStep`.
    ``plain=True`` is the oracle: the attention, LayerNorm and
    cross-entropy on their plain versions behind the same casts, the
    update on the kernels' plain version, no kernel launched.  `nudge`
    moves layer 0's FFN up-projection element 0 by one unit in the last
    place of the AMP dtype (the one-ulp floor); `fault` plants
    `AMP_FAULTS`.  Returns the run's stats and its step time."""
    import torch
    from mxnet_tpu_torch import amp, autograd, kernels
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.models.layers import _plain_twin
    from mxnet_tpu_torch.ops.fused_optimizer import kernel_plain
    from mxnet_tpu_torch.ops.softmax_xent import (
        softmax_cross_entropy, softmax_cross_entropy_reference)
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import TrainStep

    key, amp_dt, w_dt, entry = run
    ids, vl, mp, lab = batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    amp.init(amp_dt)
    try:
        bench = bert_bench(dev, "float32")
        if w_dt == "float16":
            amp.convert_hybrid_block(bench, "float16")
        if nudge:
            w = bench.model.bert.layers[0].ffn_intermediate.weight.data()
            with torch.no_grad():
                x = w.view(-1)[:1]
                h = x.to(getattr(torch, amp_dt))
                h.view(torch.int16).add_(1)
                x.copy_(h)
        xent = softmax_cross_entropy
        if plain:
            _plain_twin(bench, norm=_amp_norm_reference)
            xent = softmax_cross_entropy_reference
        losses, scales, skipped = [], [], []
        if entry == "step":
            def loss_fn(out, ids, vl, mp, lab):
                return xent(out[0], lab).mean()
            with pallas_mode("reference" if plain else "auto"):
                step = TrainStep(bench, Adam(learning_rate=AMP_LR), loss_fn,
                                 num_model_args=3,
                                 update=kernel_plain if plain else None)
            step.warmup(*batch)
            trainer = None
        else:
            trainer = Trainer(bench.model.collect_params(), "adam",
                              {"learning_rate": AMP_LR,
                               "multi_precision": entry == "trainer_mp"})
            amp.init_trainer(trainer)
            scaler = trainer._amp_loss_scaler
            if fault == "overflowed_step_applied":
                scaler.has_overflow = lambda params: False
        kernels.reset_launch_counts()
        with (plain_trainer_update() if plain and trainer is not None
              else contextlib.nullcontext()), pallas_mode("auto"):
            for i in range(TRAIN_STEPS):
                if trainer is None:
                    losses.append(step.dispatch(*batch).loss)
                else:
                    with autograd.record():
                        loss = xent(bench(ids, vl, mp)[0], lab).mean()
                    losses.append(loss.detach())
                    if i == AMP_POISON_STEP:
                        loss = loss * math.inf
                    with amp.scale_loss(loss, trainer) as scaled:
                        scaled.backward()
                    trainer.step(1)
                    scales.append(scaler.loss_scale)
                    if scaler._last_overflow_iter == scaler._iter - 1:
                        skipped.append(i)
                if i == 1:        # time the steady steps 3..N
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 2)
        launches = kernels.launch_counts()
        by_dtype = {f"{n}:{d}": v
                    for (n, d), v in sorted(kernels.DTYPE_LAUNCHES.items())}
        params = dict(bench.model.named_parameters())
        dtypes = sorted({str(p.dtype)[6:] for p in params.values()})
        masters = None
        if trainer is not None and entry == "trainer_mp":
            st = trainer._states
            masters = sorted({str(st[n][0].dtype)[6:] if
                              trainer._optimizer._is_mp_state(p, st[n])
                              else "none" for n, p in params.items()})
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        amp.disable()
    return dict(losses=[float(x) for x in losses], step_ms=step_s * 1e3,
                launches=launches, dtype_launches=by_dtype,
                loss_scales=scales, skipped_steps=skipped,
                weight_dtypes=dtypes, master_dtypes=masters,
                peak_mem_gb=peak), step_s


def amp_want_launches(run, layers, applied):
    """Exact launches over `TRAIN_STEPS` steps, by kernel and input dtype
    (`kernels.DTYPE_LAUNCHES`, as ``name:dtype``): the flash kernels once a
    layer each way and the cross-entropy once each way, in the AMP dtype
    (attention and the MLM head's product are TARGET ops); the fused norm
    2 a layer + 2 (embeddings, MLM head) in f32 (``layer_norm`` is an FP32
    op); and the chunk kernel once a step it applied (f32 weights: one
    group, counted under float32), none under ``multi_precision`` (the
    per-parameter route).  No other kernel."""
    _, amp_dt, _, entry = run
    want = {f"flash_attention_fwd:{amp_dt}": layers * TRAIN_STEPS,
            f"flash_attention_bwd:{amp_dt}": layers * TRAIN_STEPS,
            f"softmax_xent_fwd:{amp_dt}": TRAIN_STEPS,
            f"softmax_xent_bwd:{amp_dt}": TRAIN_STEPS,
            "fused_norm:float32": (2 * layers + 2) * TRAIN_STEPS,
            "fused_optimizer_chunk:float32":
                0 if entry == "trainer_mp" else applied}
    return {k: v for k, v in want.items() if v}


def run_amp(dev, results, card):
    """fp16 AMP with its loss scaler (the Trainer), f16 weights with f32
    masters, and bf16 AMP (`TrainStep`), each against its oracle, plus
    the one-ulp floors and the planted fault."""
    import torch
    from mxnet_tpu_torch.models import bert_base

    cfg = bert_base()
    B, S, M = 64, 128, 20
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in bert_batch(cfg.vocab_size, B, S, M))
    flops = bench_flops_per_step(cfg, B, S, M)
    runs, floors = results["amp"], results["amp_one_ulp"]
    problems = []
    for run in AMP_RUNS:
        key, amp_dt, w_dt, entry = run
        st, step_s = amp_run(dev, run, False, batch)
        nst, _ = amp_run(dev, run, False, batch, nudge=True)
        floors[key] = c = dict(
            losses=nst["losses"],
            trajectory_rel_dev=traj_dev(nst["losses"], st["losses"]))
        print(f"[amp one ulp {key}] {json.dumps(c)}", flush=True)
        pst, pstep_s = amp_run(dev, run, True, batch)
        applied = TRAIN_STEPS - len(st["skipped_steps"])
        want = amp_want_launches(run, cfg.num_layers, applied)
        # every kernel by input dtype, and any launch counted by name
        # alone beside them
        got = dict(st["dtype_launches"])
        by_name = {k.split(":")[0] for k in got}
        got.update({k: v for k, v in st["launches"].items()
                    if v and k not in by_name})
        if got != want:
            problems.append(f"amp {key}: kernel launches {got}, want {want}")
        if any(pst["launches"].values()):
            problems.append(f"amp {key}: the plain run launched kernels "
                            f"{pst['launches']}")
        ls = st["losses"]
        dev_rel = traj_dev(ls, pst["losses"])
        floor = c["trajectory_rel_dev"]
        tol = max(1e-3, GPT_FLOOR_X * floor)
        st.update(amp_dtype=amp_dt, weights=w_dt, entry=entry,
                  plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
                  plain_skipped_steps=pst["skipped_steps"],
                  plain_loss_scales=pst["loss_scales"],
                  trajectory_rel_dev=dev_rel, trajectory_tol=tol,
                  one_ulp_floor=floor, samples_per_s=B / step_s,
                  plain_samples_per_s=B / pstep_s, flops_per_step=flops,
                  tflops=flops / step_s / 1e12,
                  peak_share=flops / step_s / PEAK[amp_dt])
        runs[key] = st
        print(f"[amp {key}] {json.dumps(st)}", flush=True)
        print(f"[amp {key}] {B / step_s:.1f} samples/s, "
              f"{st['step_ms']:.2f} ms/step, {st['tflops']:.2f} TFLOP/s, "
              f"peak memory {st['peak_mem_gb']:.2f} GB on {card}; skipped "
              f"{st['skipped_steps']} (oracle {pst['skipped_steps']}); "
              f"trajectory vs plain {dev_rel:.3g} (limit {tol:.3g})",
              flush=True)
        if not all(math.isfinite(x) for x in ls):
            problems.append(f"amp {key}: non-finite loss {ls}")
        if dev_rel > tol:
            problems.append(f"amp {key}: loss trajectory departs from the "
                            f"plain path's by {dev_rel:.3g} > {tol:.3g}")
        if st["skipped_steps"] != pst["skipped_steps"]:
            problems.append(f"amp {key}: skipped {st['skipped_steps']}, "
                            f"the oracle {pst['skipped_steps']}")
        if amp_dt == "float16" and AMP_POISON_STEP not in \
                st["skipped_steps"]:
            problems.append(f"amp {key}: the poisoned step "
                            f"{AMP_POISON_STEP} was applied")
        want_masters = ["float32"] if entry == "trainer_mp" else None
        if st["weight_dtypes"] != [w_dt] or \
                st["master_dtypes"] != want_masters:
            problems.append(f"amp {key}: weights {st['weight_dtypes']}, "
                            f"masters {st['master_dtypes']}; want [{w_dt}], "
                            f"{want_masters}")
        if not ls[-1] < ls[0]:
            problems.append(f"amp {key}: loss did not fall {ls}")
    # the control, read against the sound fp16 run's oracle and limit
    ref = runs["fp16_amp"]
    for fault in AMP_FAULTS:
        st, _ = amp_run(dev, AMP_RUNS[0], False, batch, fault=fault)
        dev_rel = traj_dev(st["losses"], ref["plain_losses"])
        tol = ref["trajectory_tol"]
        results["amp_controls"][fault] = c = dict(
            losses=st["losses"], skipped_steps=st["skipped_steps"],
            trajectory_rel_dev=dev_rel, trajectory_tol=tol,
            caught=dev_rel > tol or
            st["skipped_steps"] != ref["plain_skipped_steps"])
        print(f"[amp control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            problems.append(f"amp control {fault}: the planted fault "
                            f"passes the gate")
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# phase optim: the rest of the optimizer family on the BERT-base step
# ---------------------------------------------------------------------------

# (key, class, kwargs, lr): the chunk kernel's six new rules (Signum with
# and without momentum), each at a rate its first steps train at
OPTIM_RULES = (("nag", "NAG", {}, 1e-2),
               ("signum_momentum", "Signum", {}, 1e-4),
               ("signum", "Signum", {"momentum": 0.0}, 1e-4),
               ("adabelief", "AdaBelief", {}, 1e-4),
               ("adamax", "Adamax", {}, 1e-4),
               ("adadelta", "AdaDelta", {}, 1e-2),
               ("ftml", "FTML", {}, 1e-4))
# the rules that also run through the gluon Trainer (bf16 model, state in
# bf16), under a cosine schedule with linear warmup
OPTIM_TRAINER = ("nag", "adadelta")
OPTIM_WARMUP = 5
# the per-leaf rules: (key, class, kwargs, lr, entry); the three that
# JAX's step cannot run go through the Trainer, per parameter
OPTIM_PER_LEAF = (("nadam", "Nadam", {}, 1e-4, "trainer"),
                  ("sgld", "SGLD", {}, 1e-6, "trainer"),
                  ("dcasgd", "DCASGD", {}, 1e-3, "trainer"),
                  ("lars", "LARS", {"momentum": 0.9}, 0.1, "step"),
                  ("adagrad", "AdaGrad", {}, 1e-3, "step"),
                  ("groupadagrad", "GroupAdaGrad", {}, 1e-3, "step"),
                  ("rmsprop", "RMSProp", {}, 1e-4, "step"),
                  ("ftrl", "Ftrl", {}, 1e-2, "step"),
                  ("lans", "LANS", {}, 1e-3, "step"))
OPTIM_PER_LEAF_STEPS = 3
# LAMB over an f16 BERT-base (f16 weights, f32 LayerNorm parameters, f32
# state: `TrainStep`'s `_master_dtype`): phases A and B over (f16, f32)
OPTIM_F16 = ("lamb", "LAMB", {}, 1e-3)
# the phase's BERT-base runs, and k6's BERT-base leaves, keep its widths
# and cut its depth to 4 of 12 layers, for the smoke's time limit (every
# leaf shape stays; the train phase updates the 12-layer model)
OPTIM_LAYERS = 4
# planted faults in the chunk kernel's math, each a mutation of the
# kernel's own source built into a library of its own: (rule, entry,
# dtype, [(text, replacement)]).  AdaDelta's fault shows only over 16-bit
# state, so it runs through the Trainer of a bf16 model.
OPTIM_FAULTS = {
    "adadelta_eps_sum_not_rounded": (
        "adadelta", "trainer", "bfloat16",
        [("rnd<S>(sqrtf(rnd<S>(v + epss)))", "sqrtf(v + c.eps)")]),
    "ftml_v_and_z_swapped": (
        "ftml", "step", "float32",
        [("if (s1) s1[i] = p.skip ? vr[k] : from_f<S>(v);",
          "if (s1) s1[i] = p.skip ? vr[k] : from_f<S>(z);"),
         ("if (s2) s2[i] = p.skip ? zr[k] : from_f<S>(z);",
          "if (s2) s2[i] = p.skip ? zr[k] : from_f<S>(v);")])}


def start_fault_builds():
    """Start one ``nvcc`` a fault of `OPTIM_FAULTS`, each on a copy of
    ``csrc/fused_optimizer.cu`` with the fault's replacements (each text
    must occur exactly once), with the kernels' own flags; returns {fault:
    (library path, process)}.  Started before the phases, read by the
    optim phase."""
    from mxnet_tpu_torch import kernels
    src = open(os.path.join(kernels.CSRC, "fused_optimizer.cu")).read()
    out_dir = os.path.join(HERE, "build", "mxnet_tpu_torch", "faults")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for fault, (_, _, _, edits) in OPTIM_FAULTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"fault {fault}: {old!r} occurs "
                                     f"{text.count(old)} times in the kernel")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{fault}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{fault}.so")
        # the mutated copy includes nothing from csrc/ but CUDA's headers
        procs[fault] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


@contextlib.contextmanager
def chunk_library(path):
    """The chunk kernel's entry from the library at `path` (a fault's) for
    the duration of the block."""
    import ctypes
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    fn = ctypes.CDLL(path).mxt_fused_chunk
    fn.argtypes = fo._SIGS["mxt_fused_chunk"]
    fn.restype = ctypes.c_int
    old = fo._fns.get("mxt_fused_chunk")
    fo._fns["mxt_fused_chunk"] = fn
    try:
        yield
    finally:
        if old is None:
            fo._fns.pop("mxt_fused_chunk", None)
        else:
            fo._fns["mxt_fused_chunk"] = old


@contextlib.contextmanager
def plain_trainer_update():
    """The gluon `Trainer`'s whole-tree update replaced by the kernels'
    plain version, `kernel_plain` (what ``update=kernel_plain`` does for
    `TrainStep`): a Trainer run's optimizer oracle, with every other
    kernel on the step as it is."""
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    real = fo.apply_updates

    def plain(optimizer, params, grads, states, hp, skip=None,
              use_kernel=False):
        return fo.kernel_plain(optimizer, params, grads, states, hp, skip)
    fo.apply_updates = plain
    try:
        yield
    finally:
        fo.apply_updates = real


def optim_sched(lr):
    """The Trainer runs' schedule: cosine from `lr` to lr / 10 over
    `TRAIN_STEPS` updates, after `OPTIM_WARMUP` of linear warmup from
    lr / 10."""
    from mxnet_tpu_torch.optimizer import CosineScheduler
    return CosineScheduler(max_update=TRAIN_STEPS, base_lr=lr,
                           final_lr=lr / 10, warmup_steps=OPTIM_WARMUP,
                           warmup_begin_lr=lr / 10)


def optim_run(dev, dtype, rule, batch, entry="step", plain=False,
              steps=TRAIN_STEPS, lib=None, sched=False):
    """`steps` steps of the BERT-base pretraining step (`bert_bench` at
    `OPTIM_LAYERS` layers, the mean MLM cross-entropy) with `rule` (a
    ``(class, kwargs, lr)``) through `TrainStep` or the gluon `Trainer` on
    the default route.
    ``plain`` replaces the optimizer kernel by its plain version
    (`kernel_plain`; every other kernel stays), `lib` is a fault's chunk
    library, `sched` the Trainer's `optim_sched`.  Returns the stats, the
    weights before the first step, and the weights and state after it."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import kernels, optimizer as topt
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.ops.fused_optimizer import kernel_plain
    from mxnet_tpu_torch.ops.softmax_xent import softmax_cross_entropy
    from mxnet_tpu_torch.parallel import TrainStep

    cls, kw, lr = rule
    kw = dict(kw, learning_rate=lr)
    if sched:
        kw["lr_scheduler"] = optim_sched(lr)
    opt = getattr(topt, cls)(**kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bench = bert_bench(dev, dtype, OPTIM_LAYERS)
    params = {n: p for n, p in bench.named_parameters()}

    def loss_fn(out, ids, vl, mp, lab):
        return softmax_cross_entropy(out[0], lab).mean()

    with pallas_mode("auto"), contextlib.ExitStack() as ctx:
        if entry == "step":
            step = TrainStep(bench, opt, loss_fn, num_model_args=3,
                             update=kernel_plain if plain else None)
            step.warmup(*batch)
            states = lambda: step.opt_state            # noqa: E731
        else:
            trainer = Trainer(params, opt)
            step = _TrainerStep(bench, trainer, loss_fn, num_model_args=3)
            states = lambda: trainer._states            # noqa: E731
            if plain:
                ctx.enter_context(plain_trainer_update())
        if lib is not None:
            ctx.enter_context(chunk_library(lib))
        before = {n: p.detach().clone() for n, p in params.items()}
        kernels.reset_launch_counts()
        losses, lrs = [], []
        for i in range(steps):
            out = step.dispatch(*batch)
            losses.append(out.loss if entry == "step" else out)
            if sched:       # the device scalar the update read
                lrs.append(trainer._hp._dev["lr"])
            if i == 0:
                torch.cuda.synchronize()
                after = ({n: p.detach().clone() for n, p in params.items()},
                         {n: tuple(t.clone() for t in st)
                          for n, st in states().items()})
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / max(1, steps - 2)
        launches = kernels.launch_counts()
        by_dtype = {f"{n}:{d}": v for (n, d), v in
                    sorted(kernels.DTYPE_LAUNCHES.items())
                    if n in ("fused_optimizer_chunk", "lamb_phase_a",
                             "lamb_phase_b")}
    st = dict(losses=[float(x) for x in losses], step_ms=step_s * 1e3,
              launches=launches, dtype_launches=by_dtype, dtype_groups=len(
                  {(p.dtype, tuple(t.dtype for t in states()[n]))
                   for n, p in params.items()}),
              state_dtypes=sorted({str(t.dtype)[6:] for st in
                                   states().values() for t in st}),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if lrs:
        st["lr_used"] = [float(x) for x in lrs]
        st["lr_scheduler"] = [float(np.float32(opt.lr_scheduler(k)))
                              for k in range(1, steps + 1)]
    del bench, step, params
    return st, step_s, before, after


def _optim_compare(st, pst, before, after, pafter, tol):
    """The kernel run `st` against its oracle `pst`: the first step's
    weights and state (`_opt_err`: the same gradients on both sides, the
    optimizer alone apart) and the loss trajectory (`tol`).  Updates `st`
    and returns whether both hold."""
    err, share, ok = _opt_err(after[0], after[1], pafter[0], pafter[1],
                              before)
    dev_rel = traj_dev(st["losses"], pst["losses"])
    st.update(plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
              step1_max_abs_err=err, step1_bf16_mismatch_share=share,
              step1_ok=ok, trajectory_rel_dev=dev_rel, trajectory_tol=tol)
    return ok and dev_rel <= tol


def optim_want(n_groups, layers, steps=TRAIN_STEPS, chunk=True,
               opt="Adam"):
    """Exact launches of `steps` kernel-route BERT steps: the train
    phase's counts, the chunk (LAMB: phases A and B) once per dtype group
    (none for the plain oracle)."""
    want = want_launches(opt, "auto", n_groups, layers)
    want = {k: v // TRAIN_STEPS * steps for k, v in want.items()}
    if not chunk:
        want["fused_optimizer_chunk"] = 0
    return want


def run_optim(dev, results, card, fault_builds):
    """The chunk kernel's six new rules through the BERT-base step, the
    Trainer runs under a schedule, the per-leaf rules and the planted
    faults (module docstring, phase 19)."""
    import torch
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.parallel import TrainStep

    t_phase = time.perf_counter()
    cfg = bert_base(num_layers=OPTIM_LAYERS)
    B, S, M = 64, 128, 20
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in bert_batch(cfg.vocab_size, B, S, M))
    out = results["optim"]
    out["layers"] = cfg.num_layers
    problems = []
    libs = {}
    for fault, (lib, proc) in fault_builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            problems.append(f"optim: the {fault} library did not build:\n"
                            f"{log}")
        libs[fault] = lib
    faults_of = {(r, e, d): f for f, (r, e, d, _) in OPTIM_FAULTS.items()}

    def check(key, st, pst, before, after, pafter, want, tol):
        got = {k: st["launches"][k] for k in want}
        pwant = dict(want, fused_optimizer_chunk=0, lamb_phase_a=0,
                     lamb_phase_b=0)
        pgot = {k: pst["launches"][k] for k in pwant}
        if got != want or pgot != pwant:
            problems.append(f"optim {key}: launches {got} (oracle {pgot}), "
                            f"want {want} (oracle {pwant})")
        ok = _optim_compare(st, pst, before, after, pafter, tol)
        ls = st["losses"]
        if not all(math.isfinite(x) for x in ls):
            problems.append(f"optim {key}: non-finite loss {ls}")
        elif not ok:
            problems.append(
                f"optim {key}: step 1 {st['step1_ok']} (max-abs "
                f"{st['step1_max_abs_err']:.3g}, 16-bit share "
                f"{st['step1_bf16_mismatch_share']:.3g}), trajectory "
                f"{st['trajectory_rel_dev']:.3g} > {tol}")
        elif not ls[-1] < ls[0]:
            problems.append(f"optim {key}: loss did not fall {ls}")
        st["samples_per_s"] = B / (st["step_ms"] / 1e3)
        out[key] = st
        print(f"[optim {key}] {json.dumps(st)}", flush=True)

    def control(fault, rule, entry, dtype, pst, before, pafter, sched):
        st, _, _, after = optim_run(dev, dtype, rule, batch, entry,
                                    lib=libs[fault], sched=sched)
        tol = traj_tol(dtype, "auto")
        _optim_compare(st, pst, before, after, pafter, tol)
        c = dict(losses=st["losses"], step1_ok=st["step1_ok"],
                 step1_max_abs_err=st["step1_max_abs_err"],
                 step1_bf16_mismatch_share=st["step1_bf16_mismatch_share"],
                 trajectory_rel_dev=st["trajectory_rel_dev"],
                 trajectory_tol=tol, launches=st["launches"],
                 caught=not st["step1_ok"] or
                 st["trajectory_rel_dev"] > tol)
        out[f"control_{fault}"] = c
        print(f"[optim control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            problems.append(f"optim control {fault}: the planted fault "
                            f"passes both checks")

    runs = [(key, cls, kw, lr, "step", dtype, False)
            for key, cls, kw, lr in OPTIM_RULES
            for dtype in ("bfloat16", "float32")]
    runs += [(key, cls, kw, lr, "trainer", "bfloat16", True)
             for key, cls, kw, lr in OPTIM_RULES if key in OPTIM_TRAINER]
    for key, cls, kw, lr, entry, dtype, sched in runs:
        name = f"{key}_{entry}_{dtype}"
        rule = (cls, kw, lr)
        st, _, before, after = optim_run(dev, dtype, rule, batch, entry,
                                         sched=sched)
        pst, _, _, pafter = optim_run(dev, dtype, rule, batch, entry,
                                      plain=True, sched=sched)
        want = optim_want(st["dtype_groups"], cfg.num_layers)
        check(name, st, pst, before, after, pafter, want,
              traj_tol(dtype, "auto"))
        if sched:
            st["lr_matches_scheduler"] = st["lr_used"] == st["lr_scheduler"]
            if not st["lr_matches_scheduler"]:
                problems.append(f"optim {name}: the steps ran at "
                                f"{st['lr_used']}, the schedule says "
                                f"{st['lr_scheduler']}")
        fault = faults_of.get((key, entry, dtype))
        if fault is not None and fault in libs:
            control(fault, rule, entry, dtype, pst, before, pafter, sched)
        del before, after, pafter
        torch.cuda.empty_cache()

    # LAMB over the f16 model: phases A and B once a dtype group a step,
    # each counted under its group's weight dtype
    key, cls, kw, lr = OPTIM_F16
    name = f"{key}_step_float16"
    st, _, before, after = optim_run(dev, "float16", (cls, kw, lr), batch)
    pst, _, _, pafter = optim_run(dev, "float16", (cls, kw, lr), batch,
                                  plain=True)
    want_d = {f"lamb_phase_{p}:{d}": TRAIN_STEPS for p in "ab"
              for d in ("float16", "float32")}
    if st["dtype_launches"] != want_d or st["state_dtypes"] != ["float32"]:
        problems.append(f"optim {name}: launches by dtype "
                        f"{st['dtype_launches']} (want {want_d}), state "
                        f"{st['state_dtypes']}")
    check(name, st, pst, before, after, pafter,
          optim_want(st["dtype_groups"], cfg.num_layers, opt="LAMB"),
          traj_tol("float16", "auto"))
    del before, after, pafter
    torch.cuda.empty_cache()

    # the per-leaf rules: a few steps each, finite, no optimizer kernel,
    # the state in the dtypes the entry declares
    for key, cls, kw, lr, entry in OPTIM_PER_LEAF:
        st, _, _, _ = optim_run(dev, "bfloat16", (cls, kw, lr), batch,
                                entry, steps=OPTIM_PER_LEAF_STEPS)
        want_dt = ["bfloat16", "float32"] if entry == "trainer" \
            else ["float32"]
        opt_launch = sum(st["launches"][k] for k in (
            "fused_optimizer_chunk", "lamb_phase_a", "lamb_phase_b"))
        st.update(entry=entry, optimizer_launches=opt_launch,
                  want_state_dtypes=want_dt)
        name = f"{key}_{entry}_bfloat16"
        out[name] = st
        print(f"[optim {name}] {json.dumps(st)}", flush=True)
        if not all(math.isfinite(x) for x in st["losses"]):
            problems.append(f"optim {name}: non-finite loss "
                            f"{st['losses']}")
        if opt_launch:
            problems.append(f"optim {name}: a per-leaf rule launched the "
                            f"optimizer kernels {st['launches']}")
        if st["state_dtypes"] and st["state_dtypes"] != want_dt:
            problems.append(f"optim {name}: state in {st['state_dtypes']}, "
                            f"want {want_dt}")
    # the rules JAX's step cannot run are refused by name on the card too
    refused = {}
    lin = torch.nn.Linear(4, 4, device=dev)
    for cls in ("Nadam", "SGLD", "DCASGD"):
        try:
            TrainStep(lin, getattr(topt, cls)(), lambda o, x: o.sum(),
                      num_model_args=1)
            refused[cls] = None
        except MXNetError as e:
            refused[cls] = str(e)
    out["train_step_refuses"] = refused
    if not all(v and cls in v for cls, v in refused.items()):
        problems.append(f"optim: TrainStep did not refuse {refused}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[optim] {out['seconds']:.1f} s on {card}", flush=True)
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# phase 11: the MoE row gather against its plain version
# ---------------------------------------------------------------------------

MOE_H, MOE_I, MOE_E, MOE_CF = 768, 3072, 8, 1.25   # switch-base-8's widths
MOE_B, MOE_L = 64, 128                             # bench.py's batch
# (dtype, tokens, experts, hidden, capacity factor): the slice's shapes
# in each dtype, the slice's 10240 rows at a width whose rows take 8-byte
# pieces (h 100 in bf16: 200 bytes), and an odd one (capacity
# int(0.46 * 53 / 4) = 6) through the wrappers
K7_CASES = (("float32", 8192, 8, 768, 1.25), ("bfloat16", 8192, 8, 768, 1.25),
            ("float16", 8192, 8, 768, 1.25), ("bfloat16", 8192, 8, 100, 1.25),
            ("float32", 53, 4, 256, 0.46))


def skewed_routing(dev, T, E, H, cf, seed):
    """Seeded tokens (T, H) and a router whose row e is scaled by 1 +
    0.25 e, routed by the layer's own `route`: later experts draw more
    tokens than their capacity, earlier ones leave slots empty."""
    import torch
    from mxnet_tpu_torch.parallel.moe import route
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, H, generator=g)
    rw = torch.randn(E, H, generator=g) / H ** 0.5
    rw = rw * (1.0 + 0.25 * torch.arange(E, dtype=torch.float32))[:, None]
    expert, gate, pos, kept, cap, _ = route(x.to(dev), rw.to(dev), cf)
    return x, expert, gate, pos, kept, cap


def _faults_caught(md, down, expert, pos, kept, gate, E, C, want):
    """Planted faults of the combine launched on the card, each compared
    with the plain version as a sound result is: the scale ignored, and
    ``kept`` ignored (dropped tokens read their expert's slot 0 at their
    gate).  Returns {fault: rejected}."""
    import torch
    slot, _ = md.combine_index(expert, pos, kept, gate, E, C)
    no_kept = (expert.to(torch.int32) * C + pos).to(torch.int32)
    bad = {"scale_ignored": md.gather_rows(down, slot, None,
                                           counter="moe_combine"),
           "kept_ignored": md.gather_rows(down, no_kept, gate.float(),
                                          counter="moe_combine")}
    return {k: not torch.equal(v, want) for k, v in bad.items()}


def k7_cases(dev):
    """The row gather at the slice's shapes and an odd one: bit equality
    with `gather_rows_plain`, zero rows, planted faults, times, host µs a
    call and the launch plan."""
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import moe_dispatch as md

    out = []
    for dtype, T, E, H, cf in K7_CASES:
        dt = getattr(torch, dtype)
        x, expert, gate, pos, kept, C = skewed_routing(dev, T, E, H, cf,
                                                       seed=11)
        x = x.to(dev, dt)
        g = torch.Generator().manual_seed(12)
        down = torch.randn(E * C, H, generator=g).to(dev, dt)
        inv = md.dispatch_index(expert, pos, kept, E, C)
        slot, scale = md.combine_index(expert, pos, kept, gate, E, C)
        got = {"dispatch": md.gather_rows(x, inv, counter="moe_dispatch"),
               "combine": md.gather_rows(down, slot, scale,
                                         counter="moe_combine")}
        want = {"dispatch": md.gather_rows_plain(x, inv),
                "combine": md.gather_rows_plain(down, slot, scale)}
        if T < 1000:      # the odd case through the public wrappers
            got["dispatch"] = md.moe_dispatch(
                x, expert, pos, kept, E, C, use_kernel=True).reshape(-1, H)
            got["combine"] = md.moe_combine(
                down.reshape(E, C, H), expert, pos, kept, gate,
                use_kernel=True)
        torch.cuda.synchronize()
        empty = inv == T
        zero = {"dispatch": empty, "combine": ~kept}
        n_kept = int(kept.sum())
        controls = _faults_caught(md, down, expert, pos, kept, gate, E, C,
                                  want["combine"])
        xz = torch.cat([x, x.new_zeros(1, H)])
        dz = torch.cat([down, down.new_zeros(1, H)])
        inv64, slot64, scale_dt = inv.long(), slot.long(), scale.to(dt)
        item = x.element_size()
        for op in ("dispatch", "combine"):
            a, b = got[op], want[op]
            case = dict(dtype=dtype, op=op, T=T, E=E, C=C, H=H,
                        kept=n_kept, dropped=T - n_kept,
                        empty_slots=int(empty.sum()),
                        bit_equal=bool(torch.equal(a, b)),
                        zero_rows_exact=not bool(a[zero[op]].any()),
                        max_abs_err=float((a.float() - b.float()).abs().max()))
            case["ok"] = case["bit_equal"] and case["zero_rows_exact"]
            if T > 1000:    # the slice's shapes overflow and leave slots empty
                case["ok"] = case["ok"] and case["dropped"] > 0 and \
                    case["empty_slots"] > 0
            src = down if op == "combine" else x
            case["plan"] = md._plan(
                a.shape[0], H, item,
                md._piece(H, item, src.data_ptr(), a.data_ptr()),
                kernels.sm_count(a.device))._asdict()
            if op == "combine":
                case["controls_caught"] = controls
                case["ok"] = case["ok"] and all(controls.values())
                case["ms"] = time_ms(lambda: md.gather_rows(
                    down, slot, scale, counter="moe_combine"))
                case["host_us"] = host_us(lambda: md.gather_rows(
                    down, slot, scale, counter="moe_combine"))
                case["plain_ms"] = time_ms(lambda: md.gather_rows_plain(
                    down, slot, scale))
                # two calls: no one library call gathers and scales
                case["library_ms"] = time_ms(lambda: torch.index_select(
                    dz, 0, slot64) * scale_dt[:, None])
                case["library_calls"] = 2
                nbytes = n_kept * H * item + T * H * item + 8 * T
                flops = T * H
            else:
                case["ms"] = time_ms(lambda: md.gather_rows(
                    x, inv, counter="moe_dispatch"))
                case["host_us"] = host_us(lambda: md.gather_rows(
                    x, inv, counter="moe_dispatch"))
                case["plain_ms"] = time_ms(lambda: md.gather_rows_plain(
                    x, inv))
                case["library_ms"] = time_ms(lambda: torch.index_select(
                    xz, 0, inv64))
                case["library_calls"] = 1
                nbytes = n_kept * H * item + E * C * H * item + 4 * E * C
                flops = 0
            case["bound_ms"], case["bound_by"] = bound(nbytes, flops,
                                                       "float32")
            out.append(case)
    return out


# ---------------------------------------------------------------------------
# phase 12: the autotuner's trial launches of the chunk kernel (row 10)
# ---------------------------------------------------------------------------

def moe_param_count():
    return MOE_E * MOE_H + 2 * MOE_E * MOE_I * MOE_H


def run_tune(dev, results, card):
    """Cold and warm ``tune("fused_optimizer", (n,), "float32")`` for the
    MoE layer's and BERT-base's f32 parameter counts, in a temporary
    cache; every candidate's bits against ``CHUNK``'s; the next launch's
    chunk; the same under "float16" for GPT-2 small's f16 leaves; then
    K2's plan (f32 and f16 activations), K1's page size (f32 and an f16
    pool) and the flash forward's blocks.
    The tuned configs are dropped from this process's memory after the
    phase, so each later phase launches at its static default whatever ran
    before it."""
    import tempfile
    import torch
    from mxnet_tpu_torch import kernels, optimizer as topt
    from mxnet_tpu_torch.ops import autotune as at
    from mxnet_tpu_torch.ops import fused_optimizer as fo

    bert_n = sum(math.prod(s) for _, s, _ in bert_leaves("float32"))
    old = os.environ.get("MXTPU_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MXTPU_AUTOTUNE_CACHE"] = tmp
        at.clear_memory_cache()
        try:
            cases = [(label, lambda n=n: tune_case(dev, n, at, fo, topt,
                                                   kernels, torch))
                     for label, n in (("moe_f32", moe_param_count()),
                                      ("bert_f32", bert_n))]
            gpt_n = sum(math.prod(s) for _, s, _ in gpt_leaves("float16"))
            cases += [("gpt_f16", lambda: tune_case(
                          dev, gpt_n, at, fo, topt, kernels, torch,
                          "float16")),
                      ("k2_int8", lambda: k2_tune_case(dev, at, kernels,
                                                       torch)),
                      ("k2_int8_float16", lambda: k2_tune_case(
                          dev, at, kernels, torch, "float16")),
                      ("k1_page_size", lambda: k1_tune_case(at, kernels,
                                                            torch)),
                      ("k1_page_size_float16", lambda: fresh_cache(
                          at, tmp, "f16", lambda: k1_tune_case(
                              at, kernels, torch, "float16"))),
                      ("flash_fwd_bf16", lambda: flash_tune_case(
                          at, kernels, torch)),
                      ("norm_bf16", lambda: norm_tune_case(at, kernels,
                                                           torch))]
            for label, case in cases:
                results["tune"][label] = st = case()
                print(f"[tune {label}] {json.dumps(st)}", flush=True)
                for c, t in st["timings_ms"].items():
                    print(f"[tune {label}] {c}: {t:.4f} ms (CUDA events, L2 "
                          f"flushed) on {card}", flush=True)
                print(f"[tune {label}] pick {st['config']}", flush=True)
                if not st["ok"]:
                    raise AssertionError(f"tune {label}: {st}")
        finally:
            at.clear_memory_cache()
            if old is None:
                os.environ.pop("MXTPU_AUTOTUNE_CACHE", None)
            else:
                os.environ["MXTPU_AUTOTUNE_CACHE"] = old


K2_TUNE = (8, 2304, 768)      # decode's QKV projection, int8 f32


def fresh_cache(at, root, name, fn):
    """`fn()` with the tuner's cache in a fresh directory under `root` and
    its memory cache cleared before and after: `ServeConfig()` takes any
    tuned page size of the device kind, so a second K1 search is read
    alone."""
    old = os.environ.get("MXTPU_AUTOTUNE_CACHE")
    os.environ["MXTPU_AUTOTUNE_CACHE"] = os.path.join(root, name)
    os.makedirs(os.environ["MXTPU_AUTOTUNE_CACHE"], exist_ok=True)
    at.clear_memory_cache()
    try:
        return fn()
    finally:
        at.clear_memory_cache()
        os.environ["MXTPU_AUTOTUNE_CACHE"] = old


def least_pick(res):
    """Is a cold `tune` result's pick the trial of least time?"""
    return res.timings_ms[res.config.key()] == min(res.timings_ms.values())


def k2_tune_case(dev, at, kernels, torch, dtype="float32"):
    """Cold and warm ``tune("quantized_matmul", (8, 2304, 768), key)`` over
    K2's whole plan menu, the key ``int8`` for f32 activations and
    ``int8_float16`` for f16 ones (the trials launch K2 on x of that
    dtype); every candidate's launch against the plain version; the next
    `quantized_matmul` takes the tuned plan."""
    from mxnet_tpu_torch.ops import quantized_matmul as qm
    M, N, K = K2_TUNE
    xdt = getattr(torch, dtype)
    key = qm._tune_dtype(8, xdt)
    cands = qm._candidates(K2_TUNE, key)
    kernels.reset_launch_counts()
    cold = at.tune("quantized_matmul", K2_TUNE, key, top_k=len(cands))
    trial_launches = kernels.launch_counts()["quantized_matmul"]
    trial_dtypes = {f"{k}:{d}": v for (k, d), v in
                    kernels.DTYPE_LAUNCHES.items()}
    warm = at.tune("quantized_matmul", K2_TUNE, key, top_k=len(cands))
    warm_launches = kernels.launch_counts()["quantized_matmul"] - \
        trial_launches
    g = torch.Generator().manual_seed(17)
    qt = qm.quantize_weight(torch.randn(N, K, generator=g) * 0.02, 8).to(dev)
    x = torch.randn(M, K, generator=g).to(dev, xdt)
    ref = qm.quantized_matmul_reference(x, qt)
    scale = float(ref.abs().max())
    sms = qm._sms(x.device)
    errs = {}
    for c in cands:
        plan = qm._plan(M, N, K, 8, x.dtype, sms, qm.VARIANTS[c.variant],
                        c.split)
        got = qm._qmm_cuda(x, qt, plan)
        torch.cuda.synchronize()
        errs[f"{plan.variant}/{plan.split}"] = float(
            (got.float() - ref.float()).abs().max())
    tuned = qm._tuned_plan(M, N, K, 8, x.dtype, x.device)
    kernels.reset_launch_counts()
    qm.quantized_matmul(x, qt)
    next_launches = kernels.launch_counts()["quantized_matmul"]
    per_trial = 1 + 5          # time_callable's warmup and runs
    st = dict(shape=list(K2_TUNE), key=key, candidates=len(cands),
              trial_launches_by_dtype=trial_dtypes,
              config=dict(cold.config), cold_trials=cold.trials,
              cold_search_ms=cold.search_ms, trial_launches=trial_launches,
              timings_ms={f"{qm.VARIANTS[dict(k)['variant']]}/"
                          f"{dict(k)['split']}": v
                          for k, v in cold.timings_ms.items()},
              warm_hit=warm.cache_hit, warm_trials=warm.trials,
              warm_launches=warm_launches, candidate_errs=errs,
              tol=TOL[dtype] * scale, tuned_plan=dict(tuned._asdict()),
              next_launches=next_launches)
    st["pick_is_least"] = least_pick(cold)
    st["ok"] = (st["pick_is_least"] and cold.trials == len(cands)
                and trial_launches == per_trial * cold.trials
                and trial_dtypes == {f"quantized_matmul:{dtype}":
                                     trial_launches}
                and warm.cache_hit and warm.trials == 0
                and warm_launches == 0
                and all(e <= st["tol"] for e in errs.values())
                and (qm.VARIANTS.index(tuned.variant), tuned.split)
                == (cold.config.variant, cold.config.split)
                and next_launches == 1)
    return st


K1_TUNE = (8, 12, 12, 64, 512)   # slots, heads, kv heads, head dim, ctx


def k1_tune_case(at, kernels, torch, dtype="float32"):
    """Cold and warm ``tune("paged_attention", (8, 12, 12, 64, 512),
    dtype)`` over the four page sizes (an f16 key times K1 over f16
    queries and an f16 pool, counted under float16); each candidate's
    decode step against the plain version; `ServeConfig()` then takes the
    tuned page size (``MXTPU_SERVE_PAGE_SIZE`` unset for the check)."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serve import ServeConfig
    cands = pa._at_candidates(K1_TUNE, dtype)
    kernels.reset_launch_counts()
    cold = at.tune("paged_attention", K1_TUNE, dtype, top_k=len(cands))
    trial_launches = kernels.launch_counts()["ragged_paged_attention"]
    trial_dtypes = {f"{k}:{d}": v for (k, d), v in
                    kernels.DTYPE_LAUNCHES.items()}
    warm = at.tune("paged_attention", K1_TUNE, dtype, top_k=len(cands))
    warm_launches = kernels.launch_counts()["ragged_paged_attention"] - \
        trial_launches
    errs, tols = {}, {}
    for c in cands:
        args = pa._at_inputs(c, K1_TUNE, dtype, torch.device("cuda", 0))
        got = pa.ragged_paged_attention(*args)
        ref = pa.paged_attention_reference(*args)
        torch.cuda.synchronize()
        errs[c.page_size] = float((got.float() - ref.float()).abs().max())
        tols[c.page_size] = TOL[dtype] * float(ref.float().abs().max())
    env = os.environ.pop("MXTPU_SERVE_PAGE_SIZE", None)
    try:
        serve_page = ServeConfig().page_size
    finally:
        if env is not None:
            os.environ["MXTPU_SERVE_PAGE_SIZE"] = env
    per_trial = 1 + 5          # time_callable's warmup and runs
    st = dict(shape=list(K1_TUNE), dtype=dtype, candidates=len(cands),
              trial_launches_by_dtype=trial_dtypes,
              config=dict(cold.config), cold_trials=cold.trials,
              cold_search_ms=cold.search_ms, trial_launches=trial_launches,
              timings_ms={dict(k)["page_size"]: v
                          for k, v in cold.timings_ms.items()},
              warm_hit=warm.cache_hit, warm_trials=warm.trials,
              warm_launches=warm_launches, candidate_errs=errs,
              candidate_tols=tols, serve_config_page_size=serve_page)
    st["pick_is_least"] = least_pick(cold)
    st["ok"] = (st["pick_is_least"] and cold.trials == len(cands)
                and trial_launches == per_trial * cold.trials
                and warm.cache_hit and warm.trials == 0
                and warm_launches == 0
                and all(errs[p] <= tols[p] for p in errs)
                and trial_dtypes == {f"ragged_paged_attention:{dtype}":
                                     trial_launches}
                and serve_page == cold.config.page_size)
    return st


FLASH_TUNE = (64, 12, 128, 128, 64)   # BERT-base's attention: B, H, Lq, Lk, D


def flash_tune_case(at, kernels, torch):
    """Cold and warm ``tune("flash_attention", (64, 12, 128, 128, 64),
    "bfloat16")`` over the forward's (block_q, block_k) menu: the trials
    launch the CUDA forward, every candidate's causal forward (the trial's
    call) is within 2e-2 of the plain version's scale, a warm call is a hit
    with 0 trials, and the next call's plan takes the tuned blocks."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda", 0)
    B, H, Lq, Lk, D = FLASH_TUNE
    cands = fa._at_candidates(FLASH_TUNE, "bfloat16")
    env = {k: os.environ.pop(k, None) for k in ("MXTPU_FLASH_BLOCK_Q",
                                                "MXTPU_FLASH_BLOCK_K")}
    try:
        kernels.reset_launch_counts()
        cold = at.tune("flash_attention", FLASH_TUNE, "bfloat16",
                       top_k=len(cands))
        trial_launches = kernels.launch_counts()["flash_attention_fwd"]
        warm = at.tune("flash_attention", FLASH_TUNE, "bfloat16",
                       top_k=len(cands))
        warm_launches = kernels.launch_counts()["flash_attention_fwd"] - \
            trial_launches
        q, k, v = fa._at_inputs(FLASH_TUNE, "bfloat16", dev)
        ref = fa.flash_attention_reference(q, k, v, causal=True)
        tol = TOL["bfloat16"] * float(ref.float().abs().max())
        errs = {}
        for c in cands:
            got = fa.flash_attention(q, k, v, causal=True,
                                     block_q=c.block_q, block_k=c.block_k)
            torch.cuda.synchronize()
            errs[f"{c.block_q}x{c.block_k}"] = float(
                (got.float() - ref.float()).abs().max())
        plan = fa._planned_fwd(B, H, Lq, Lk, D, torch.bfloat16, dev)
    finally:
        for k_, v_ in env.items():
            if v_ is not None:
                os.environ[k_] = v_
    per_trial = 1 + 5          # time_callable's warmup and runs
    st = dict(shape=list(FLASH_TUNE), candidates=len(cands),
              config=dict(cold.config), cold_trials=cold.trials,
              cold_search_ms=cold.search_ms, trial_launches=trial_launches,
              timings_ms={f"{dict(k_)['block_q']}x{dict(k_)['block_k']}": v_
                          for k_, v_ in cold.timings_ms.items()},
              warm_hit=warm.cache_hit, warm_trials=warm.trials,
              warm_launches=warm_launches, candidate_errs=errs, tol=tol,
              next_plan=plan._asdict())
    st["pick_is_least"] = least_pick(cold)
    st["ok"] = (st["pick_is_least"] and cold.trials == len(cands)
                and trial_launches == per_trial * cold.trials
                and warm.cache_hit and warm.trials == 0
                and warm_launches == 0
                and all(e <= tol for e in errs.values())
                and (plan.bq, plan.bk, plan.source)
                == (cold.config.block_q, cold.config.block_k, "tuned"))
    return st


NORM_TUNE = (8192, 768)       # the BERT step's LayerNorm rows, hidden 768


def norm_tune_case(at, kernels, torch):
    """Cold and warm ``tune("fused_norm", (8192, 768), "bfloat16")`` over
    JAX's block_rows menu: the trials launch the CUDA kernel, every
    candidate's LayerNorm (the trial's call) is within 2e-2 of the plain
    version's scale, a warm call is a hit with 0 trials, and the next
    call's plan takes the tuned block_rows ("tuned")."""
    from mxnet_tpu_torch.ops import fused_norm as fn
    dev = torch.device("cuda", 0)
    cands = fn._candidates(NORM_TUNE, "bfloat16")
    kernels.reset_launch_counts()
    cold = at.tune("fused_norm", NORM_TUNE, "bfloat16", top_k=len(cands))
    trial_launches = kernels.launch_counts()["fused_norm"]
    warm = at.tune("fused_norm", NORM_TUNE, "bfloat16", top_k=len(cands))
    warm_launches = kernels.launch_counts()["fused_norm"] - trial_launches
    x, g, b = fn._at_inputs(NORM_TUNE, "bfloat16", dev)
    ref = fn.norm_plain(x, None, g, b, 1e-5, False)
    tol = TOL["bfloat16"] * float(ref.float().abs().max())
    errs = {}
    for c in cands:
        got = fn._norm_cuda(x, None, g, b, 1e-5, False,
                            block_rows=c.block_rows)
        torch.cuda.synchronize()
        errs[c.block_rows] = float((got.float() - ref.float()).abs().max())
    kernels.reset_launch_counts()
    fn.fused_layer_norm(x, g, b, use_kernel=True)
    torch.cuda.synchronize()
    next_launches = kernels.launch_counts()["fused_norm"]
    plan = fn._planned(*NORM_TUNE, x.dtype, g.dtype, dev, fn._aligned(x))
    per_trial = 1 + 5          # time_callable's warmup and runs
    st = dict(shape=list(NORM_TUNE), candidates=len(cands),
              config=dict(cold.config), cold_trials=cold.trials,
              cold_search_ms=cold.search_ms, trial_launches=trial_launches,
              timings_ms={dict(k_)["block_rows"]: v_
                          for k_, v_ in cold.timings_ms.items()},
              warm_hit=warm.cache_hit, warm_trials=warm.trials,
              warm_launches=warm_launches, candidate_errs=errs, tol=tol,
              next_launches=next_launches, next_plan=plan._asdict())
    st["pick_is_least"] = least_pick(cold)
    st["ok"] = (st["pick_is_least"] and cold.trials == len(cands)
                and trial_launches == per_trial * cold.trials
                and warm.cache_hit and warm.trials == 0
                and warm_launches == 0 and next_launches == 1
                and all(e <= tol for e in errs.values())
                and (plan.block_rows, plan.source)
                == (cold.config.block_rows, "tuned"))
    # a second cold search (memory and disk cleared): the same pick, or
    # how far apart the two picks' times lie in each search
    at.clear_memory_cache()
    os.remove(at._disk_path("fused_norm"))
    again = at.tune("fused_norm", NORM_TUNE, "bfloat16", top_k=len(cands))
    t1 = st["timings_ms"]
    t2 = {dict(k_)["block_rows"]: v_ for k_, v_ in again.timings_ms.items()}
    a, b = cold.config.block_rows, again.config.block_rows
    st.update(second_config=dict(again.config), second_timings_ms=t2,
              same_pick=a == b,
              picks_gap=max(t1[b] / t1[a], t2[a] / t2[b]) - 1.0)
    st["ok"] = st["ok"] and least_pick(again)
    return st


def tune_case(dev, n, at, fo, topt, kernels, torch, dtype="float32"):
    """Cold and warm ``tune("fused_optimizer", (n,), dtype)``: the trials
    launch the chunk over a `dtype` leaf with f32 moments (counted under
    `dtype`); every candidate chunk gives ``CHUNK``'s bits, ``CHUNK``'s
    within `_opt_err` of the plain version; the next `apply_updates` takes
    the tuned chunk; timed beside the plain version and torch's fused Adam
    (over f16 moments for an f16 leaf: its state takes the weight's
    dtype, another function)."""
    wdt = getattr(torch, dtype)
    kernels.reset_launch_counts()
    cold = at.tune("fused_optimizer", (n,), dtype)
    trial_launches = kernels.launch_counts()["fused_optimizer_chunk"]
    trial_dtypes = {f"{k}:{d}": v for (k, d), v in
                    kernels.DTYPE_LAUNCHES.items()}
    warm = at.tune("fused_optimizer", (n,), dtype)
    warm_launches = kernels.launch_counts()["fused_optimizer_chunk"] - \
        trial_launches
    # bits at every candidate against CHUNK's, CHUNK's against the plain
    opt = topt.Adam(learning_rate=1e-3)
    g = torch.Generator(device=dev).manual_seed(13)
    w0 = {"w": (0.02 * torch.randn(n, generator=g, device=dev)).to(wdt)}
    gr = {"w": (1e-3 * torch.randn(n, generator=g, device=dev)).to(wdt)}
    s0 = {"w": (1e-4 * torch.randn(n, generator=g, device=dev),
                1e-8 * torch.rand(n, generator=g, device=dev))}
    hp = {k: torch.full((), v, device=dev) for k, v in (
        ("lr", 1e-3), ("wd", 0.01), ("rescale_grad", 1.0), ("t", 3.0))}
    hp["clip_gradient"] = None
    keep, hptr = fo._device_hp(hp, None, dev)

    def at_chunk(chunk):
        p = {"w": w0["w"].clone()}
        s = {"w": tuple(t.clone() for t in s0["w"])}
        fo._chunk_cuda(opt, 0, ["w"], p, gr, s, hptr, dev, chunk)
        return p, s
    ref_p, ref_s = at_chunk(fo.CHUNK)
    want_p, want_s = fo.kernel_plain(opt, w0, gr, s0, hp)
    err, _, plain_ok = _opt_err(ref_p, ref_s, want_p, want_s, w0)
    del want_p, want_s
    equal = {}
    for c in fo._candidates((n,), "float32"):
        p, s = at_chunk(c.chunk)
        equal[c.chunk] = bool(torch.equal(p["w"], ref_p["w"]) and all(
            torch.equal(a, b) for a, b in zip(s["w"], ref_s["w"])))
        del p, s
    # the next apply_updates launches with the tuned chunk
    kernels.reset_launch_counts()
    fo.apply_updates(opt, {"w": ref_p["w"]}, gr, ref_s, hp, use_kernel=True)
    torch.cuda.synchronize()
    next_chunk = fo.last_chunk[dtype]
    next_launches = kernels.launch_counts()["fused_optimizer_chunk"]
    bound_ms, bound_by = _opt_bound("adam", w0)
    # the tuned chunk's launch (CUDA events, L2 flushed) beside the plain
    # version and torch's one-call fused Adam over the same leaf
    tp, ts = ref_p, ref_s
    chunk = cold.config.chunk
    ms = time_ms(lambda: fo._chunk_cuda(opt, 0, ["w"], tp, gr, ts, hptr,
                                        dev, chunk), iters=10, warm=2)
    plain_ms = time_ms(lambda: fo.kernel_plain(opt, tp, gr, ts, hp),
                       iters=5, warm=1)
    steps = [torch.full((), 3.0, device=dev)]
    lm, lv = (t.to(wdt) for t in ts["w"])
    library_ms = time_ms(lambda: torch._fused_adam_(
        [tp["w"]], [gr["w"]], [lm], [lv], [], steps,
        lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
        amsgrad=False, maximize=False), iters=10, warm=2)
    del keep, ref_p, ref_s, w0, gr, s0, tp, ts, lm, lv
    torch.cuda.empty_cache()
    per_trial = 1 + 5          # time_callable's warmup and runs
    st = dict(elements=n, dtype=dtype, trial_launches_by_dtype=trial_dtypes,
              bucket=at.shape_bucket((n,))[0],
              config=dict(cold.config), cold_trials=cold.trials,
              cold_search_ms=cold.search_ms,
              trial_launches=trial_launches,
              timings_ms={str(dict(k)["chunk"]): v
                          for k, v in cold.timings_ms.items()},
              warm_hit=warm.cache_hit, warm_trials=warm.trials,
              warm_launches=warm_launches,
              candidates_bit_equal_to_chunk=equal,
              chunk_vs_plain_err=err, chunk_vs_plain_ok=plain_ok,
              next_launch_chunk=next_chunk,
              next_launches=next_launches, ms=ms, plain_ms=plain_ms,
              library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    st["pick_is_least"] = least_pick(cold)
    st["ok"] = (st["pick_is_least"] and cold.trials > 0
                and trial_launches == per_trial * cold.trials
                and trial_dtypes == {f"fused_optimizer_chunk:{dtype}":
                                     trial_launches}
                and warm.cache_hit and warm.trials == 0
                and warm_launches == 0 and all(equal.values()) and plain_ok
                and next_chunk == cold.config.chunk and next_launches == 1)
    return st


# ---------------------------------------------------------------------------
# phase 13: Switch-MoE training at full width
# ---------------------------------------------------------------------------

# (weights, entry point): TrainStep (f32 optimizer state) and the gluon
# Trainer (state in the weights' dtype: the chunk kernel's bf16/bf16
# instance for a bf16 layer)
MOE_RUNS = (("float32", "step"), ("bfloat16", "step"),
            ("float32", "trainer"), ("bfloat16", "trainer"))
MOE_FAULTS = ("combine_without_gate",)


def moe_tol(dtype):
    """Loss trajectory limit, relative, kernel route vs its plain oracle.
    f32: the gathers are copies and one f32 multiply on both routes and
    the chunk kernel is Adam's math, so the runs differ by f32 rounding of
    the update alone (fused multiply-adds) and the routing flips only at
    near ties, each token 1/8192 of the loss: 1e-4, `traj_tol`'s f32 limit.
    bf16: the kernel's combine multiplies in f32 and casts once, the
    reference in bf16 (two roundings, as in JAX), so rows differ by a bf16
    step and the difference spreads through the updates: 1e-3,
    `traj_tol`'s bf16 kernel-route limit.  The planted fault shows how far
    above it a wrong kernel lands."""
    return 1e-3 if dtype == "bfloat16" else 1e-4


def moe_batch(dev, dtype, seed=21):
    """bench.py's 64 x 128 tokens at hidden 768: seeded x and target."""
    import torch
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(MOE_B, MOE_L, MOE_H, generator=g).to(dev, dt)
                 for _ in range(2))


def moe_loss(out, x, y):
    """MSE to the target plus 0.01 x the load-balance loss, in f32."""
    return ((out[0].float() - y.float()) ** 2).mean() + 0.01 * out[1]


def moe_run(dev, dtype, entry, plain, batch, fault=None):
    """`TRAIN_STEPS` steps of the MoE layer (seed 0) with Adam lr 1e-4
    through `entry` under ``MXTPU_PALLAS=auto`` (or ``reference`` for the
    plain oracle); returns its stats, the step time and the experts the
    router chose at each step (recorded where `switch_moe` routes)."""
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.ops import moe_dispatch as md
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import MoEFeedForward, TrainStep
    from mxnet_tpu_torch.parallel import moe as moe_mod

    experts = []
    route0, combine_index0 = moe_mod.route, md.combine_index

    def recording_route(*a, **k):
        r = route0(*a, **k)
        experts.append(r[0])
        return r

    def gateless(expert, pos, kept, gate, e, c):
        slot, _ = combine_index0(expert, pos, kept, gate, e, c)
        return slot, kept.float()

    x, y = batch
    tokens = x.shape[0] * x.shape[1]
    mode = "reference" if plain else "auto"
    moe_mod.route = recording_route
    if fault == "combine_without_gate":
        md.combine_index = gateless
    try:
        with pallas_mode(mode):
            layer = MoEFeedForward(MOE_H, MOE_I, num_experts=MOE_E,
                                   capacity_factor=MOE_CF, dtype=dtype,
                                   device=dev, seed=0)
            opt = Adam(learning_rate=1e-4)
            if entry == "step":
                step = TrainStep(layer, opt, moe_loss, num_model_args=1)
                step.warmup(x, y)
                fused = step._fused_opt_kernel
            else:
                trainer = Trainer(layer.collect_params(), opt)
                fused = None

            def one():
                if entry == "step":
                    return step.dispatch(x, y).loss
                loss = moe_loss(layer(x), x, y)
                # MXNet's convention: the batch's summed loss, which
                # step(batch_size) rescales by 1 / batch_size
                (loss * tokens).backward()
                trainer.step(tokens)
                return loss.detach()
            experts.clear()
            kernels.reset_launch_counts()
            losses = []
            for i in range(TRAIN_STEPS):
                losses.append(one())
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 2)
            launches = kernels.launch_counts()
    finally:
        moe_mod.route, md.combine_index = route0, combine_index0
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    return dict(losses=[float(v) for v in losses], step_ms=step_s * 1e3,
                launches=launches, fused_opt_kernel=fused,
                chunk=fo.last_chunk.get(dtype),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), \
        step_s, [e.clone() for e in experts]


def moe_flops_per_step(tokens):
    """The expert products: up and down, 2 E C H I operations each
    forward, three times that a training step."""
    cap = int(MOE_CF * tokens / MOE_E)
    return 3 * 2 * 2 * MOE_E * cap * MOE_H * MOE_I


def run_moe(dev, results, card):
    import torch
    flops = moe_flops_per_step(MOE_B * MOE_L)
    tokens = MOE_B * MOE_L
    for dtype, entry in MOE_RUNS:
        key = f"{dtype}_{entry}"
        batch = moe_batch(dev, dtype)
        torch.cuda.reset_peak_memory_stats()
        st, step_s, ex = moe_run(dev, dtype, entry, False, batch)
        torch.cuda.empty_cache()
        pst, pstep_s, pex = moe_run(dev, dtype, entry, True, batch)
        torch.cuda.empty_cache()
        want = {k: 0 for k in st["launches"]}
        want.update(moe_dispatch=TRAIN_STEPS, moe_combine=TRAIN_STEPS,
                    fused_optimizer_chunk=TRAIN_STEPS)
        if st["launches"] != want:
            raise AssertionError(f"moe {key}: kernel launches "
                                 f"{st['launches']}, want {want}")
        if any(pst["launches"].values()):
            raise AssertionError(f"moe {key}: the plain run launched "
                                 f"kernels {pst['launches']}")
        ls = st["losses"]
        if not all(math.isfinite(v) for v in ls):
            raise AssertionError(f"moe {key}: non-finite loss {ls}")
        dev_rel = traj_dev(ls, pst["losses"])
        peak = PEAK[dtype]
        st.update(plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
                  trajectory_rel_dev=dev_rel, trajectory_tol=moe_tol(dtype),
                  tokens_routed_apart=[int((a != b).sum())
                                       for a, b in zip(ex, pex)],
                  tokens_per_s=tokens / step_s,
                  plain_tokens_per_s=tokens / pstep_s,
                  flops_per_step=flops, tflops=flops / step_s / 1e12,
                  peak_share=flops / step_s / peak, peak_flops=peak)
        results["moe"][key] = st
        print(f"[moe {key}] {json.dumps(st)}", flush=True)
        print(f"[moe {key}] {tokens / step_s:.1f} tokens/s, "
              f"{st['step_ms']:.3f} ms/step, {st['tflops']:.2f} TFLOP/s = "
              f"{100 * st['peak_share']:.2f}% of the dense {dtype} peak "
              f"({peak / 1e12:.0f} TFLOP/s) of {card}", flush=True)
        tol = moe_tol(dtype)
        if dev_rel > tol:
            raise AssertionError(
                f"moe {key}: loss trajectory departs from the plain path's "
                f"by {dev_rel:.3g} (limit {tol}) ({ls} vs {pst['losses']})")
        if not ls[-1] < ls[0]:
            raise AssertionError(f"moe {key}: loss did not fall {ls}")

    # the control: a combine that ignores the gate, read against the f32
    # TrainStep run's oracle and limit
    oracle = results["moe"]["float32_step"]["plain_losses"]
    tol = moe_tol("float32")
    for fault in MOE_FAULTS:
        st, _, _ = moe_run(dev, "float32", "step", False,
                           moe_batch(dev, "float32"), fault)
        torch.cuda.empty_cache()
        dev_rel = traj_dev(st["losses"], oracle)
        results["moe_controls"][fault] = c = dict(
            losses=st["losses"], trajectory_rel_dev=dev_rel,
            trajectory_tol=tol, over_tol=dev_rel / tol, caught=dev_rel > tol)
        print(f"[moe control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            raise AssertionError(
                f"moe control {fault}: the planted fault departs from the "
                f"oracle by only {dev_rel:.3g} <= {tol}")


# ---------------------------------------------------------------------------
# phase 14: GPT-2-small causal-LM training at full width
# ---------------------------------------------------------------------------

GPT_B, GPT_L = 8, 1024          # sequences x tokens a step
# the gpt phase keeps GPT-2 small's widths and cuts its depth to 6 of 12
# layers, for the smoke's time limit (launch counts, oracles, one-ulp
# floors and faults follow the model's depth; train_profile.py and
# gluon_cost.py time the 12-layer model, and gluon_gpt trains it)
GPT_LAYERS = 6
GPT_LR, GPT_WD = 3e-4, 0.1      # AdamW
REMAT_RTOL = 1e-5               # remat vs no remat (JAX's test_models.py:328)
# (weights, remat, entry point): TrainStep in bf16 and f32 without remat,
# bf16 under both remat policies, and the gluon Trainer in bf16
GPT_RUNS = (("bfloat16", False, "step"), ("float32", False, "step"),
            ("bfloat16", "full", "step"),
            ("bfloat16", "dots_saveable", "step"),
            ("bfloat16", False, "trainer"), ("float16", False, "step"))
# planted faults: every attention built non-causal (read against the bf16
# oracle at `traj_tol`), and a remat run whose recompute does not put the
# dropout generators back (read against the bf16 run without remat at
# REMAT_RTOL)
GPT_FAULTS = ("attention_not_causal", "remat_without_generator_restore")
GPT_FLOOR_X = 10     # a 16-bit run's limit: this many one-ulp floors
# the f16 controls, each read against the f16 trajectory limit and by
# `gpt_step1_check`: the bf16 controls' first fault (a forward fault), and
# AdamW's update without its bias correction (an update fault)
GPT_F16_FAULTS = ("attention_not_causal", "adamw_without_bias_correction")


def gpt_tol(dtype, floor):
    """The gpt phase's trajectory limit, kernel run vs its plain oracle.
    f32: `traj_tol`'s 1e-4.  bf16: the weights are bf16 with no f32 master
    copy, so an update that differs in its last bits can round a weight a
    whole bf16 step (2^-8 of it) apart, and the run is chaotic.  `floor`
    measures that in the same call: the departure of the bf16 run from
    itself with one weight element one bf16 ulp away before step 1 (on the
    H100, 1.2e-3 -- over `traj_tol`'s 1e-3 alone).  A kernel and its plain
    version differ in many roundings a step, so bf16 runs are held to the
    larger of `traj_tol` and `GPT_FLOOR_X` floors; the controls show how
    far above that a wrong kernel lands.  f16 weights (no master copy
    either) take the same rule with f16's own floor."""
    if dtype not in ("bfloat16", "float16"):
        return traj_tol(dtype, "auto")
    return max(traj_tol(dtype, "auto"), GPT_FLOOR_X * floor)


def gpt_batch(dev, vocab, seed=0):
    """A (8, 1025) token stream from `seed`: inputs ``[:, :-1]``, labels
    ``[:, 1:]`` (views of one tensor; the logits stay contiguous)."""
    import numpy as np
    import torch
    stream = np.random.RandomState(seed).randint(
        0, vocab, (GPT_B, GPT_L + 1)).astype(np.int32)
    t = torch.from_numpy(stream).to(dev)
    return t[:, :-1], t[:, 1:]


class _TrainerStep:
    """The gluon `Trainer` loop behind `TrainStep`'s ``dispatch``: forward
    on the first `num_model_args` batch arguments and the mean loss inside
    ``autograd.record()``, ``loss.backward()``, ``trainer.step(1)``."""

    def __init__(self, model, trainer, loss_fn, num_model_args=1):
        self.model, self.trainer, self.loss_fn = model, trainer, loss_fn
        self.num_model_args = num_model_args

    def dispatch(self, *batch):
        from mxnet_tpu_torch import autograd
        with autograd.record():
            out = self.model(*batch[:self.num_model_args])
            loss = self.loss_fn(out, *batch)
        loss.backward()
        self.trainer.step(1)
        return loss.detach()


def gpt_train_step(dev, dtype, plain=False, remat=False, entry="step",
                   fault=None, nudge=False, arch=None, route="auto"):
    """`gpt_small` (GPT-2 small, seed 0, dropout 0.1) with the causal-LM
    loss (`gluon.loss.SoftmaxCrossEntropyLoss` over the (8192, V) logits)
    and AdamW lr 3e-4, weight decay 0.1, through `TrainStep` or the gluon
    `Trainer`.  ``plain=True`` builds the oracle, which launches no kernel:
    every attention swaps in `multi_head_attention_reference`, every
    LayerNorm (and the residual norm) the fused norm's plain version, the
    loss `softmax_cross_entropy_reference`, and the update the kernels'
    plain version leaf by leaf (`kernel_plain`; the `Trainer`, run under
    ``MXTPU_PALLAS=reference``, its per-leaf rule).  `fault` plants one of
    `GPT_FAULTS`.  `nudge` moves one weight element (layer 0's FFN
    up-projection, element 0) by one unit in the last place: how far one
    rounding difference carries over the run.  `arch` adds `gpt_small`
    arguments (the gpt_gqa phase's RoPE, grouped K/V and window).
    ``route="reference"`` builds the step under ``MXTPU_PALLAS=reference``
    (the model's own norms in the input dtype, the per-leaf update; flash
    and the cross-entropy keep their kernels)."""
    import torch
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small
    from mxnet_tpu_torch.models.layers import (FusedSelfAttention,
                                               _plain_twin)
    from mxnet_tpu_torch.ops.fused_optimizer import kernel_plain
    from mxnet_tpu_torch.ops.softmax_xent import \
        softmax_cross_entropy_reference
    from mxnet_tpu_torch.optimizer import AdamW
    from mxnet_tpu_torch.parallel import TrainStep

    cfg = gpt_small(dtype=dtype, remat=remat, **(arch or {}))
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    if nudge:
        w = model.transformer.layers[0].ffn.ffn_intermediate.weight.data()
        bits = torch.int16 if w.element_size() == 2 else torch.int32
        with torch.no_grad():
            w.view(-1)[:1].view(bits).add_(1)
    V = cfg.vocab_size
    ce = SoftmaxCrossEntropyLoss()

    def loss_fn(out, ids, lab):
        return ce(out.reshape(-1, V), lab.reshape(-1)).mean()

    if plain:
        _plain_twin(model)

        def loss_fn(out, ids, lab):     # noqa: F811 - the oracle's loss
            return softmax_cross_entropy_reference(
                out.reshape(-1, V), lab.reshape(-1)).mean()
    if fault in ("attention_not_causal", "window_ignored"):
        for m in model.modules():
            if isinstance(m, FusedSelfAttention):
                if fault == "window_ignored":
                    m.window = None
                else:
                    m.causal = False
    opt = AdamW(learning_rate=GPT_LR, wd=GPT_WD,
                correct_bias=fault != "adamw_without_bias_correction")
    with pallas_mode("reference" if plain else route):
        if entry == "step":
            return model, TrainStep(model, opt, loss_fn, num_model_args=1,
                                    update=kernel_plain if plain else None)
    return model, _TrainerStep(
        model, Trainer(model.collect_params(), opt), loss_fn)


def _zero_grad_share(step):
    """Wrap `step`'s forward-and-backward so that its first call records
    the share of 16-bit gradient elements that are exactly zero (f16's
    range flushes what a mean loss over 8192 tokens makes small: JAX's
    step has no loss scaler either).  Returns the dict it fills."""
    seen = {}
    inner = step._compute

    def compute(batch):
        loss, grads = inner(batch)
        if not seen:
            g16 = [g for g in grads.values() if g.element_size() == 2]
            total = sum(g.numel() for g in g16)
            zeros = sum(int((g == 0).sum()) for g in g16)
            seen.update(elements=total, zeros=zeros,
                        share=zeros / total if total else None)
        return loss, grads
    step._compute = compute
    return seen


def _first_grads(step):
    """Wrap `step`'s forward-and-backward so that its first call's
    gradients are kept (on the host) in the dict it returns."""
    kept = {}
    inner = step._compute

    def compute(batch):
        loss, grads = inner(batch)
        if not kept:
            kept.update({n: g.detach().cpu() for n, g in grads.items()})
        return loss, grads
    step._compute = compute
    return kept


def gpt_run(dev, dtype, plain, batch, remat=False, entry="step",
            fault=None, nudge=False, arch=None, route="auto", step1=False):
    """`TRAIN_STEPS` steps of `gpt_train_step` under ``MXTPU_PALLAS=
    route`` (``reference`` for the oracle), counts reset after warmup;
    returns its stats and the step time.  An f16 `TrainStep` run also
    records the share of f16 gradient elements that are zero after step
    1's backward (`_zero_grad_share`, before the timed steps).  `step1`
    keeps, under ``st["_step1"]``, the weights before step 1, the weights
    and optimizer state after it and its gradients (`gpt_step1_check`)."""
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import nn as tnn

    gen_contexts, common_args = tnn._generator_contexts, fa._common_args
    fwd_cuda, bwd_cuda = fa._flash_fwd_cuda, fa._flash_bwd_cuda
    if fault == "columns_past_128_dropped":
        # the kernels see q, k, v cut to their first 128 columns; the
        # output and the gradients are zero-padded back to D
        def cut(t):
            return t[..., :128].contiguous()

        def pad(t, d):
            return torch.nn.functional.pad(t, (0, d - t.shape[-1]))

        # (the wrappers' arguments; the plan, made for D, is left out)
        def cut_fwd(q, k, v, bias3, seed, scale, causal, rate, per_head,
                    per_row, plan=None, *band):
            o, lse = fwd_cuda(cut(q), cut(k), cut(v), bias3, seed, scale,
                              causal, rate, per_head, per_row, None, *band)
            return pad(o, q.shape[-1]), lse

        def cut_bwd(q, k, v, bias3, seed, o, lse, g, scale, causal, rate,
                    per_head, per_row, plan=None, *band):
            grads = bwd_cuda(cut(q), cut(k), cut(v), bias3, seed, cut(o),
                             lse, cut(g), scale, causal, rate, per_head,
                             per_row, None, *band)
            return tuple(pad(x, q.shape[-1]) for x in grads)
        fa._flash_fwd_cuda, fa._flash_bwd_cuda = cut_fwd, cut_bwd
    if fault == "scale_of_128":
        # the kernels are given a softmax scale of 1 / sqrt(128)
        def scale_128(q, k, bias3, scale, *args):
            return common_args(q, k, bias3, 128 ** -0.5, *args)
        fa._common_args = scale_128
    if fault == "remat_without_generator_restore":
        tnn._generator_contexts = lambda gens: (contextlib.nullcontext(),
                                                contextlib.nullcontext())
    if fault == "fold_positions_unwrapped":
        # the kernels' masks read the folded row, not its position: the
        # segment length they are given is the folded rows'
        def unwrapped(q, *args):
            return common_args(q, *args[:-1], q.shape[2])
        fa._common_args = unwrapped
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, step = gpt_train_step(dev, dtype, plain, remat, entry, fault,
                                     nudge, arch, route)
        with pallas_mode("reference" if plain else route):
            before = model.generator.get_state()
            if entry == "step":
                warm_s = step.warmup(*batch)
                if not torch.equal(model.generator.get_state(), before):
                    raise AssertionError("gpt: warmup moved the dropout "
                                         "generator")
            else:
                warm_s = None
            zeros = _zero_grad_share(step) if dtype == "float16" and \
                entry == "step" else None
            grads1 = _first_grads(step) if step1 else None
            kernels.reset_launch_counts()
            losses = []
            snap = None
            if step1:     # kept on the host: later runs' peaks stay theirs
                snap = [{n: p.detach().cpu()
                         for n, p in model.named_parameters()}]
            for i in range(TRAIN_STEPS):
                losses.append(step.dispatch(*batch) if entry == "trainer"
                              else step.dispatch(*batch).loss)
                if i == 0 and snap is not None:
                    snap += [{n: p.detach().cpu()
                              for n, p in model.named_parameters()},
                             {n: tuple(t.cpu() for t in st)
                              for n, st in step.opt_state.items()},
                             grads1]
                if i == 1:        # time the steady steps 3..N
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 2)
            launches = kernels.launch_counts()
            by_dtype = {f"{n}:{d}": v for (n, d), v in
                        sorted(kernels.DTYPE_LAUNCHES.items())}
        peak = torch.cuda.max_memory_allocated() / 1e9
        groups = len({p.dtype for p in model.parameters()})
    finally:
        tnn._generator_contexts, fa._common_args = gen_contexts, common_args
        fa._flash_fwd_cuda, fa._flash_bwd_cuda = fwd_cuda, bwd_cuda
    del model, step
    torch.cuda.empty_cache()
    st = dict(losses=[float(x) for x in losses], step_ms=step_s * 1e3,
              warmup_s=warm_s, launches=launches, dtype_launches=by_dtype,
              dtype_groups=groups, peak_mem_gb=peak)
    if zeros is not None:
        st["step1_zero_grad_share"] = zeros
    if snap is not None:
        st["_step1"] = snap
    return st, step_s


def gpt_step1_limit(layers, dtype="float16"):
    """`gpt_step1_check`'s limit on step 1's optimizer state against the
    oracle's: the 16-bit kernels are each held to their dtype's tolerance
    of their output's scale (`TOL`), and a gradient passes two pairs of
    them a layer (flash attention, the norm), so their departures may add
    to ``TOL[dtype] * 2 * layers`` (0.12 for an f16 GPT-2 small)."""
    return TOL[dtype] * 2 * layers


def gpt_step1_check(got, want, dev, layers, opt=None, hp_vals=None,
                    dtype="float16"):
    """Step 1 of an f16 run against its plain oracle's, both from the same
    weights, batch and dropout masks (one step: not chaotic), two ways.
    (1) The update alone, fed the same gradients, as the optim phase's
    `_opt_err` holds it: the run's own step-1 gradients through the
    kernels' plain update (`kernel_plain`, AdamW from zero state at t = 1)
    against the weights and state the run wrote.  (2) The whole step:
    each optimizer state slot (AdamW's m and v, which carry step 1's
    gradients and their squares) over the model, in the L2 norm, within
    `gpt_step1_limit` of the oracle's norm.  Reported beside them: each
    slot's worst tensor, element-wise against its own scale (a gradient
    that is zero up to rounding has no scale to hold it to), and the
    share of `dtype` weight elements more than one step of it off the
    oracle's.  `got` and `want` are `gpt_run`'s ``_step1`` lists; `opt`
    and `hp_vals` the run's rule and step-1 hyperparameters (default the
    gpt phase's AdamW).  The gluon_gpt phase holds its bf16 `Trainer` run
    to the same check, with bf16's tolerance."""
    import torch
    from mxnet_tpu_torch.ops.fused_optimizer import kernel_plain
    from mxnet_tpu_torch.optimizer import AdamW
    before, wk, sk, gk = got
    _, wp, sp, _ = want
    if opt is None:
        opt = AdamW(learning_rate=GPT_LR, wd=GPT_WD)
        hp_vals = {"lr": GPT_LR, "wd": GPT_WD, "rescale_grad": 1.0,
                   "t": 1.0}
    hp = {k: torch.full((), v, device=dev) for k, v in hp_vals.items()}
    hp["clip_gradient"] = None
    old = {n: w.to(dev) for n, w in before.items() if n in gk}
    zero = {n: tuple(torch.zeros_like(t, device=dev) for t in sk[n])
            for n in old}
    want_p, want_s = kernel_plain(opt, old, {n: g.to(dev) for n, g in
                                             gk.items()}, zero, hp)
    err, share, upd_ok = _opt_err(
        {n: wk[n].to(dev) for n in old},
        {n: tuple(t.to(dev) for t in sk[n]) for n in old},
        want_p, want_s, old)
    del old, zero, want_p, want_s
    slots = max(len(v) for v in sp.values())
    diff2, norm2 = [0.0] * slots, [0.0] * slots
    worst = [(0.0, None)] * slots
    for n in sp:
        for i, (a, b) in enumerate(zip(sk[n], sp[n])):
            d = a.double() - b.double()
            diff2[i] += float((d * d).sum())
            norm2[i] += float((b.double() ** 2).sum())
            scale = float(b.double().abs().max())
            e = float(d.abs().max()) / scale if scale > 0 else \
                (math.inf if float(d.abs().max()) > 0 else 0.0)
            if e > worst[i][0]:
                worst[i] = (e, n)
    rel = [math.sqrt(d / nn) if nn > 0 else math.inf
           for d, nn in zip(diff2, norm2)]
    off = n16 = 0
    for n, b in wp.items():
        if b.dtype == getattr(torch, dtype):
            d = (wk[n].float() - b.float()).abs()
            off += int((d > STEP16[dtype] * b.float().abs()
                        + 2.0 ** -24).sum())
            n16 += d.numel()
    lim = gpt_step1_limit(layers, dtype)
    return dict(update_max_abs_err=err, update_f16_mismatch_share=share,
                update_ok=upd_ok, state_rel_l2=rel, state_limit=lim,
                state_ok=max(rel) <= lim,
                state_worst_tensor_rel=[w for w, _ in worst],
                state_worst_tensor=[n for _, n in worst],
                weight_off_share=off / n16 if n16 else 0.0,
                ok=upd_ok and max(rel) <= lim)


def gpt_want_launches(n_groups, layers, remat):
    """Exact launches over `TRAIN_STEPS` steps.  A step: the flash forward
    once a layer and the backward once a layer; the fused norm twice a
    layer (the first norm, the second fused with the residual) and the
    final norm; the cross-entropy once each way; the chunk once per dtype
    group.  Under either remat policy each layer's forward runs again in
    the backward pass: the kernels are extension calls that no selective
    policy saves, so the recompute launches the flash forward and both
    norms of every layer again."""
    again = 2 if remat else 1
    per_step = {"flash_attention_fwd": layers * again,
                "flash_attention_bwd": layers,
                "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                "fused_norm": 2 * layers * again + 1,
                "fused_optimizer_chunk": n_groups}
    return {k: v * TRAIN_STEPS for k, v in per_step.items()}


def gpt_f16_want(layers):
    """The f16 run's launches by kernel and input dtype over `TRAIN_STEPS`
    steps (``name:dtype``): flash, cross-entropy and the norm in f16 (the
    fused norm returns x's dtype, so the residual stream stays f16), the
    chunk once over the f16 leaves (f32 state) and once over the f32
    LayerNorm group a step."""
    want = {f"{k}:float16": v for k, v in
            gpt_want_launches(2, layers, False).items()
            if k != "fused_optimizer_chunk"}
    want.update({"fused_optimizer_chunk:float16": TRAIN_STEPS,
                 "fused_optimizer_chunk:float32": TRAIN_STEPS})
    return want


def run_gpt(dev, results, card):
    import torch
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small

    cfg = gpt_small(num_layers=GPT_LAYERS)
    depth = dict(num_layers=cfg.num_layers)
    batch = gpt_batch(dev, cfg.vocab_size)
    tokens = GPT_B * GPT_L
    flops = GPTForCausalLM.flops_per_token(cfg, GPT_L) * tokens
    runs, floors = results["gpt"], results["gpt_one_ulp"]
    problems = []        # every run and control is reported before failing
    step1 = {}           # the f16 kernel run's and its oracle's step 1
    for dtype, remat, entry in GPT_RUNS:
        key = f"{dtype}_{entry}_remat_{remat or 'off'}"
        f16 = dtype == "float16"
        st, step_s = gpt_run(dev, dtype, False, batch, remat, entry,
                             arch=depth, step1=f16)
        if f16:
            step1["kernel"] = st.pop("_step1")
        if dtype not in floors:
            # how far one rounding difference carries: the same run with
            # one weight element one unit in the last place away
            nst, _ = gpt_run(dev, dtype, False, batch, nudge=True,
                             arch=depth)
            floors[dtype] = c = dict(
                losses=nst["losses"],
                trajectory_rel_dev=traj_dev(nst["losses"], st["losses"]))
            print(f"[gpt one ulp {dtype}] {json.dumps(c)}", flush=True)
        if remat:
            # remat recomputes the same math, so the plain route with remat
            # is the plain route without it: a remat run shares the bf16
            # run's oracle (and is held to that run itself at REMAT_RTOL)
            base = runs["bfloat16_step_remat_off"]
            pst = dict(losses=base["plain_losses"], launches={},
                       step_ms=base["plain_step_ms"],
                       peak_mem_gb=base["plain_peak_mem_gb"])
            pstep_s = base["plain_step_ms"] / 1e3
        else:
            pst, pstep_s = gpt_run(dev, dtype, True, batch, remat, entry,
                                   arch=depth, step1=f16)
        if f16:
            step1["plain"] = pst.pop("_step1")
            st["step1_check"] = chk = gpt_step1_check(
                step1.pop("kernel"), step1["plain"], dev, cfg.num_layers)
            if not chk["ok"]:
                problems.append(f"gpt {key}: step 1 off the plain "
                                f"version's: {json.dumps(chk)}")
        want = gpt_want_launches(st["dtype_groups"], cfg.num_layers,
                                 bool(remat))
        got = {k: st["launches"][k] for k in want}
        others = {k: v for k, v in st["launches"].items()
                  if k not in want and v}
        if got != want or others:
            problems.append(f"gpt {key}: kernel launches {got} (and "
                            f"{others}), want {want} over {TRAIN_STEPS} "
                            f"steps")
        if dtype == "float16" and st["dtype_launches"] != \
                gpt_f16_want(cfg.num_layers):
            problems.append(f"gpt {key}: launches by dtype "
                            f"{st['dtype_launches']}, want "
                            f"{gpt_f16_want(cfg.num_layers)}")
        if any(pst["launches"].values()):
            problems.append(f"gpt {key}: the plain run launched kernels "
                            f"{pst['launches']}")
        ls = st["losses"]
        dev_rel = traj_dev(ls, pst["losses"])
        floor = floors[dtype]["trajectory_rel_dev"]
        tol = gpt_tol(dtype, floor)
        st.update(plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
                  plain_peak_mem_gb=pst["peak_mem_gb"],
                  trajectory_rel_dev=dev_rel, trajectory_tol=tol,
                  one_ulp_floor=floor,
                  within_traj_tol=dev_rel <= traj_tol(dtype, "auto"),
                  tokens_per_s=tokens / step_s,
                  plain_tokens_per_s=tokens / pstep_s,
                  flops_per_step=flops, tflops=flops / step_s / 1e12,
                  bf16_peak_share=flops / step_s / PEAK["bfloat16"])
        if remat:
            base = runs["bfloat16_step_remat_off"]
            st["remat_rel_dev"] = traj_dev(ls, base["losses"])
            st["remat_rtol"] = REMAT_RTOL
            st["no_remat_peak_mem_gb"] = base["peak_mem_gb"]
        if dtype == "float16":
            # reported, not gated: what f16 flushes without a loss scaler
            st["plain_step1_zero_grad_share"] = pst.get(
                "step1_zero_grad_share")
            base = runs["bfloat16_step_remat_off"]
            st.update(bf16_step_ms=base["step_ms"],
                      bf16_tokens_per_s=base["tokens_per_s"],
                      bf16_peak_mem_gb=base["peak_mem_gb"])
        runs[key] = st
        print(f"[gpt {key}] {json.dumps(st)}", flush=True)
        print(f"[gpt {key}] {tokens / step_s:.1f} tokens/s, "
              f"{st['step_ms']:.2f} ms/step, {st['tflops']:.2f} TFLOP/s = "
              f"{100 * st['bf16_peak_share']:.2f}% of the dense bf16 peak "
              f"(989 TFLOP/s) of {card}; peak memory "
              f"{st['peak_mem_gb']:.2f} GB; trajectory vs plain "
              f"{dev_rel:.3g} (limit {tol:.3g}: {GPT_FLOOR_X} one-ulp floors "
              f"of {floor:.3g}, at least traj_tol "
              f"{traj_tol(dtype, 'auto')})", flush=True)
        if not all(math.isfinite(x) for x in ls):
            problems.append(f"gpt {key}: non-finite loss {ls}")
        if dev_rel > tol:
            problems.append(
                f"gpt {key}: loss trajectory departs from the plain path's "
                f"by {dev_rel:.3g} > {tol} ({ls} vs {pst['losses']})")
        if not ls[-1] < ls[0]:
            problems.append(f"gpt {key}: loss did not fall {ls}")
        if remat:
            print(f"[gpt {key}] remat vs no remat: {st['remat_rel_dev']:.3g} "
                  f"(limit {REMAT_RTOL}); peak memory "
                  f"{st['peak_mem_gb']:.2f} GB vs "
                  f"{st['no_remat_peak_mem_gb']:.2f} GB", flush=True)
            if st["remat_rel_dev"] > REMAT_RTOL:
                problems.append(
                    f"gpt {key}: remat departs from no remat by "
                    f"{st['remat_rel_dev']:.3g} > {REMAT_RTOL}")
            if not st["peak_mem_gb"] < st["no_remat_peak_mem_gb"]:
                problems.append(f"gpt {key}: remat did not lower the peak "
                                f"memory")

    # the controls, each read against the limit its sound run is held to
    for fault in GPT_FAULTS:
        remat = "full" if fault == "remat_without_generator_restore" \
            else False
        st, _ = gpt_run(dev, "bfloat16", False, batch, remat, "step", fault,
                        arch=depth)
        if remat:
            ref = runs["bfloat16_step_remat_off"]["losses"]
            tol = REMAT_RTOL
        else:
            ref = runs["bfloat16_step_remat_off"]["plain_losses"]
            tol = gpt_tol("bfloat16",
                          floors["bfloat16"]["trajectory_rel_dev"])
        dev_rel = traj_dev(st["losses"], ref)
        results["gpt_controls"][fault] = c = dict(
            losses=st["losses"], trajectory_rel_dev=dev_rel,
            trajectory_tol=tol, over_tol=dev_rel / tol, caught=dev_rel > tol)
        print(f"[gpt control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            problems.append(
                f"gpt control {fault}: the planted fault departs by only "
                f"{dev_rel:.3g} <= {tol}; the check cannot see it")
    gpt_f16_checks(dev, results, batch, cfg, step1["plain"], problems)
    if problems:
        raise AssertionError("; ".join(problems))


def gpt_f16_checks(dev, results, batch, cfg, plain1, problems):
    """The f16 run's controls and its reference route.  Each of
    `GPT_F16_FAULTS` planted in the f16 run: where its trajectory lands
    against the f16 limit (`gpt_tol`, 10 f16 floors: reported, as the
    limit may not see it) and whether `gpt_step1_check` against the sound
    oracle's step 1 (`plain1`) catches it (gated).  Then the f16 run on
    the reference route (``MXTPU_PALLAS=reference``: LayerNorm statistics
    in f16, the per-leaf update): finite, falling, flash and the
    cross-entropy launched, neither the norm nor the chunk."""
    runs, floors = results["gpt"], results["gpt_one_ulp"]
    depth = dict(num_layers=cfg.num_layers)
    sound = runs["float16_step_remat_off"]
    tol = gpt_tol("float16", floors["float16"]["trajectory_rel_dev"])
    for fault in GPT_F16_FAULTS:
        st, _ = gpt_run(dev, "float16", False, batch, fault=fault,
                        arch=depth, step1=True)
        chk = gpt_step1_check(st.pop("_step1"), plain1, dev,
                              cfg.num_layers)
        dev_rel = traj_dev(st["losses"], sound["plain_losses"])
        results["gpt_controls"][f"float16_{fault}"] = c = dict(
            losses=st["losses"], trajectory_rel_dev=dev_rel,
            trajectory_tol=tol, over_tol=dev_rel / tol,
            caught_by_trajectory=dev_rel > tol, step1=chk,
            caught_by_step1=not chk["ok"])
        print(f"[gpt control float16 {fault}] {json.dumps(c)}", flush=True)
        if not c["caught_by_step1"]:
            problems.append(f"gpt control float16 {fault}: the step-1 "
                            f"check cannot see it ({json.dumps(chk)})")
    st, step_s = gpt_run(dev, "float16", False, batch, arch=depth,
                         route="reference")
    want = {k: v for k, v in gpt_want_launches(
        1, cfg.num_layers, False).items()
        if k not in ("fused_norm", "fused_optimizer_chunk")}
    got = {k: v for k, v in st["launches"].items() if v}
    ls = st["losses"]
    st.update(finite=all(math.isfinite(x) for x in ls),
              loss_fell=ls[-1] < ls[0],
              trajectory_rel_dev_vs_kernel_route=traj_dev(
                  ls, sound["losses"]))
    runs["float16_step_remat_off_reference_route"] = st
    print(f"[gpt float16 reference route] {json.dumps(st)}", flush=True)
    if not st["finite"] or not st["loss_fell"] or got != want:
        problems.append(f"gpt float16 reference route: losses {ls}, "
                        f"launches {got} (want {want})")


# ---------------------------------------------------------------------------
# gpt_gqa: GPT-2 small's widths with Mistral 7B's attention scheme
# ---------------------------------------------------------------------------

# Mistral 7B (Jiang et al. 2023, arXiv 2310.06825, Table 1): 32 heads over
# 8 kv heads, a one-sided sliding window, RoPE.  At GPT-2 small's 12 heads,
# 3 kv heads keep its 4 query heads a kv head; a window of 256 keeps a
# query's band at a quarter of L = 1024
GQA_ARCH = dict(rope=True, rope_theta=10000.0, num_kv_heads=3, window=256)
# the gpt_gqa and gpt_d256 phases keep GPT-2 small's widths and cut its
# depth to 6 of 12 layers, for the smoke's time limit (launch counts,
# oracles, one-ulp floors and faults follow the model's depth;
# train_profile.py profiles the 12-layer models)
ARCH_LAYERS = 6
# (weights, entry point): TrainStep in bf16 and f32, the gluon Trainer in
# bf16
GQA_RUNS = (("bfloat16", "step"), ("float32", "step"),
            ("bfloat16", "trainer"))
# planted faults, each run in f32 and read against the f32 oracle at
# `gpt_tol`'s 1e-4 (a bf16 run's chaos, ten one-ulp floors, would leave
# the ignored window under 2x its limit): the kernels run without the
# window, and the kernels' masks read the folded row instead of its
# position (r, not r % Lq)
GQA_FAULTS = ("window_ignored", "fold_positions_unwrapped")
GQA_GENERATE = 4      # prompts generated again with use_cache=False


def run_gpt_gqa(dev, results, card):
    import torch
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small

    arch = dict(GQA_ARCH, num_layers=ARCH_LAYERS)
    cfg = gpt_small(**arch)
    batch = gpt_batch(dev, cfg.vocab_size)
    tokens = GPT_B * GPT_L
    # the window clamps each query's span at w + 1 keys; the K/V
    # projections are a quarter as wide
    flops = GPTForCausalLM.flops_per_token(cfg, GPT_L) * tokens
    runs, floors = results["gpt_gqa"], results["gpt_gqa_one_ulp"]
    problems = []        # every run and control is reported before failing
    for dtype, entry in GQA_RUNS:
        key = f"{dtype}_{entry}"
        st, step_s = gpt_run(dev, dtype, False, batch, entry=entry,
                             arch=arch)
        if dtype == "bfloat16" and dtype not in floors:
            # the chaos of this bf16 run, as in the gpt phase
            nst, _ = gpt_run(dev, dtype, False, batch, nudge=True,
                             arch=arch)
            floors[dtype] = c = dict(
                losses=nst["losses"],
                trajectory_rel_dev=traj_dev(nst["losses"], st["losses"]))
            print(f"[gpt_gqa one ulp {dtype}] {json.dumps(c)}", flush=True)
        pst, pstep_s = gpt_run(dev, dtype, True, batch, entry=entry,
                               arch=arch)
        want = gpt_want_launches(st["dtype_groups"], cfg.num_layers, False)
        got = {k: st["launches"][k] for k in want}
        others = {k: v for k, v in st["launches"].items()
                  if k not in want and v}
        if got != want or others:
            problems.append(f"gpt_gqa {key}: kernel launches {got} (and "
                            f"{others}), want {want} over {TRAIN_STEPS} "
                            f"steps")
        if any(pst["launches"].values()):
            problems.append(f"gpt_gqa {key}: the plain run launched "
                            f"kernels {pst['launches']}")
        ls = st["losses"]
        dev_rel = traj_dev(ls, pst["losses"])
        floor = floors.get(dtype, {}).get("trajectory_rel_dev", 0.0)
        tol = gpt_tol(dtype, floor)
        st.update(plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
                  plain_peak_mem_gb=pst["peak_mem_gb"],
                  trajectory_rel_dev=dev_rel, trajectory_tol=tol,
                  one_ulp_floor=floor,
                  within_traj_tol=dev_rel <= traj_tol(dtype, "auto"),
                  tokens_per_s=tokens / step_s,
                  plain_tokens_per_s=tokens / pstep_s,
                  flops_per_step=flops, tflops=flops / step_s / 1e12,
                  bf16_peak_share=flops / step_s / PEAK["bfloat16"])
        runs[key] = st
        print(f"[gpt_gqa {key}] {json.dumps(st)}", flush=True)
        print(f"[gpt_gqa {key}] {tokens / step_s:.1f} tokens/s, "
              f"{st['step_ms']:.2f} ms/step, {st['tflops']:.2f} TFLOP/s = "
              f"{100 * st['bf16_peak_share']:.2f}% of the dense bf16 peak "
              f"(989 TFLOP/s) of {card}; peak memory "
              f"{st['peak_mem_gb']:.2f} GB; trajectory vs plain "
              f"{dev_rel:.3g} (limit {tol:.3g})", flush=True)
        if not all(math.isfinite(x) for x in ls):
            problems.append(f"gpt_gqa {key}: non-finite loss {ls}")
        if dev_rel > tol:
            problems.append(
                f"gpt_gqa {key}: loss trajectory departs from the plain "
                f"path's by {dev_rel:.3g} > {tol} ({ls} vs {pst['losses']})")
        if not ls[-1] < ls[0]:
            problems.append(f"gpt_gqa {key}: loss did not fall {ls}")

    ref = runs["float32_step"]["plain_losses"]
    tol = gpt_tol("float32", 0.0)
    for fault in GQA_FAULTS:
        st, _ = gpt_run(dev, "float32", False, batch, fault=fault,
                        arch=arch)
        dev_rel = traj_dev(st["losses"], ref)
        results["gpt_gqa_controls"][fault] = c = dict(
            losses=st["losses"], trajectory_rel_dev=dev_rel,
            trajectory_tol=tol, over_tol=dev_rel / tol, caught=dev_rel > tol)
        print(f"[gpt_gqa control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            problems.append(
                f"gpt_gqa control {fault}: the planted fault departs by "
                f"only {dev_rel:.3g} <= {tol}; the check cannot see it")
    try:
        arch_serve(dev, results, arch, "gpt_gqa")
    except Exception as e:          # reported with the training problems
        traceback.print_exc()
        problems.append(f"gpt_gqa serving: {e}")
    if problems:
        raise AssertionError("; ".join(problems))


def arch_serve(dev, results, arch, name, against_plain=False):
    """`gpt_small(dropout=0.0, **arch)` in f32 served through
    `serve_phase`: K1 launched once a layer a fused step, streams equal to
    the plain engine's (near ties aside); then `GQA_GENERATE` prompts
    through ``generate(use_cache=False)`` (the flash forward over the
    whole context, once a layer a new token), equal to the cached
    ``generate`` and, with `against_plain`, to the plain engine's streams.
    Stored as ``results[name + "_serve"]``."""
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small

    cfg = gpt_small(dropout=0.0, **arch)
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    prompts = make_prompts(cfg.vocab_size)
    max_new = 32
    L = cfg.num_layers
    streams, pstreams, plain, st = serve_phase(model, prompts, max_new, 0)
    if st["launches"]["ragged_paged_attention"] != L * st["fused_steps"]:
        raise AssertionError(
            f"K1 launched {st['launches']['ragged_paged_attention']} times "
            f"over {st['fused_steps']} fused steps (want {L} per step)")
    st["near_ties_vs_plain"] = compare_streams(
        streams, pstreams, plain.P, cfg, f"{name} f32 kernel vs plain")
    for s_, p in zip(streams, prompts):
        if len(s_) != len(p) + max_new or not all(
                0 <= t < cfg.vocab_size for t in s_):
            raise AssertionError(f"{name}: malformed stream")
    gen = prompts[:GQA_GENERATE]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    slow = [model.generate(torch.tensor([p]), max_new_tokens=max_new,
                           use_cache=False)[0].tolist() for p in gen]
    torch.cuda.synchronize()
    st["uncached_generate_s"] = time.perf_counter() - t0
    st["uncached_launches"] = kernels.launch_counts()
    fast = [model.generate(torch.tensor([p]), max_new_tokens=max_new)[0]
            .tolist() for p in gen]
    want = L * max_new * len(gen)
    if st["uncached_launches"]["flash_attention_fwd"] != want:
        raise AssertionError(
            f"{name}: uncached generate launched the flash forward "
            f"{st['uncached_launches']['flash_attention_fwd']} times, want "
            f"{want}")
    st["near_ties_uncached_vs_cached"] = compare_streams(
        slow, fast, plain.P, cfg, f"{name} generate(use_cache=False) vs "
        "cached")
    if against_plain:
        st["near_ties_uncached_vs_plain"] = compare_streams(
            slow, pstreams[:len(gen)], plain.P, cfg,
            f"{name} generate(use_cache=False) vs the plain engine")
    results[name + "_serve"] = st
    print(f"[{name} serve] {json.dumps(st)}", flush=True)


# ---------------------------------------------------------------------------
# gpt_d256: GPT-2 small's widths with Gemma 2B's attention
# ---------------------------------------------------------------------------

# Gemma 2B (Gemma Team 2024, arXiv 2403.08295, Table 1): head size 256, one
# kv head (multi-query), RoPE.  At GPT-2 small's hidden 768 that is 3
# query heads of 256 over one kv head; FFN, vocabulary and context stay
# GPT-2 small's (the phase cuts the depth, `ARCH_LAYERS`)
D256_ARCH = dict(num_heads=3, num_kv_heads=1, rope=True, rope_theta=10000.0)
# (weights, remat, entry point): TrainStep in bf16 and f32, the gluon
# Trainer in bf16, and TrainStep in bf16 under remat="full"
D256_RUNS = (("bfloat16", False, "step"), ("float32", False, "step"),
             ("bfloat16", False, "trainer"), ("bfloat16", "full", "step"))
# planted faults, each run in f32 and read against the f32 oracle at
# `gpt_tol`'s 1e-4: the kernels see q, k and v cut to their first 128
# columns (the output and gradients zero-padded back), and the kernels are
# given a softmax scale of 1 / sqrt(128)
D256_FAULTS = ("columns_past_128_dropped", "scale_of_128")


def run_gpt_d256(dev, results, card):
    import torch
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small

    t_phase = time.perf_counter()
    arch = dict(D256_ARCH, num_layers=ARCH_LAYERS)
    cfg = gpt_small(**arch)
    batch = gpt_batch(dev, cfg.vocab_size)
    tokens = GPT_B * GPT_L
    flops = GPTForCausalLM.flops_per_token(cfg, GPT_L) * tokens
    runs, floors = results["gpt_d256"], results["gpt_d256_one_ulp"]
    problems = []        # every run and control is reported before failing
    for dtype, remat, entry in D256_RUNS:
        key = f"{dtype}_{entry}_remat_{remat or 'off'}"
        st, step_s = gpt_run(dev, dtype, False, batch, remat, entry,
                             arch=arch)
        if dtype == "bfloat16" and dtype not in floors:
            # the chaos of this bf16 run, as in the gpt phase
            nst, _ = gpt_run(dev, dtype, False, batch, nudge=True,
                             arch=arch)
            floors[dtype] = c = dict(
                losses=nst["losses"],
                trajectory_rel_dev=traj_dev(nst["losses"], st["losses"]))
            print(f"[gpt_d256 one ulp {dtype}] {json.dumps(c)}", flush=True)
        pst, pstep_s = gpt_run(dev, dtype, True, batch, remat, entry,
                               arch=arch)
        want = gpt_want_launches(st["dtype_groups"], cfg.num_layers,
                                 bool(remat))
        got = {k: st["launches"][k] for k in want}
        others = {k: v for k, v in st["launches"].items()
                  if k not in want and v}
        if got != want or others:
            problems.append(f"gpt_d256 {key}: kernel launches {got} (and "
                            f"{others}), want {want} over {TRAIN_STEPS} "
                            f"steps")
        if any(pst["launches"].values()):
            problems.append(f"gpt_d256 {key}: the plain run launched "
                            f"kernels {pst['launches']}")
        ls = st["losses"]
        dev_rel = traj_dev(ls, pst["losses"])
        floor = floors.get(dtype, {}).get("trajectory_rel_dev", 0.0)
        tol = gpt_tol(dtype, floor)
        st.update(plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
                  plain_peak_mem_gb=pst["peak_mem_gb"],
                  trajectory_rel_dev=dev_rel, trajectory_tol=tol,
                  one_ulp_floor=floor,
                  within_traj_tol=dev_rel <= traj_tol(dtype, "auto"),
                  tokens_per_s=tokens / step_s,
                  plain_tokens_per_s=tokens / pstep_s,
                  flops_per_step=flops, tflops=flops / step_s / 1e12,
                  bf16_peak_share=flops / step_s / PEAK["bfloat16"])
        if remat:
            base = runs["bfloat16_step_remat_off"]
            st["remat_rel_dev"] = traj_dev(ls, base["losses"])
            st["remat_rtol"] = REMAT_RTOL
            st["no_remat_peak_mem_gb"] = base["peak_mem_gb"]
        runs[key] = st
        print(f"[gpt_d256 {key}] {json.dumps(st)}", flush=True)
        print(f"[gpt_d256 {key}] {tokens / step_s:.1f} tokens/s, "
              f"{st['step_ms']:.2f} ms/step, {st['tflops']:.2f} TFLOP/s = "
              f"{100 * st['bf16_peak_share']:.2f}% of the dense bf16 peak "
              f"(989 TFLOP/s) of {card}; peak memory "
              f"{st['peak_mem_gb']:.2f} GB; trajectory vs plain "
              f"{dev_rel:.3g} (limit {tol:.3g})", flush=True)
        if not all(math.isfinite(x) for x in ls):
            problems.append(f"gpt_d256 {key}: non-finite loss {ls}")
        if dev_rel > tol:
            problems.append(
                f"gpt_d256 {key}: loss trajectory departs from the plain "
                f"path's by {dev_rel:.3g} > {tol} ({ls} vs {pst['losses']})")
        if not ls[-1] < ls[0]:
            problems.append(f"gpt_d256 {key}: loss did not fall {ls}")
        if remat and st["remat_rel_dev"] > REMAT_RTOL:
            problems.append(
                f"gpt_d256 {key}: remat departs from no remat by "
                f"{st['remat_rel_dev']:.3g} > {REMAT_RTOL}")

    ref = runs["float32_step_remat_off"]["plain_losses"]
    tol = gpt_tol("float32", 0.0)
    for fault in D256_FAULTS:
        st, _ = gpt_run(dev, "float32", False, batch, fault=fault,
                        arch=arch)
        dev_rel = traj_dev(st["losses"], ref)
        results["gpt_d256_controls"][fault] = c = dict(
            losses=st["losses"], trajectory_rel_dev=dev_rel,
            trajectory_tol=tol, over_tol=dev_rel / tol, caught=dev_rel > tol)
        print(f"[gpt_d256 control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            problems.append(
                f"gpt_d256 control {fault}: the planted fault departs by "
                f"only {dev_rel:.3g} <= {tol}; the check cannot see it")
    try:
        arch_serve(dev, results, arch, "gpt_d256", against_plain=True)
    except Exception as e:          # reported with the training problems
        traceback.print_exc()
        problems.append(f"gpt_d256 serving: {e}")
    results["gpt_d256_s"] = time.perf_counter() - t_phase
    print(f"[gpt_d256] phase {results['gpt_d256_s']:.1f} s", flush=True)
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# spec_prefix: speculative decoding, the prefix cache, beam search
# ---------------------------------------------------------------------------

SPEC_SC = dict(max_slots=8, max_len=512, page_size=16, prefill_chunk=16)
SPEC_K = 4            # drafted tokens a greedy slot: verify width 5
SPEC_PREFIX = 100     # shared prompt tokens (not page-aligned: a fork)
SPEC_SAMPLED = (3, 11)   # arrival indices of the sampled requests
# (spec_tokens, prefix_cache): the phase's engine, then speculation and
# the cache each on their own and neither
SPEC_RUNS = ((SPEC_K, True), (0, False), (SPEC_K, False), (0, True))
BEAM_K, BEAM_NEW, BEAM_TOL = 4, 16, 1e-4


def spec_prompts(vocab, seed=0):
    """One `SPEC_PREFIX`-token prefix (the primer's prompt) and 18 prompts
    that extend it: 16 greedy ones with a distinct periodic suffix of 8-64
    tokens (a period of 2-8 tokens repeated) and, at `SPEC_SAMPLED`, 2
    sampled ones with a random suffix."""
    import numpy as np
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, SPEC_PREFIX).tolist()
    prompts = []
    for i in range(18):
        n = int(rng.randint(8, 65))
        if i in SPEC_SAMPLED:
            prompts.append(prefix + rng.randint(0, vocab, n).tolist())
            continue
        period = rng.randint(0, vocab, rng.randint(2, 9)).tolist()
        prompts.append(prefix + (period * (n // len(period) + 1))[:n])
    return prefix, prompts


class _RecordingDrafter:
    """`NGramDrafter` that keeps every sequence it drafted for."""

    def __init__(self):
        from mxnet_tpu_torch.serve.spec import NGramDrafter
        self.inner = NGramDrafter()
        self.seen = []

    def propose(self, tokens, k):
        self.seen.append(list(tokens))
        return self.inner.propose(tokens, k)

    def note_result(self, proposed, accepted):
        self.inner.note_result(proposed, accepted)


def spec_serve(model, spec, prefix_cache, plain=False, fault=None,
               kv_dtype=""):
    """The primer to idle, then `drive` over the 18 prompts, on an engine
    built with ``spec_tokens=spec``, ``prefix_cache`` and `kv_dtype`.
    Counts reset just before the primer, read after the drive; each fused
    step's width recorded.  ``fault="copy_page_noop"`` makes the COW copy
    a no-op."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig

    prefix, prompts = spec_prompts(model.cfg.vocab_size)
    sc = ServeConfig(spec_tokens=spec, prefix_cache=prefix_cache,
                     kv_dtype=kv_dtype, **SPEC_SC)
    rec = _RecordingDrafter() if spec else None
    eng = InferenceEngine(model, sc, device=model.device, seed=0,
                          plain_ops=plain, drafter=rec)
    eng.warmup()
    if fault == "copy_page_noop":
        eng.copy_page = lambda src, dst: None
    widths = {}
    execute = eng._execute

    def counted(*a):
        widths[a[-1]] = widths.get(a[-1], 0) + 1
        return execute(*a)
    eng._execute = counted
    kernels.reset_launch_counts()
    eng.generate(prefix, max_new_tokens=32)
    streams, st = drive(eng, prompts, 32, sampled=SPEC_SAMPLED)
    st.update(launches=kernels.launch_counts(),
              fused_steps=eng.stats()["steps_executed"],
              widths={str(k): v for k, v in sorted(widths.items())},
              spec=eng.scheduler.spec_stats(), spec_tokens=spec,
              prefix_cache=prefix_cache, plain_ops=plain)
    if rec is not None:
        st["sampled_drafts"] = sum(
            seq[:len(prompts[i])] == prompts[i]
            for seq in rec.seen for i in SPEC_SAMPLED)
    eng.drain()
    if eng.prefix_index is not None:
        eng.prefix_index.clear()
    st["pages_free_after_drain"] = eng.allocator.free_pages
    st["pages_total"] = eng.allocator.total_pages
    return streams, prompts, st, eng


def beam_score(model, seq, plen, eos):
    """The winner's length-normalised score, recomputed by one `forward`:
    the summed log-probabilities of its generated tokens up to its first
    eos, over that length (JAX's ``length_penalty`` 1.0)."""
    import torch
    with torch.no_grad():
        ids = torch.tensor([seq], device=model.device)
        lp = torch.log_softmax(model(ids).float(), dim=-1)[0]
    gen = seq[plen:]
    n = gen.index(eos) + 1 if eos in gen else len(gen)
    return float(sum(lp[plen - 1 + j, gen[j]] for j in range(n))) / n


def run_spec_prefix(dev, results, card):
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small

    cfg = gpt_small(dropout=0.0)
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    L = cfg.num_layers
    out = results["spec_prefix"]
    problems = []
    runs = {}
    for spec, pc in SPEC_RUNS:
        key = f"spec{spec}_prefix{int(pc)}"
        streams, prompts, st, eng = spec_serve(model, spec, pc)
        runs[key] = streams
        out[key] = st
        print(f"[spec_prefix {key}] {json.dumps(st)}", flush=True)
        if st["launches"]["ragged_paged_attention"] != L * st["fused_steps"]:
            problems.append(
                f"{key}: K1 launched {st['launches']['ragged_paged_attention']}"
                f" times over {st['fused_steps']} fused steps (want {L} a "
                f"step)")
        if st["pages_free_after_drain"] != st["pages_total"]:
            problems.append(f"{key}: {st['pages_free_after_drain']} pages "
                            f"free after drain, of {st['pages_total']}")
        for s_, p in zip(streams, prompts):
            if len(s_) != len(p) + 32 or not all(
                    0 <= t < cfg.vocab_size for t in s_):
                problems.append(f"{key}: malformed stream")
        del eng
    main = out[f"spec{SPEC_K}_prefix1"]
    sp = main["spec"]
    if not (sp["accept_rate"] or 0) > 0:
        problems.append(f"accept rate {sp['accept_rate']}, want > 0")
    if not sp["prefix_hit_tokens"] > 0 or not sp["cow_forks"] >= 1:
        problems.append(f"prefix hits {sp['prefix_hit_tokens']}, COW forks "
                        f"{sp['cow_forks']}: want both")
    if not main["widths"].get(str(SPEC_K + 1)):
        problems.append(f"no verify-width step: widths {main['widths']}")
    if main["sampled_drafts"]:
        problems.append(f"{main['sampled_drafts']} drafts for sampled slots")
    greedy = [i for i in range(18) if i not in SPEC_SAMPLED]

    def pick(ss):
        return [ss[i] for i in greedy]
    # the plain engine (both features on) and the plain versions' gap for
    # the near-tie rule
    pstreams, _, pst, plain = spec_serve(model, SPEC_K, True, plain=True)
    out["plain"] = pst
    if any(pst["launches"].values()):
        problems.append(f"the plain engine launched {pst['launches']}")
    main_streams = runs[f"spec{SPEC_K}_prefix1"]
    try:
        main["near_ties_vs_off"] = compare_streams(
            pick(main_streams), pick(runs["spec0_prefix0"]), plain.P, cfg,
            "spec_prefix vs neither feature")
        main["near_ties_vs_plain"] = compare_streams(
            pick(main_streams), pick(pstreams), plain.P, cfg,
            "spec_prefix kernel vs plain")
    except AssertionError as e:
        problems.append(str(e))
    # the planted control: the COW copy a no-op must change a stream
    cstreams, _, cst, _ = spec_serve(model, SPEC_K, True,
                                     fault="copy_page_noop")
    changed = sum(a != b for a, b in zip(pick(cstreams), pick(main_streams)))
    out["control_copy_page_noop"] = c = dict(
        cow_forks=cst["spec"]["cow_forks"], streams_changed=changed,
        caught=changed > 0)
    print(f"[spec_prefix control copy_page_noop] {json.dumps(c)}",
          flush=True)
    if not c["caught"]:
        problems.append("control copy_page_noop: no stream changed")
    # the int8 pool under both features: K1's int8 variant a layer a fused
    # step, its forks copying the scale planes; held to the plain engine
    qstreams, _, qst, _ = spec_serve(model, SPEC_K, True, kv_dtype="int8")
    pq, _, pqst, pqeng = spec_serve(model, SPEC_K, True, plain=True,
                                    kv_dtype="int8")
    out["int8"] = qst
    n = qst["launches"]
    if n["ragged_paged_attention_int8"] != L * qst["fused_steps"] or \
            n["ragged_paged_attention"]:
        problems.append(
            f"int8: K1's int8 variant launched "
            f"{n['ragged_paged_attention_int8']} times (float K1 "
            f"{n['ragged_paged_attention']}) over {qst['fused_steps']} "
            f"fused steps (want {L} a step)")
    if any(pqst["launches"].values()):
        problems.append(f"the plain int8 engine launched {pqst['launches']}")
    if not qst["spec"]["cow_forks"] >= 1:
        problems.append("int8: no COW fork")
    try:
        qst["near_ties_vs_plain"] = compare_streams(
            pick(qstreams), pick(pq), pqeng.P, cfg,
            "spec_prefix int8 kernel vs plain", kv_int8=True)
    except AssertionError as e:
        problems.append(str(e))
    gen = [(a[len(p):], b[len(p):]) for a, b, p in zip(
        pick(qstreams), pick(main_streams), pick(prompts))]
    qst["equal_token_share_vs_f32"] = sum(
        x == y for a, b in gen for x, y in zip(a, b)) / sum(
        len(a) for a, _ in gen)
    print(f"[spec_prefix int8] {json.dumps(qst)}", flush=True)
    del pqeng
    off = out["spec0_prefix0"]
    out["summary"] = summary = dict(
        card=card, accept_rate=sp["accept_rate"],
        steps_per_token=sp["steps_per_token"],
        steps_per_token_off=off["spec"]["steps_per_token"],
        tokens_per_s_spec_on=out[f"spec{SPEC_K}_prefix0"]["tokens_per_s"],
        tokens_per_s_spec_off=off["tokens_per_s"],
        tokens_per_s_both=main["tokens_per_s"],
        ttft_p50_ms_prefix_on=out["spec0_prefix1"]["ttft_p50_ms"],
        ttft_p99_ms_prefix_on=out["spec0_prefix1"]["ttft_p99_ms"],
        ttft_p50_ms_prefix_off=off["ttft_p50_ms"],
        ttft_p99_ms_prefix_off=off["ttft_p99_ms"],
        prefix_hit_tokens=sp["prefix_hit_tokens"], cow_forks=sp["cow_forks"],
        verify_steps=main["widths"].get(str(SPEC_K + 1), 0),
        k1_launches=main["launches"]["ragged_paged_attention"],
        int8_tokens_per_s=qst["tokens_per_s"],
        int8_k1_launches=qst["launches"]["ragged_paged_attention_int8"])
    print(f"[spec_prefix summary] {json.dumps(summary)}", flush=True)
    del plain

    # beam search: the card against a CPU copy of the model
    prompts = [p[:32] for p in make_prompts(cfg.vocab_size, n=2, lo=32,
                                            hi=32, seed=5)]
    ids = torch.tensor(prompts, dtype=torch.int32)
    free = model.generate(ids.to(dev), BEAM_NEW, num_beams=BEAM_K)
    eos = int(free[0, 32])      # the first token the free search emits
    cpu = GPTForCausalLM(cfg, device="cpu", seed=0)   # the same weights
    kernels.reset_launch_counts()
    got = model.generate(ids.to(dev), BEAM_NEW, num_beams=BEAM_K,
                         eos_token_id=eos).cpu().tolist()
    beam_launches = kernels.launch_counts()
    want = cpu.generate(ids, BEAM_NEW, num_beams=BEAM_K,
                        eos_token_id=eos).tolist()
    rows = []
    for g_, w_ in zip(got, want):
        row = dict(equal=g_ == w_)
        if g_ != w_:
            sg, sw = (beam_score(cpu, x, 32, eos) for x in (g_, w_))
            row.update(score_card=sg, score_cpu=sw, gap=abs(sg - sw))
            if abs(sg - sw) >= BEAM_TOL:
                problems.append(f"beam: the card's winner scores {sg:.6g}, "
                                f"the CPU's {sw:.6g} (gap >= {BEAM_TOL})")
        rows.append(row)
    out["beam"] = dict(num_beams=BEAM_K, eos=eos, rows=rows,
                       launches=beam_launches,
                       eos_hit=[eos in g_[32:] for g_ in got])
    print(f"[spec_prefix beam] {json.dumps(out['beam'])}", flush=True)
    del cpu, model
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# nmt: the Transformer encoder-decoder (Vaswani et al. 2017, "base")
# ---------------------------------------------------------------------------

NMT_B, NMT_LS, NMT_LT = 32, 128, 96    # sources x tokens, target tokens
NMT_VL = (64, 128)                     # source valid lengths, inclusive
NMT_LR = 1e-4                          # Adam
NMT_TRANSLATE = 8                      # sources through greedy_translate
# planted fault, read against the f32 oracle at `nmt_tol`: the decoder's
# self-attention built non-causal (each target position sees its label)
NMT_FAULTS = ("decoder_not_causal",)


def nmt_tol(dtype, floor):
    """The nmt phase's trajectory limit, kernel run vs its plain oracle:
    the larger of `traj_tol` and `GPT_FLOOR_X` one-ulp floors of the same
    call, in either dtype.  Adam at lr 1e-4 fitting a fixed batch is
    chaotic at this size even in f32: on the H100 one f32 ulp in one
    weight element moves the kernel run 2.3e-4 (the plain run 8.0e-5;
    without dropout 1.1e-3 and 1.8e-3; with epsilon 1e-6 3.1e-4), over
    `traj_tol`'s 1e-4, while each route repeats itself bit for bit.  The
    control shows how far above the limit a wrong attention lands."""
    return max(traj_tol(dtype, "auto"), GPT_FLOOR_X * floor)


def nmt_batch(dev, cfg, seed=0):
    """Sources (32, 128) padded by ``src_valid_length`` (64-128), target
    inputs (32, 96) and labels (32, 96), from `seed`."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    src = rng.randint(0, cfg.src_vocab_size, (NMT_B, NMT_LS))
    vl = rng.randint(NMT_VL[0], NMT_VL[1] + 1, NMT_B)
    tgt = rng.randint(0, cfg.tgt_vocab_size, (NMT_B, NMT_LT + 1))
    t = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (src, vl, tgt)]
    return t[0], t[2][:, :-1], t[1], t[2][:, 1:]


def nmt_flops_per_step(cfg, vl):
    """Training FLOPs of one step (3x the forward's multiply-adds, x2):
    every position through the projections (encoder q/k/v/o and FFN at
    all 128 source positions; decoder q/k/v/o, cross q/o, FFN and the
    vocabulary projection at the 96 target positions; cross k/v at the
    source positions) plus attention's two products over the (query, key)
    pairs the masks keep: the encoder's and cross-attention's keys up to
    each source's valid length, the decoder's causal half."""
    h, ff, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    src_tok, tgt_tok = NMT_B * NMT_LS, NMT_B * NMT_LT
    params = src_tok * n * (4 * h * h + 2 * h * ff) \
        + tgt_tok * n * (6 * h * h + 2 * h * ff) \
        + src_tok * n * 2 * h * h + tgt_tok * h * cfg.tgt_vocab_size
    keys = sum(int(v) for v in vl)
    pairs = n * (NMT_LS * keys + NMT_B * NMT_LT * (NMT_LT + 1) // 2
                 + NMT_LT * keys)
    return 6.0 * params + 12.0 * h * pairs


def nmt_model(dev, dtype, plain=False, fault=None):
    """`transformer_base` (seed 0, dropout 0.1) on `dev`; ``plain=True``
    swaps in the plain versions (attention, norms) so the model launches
    no kernel; `fault` plants one of `NMT_FAULTS`."""
    from mxnet_tpu_torch.models import TransformerNMT, transformer_base
    from mxnet_tpu_torch.models.layers import _plain_twin

    model = TransformerNMT(transformer_base(dtype=dtype), device=dev,
                           seed=0)
    if fault == "decoder_not_causal":
        for layer in model.decoder.layers:
            layer.attention.causal = False
    if plain:
        _plain_twin(model)
    return model


def nmt_run(dev, dtype, plain, batch, nudge=False, fault=None):
    """`TRAIN_STEPS` Adam steps of `nmt_model` through `TrainStep` (the
    cross-entropy over the (3072, 32000) logits), counts reset after
    warmup; the oracle updates leaf by leaf (`kernel_plain`) with the
    plain loss.  `nudge` moves one weight element one unit in the last
    place (how far one rounding carries).  Returns its stats and the step
    time."""
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.fused_optimizer import kernel_plain
    from mxnet_tpu_torch.ops.softmax_xent import \
        softmax_cross_entropy_reference
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import TrainStep

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = nmt_model(dev, dtype, plain, fault)
    if nudge:
        w = model.encoder.layers[0].ffn.ffn_intermediate.weight.data()
        bits = torch.int16 if w.element_size() == 2 else torch.int32
        with torch.no_grad():
            w.view(-1)[:1].view(bits).add_(1)
    V = model.cfg.tgt_vocab_size
    ce = SoftmaxCrossEntropyLoss()

    def loss_fn(out, src, tin, vl, lab):
        if plain:
            return softmax_cross_entropy_reference(
                out.reshape(-1, V), lab.reshape(-1)).mean()
        return ce(out.reshape(-1, V), lab.reshape(-1)).mean()

    with pallas_mode("reference" if plain else "auto"):
        step = TrainStep(model, Adam(learning_rate=NMT_LR), loss_fn,
                         num_model_args=3,
                         update=kernel_plain if plain else None)
        warm_s = step.warmup(*batch)
        kernels.reset_launch_counts()
        losses = []
        for i in range(TRAIN_STEPS):
            losses.append(step.dispatch(*batch).loss)
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 2)
        launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    groups = len({p.dtype for p in model.parameters()})
    del model, step
    torch.cuda.empty_cache()
    return dict(losses=[float(x) for x in losses], step_ms=step_s * 1e3,
                warmup_s=warm_s, launches=launches, dtype_groups=groups,
                peak_mem_gb=peak), step_s


def nmt_want_launches(n_groups, layers):
    """Exact launches over `TRAIN_STEPS` steps.  A step: the flash forward
    and backward three times a decoder layer (self, causal; cross, Lq !=
    Lk) and once an encoder layer; the fused norm twice an encoder layer,
    three times a decoder layer, and each stack's final norm; the
    cross-entropy once each way; the chunk once per dtype group."""
    per_step = {"flash_attention_fwd": 3 * layers,
                "flash_attention_bwd": 3 * layers,
                "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                "fused_norm": 5 * layers + 2,
                "fused_optimizer_chunk": n_groups}
    return {k: v * TRAIN_STEPS for k, v in per_step.items()}


def nmt_compare(got, want, plain, src, vl):
    """Every translation in `got` equals `want`, except where the plain
    model's top-2 gap at the first differing token is below GAP; returns
    the number of such near ties, raises on any other difference."""
    import torch
    near = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        k = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        with torch.no_grad():
            logits = plain(src[i:i + 1], torch.tensor([w[:k]], device=src
                                                      .device,
                                                      dtype=torch.int32),
                           vl[i:i + 1])[0, -1].float()
        top = torch.topk(logits, 2).values
        gap = float(top[0] - top[1])
        if gap >= GAP:
            raise AssertionError(
                f"nmt translation {i} diverges at token {k} ({g[k]} vs "
                f"{w[k]}) where the plain model's top-2 gap is {gap:.3g}")
        near += 1
    return near


def run_nmt(dev, results, card):
    import torch
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.models import transformer_base

    cfg = transformer_base()
    batch = nmt_batch(dev, cfg)
    flops = nmt_flops_per_step(cfg, batch[2].tolist())
    tgt_tokens = NMT_B * NMT_LT
    out = results["nmt"]
    out["flops_per_step"] = flops
    problems = []
    for dtype in ("float32", "bfloat16"):
        st, step_s = nmt_run(dev, dtype, False, batch)
        pst, pstep_s = nmt_run(dev, dtype, True, batch)
        nst, _ = nmt_run(dev, dtype, False, batch, nudge=True)
        want = nmt_want_launches(st["dtype_groups"], cfg.num_layers)
        got = {k: st["launches"][k] for k in want}
        others = {k: v for k, v in st["launches"].items()
                  if k not in want and v}
        if got != want or others:
            problems.append(f"nmt {dtype}: kernel launches {got} (and "
                            f"{others}), want {want} over {TRAIN_STEPS} "
                            f"steps")
        if any(pst["launches"].values()):
            problems.append(f"nmt {dtype}: the plain run launched kernels "
                            f"{pst['launches']}")
        ls = st["losses"]
        dev_rel = traj_dev(ls, pst["losses"])
        floor = traj_dev(nst["losses"], ls)
        tol = nmt_tol(dtype, floor)
        st.update(plain_losses=pst["losses"], plain_step_ms=pst["step_ms"],
                  trajectory_rel_dev=dev_rel, trajectory_tol=tol,
                  one_ulp_floor=floor,
                  within_traj_tol=dev_rel <= traj_tol(dtype, "auto"),
                  target_tokens_per_s=tgt_tokens / step_s,
                  tokens_per_s=(NMT_B * (NMT_LS + NMT_LT)) / step_s,
                  plain_target_tokens_per_s=tgt_tokens / pstep_s,
                  flops_per_step=flops, tflops=flops / step_s / 1e12,
                  peak_share=flops / step_s / PEAK[dtype])
        out[dtype] = st
        print(f"[nmt {dtype}] {json.dumps(st)}", flush=True)
        print(f"[nmt {dtype}] {st['step_ms']:.2f} ms/step, "
              f"{st['target_tokens_per_s']:.1f} target tokens/s, "
              f"{st['tflops']:.2f} TFLOP/s ({flops / 1e12:.4f} TFLOP a "
              f"step) = {100 * st['peak_share']:.2f}% of the {dtype} peak "
              f"of {card}; trajectory vs plain {dev_rel:.3g} (limit "
              f"{tol:.3g}: {GPT_FLOOR_X} one-ulp floors of {floor:.3g}, at "
              f"least traj_tol {traj_tol(dtype, 'auto')})", flush=True)
        if not all(math.isfinite(x) for x in ls):
            problems.append(f"nmt {dtype}: non-finite loss {ls}")
        if dev_rel > tol:
            problems.append(f"nmt {dtype}: loss trajectory departs from the "
                            f"plain path's by {dev_rel:.3g} > {tol}")
        if not ls[-1] < ls[0]:
            problems.append(f"nmt {dtype}: loss did not fall {ls}")
    for fault in NMT_FAULTS:
        st, _ = nmt_run(dev, "float32", False, batch, fault=fault)
        ref = out["float32"]
        dev_rel = traj_dev(st["losses"], ref["plain_losses"])
        tol = ref["trajectory_tol"]
        out[f"control_{fault}"] = c = dict(
            losses=st["losses"], trajectory_rel_dev=dev_rel,
            trajectory_tol=tol, over_tol=dev_rel / tol, caught=dev_rel > tol)
        print(f"[nmt control {fault}] {json.dumps(c)}", flush=True)
        if not c["caught"]:
            problems.append(f"nmt control {fault}: the planted fault departs "
                            f"by only {dev_rel:.3g} <= {tol:.3g}")

    # greedy translation, kernel route against the plain one (f32)
    src, _, vl, _ = batch
    src, vl = src[:NMT_TRANSLATE], vl[:NMT_TRANSLATE]
    model = nmt_model(dev, "float32")
    plain = nmt_model(dev, "float32", plain=True).eval()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = model.greedy_translate(src, max_len=32, src_valid_length=vl)
    torch.cuda.synchronize()
    tr = dict(seconds=time.perf_counter() - t0,
              launches=kernels.launch_counts(), shape=list(got.shape))
    want = plain.greedy_translate(src, max_len=32, src_valid_length=vl)
    steps = got.shape[1] - 1
    need = cfg.num_layers * (1 + 2 * steps)
    if tr["launches"]["flash_attention_fwd"] != need:
        problems.append(f"nmt translate: flash forward launched "
                        f"{tr['launches']['flash_attention_fwd']} times, "
                        f"want {need}")
    try:
        tr["near_ties_vs_plain"] = nmt_compare(got.tolist(), want.tolist(),
                                               plain, src, vl)
    except AssertionError as e:
        problems.append(str(e))
    out["translate"] = tr
    print(f"[nmt translate] {json.dumps(tr)}", flush=True)
    del model, plain
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# gluon: the Gluon front end -- BERT-base fine-tuned through `Block`,
# `Trainer`, loss and metrics; `quantize_net` over an MLP at BERT's widths
# ---------------------------------------------------------------------------

GLUON_B, GLUON_L, GLUON_STEPS = 32, 128, 8
GLUON_LR, GLUON_DECAY = 5e-4, 0.75       # bert_finetune.py:99-106, :114
# Adam's epsilon: the key third of the QKV bias has an exactly zero
# gradient (softmax ignores a per-row shift), where epsilon 1e-8 would
# turn round-off into full steps of random sign between the two runs
GLUON_EPS = 1e-6
MLP_B, MLP_STEPS, MLP_CALIB, MLP_LR = 64, 20, 4, 5e-3
# K2 at the MLP's three products (M, N, K), timed; then the edges no other
# phase has, checked: N = 2 at K = 16, and quantization_int8.py's first
# layer (K = 16)
GLUON_K2 = ((64, 3072, 768), (64, 768, 3072), (64, 2, 768))
GLUON_K2_EDGES = ((64, 2, 16), (64, 64, 16))
# the cross-entropy at the fine-tune's and the example's class counts
GLUON_XENT = (("float32", 32, 2), ("float32", 32, 3), ("float32", 64, 2))


def _bert_classifier(cfg):
    """`examples/bert_finetune.py`'s BertClassifier: the port's
    `BertModel` as its direct child ``bert``, then dropout and a dense
    head; its parameters wait for ``initialize()``, as in Gluon."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.models.bert import BertModel

    class BertClassifier(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.bert = BertModel(cfg)
            self.dropout = nn.Dropout(cfg.dropout)
            self.classifier = nn.Dense(2, in_units=cfg.hidden_size)

        def forward(self, ids, token_types, valid_length):
            _, pooled = self.bert(ids, token_types, valid_length)
            return self.classifier(self.dropout(pooled))

    return BertClassifier()


def gluon_batches(cfg, seed=0):
    """`bert_finetune.py`'s synthetic pairs at (32, 128): segment B from
    the middle, ragged valid_length in [0.8 L, L], the label a marker
    token at the middle."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(GLUON_STEPS):
        ids = rng.randint(5, cfg.vocab_size, (GLUON_B, GLUON_L))
        half = GLUON_L // 2
        tt = np.zeros((GLUON_B, GLUON_L), np.int32)
        tt[:, half:] = 1
        vl = rng.randint(int(0.8 * GLUON_L), GLUON_L + 1, (GLUON_B,))
        lab = rng.randint(0, 2, (GLUON_B,))
        ids[:, half] = 3 + lab
        out.append((ids.astype(np.int32), tt, vl.astype(np.int32),
                    lab.astype(np.int32)))
    return out


def gluon_finetune(dev, cfg, batches, ckpt, plain=False, saved=None):
    """The fine-tune loop of `examples/bert_finetune.py` on the card:
    BERT-base (seed 0, N(0, 0.02)) whose backbone comes back from
    `ckpt` through ``net.bert.load_parameters``, ``hybridize()``, ``autograd.record``,
    `SoftmaxCrossEntropyLoss`, `gluon.Trainer(net.collect_params(),
    "adam")` with the layer-wise ``lr_mult`` and the warm-up
    `PolyScheduler`, `metric.Accuracy` and `metric.F1` each step.
    ``plain=True`` is its twin on the plain versions (no launch): the
    attention's and norms' plain versions and the plain cross-entropy.
    `saved` (name -> the values written to `ckpt`) is checked bit for bit
    against what `load_parameters` brought back.  Returns the stats and
    the net."""
    import functools
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, initializer, kernels
    from mxnet_tpu_torch import random as mrandom
    from mxnet_tpu_torch.gluon import metric
    from mxnet_tpu_torch.models.layers import _plain_twin
    from mxnet_tpu_torch.ndarray.ndarray import apply
    from mxnet_tpu_torch.ops.softmax_xent import \
        softmax_cross_entropy_reference
    from mxnet_tpu_torch.optimizer import lr_scheduler

    mrandom.seed(0)
    net = _bert_classifier(cfg)
    net.initialize(initializer.Normal(0.02), device=dev)
    net.bert.load_parameters(ckpt)
    params = net.collect_params()
    backbone = net.bert.collect_params()
    bit_equal = None if saved is None else all(
        torch.equal(backbone[n].data(), v) for n, v in saved.items())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    if plain:
        _plain_twin(net)
        loss_fn = functools.partial(apply, softmax_cross_entropy_reference)
    for name, p in params.items():
        if ".layers." in name:
            p.lr_mult = GLUON_DECAY ** (
                cfg.num_layers - int(name.split(".layers.")[1].split(".")[0]))
        elif name.startswith("bert."):
            p.lr_mult = GLUON_DECAY ** (cfg.num_layers + 1)
    sched = lr_scheduler.PolyScheduler(
        max_update=GLUON_STEPS, base_lr=GLUON_LR, final_lr=0.0, pwr=1,
        warmup_steps=max(1, GLUON_STEPS // 10), warmup_begin_lr=0.0)
    trainer = gluon.Trainer(params, "adam", {
        "learning_rate": GLUON_LR, "lr_scheduler": sched,
        "epsilon": GLUON_EPS})
    net.hybridize()
    acc, f1 = metric.Accuracy(), metric.F1()
    losses, preds, per_step = [], [], []
    for i, (ids, tt, vl, lab) in enumerate(batches):
        # the example's batch: mx.np arrays on the current device
        ids, tt, vl, lab = (mx.np.array(ids, dtype="int32"),
                            mx.np.array(tt, dtype="int32"),
                            mx.np.array(vl, dtype="int32"),
                            mx.np.array(lab))
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        kernels.reset_launch_counts()
        with autograd.record():
            logits = net(ids, tt, vl)
            loss = loss_fn(logits, lab)
        loss.backward()
        trainer.step(GLUON_B)
        per_step.append(kernels.launch_counts())
        losses.append(float(loss.mean().asnumpy()))
        acc.update(lab, logits)
        f1.update(lab, logits)
        preds.append(logits.asnumpy().argmax(1))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (GLUON_STEPS - 2)
    labels = np.concatenate([b[3] for b in batches])
    pred = np.concatenate(preds)
    tp = float(((pred == 1) & (labels == 1)).sum())
    fp = float(((pred == 1) & (labels == 0)).sum())
    fneg = float(((pred == 0) & (labels == 1)).sum())
    prec, rec = tp / max(tp + fp, 1e-12), tp / max(tp + fneg, 1e-12)
    st = dict(losses=losses, step_ms=step_s * 1e3,
              launches_per_step=per_step,
              accuracy=acc.get()[1], f1=f1.get()[1],
              numpy_accuracy=float((pred == labels).mean()),
              numpy_f1=2 * prec * rec / max(prec + rec, 1e-12),
              route="fused" if trainer._uniform_mults() else "per-parameter",
              tensors=len(params), checkpoint_bit_equal=bit_equal)
    return st, net


def gluon_want(layers):
    """Launches a fine-tune step: the flash forward and backward once a
    layer, the norm twice a layer and the embeddings' once, the
    cross-entropy once each way, no optimizer kernel (the layer-wise
    ``lr_mult`` takes the per-parameter route, as JAX's Trainer does)."""
    return {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
            "fused_norm": 2 * layers + 1, "softmax_xent_fwd": 1,
            "softmax_xent_bwd": 1}


def mlp_data(seed=3):
    """Gaussian blobs in 768 dimensions, two classes: (train batches,
    calibration batches, test x, test labels)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    centers = rng.randn(2, 768) * 0.3
    n = MLP_B * (MLP_STEPS + MLP_CALIB + 2)
    y = rng.randint(0, 2, n)
    x = (centers[y] + rng.randn(n, 768)).astype(np.float32)
    y = y.astype(np.int32)
    b = [(x[i:i + MLP_B], y[i:i + MLP_B]) for i in range(0, n, MLP_B)]
    test = (x[-2 * MLP_B:], y[-2 * MLP_B:])
    return b[:MLP_STEPS], [xb for xb, _ in
                           b[MLP_STEPS:MLP_STEPS + MLP_CALIB]], test


def gluon_mlp(dev, problems, card):
    """`examples/quantization_int8.py`'s flow at BERT's FFN widths:
    train the MLP 20 Adam steps through the `Trainer` (row 7 once a step),
    calibrate on 4 batches ("naive", then "entropy"), `quantize_net` (K2
    three times a forward, held to `quantized_matmul_reference` by running
    the same quantized net under ``MXTPU_PALLAS=reference``), then under
    ``MXTPU_QUANT_ACT=1`` (no K2)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, kernels
    from mxnet_tpu_torch import random as mrandom
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.gluon import nn

    train, calib, (xt, yt) = mlp_data()
    mrandom.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(3072, in_units=768, activation="relu"), nn.LayerNorm(),
            nn.Dense(768, activation="relu"), nn.Dense(2))
    net.initialize(device=dev)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": MLP_LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    kernels.reset_launch_counts()
    losses = []
    for xb, yb in train:
        xb, yb = mx.np.array(xb), mx.np.array(yb)
        with autograd.record():
            loss = loss_fn(net(xb), yb)
        loss.backward()
        trainer.step(MLP_B)
        losses.append(float(loss.mean().asnumpy()))
    train_launches = kernels.launch_counts()
    want = {"fused_optimizer_chunk": MLP_STEPS, "fused_norm": MLP_STEPS,
            "softmax_xent_fwd": MLP_STEPS, "softmax_xent_bwd": MLP_STEPS}
    got = {k: train_launches[k] for k in want}
    st = dict(losses=losses, launches=train_launches)
    print(f"[gluon mlp] losses {losses[0]:.4g} -> {losses[-1]:.4g}, "
          f"launches {json.dumps(got)} over {MLP_STEPS} steps ({card})",
          flush=True)
    if got != want:
        problems.append(f"gluon mlp: launches {got}, want {want}")
    if not losses[-1] < losses[0]:
        problems.append(f"gluon mlp: loss did not fall {losses}")
    x = mx.np.array(xt)
    p32 = net(x).asnumpy().argmax(-1)
    st["fp32_accuracy"] = float((p32 == yt).mean())
    calib = [mx.np.array(c) for c in calib]
    for mode in ("naive", "entropy"):
        qnet = quantize_net(net, calib_data=calib, calib_mode=mode)
        kernels.reset_launch_counts()
        out = qnet(x)
        torch.cuda.synchronize()
        k2 = kernels.launch_counts()["quantized_matmul"]
        with pallas_mode("reference"):
            ref = qnet(x)
        err, scale = _scale_err(out._data, ref._data)
        p8 = out.asnumpy().argmax(-1)
        c = dict(k2_launches_per_forward=k2, max_abs_err=err,
                 out_scale=scale, tol=TOL["float32"] * scale,
                 int8_accuracy=float((p8 == yt).mean()),
                 agreement=float((p8 == p32).mean()),
                 thresholds={k: q.x_amax for k, q in qnet._qmap.items()})
        if k2 != 3:
            problems.append(f"gluon quantize_net {mode}: K2 launched {k2} "
                            f"times a forward, want 3")
        if not err <= c["tol"]:
            problems.append(f"gluon quantize_net {mode}: {err:.3g} off the "
                            f"plain version (limit {c['tol']:.3g})")
        if mode == "naive":
            with env(MXTPU_QUANT_ACT="1"):
                kernels.reset_launch_counts()
                act = qnet(x)
                torch.cuda.synchronize()
                c["act8_k2_launches"] = \
                    kernels.launch_counts()["quantized_matmul"]
            pa = act.asnumpy().argmax(-1)
            c["act8_agreement"] = float((pa == p32).mean())
            c["act8_finite"] = bool(mx.np.isfinite(act).all())
            if c["act8_k2_launches"] or not c["act8_finite"]:
                problems.append(f"gluon quantize_net under MXTPU_QUANT_ACT"
                                f"=1: K2 launched {c['act8_k2_launches']} "
                                f"times, finite {c['act8_finite']}")
        st[f"quantize_{mode}"] = c
        print(f"[gluon quantize_net {mode}] {json.dumps(c)} ({card})",
              flush=True)
    if not np.isfinite(losses).all():
        problems.append(f"gluon mlp: non-finite loss {losses}")
    return st


def gluon_cases(dev):
    """The cross-entropy at V = 2 and 3 (`GLUON_XENT`) and K2 at the MLP's
    products (timed, beside cuBLAS over a dequantized copy and the bound)
    and at N = 2 and K = 16 (`GLUON_K2_EDGES`)."""
    import torch
    from mxnet_tpu_torch.ops import quantized_matmul as qm
    from mxnet_tpu_torch.ops import softmax_xent as sx
    g = torch.Generator().manual_seed(21)
    out = []
    for dtype, N, V in GLUON_XENT:
        x = (2.0 * torch.randn(N, V, generator=g)).to(dev)
        lab = torch.randint(0, V, (N,), generator=g).to(dev, torch.int32)
        gr = torch.rand(N, generator=g).to(dev)
        errs, _, _ = _xent_errs(sx, x, lab, gr)
        out.append(dict(_xent_case(dtype, N, V, errs), kernel="xent"))
    for (M, N, K), timed in ([(s, True) for s in GLUON_K2] +
                             [(s, False) for s in GLUON_K2_EDGES]):
        qt = qm.quantize_weight(torch.randn(N, K, generator=g) * 0.02,
                                8).to(dev)
        x = torch.randn(M, K, generator=g).to(dev)
        got = qm.quantized_matmul(x, qt)
        ref = qm.quantized_matmul_reference(x, qt)
        torch.cuda.synchronize()
        err, scale = _scale_err(got, ref)
        case = dict(kernel="k2", bits=8, dtype="float32", M=M, N=N, K=K,
                    plan=dict(qm._tuned_plan(M, N, K, 8, x.dtype,
                                             x.device)._asdict()),
                    max_abs_err=err, out_scale=scale,
                    tol=TOL["float32"] * scale, ok=err <= TOL["float32"] *
                    scale)
        if timed:
            wd = qm.dequantize_weight(qt, x.dtype)
            case["ms"] = time_ms(lambda: qm.quantized_matmul(x, qt))
            case["plain_ms"] = time_ms(
                lambda: qm.quantized_matmul_reference(x, qt))
            case["library_ms"] = time_ms(lambda: x @ wd.T)
            case["bound_ms"], case["bound_by"] = bound(
                x.numel() * 4 + qt.nbytes() + M * N * 4, 2.0 * M * N * K,
                "tf32x2")
        out.append(case)
    return out


def run_gluon(dev, results, card):
    """The gluon phase: the card cases, the BERT-base fine-tune against
    its plain twin, and the MLP's `quantize_net`.  Every count and time is
    printed beside the card's name and power limit."""
    import tempfile
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch import random as mrandom
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.models.bert import BertModel

    res = results["gluon"]
    problems = []
    t_phase = time.perf_counter()
    res["cases"] = cases = gluon_cases(dev)
    for c in cases:
        print(f"[gluon case] {json.dumps(c)} ({card})", flush=True)
        if not c["ok"]:
            problems.append(f"gluon case {c}: outside tolerance")

    cfg = bert_base()
    batches = gluon_batches(cfg)
    fd, ckpt = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        # the "pretrained" backbone, saved as the example saves it
        mrandom.seed(0)
        pre = BertModel(cfg)
        pre.initialize(initializer.Normal(0.02), device=dev)
        pre.save_parameters(ckpt)
        saved = {n: p.data() for n, p in pre.collect_params().items()}
        st, net = gluon_finetune(dev, cfg, batches, ckpt, saved=saved)
        del pre, saved
        pst, pnet = gluon_finetune(dev, cfg, batches, ckpt, plain=True)
    finally:
        os.remove(ckpt)
    want = gluon_want(cfg.num_layers)
    for i, (k, pk) in enumerate(zip(st.pop("launches_per_step"),
                                    pst.pop("launches_per_step"))):
        if {n: k[n] for n in want} != want or k["fused_optimizer_chunk"]:
            problems.append(f"gluon finetune step {i + 1}: launches {k}, "
                            f"want {want}")
        if any(pk.values()):
            problems.append(f"gluon finetune step {i + 1}: the plain twin "
                            f"launched {pk}")
    st["launches_per_step"] = want
    # each tensor's departure from the twin's, relative to the twin's
    # tensor in the L2 norm (gated), and its largest element's relative to
    # the tensor's largest (reported: Adam turns round-off in a gradient
    # that is zero up to rounding, the key third of the QKV bias, into
    # steps, element by element)
    pw = pnet.collect_params()
    rel, elem = {}, {}
    for n, p in net.collect_params().items():
        a, b = p.data().detach(), pw[n].data().detach()
        rel[n] = float((a - b).norm() / b.norm().clamp_min(1e-30))
        elem[n] = float((a - b).abs().max() /
                        b.abs().max().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    st.update(weights_rel_dev=rel[worst], weights_rel_dev_tensor=worst,
              weights_elem_rel_dev=max(elem.values()),
              weights_elem_rel_dev_tensor=max(elem, key=elem.get))
    st["plain_losses"] = pst["losses"]
    st["plain_step_ms"] = pst["step_ms"]
    st["trajectory_rel_dev"] = traj_dev(st["losses"], pst["losses"])
    st["tol"] = tol = traj_tol("float32", "auto")
    del net, pnet, pw
    torch.cuda.empty_cache()
    res["finetune"] = st
    print(f"[gluon finetune] {json.dumps(st)} ({card})", flush=True)
    if not st["checkpoint_bit_equal"]:
        problems.append("gluon: the backbone did not come back bit-equal "
                        "from save_parameters / load_parameters")
    if st["trajectory_rel_dev"] > tol or st["weights_rel_dev"] > tol:
        problems.append(f"gluon finetune: {st['trajectory_rel_dev']:.3g} "
                        f"(losses), {st['weights_rel_dev']:.3g} (weights) "
                        f"off the plain twin, limit {tol}")
    if abs(st["accuracy"] - st["numpy_accuracy"]) > 1e-12 or \
            abs(st["f1"] - st["numpy_f1"]) > 1e-12:
        problems.append(f"gluon metrics {st['accuracy']}, {st['f1']} vs "
                        f"numpy {st['numpy_accuracy']}, {st['numpy_f1']}")
    if not all(math.isfinite(x) for x in st["losses"]):
        problems.append(f"gluon finetune: non-finite loss {st['losses']}")
    res["mlp"] = gluon_mlp(dev, problems, card)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[gluon] {res['seconds']:.1f} s, fine-tune "
          f"{st['step_ms']:.2f} ms a step ({card})", flush=True)
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# phase gluon_gpt: the Gluon calls of examples/gpt_generation.py and
# examples/serve_gpt.py on the port's GPT blocks
# ---------------------------------------------------------------------------

GGPT_V, GGPT_SEQ, GGPT_STEPS, GGPT_LR = 64, 24, 120, 3e-3   # the example's
GGPT_CONFIGS = (("classic", {}),
                ("modern", dict(rope=True, num_kv_heads=2, window=8)))
GGPT_ACCURACY = 0.6              # the example's own assertion
GGPT_B, GGPT_L, GGPT_FULL_LR = 8, 1024, 1e-4     # GPT-2 small's runs
GGPT_NEW = 16                    # generated tokens, from 2 prompts of 4
GGPT_SERVE = dict(max_slots=2, page_size=4, num_pages=6, prefill_chunk=4,
                  max_len=20)    # examples/serve_gpt.py's pool
GGPT_SERVE_LENS, GGPT_SERVE_NEW, GGPT_SERVE_SEED = (3, 9, 5, 12, 2, 7), 8, 11


def grammar_batch(rng, batch, seq, vocab):
    """`examples/gpt_generation.py`'s ``synthetic_batch``: the Markov
    grammar next = cur * 3 + 1 (mod V) with p 0.9, else a random token."""
    import numpy as np
    ids = np.empty((batch, seq), np.int64)
    ids[:, 0] = rng.randint(0, vocab, batch)
    for t in range(1, seq):
        follow = (ids[:, t - 1] * 3 + 1) % vocab
        noise = rng.randint(0, vocab, batch)
        ids[:, t] = np.where(rng.rand(batch) < 0.9, follow, noise)
    return ids.astype(np.int32)


def rule_accuracy(tokens, vocab):
    """`examples/gpt_generation.py`'s share of generated transitions that
    follow the grammar."""
    import numpy as np
    t = np.asarray(tokens)
    return float((t[:, 1:] == (t[:, :-1] * 3 + 1) % vocab).mean())


def gluon_gpt_train(model, dev, steps, rng, batch, seq, lr, plain=False,
                    step1=False, raw=False):
    """The example's ``train`` on the card, as written: `gluon.Trainer(
    model.collect_params(), "adam")`, ``hybridize()``, ``mx.np.array``
    batches, the forward and the mean `SoftmaxCrossEntropyLoss` over the
    shifted logits inside ``autograd.record()``, ``loss.backward()``,
    ``trainer.step(1)``, on `steps` grammar batches drawn from `rng` (a
    numpy ``RandomState``).  ``plain=True`` is the twin (`_plain_twin`
    applied by the caller): the loss's and the update's plain versions.
    ``raw=True`` runs the same loop on torch tensors in place of the
    arrays.  `step1` keeps the weights before step 1, its gradients, and
    the weights and state after it (`gpt_step1_check`).  Returns (losses,
    launches, seconds a step over steps 3.., step-1 record)."""
    import functools
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, kernels
    from mxnet_tpu_torch.ndarray.ndarray import apply
    from mxnet_tpu_torch.ops.softmax_xent import \
        softmax_cross_entropy_reference
    V = model.cfg.vocab_size
    trainer = gluon.Trainer(model.collect_params(), "adam",
                            {"learning_rate": lr})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    if plain:
        loss_fn = functools.partial(apply, softmax_cross_entropy_reference)
    model.hybridize()
    params = model.collect_params()
    make = (lambda a: torch.from_numpy(a).to(dev)) if raw else mx.np.array
    batches = [make(grammar_batch(rng, batch, seq, V))
               for _ in range(steps)]
    losses, rec = [], None
    host = lambda t: t.detach().to("cpu", copy=True)      # noqa: E731
    before = {n: host(p.data()) for n, p in params.items()} \
        if step1 else None
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_trainer_update() if plain else contextlib.nullcontext():
        for i, ids in enumerate(batches):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with autograd.record():
                logits = model(ids)
                loss = loss_fn(logits[:, :-1].reshape(-1, V),
                               ids[:, 1:].reshape(-1)).mean()
            loss.backward()
            if step1 and i == 0:
                rec = [before, None, None,
                       {n: host(p.data().grad) for n, p in params.items()}]
            trainer.step(1)
            if step1 and i == 0:
                rec[1] = {n: host(p.data()) for n, p in params.items()}
                rec[2] = {n: tuple(host(t) for t in trainer._states[n])
                          for n in params}
            losses.append(loss.detach())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / max(1, steps - 2)
    return [float(x) for x in losses], kernels.launch_counts(), step_s, rec


def gluon_gpt_example(dev, name, extra, rng, problems, card):
    """Part (a): `examples/gpt_generation.py`'s run, as written, for one
    of its two configurations: ``GPTForCausalLM(cfg)`` on the card,
    ``initialize()``, the first call, 120 steps of its loop, then greedy
    (held to its rule-accuracy assertion), sampled and beam decodes;
    `rng` is the example's one ``RandomState(0)``, shared by both."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=GGPT_V, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128, max_position=64,
                    dropout=0.0, **extra)
    model = GPTForCausalLM(cfg)
    model.initialize()
    prompt = mx.np.array(grammar_batch(rng, 2, 4, GGPT_V))
    model(prompt)
    t0 = time.perf_counter()
    losses, launches, step_s, _ = gluon_gpt_train(
        model, dev, GGPT_STEPS, rng, 8, GGPT_SEQ, GGPT_LR)
    train_s = time.perf_counter() - t0
    plen = prompt.shape[1]
    greedy = model.generate(prompt, max_new_tokens=GGPT_NEW).asnumpy()
    acc = rule_accuracy(greedy[:, plen - 1:], GGPT_V)
    sampled = model.generate(prompt, max_new_tokens=GGPT_NEW, greedy=False,
                             temperature=0.8, top_k=8, top_p=0.95)
    beam = model.generate(prompt, max_new_tokens=GGPT_NEW, num_beams=4,
                          eos_token_id=GGPT_V - 1)
    st = dict(losses=losses[::20] + losses[-1:], train_s=train_s,
              step_ms=step_s * 1e3, launches=launches,
              rule_accuracy=acc, greedy=greedy[0].tolist(),
              sampled=sampled.asnumpy()[0].tolist(),
              beam=beam.asnumpy()[0].tolist())
    print(f"[gluon_gpt {name}] {json.dumps(st)} ({card})", flush=True)
    if not acc > GGPT_ACCURACY:
        problems.append(f"gluon_gpt {name}: greedy decode did not learn "
                        f"the grammar ({acc} <= {GGPT_ACCURACY})")
    for k in ("flash_attention_fwd", "flash_attention_bwd", "fused_norm",
              "softmax_xent_fwd", "fused_optimizer_chunk"):
        if not launches.get(k):
            problems.append(f"gluon_gpt {name}: {k} never launched "
                            f"({launches})")
    return st


def gluon_gpt_want(layers):
    """Launches a step of the full-width bf16 `Trainer` run, the gpt
    phase's bf16 `Trainer` run's: flash 12 + 12, the norm 25 (12 of them
    with the residual), the cross-entropy 1 + 1, the chunk twice (the bf16
    leaves and the f32 LayerNorm group)."""
    return {k: v // TRAIN_STEPS for k, v in
            gpt_want_launches(2, layers, False).items()}


def gluon_gpt_full(dev, results, problems, card):
    """Part (b): GPT-2 small (124 M parameters, bf16, dropout 0.1, no
    cut) built and trained as the example builds and trains its model,
    with Adam at `GGPT_FULL_LR` over `TRAIN_STEPS` grammar batches of
    8 x 1024, against its plain twin (`_plain_twin`, the plain loss, the
    kernels' plain update) from the same seed and batches; then greedy
    and 4-beam `generate`, and the `save_parameters` / `load_parameters`
    round trip into a fresh model.  Returns the trained model."""
    import tempfile
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random as mrandom
    from mxnet_tpu_torch.models import GPTForCausalLM, gpt_small
    from mxnet_tpu_torch.models.layers import _plain_twin
    from mxnet_tpu_torch.optimizer import Adam

    res = results["gluon_gpt"]
    cfg = gpt_small(dropout=0.1, dtype="bfloat16")
    layers = cfg.num_layers
    runs = {}
    # the arrays' run, its plain twin, then the arrays' run again on raw
    # tensors (the loop before the array front end), same seed and batches
    for key, plain, raw in (("array", False, False), ("plain", True, False),
                            ("raw", False, True)):
        torch.cuda.empty_cache()
        mrandom.seed(0)
        model = GPTForCausalLM(cfg)
        model.initialize()
        if plain:
            _plain_twin(model)
        prompt = mx.np.array(grammar_batch(
            np.random.RandomState(1), 2, 4, cfg.vocab_size))
        model(prompt)
        with pallas_mode("auto"):
            runs[key] = (model, prompt) + gluon_gpt_train(
                model, dev, TRAIN_STEPS, np.random.RandomState(2), GGPT_B,
                GGPT_L, GGPT_FULL_LR, plain=plain, step1=not raw, raw=raw)
        if raw:
            del model
            runs["raw"] = runs["raw"][2:]
    (model, prompt, losses, launches, step_s, rec) = runs["array"]
    (twin, _, plosses, plaunches, pstep_s, prec) = runs["plain"]
    rlosses, rlaunches, rstep_s, _ = runs["raw"]
    floor = results["gpt_one_ulp"].get("bfloat16", {}).get(
        "trajectory_rel_dev")
    if floor is None:
        raise AssertionError("gluon_gpt: the gpt phase's bf16 one-ulp floor "
                             "is missing (that phase failed first)")
    tol = gpt_tol("bfloat16", floor)
    dev_rel = traj_dev(losses, plosses)
    want = {k: v * TRAIN_STEPS for k, v in gluon_gpt_want(layers).items()}
    got = {k: launches.get(k, 0) for k in want}
    others = {k: v for k, v in launches.items() if k not in want and v}
    hp = {"lr": GGPT_FULL_LR, "wd": 0.0, "rescale_grad": 1.0, "t": 1.0}
    chk = gpt_step1_check(rec, prec, dev, layers,
                          Adam(learning_rate=GGPT_FULL_LR), hp, "bfloat16")
    tokens = GGPT_B * (GGPT_L - 1)
    raw_diff = max(abs(a - b) for a, b in zip(losses, rlosses))
    raw_dev = traj_dev(losses, rlosses)
    st = dict(losses=losses, plain_losses=plosses, trajectory_rel_dev=dev_rel,
              trajectory_tol=tol, one_ulp_floor=floor, step_ms=step_s * 1e3,
              plain_step_ms=pstep_s * 1e3, tokens_per_s=tokens / step_s,
              raw_losses=rlosses, raw_step_ms=rstep_s * 1e3,
              raw_max_loss_diff=raw_diff, raw_trajectory_rel_dev=raw_dev,
              raw_bit_equal=losses == rlosses, raw_launches=rlaunches,
              launches=launches, launches_per_step=gluon_gpt_want(layers),
              step1_check=chk,
              parameters=sum(p.data().numel()
                             for p in model.collect_params().values()))
    if got != want or others:
        problems.append(f"gluon_gpt full: launches {got} (and {others}), "
                        f"want {want} over {TRAIN_STEPS} steps")
    if any(plaunches.values()):
        problems.append(f"gluon_gpt full: the plain twin launched "
                        f"{plaunches}")
    if not all(math.isfinite(x) for x in losses) or dev_rel > tol:
        problems.append(f"gluon_gpt full: loss trajectory departs from the "
                        f"twin's by {dev_rel:.3g} > {tol:.3g} ({losses} vs "
                        f"{plosses})")
    if not chk["ok"]:
        problems.append(f"gluon_gpt full: step 1 off the twin's: "
                        f"{json.dumps(chk)}")
    if not losses[-1] < losses[0]:
        problems.append(f"gluon_gpt full: loss did not fall {losses}")
    print(f"[gluon_gpt full] arrays against raw tensors: largest loss "
          f"difference {raw_diff:.3g}, bit-equal {losses == rlosses}, "
          f"trajectory {raw_dev:.3g} (limit {tol:.3g}); {step_s * 1e3:.2f} "
          f"against {rstep_s * 1e3:.2f} ms a step ({card})", flush=True)
    # the two runs share every kernel, seed and batch: bit-equal losses
    if raw_dev > tol or rlaunches != launches or losses != rlosses:
        problems.append(f"gluon_gpt full: the arrays' run departs from the "
                        f"raw tensors' by {raw_dev:.3g} (limit {tol:.3g}, "
                        f"bit-equal {losses == rlosses}) or launched "
                        f"{launches} against {rlaunches}")

    # the round trip: a fresh model, initialize(), load_parameters
    fd, ckpt = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        model.save_parameters(ckpt)
        fresh = GPTForCausalLM(cfg, seed=1)
        fresh.initialize()
        fresh.load_parameters(ckpt)
        twin.load_parameters(ckpt)
    finally:
        os.remove(ckpt)
    st["round_trip_bit_equal"] = bool(mx.np.array_equal(model(prompt),
                                                       fresh(prompt)))
    del fresh
    if not st["round_trip_bit_equal"]:
        problems.append("gluon_gpt full: logits after save_parameters / "
                        "load_parameters are not bit-equal")
    # decodes over the trained weights, the twin holding the same ones
    gen = {}
    for key, kw in (("greedy", {}),
                    ("beam", dict(num_beams=4, eos_token_id=GGPT_V - 1))):
        a = model.generate(prompt, max_new_tokens=GGPT_NEW, **kw).tolist()
        b = twin.generate(prompt, max_new_tokens=GGPT_NEW, **kw).tolist()
        gen[key] = a
        if a != b:
            problems.append(f"gluon_gpt full {key}: {a} vs the twin's {b}")
    gen["sampled"] = model.generate(
        prompt, max_new_tokens=GGPT_NEW, greedy=False, temperature=0.8,
        top_k=8, top_p=0.95).tolist()
    st["generate"] = gen
    del twin, runs
    torch.cuda.empty_cache()
    res["full"] = st
    print(f"[gluon_gpt full] {json.dumps(st)} ({card})", flush=True)
    print(f"[gluon_gpt full] {st['step_ms']:.2f} ms a step "
          f"({st['tokens_per_s']:.0f} tokens/s), the twin "
          f"{st['plain_step_ms']:.2f} ms; trajectory vs twin {dev_rel:.3g} "
          f"(limit {tol:.3g}) ({card})", flush=True)
    return model


def gluon_gpt_serve(dev, model, results, problems, card):
    """Part (c): `examples/serve_gpt.py`'s engine over the trained Block:
    its pool (5 allocatable pages of 4, so two overlapping decodes must
    evict), its six prompts (seed 11), 8 new tokens each; every stream
    equal to an unbatched greedy `generate` of the same Block (a stream
    may part only at a near tie of the plain path, `compare_streams`), at
    least one eviction, and K1 once a layer a fused step.  The example's
    telemetry snapshot waits for A14 part 2: the port's scheduler
    telemetry is not ported and raises by name."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig
    from mxnet_tpu_torch.serve.decode import extract_decode_weights

    cfg = model.cfg
    rng = np.random.RandomState(GGPT_SERVE_SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in GGPT_SERVE_LENS]
    refs = [model.generate(mx.np.array([p], dtype="int32"),
                           max_new_tokens=GGPT_SERVE_NEW)[0].tolist()
            for p in prompts]
    eng = InferenceEngine(model, ServeConfig(**GGPT_SERVE))
    warm_s = eng.warmup()
    streams = {i: [] for i in range(len(prompts))}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=GGPT_SERVE_NEW,
                          on_token=lambda t, r, i=i: streams[i].append(t))
               for i, p in enumerate(prompts)]
    steps = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = [h.result(timeout=0) for h in handles]
    launches = kernels.launch_counts()
    near = compare_streams(got, refs, extract_decode_weights(model), cfg,
                           "gluon_gpt serve")
    evictions = sum(h.evictions for h in handles)
    st = dict(steps=steps, wall_s=wall, warmup_s=warm_s,
              evictions=evictions, near_ties=near, launches=launches,
              streams=got)
    results["gluon_gpt"]["serve"] = st
    print(f"[gluon_gpt serve] {json.dumps(st)} ({card})", flush=True)
    if evictions < 1:
        problems.append("gluon_gpt serve: page pressure forced no eviction")
    for i, (h, s) in enumerate(zip(got, streams.values())):
        if s != h[len(prompts[i]):]:
            problems.append(f"gluon_gpt serve: request {i}'s streamed tokens "
                            f"{s} differ from its result {h}")
    k1 = launches.get("ragged_paged_attention", 0)
    if k1 != cfg.num_layers * steps:
        problems.append(f"gluon_gpt serve: K1 launched {k1} times over "
                        f"{steps} steps, want {cfg.num_layers} a step")


def run_gluon_gpt(dev, results, card):
    """The gluon_gpt phase: (a) `examples/gpt_generation.py` at its own
    size, both configurations; (b) GPT-2 small at full width through the
    same Gluon calls, against its plain twin; (c) `examples/serve_gpt.py`'s
    engine over the trained Block.  Each runs the examples' ``mx.np`` code
    as written (arrays in, ``loss.backward()``, ``.asnumpy()`` reads)."""
    import numpy as np
    from mxnet_tpu_torch import random as mrandom
    res = results["gluon_gpt"]
    problems = []
    t0 = time.perf_counter()
    mrandom.seed(0)
    rng = np.random.RandomState(0)
    res["example"] = {name: gluon_gpt_example(dev, name, extra, rng,
                                              problems, card)
                      for name, extra in GGPT_CONFIGS}
    model = gluon_gpt_full(dev, results, problems, card)
    gluon_gpt_serve(dev, model, results, problems, card)
    res["seconds"] = time.perf_counter() - t0
    print(f"[gluon_gpt] {res['seconds']:.1f} s ({card})", flush=True)
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# phase np: the tensor front end (mx.np, mx.npx) on the card
# ---------------------------------------------------------------------------

NP_ROWS, NP_H = (8, 1024), 768          # GPT-2 small's activations
NP_XENT = (8192, 50257)                 # the gpt phase's logits
NP_GQA = dict(num_kv_heads=3, window=256, rope_theta=10000.0)  # gpt_gqa's
NP_MLP = (64, 768, 3072, 10)            # batch, in, hidden, classes
NP_MLP_STEPS, NP_MLP_LR = 20, 0.05
NP_HOST_CALLS = 1000


def np_kernel_cases(dev):
    """The kernel-routed ``npx`` ops at GPT-2 small's widths, forward and
    backward through ``attach_grad`` / ``record`` / ``backward``, each
    against its plain version on the same inputs (tensors, the plain
    function by name, ``torch.autograd.grad``): ``(name, dtype, npx call,
    plain call, arrays, launches one forward and backward must make)``."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_norm as fn
    from mxnet_tpu_torch.ops.attention import multi_head_attention_reference
    from mxnet_tpu_torch.ops.softmax_xent import \
        softmax_cross_entropy_reference
    npx = mx.npx
    g = torch.Generator().manual_seed(25)
    norm, xent = {"fused_norm": 1}, {"softmax_xent_fwd": 1,
                                     "softmax_xent_bwd": 1}
    flash = {"flash_attention_fwd": 1, "flash_attention_bwd": 1}

    def rnd(*shape, dtype="float32", scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(
            dev, getattr(torch, dtype))

    out = []
    for dt in ("float32", "bfloat16"):
        x = rnd(*NP_ROWS, NP_H, dtype=dt)
        r = rnd(*NP_ROWS, NP_H, dtype=dt)
        gam = 1 + rnd(NP_H, scale=0.1)
        bet = rnd(NP_H, scale=0.1)
        out.append(("layer_norm", dt,
                    lambda a, b, c: npx.layer_norm(a, b, c),
                    fn.fused_layer_norm_reference, (x, gam, bet), norm))
        out.append(("layer_norm_residual", dt,
                    lambda a, b, c, d: npx.layer_norm_residual(a, b, c, d),
                    fn.fused_layer_norm_residual_reference,
                    (x, r, gam, bet), norm))
        out.append(("rms_norm", dt, lambda a, b: npx.rms_norm(a, b),
                    fn.fused_rms_norm_reference, (x, gam), norm))
        logits = rnd(*NP_XENT, dtype=dt, scale=2.0)
        labels = torch.randint(0, NP_XENT[1], (NP_XENT[0],),
                               generator=g).to(dev, torch.int32)
        out.append(("softmax_cross_entropy", dt,
                    lambda a, b: npx.softmax_cross_entropy(a, b),
                    softmax_cross_entropy_reference, (logits, labels), xent))
        q, k, v = (rnd(*NP_ROWS, NP_H, dtype=dt) for _ in range(3))
        out.append(("multi_head_attention", dt,
                    lambda a, b, c: npx.multi_head_attention(
                        a, b, c, 12, causal=True),
                    lambda a, b, c: multi_head_attention_reference(
                        a, b, c, 12, causal=True, training=True),
                    (q, k, v), flash))
        kv = NP_GQA["num_kv_heads"] * NP_H // 12
        kg, vg = rnd(*NP_ROWS, kv, dtype=dt), rnd(*NP_ROWS, kv, dtype=dt)
        out.append(("gqa_attention", dt,
                    lambda a, b, c: npx.multi_head_attention(
                        a, b, c, 12, causal=True, **NP_GQA),
                    lambda a, b, c: multi_head_attention_reference(
                        a, b, c, 12, causal=True, training=True, **NP_GQA),
                    (q, kg, vg), flash))
    return out


def _np_case(dev, name, dt, npx_fn, plain_fn, args, want):
    """One `np_kernel_cases` entry: the arrays' forward and backward (the
    head a seeded weighting of every output), its launches, and each
    output and gradient against the plain version's."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, kernels
    g = torch.Generator(device=dev).manual_seed(7)
    arrs = [mx.np.asarray(a.clone()) for a in args]
    for a in arrs:
        if a._data.is_floating_point():
            a.attach_grad()
    kernels.reset_launch_counts()
    with autograd.record():
        outs = npx_fn(*arrs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        ws = [mx.np.asarray(torch.rand(o.shape, generator=g, device=dev,
                                       dtype=o._data.dtype)) for o in outs]
        head = sum((o * w).sum() for o, w in zip(outs, ws))
    head.backward()
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.launch_counts().items() if v}
    leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    pouts = plain_fn(*leaves)
    pouts = pouts if isinstance(pouts, tuple) else (pouts,)
    phead = sum((o * w._data).sum() for o, w in zip(pouts, ws))
    diff = [t for t in leaves if t.requires_grad]
    pgrads = torch.autograd.grad(phead, diff)
    errs = []
    for o, po in zip(outs, pouts):
        errs.append(_scale_err(o._data, po.detach()))
    grads = [a.grad._data for a in arrs if a._data.is_floating_point()]
    for gr, pg in zip(grads, pgrads):
        errs.append(_scale_err(gr, pg))
    tol = TOL[dt]
    worst = max(e / max(s, 1e-30) for e, s in errs)
    c = dict(case=name, dtype=dt, launches=got, want=want,
             max_rel_err=worst, tol=tol,
             max_abs_err=max(e for e, _ in errs),
             ok=got == want and worst <= tol)
    return c


def np_mlp(dev, arrays):
    """A two-layer MLP (768 -> 3072 -> 10) written in ``mx.np`` alone:
    ``np.dot``, ``np.maximum``, ``npx.log_softmax``, ``npx.pick``, 20 steps
    of hand-written SGD over ``w.grad`` (``arrays=True``); or the same
    program on raw tensors.  Returns the losses and the final weights."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    B, D, H, C = NP_MLP
    rng = np.random.RandomState(31)
    init = [rng.randn(D, H).astype(np.float32) * 0.03,
            np.zeros(H, np.float32),
            rng.randn(H, C).astype(np.float32) * 0.03,
            np.zeros(C, np.float32)]
    data = [(rng.randn(B, D).astype(np.float32),
             rng.randint(0, C, B).astype(np.int32))
            for _ in range(NP_MLP_STEPS)]
    losses = []
    if arrays:
        npx = mx.npx
        params = [mx.np.array(p) for p in init]
        for p in params:
            p.attach_grad()
        for xb, yb in data:
            x, y = mx.np.array(xb), mx.np.array(yb)
            with autograd.record():
                h = mx.np.maximum(mx.np.dot(x, params[0]) + params[1], 0)
                logp = npx.log_softmax(mx.np.dot(h, params[2]) + params[3])
                loss = -npx.pick(logp, y).mean()
            loss.backward()
            for p in params:
                p[:] = p - NP_MLP_LR * p.grad
            losses.append(float(loss))
        return losses, [p._data for p in params]
    params = [torch.from_numpy(p).to(dev).requires_grad_() for p in init]
    for xb, yb in data:
        x = torch.from_numpy(xb).to(dev)
        y = torch.from_numpy(yb).to(dev)
        h = torch.maximum(x @ params[0] + params[1], torch.tensor(0.0,
                                                                device=dev))
        logp = torch.log_softmax(h @ params[2] + params[3], dim=-1)
        loss = -torch.gather(logp, -1, y.long()[:, None])[:, 0].mean()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, gr in zip(params, grads):
                p.sub_(NP_MLP_LR * gr)
        losses.append(float(loss))
    return losses, [p.detach() for p in params]


def np_host_cost(dev):
    """Mean host µs of one ``mx.np`` binary op (``a + b`` and ``np.add``)
    against the bare torch op on the same tensors, over the same
    `NP_HOST_CALLS` calls, enqueued behind a device sleep."""
    import torch
    import mxnet_tpu_torch as mx
    ta = torch.randn(1024, device=dev)
    tb = torch.randn(1024, device=dev)
    a, b = mx.np.asarray(ta), mx.np.asarray(tb)
    out = {}
    for key, fn in (("torch", lambda: ta + tb), ("np_operator", lambda: a + b),
                    ("np_add", lambda: mx.np.add(a, b)),
                    ("torch_again", lambda: ta + tb)):
        out[key + "_us"] = host_us(fn, iters=NP_HOST_CALLS)
    out["facade_us"] = out["np_operator_us"] - min(out["torch_us"],
                                                   out["torch_again_us"])
    return out


def run_np(dev, results, card):
    """The np phase: the kernel-routed ``npx`` ops at GPT-2 small's widths
    through arrays, each against its plain version with its launches
    exact; an MLP written in ``mx.np`` alone against the same program on
    raw tensors; the front end's host cost an op."""
    import torch
    res = results["np"]
    problems = []
    t0 = time.perf_counter()
    res["cases"] = []
    for case in np_kernel_cases(dev):
        c = _np_case(dev, *case)
        res["cases"].append(c)
        print(f"[np case] {json.dumps(c)} ({card})", flush=True)
        if not c["ok"]:
            problems.append(f"np {c['case']} {c['dtype']}: launches "
                            f"{c['launches']} (want {c['want']}), "
                            f"{c['max_rel_err']:.3g} off the plain version "
                            f"(limit {c['tol']})")
        torch.cuda.empty_cache()
    losses, weights = np_mlp(dev, arrays=True)
    plosses, pweights = np_mlp(dev, arrays=False)
    wdev = max(float((a - b).norm() / b.norm()) for a, b in
               zip(weights, pweights))
    st = dict(losses=losses, raw_losses=plosses,
              trajectory_rel_dev=traj_dev(losses, plosses),
              weights_rel_dev=wdev, tol=TOL["float32"],
              bit_equal=losses == plosses)
    res["mlp"] = st
    print(f"[np mlp] {json.dumps(st)} ({card})", flush=True)
    if st["trajectory_rel_dev"] > TOL["float32"] or wdev > TOL["float32"] \
            or not losses[-1] < losses[0]:
        problems.append(f"np mlp: {st['trajectory_rel_dev']:.3g} (losses), "
                        f"{wdev:.3g} (weights) off the raw tensors' run, "
                        f"limit {TOL['float32']}; losses {losses}")
    res["host"] = np_host_cost(dev)
    print(f"[np host] {json.dumps(res['host'])} ({card})", flush=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"[np] {res['seconds']:.1f} s ({card})", flush=True)
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# phase elastic: examples/bert_pretraining.py's loop under the operations
# plane (health probes, the on-device skip, checkpoints, ElasticLoop)
# ---------------------------------------------------------------------------

ELASTIC_STEPS = 12
ELASTIC_NAN_STEP = 5      # 1-based: the loss is multiplied by NaN here
ELASTIC_STOP_STEP = 7     # a real SIGTERM to this process after this step
ELASTIC_FAIL_STEP = 9     # 1-based: the injected failure (resumed run)
ELASTIC_SAVE_EVERY = 4
ELASTIC_KEEP = 2
ELASTIC_SHAPE = (8, 128, 20)     # batch, sequence, masked positions


def elastic_data(dev, vocab):
    """The reference run's 12 batches (ids, masked positions, labels,
    flag), made from seeds on the host and moved to the card once; the
    flag is NaN at `ELASTIC_NAN_STEP`."""
    import numpy as np
    import torch
    B, S, M = ELASTIC_SHAPE
    out = []
    for i in range(ELASTIC_STEPS):
        ids, _, mpos, lab = bert_batch(vocab, B, S, M, seed=100 + i)
        flag = np.array([np.nan if i + 1 == ELASTIC_NAN_STEP else 1.0],
                        np.float32)
        out.append(tuple(torch.from_numpy(a).to(dev)
                         for a in (ids, mpos, lab, flag)))
    return out


def elastic_step(dev):
    """``examples/bert_pretraining.py``'s step on the port: its positional
    adapter ``PretrainNet(ids, masked_positions)`` over
    ``BertForPretraining(bert_base(dtype="bfloat16"))`` (full width and
    depth, seed 0, dropout 0.1 from the model's seeded generator), Adam lr
    1e-4 through `make_train_step` (dp 1), the MLM cross-entropy (the
    kernel) times the batch's flag; built under ``MXTPU_PALLAS=auto``."""
    import torch
    from mxnet_tpu_torch.models import BertForPretraining, bert_base
    from mxnet_tpu_torch.ops.softmax_xent import softmax_cross_entropy
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import make_train_step
    cfg = bert_base(dtype="bfloat16")

    class PretrainNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = BertForPretraining(cfg, device=dev, seed=0)

        def forward(self, ids, mpos):
            return self.model(ids, masked_positions=mpos)

    def loss_fn(out, ids, mpos, lab, flag):
        return softmax_cross_entropy(out[0], lab).mean() * flag[0]

    with pallas_mode("auto"):
        return make_train_step(PretrainNet(), Adam(learning_rate=1e-4),
                               loss_fn, num_model_args=2), cfg


def _train_state(step):
    """Device copies of every weight and optimizer state tensor."""
    out = {"p:" + n: p.detach().clone() for n, p in step.params.items()}
    for n in step.diff_names:
        for i, s in enumerate(step.opt_state[n]):
            out[f"s:{n}:{i}"] = s.clone()
    return out


def _differ(a, b):
    """Names whose tensors are not bit-equal."""
    import torch
    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def _device_kernels(fn):
    """CUDA kernels `fn` launched, by ``torch.profiler`` (None when the
    profiler sees no device activity)."""
    import torch
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
        return n or None
    except Exception:
        return None


def _timed_steps(step, data):
    """The 12 steps, host clock over steps 3-12 ending in a sync; returns
    (ms a step, handles)."""
    import torch
    hs = []
    for i, b in enumerate(data):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        hs.append(step.dispatch(*b))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (len(data) - 2), hs


def run_elastic(dev, results, card):
    """Phase elastic (``examples/bert_pretraining.py:95-124`` on the
    port): the plane's cost (the step with it off and on, in turns), the
    reference run R twice from the same seed, then R under `ElasticLoop`
    stopped by a real SIGTERM after step 7 (tier-1 skip at step 5) and
    resumed by a fresh step and loop that meet an injected failure at step
    9 (restore from step 8), and a corrupted checkpoint quarantined.
    Health and recovery are switched on with `health.enable` /
    `recovery.enable` (the programmatic form of ``MXTPU_HEALTH=1`` /
    ``MXTPU_RECOVERY=1``, which act at import) and off again at the end."""
    import signal
    import tempfile
    import torch
    from mxnet_tpu_torch import elastic, health, kernels, recovery
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.utils import CheckpointManager

    out = results["elastic"]
    root = tempfile.mkdtemp(prefix="mxtpu_elastic_")
    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)
            print(f"[elastic] FAILED: {what}", flush=True)

    try:
        data = elastic_data(dev, 30522)

        # -- the plane's cost: a step built with it off, one with it on,
        # timed in turns (off, on, on, off); the first "on" run is R --------
        off, cfg = elastic_step(dev)
        off.warmup(*data[0])
        health.enable(crash_dir=os.path.join(root, "crash"))
        recovery.enable()
        # the run journal: each checkpoint write's ms, sync or async
        journal = os.path.join(root, "journal.jsonl")
        telemetry.enable(journal_path=journal)
        on, _ = elastic_step(dev)
        check(on._health_probes and on._skip_nonfinite and
              not off._health_probes, "the steps' planes")
        on.warmup(*data[0])
        off_ms = [_timed_steps(off, data)[0]]
        kernels.reset_launch_counts()
        on_ms, hs = _timed_steps(on, data)
        r_launch = kernels.launch_counts()
        ref = _train_state(on)
        probes = [(h.step, float(h.probes["grad_norm"]),
                   float(h.probes["nonfinite"])) for h in hs]
        on_ms = [on_ms, _timed_steps(on, data)[0]]
        off_ms.append(_timed_steps(off, data)[0])
        off_k = _device_kernels(lambda: off.dispatch(*data[0]))
        on_k = _device_kernels(lambda: on.dispatch(*data[0]))
        cost = on.cost_features() or {}
        mean_on, mean_off = sum(on_ms) / 2, sum(off_ms) / 2
        mfu = on.mfu_estimate(mean_on / 1e3) or {}
        B, S, M = ELASTIC_SHAPE
        bench = bench_flops_per_step(cfg, B, S, M)
        n_params = sum(p.numel() for p in on.params.values())
        del on, off, hs
        torch.cuda.empty_cache()
        check(probes[ELASTIC_NAN_STEP - 1][2] > 0 and all(
            p[2] == 0 for p in probes if p[0] != ELASTIC_NAN_STEP),
            f"the probes' non-finite counts {probes}")
        cost_row = dict(
            step_ms_plane_on=on_ms, step_ms_plane_off=off_ms,
            plane_cost_ms=mean_on - mean_off,
            kernels_a_step_on=on_k, kernels_a_step_off=off_k,
            probe_kernels_a_step=(None if on_k is None or off_k is None
                                  else on_k - off_k),
            params=n_params, flops_per_step=cost.get("flops"),
            torch_flops=cost.get("torch_flops"),
            kernel_flops=cost.get("kernel_flops"),
            bench_flops_per_step=bench,
            flops_over_bench=(cost.get("flops") or 0) / bench,
            mfu_estimate=mfu.get("mfu_estimate"),
            mfu_peak=mfu.get("peak_flops"), mfu_projected=mfu.get("projected"),
            r_launches=r_launch, probes=probes)
        out["cost"] = cost_row
        print(f"[elastic cost] {json.dumps(cost_row)}", flush=True)
        print(f"[elastic] {card}: step {on_ms} ms with the plane on, "
              f"{off_ms} ms off (host clock, steps 3-12; off, on, on, off); "
              f"{cost_row['probe_kernels_a_step']} more CUDA kernels a step",
              flush=True)
        print(f"[elastic] {card}: counted {cost.get('flops')} FLOPs a step "
              f"(torch {cost.get('torch_flops')}, kernels "
              f"{cost.get('kernel_flops')}) against bench.py's {bench}; "
              f"mfu_estimate {mfu.get('mfu_estimate')}", flush=True)

        # -- R again from the seed: bit-equal? --------------------------------
        step, _ = elastic_step(dev)
        for b in data:
            step.dispatch(*b)
        step.drain()
        again = _differ(_train_state(step), ref)
        out["determinism"] = dict(differ_from_r=len(again), names=again[:5])
        print(f"[elastic] {card}: R twice: {len(again)} tensors differ",
              flush=True)
        check(not again, f"R twice differs in {again[:5]}")
        del step
        torch.cuda.empty_cache()

        # -- R under ElasticLoop: tier 1 at 5, a real SIGTERM after 7 --------
        pdir = os.path.join(root, "preempt")
        step, _ = elastic_step(dev)
        tier1 = {}
        calls = []

        def time_save_async(step):        # the snapshot's time to return
            save_async = step.save_async

            def timed(path):
                t0 = time.perf_counter()
                fut = save_async(path)
                calls.append((time.perf_counter() - t0) * 1e3)
                return fut
            step.save_async = timed

        time_save_async(step)

        def run_step(i):
            if i + 1 != ELASTIC_NAN_STEP:
                return step.dispatch(*data[i]).loss
            before = _train_state(step)
            torch.cuda.set_sync_debug_mode("error")   # no host sync
            try:
                h = step.dispatch(*data[i])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            tier1.update(nonfinite=float(h.probes["nonfinite"]),
                         changed=_differ(before, _train_state(step)))
            return h.loss

        def on_step(i, _loss):
            if i == ELASTIC_STOP_STEP:
                os.kill(os.getpid(), signal.SIGTERM)

        kernels.reset_launch_counts()
        loop = elastic.ElasticLoop(step, pdir, save_every=ELASTIC_SAVE_EVERY,
                                   keep=ELASTIC_KEEP, async_save=True,
                                   watchdog_timeout=300.0)
        res_p = loop.run(run_step, ELASTIC_STEPS, on_step=on_step)
        skips = loop.recovery.skips
        marker = recovery.read_resume_marker(pdir)
        del step, loop
        torch.cuda.empty_cache()

        # -- a fresh step and loop resume at 7; a failure at 9 ---------------
        step, _ = elastic_step(dev)       # as a restarted job builds it
        time_save_async(step)
        seen = []

        def resumed(i):
            seen.append(i)
            return step.dispatch(*data[i]).loss

        loop = elastic.ElasticLoop(
            step, pdir, save_every=ELASTIC_SAVE_EVERY, keep=ELASTIC_KEEP,
            async_save=True,
            failure_injector=elastic.FailureInjector([ELASTIC_FAIL_STEP - 1]))
        res_r = loop.run(resumed, ELASTIC_STEPS)
        launches = kernels.launch_counts()
        step.drain()
        resume_diff = _differ(_train_state(step), ref)
        row = dict(preempt_status=res_p["status"], preempt_step=res_p["step"],
                   preempt_checkpoint=os.path.basename(
                       res_p.get("checkpoint") or ""),
                   marker=marker, skips=skips,
                   tier1_nonfinite=tier1.get("nonfinite"),
                   tier1_changed=len(tier1.get("changed", ["?"])),
                   resume_status=res_r["status"], restores=res_r["restores"],
                   steps_run=seen, differ_from_r=len(resume_diff),
                   launches=launches,
                   on_disk=[s for s, _ in loop.manager.checkpoints()])
        out["runs"] = {"loop": row}
        print(f"[elastic loop] {json.dumps(row)}", flush=True)
        check(tier1.get("nonfinite", 0) > 0 and not tier1.get("changed"),
              f"tier 1: {tier1}")
        check(skips == 1, f"{skips} tier-1 skips")
        check(res_p["status"] == "preempted" and
              res_p["step"] == ELASTIC_STOP_STEP and marker is not None and
              marker.get("step") == ELASTIC_STOP_STEP and
              marker.get("complete"), f"preemption {res_p} {marker}")
        check(res_r["status"] == "completed" and res_r["restores"] == 1 and
              seen == list(range(ELASTIC_STOP_STEP, ELASTIC_STEPS)),
              f"resume {res_r} ran {seen}")
        check(not resume_diff, f"resumed run differs in {resume_diff[:5]}")
        # 12 steps dispatched in all, the chunk once per dtype group each
        check(launches["fused_optimizer_chunk"] == 2 * ELASTIC_STEPS,
              f"chunk launches {launches}")
        # the checkpoints' writes, from the journal (sync: the anchor, the
        # preemption's and the final save; async: the periodic ones)
        writes = [r for r in telemetry.RunJournal.read(journal)
                  if r["event"] == "checkpoint_write"]
        sync_w = [r["ms"] for r in writes if not r["async_save"]]
        async_w = [r["ms"] for r in writes if r["async_save"]]
        ckpt_bytes = os.path.getsize(loop.manager.latest()[1])
        save_row = dict(sync_save_ms=sync_w, async_save_ms=async_w,
                        async_save_call_ms=calls,
                        checkpoint_bytes=ckpt_bytes,
                        checkpoint_bytes_per_param=ckpt_bytes / n_params)
        out["cost"].update(save_row)
        print(f"[elastic saves] {json.dumps(save_row)}", flush=True)
        print(f"[elastic] {card}: saves sync {sync_w} ms, async {async_w} "
              f"ms in the writer ({calls} ms to return); {ckpt_bytes} bytes "
              f"a checkpoint ({ckpt_bytes / n_params:.3f} a parameter)",
              flush=True)

        # -- a corrupted newest checkpoint is quarantined --------------------
        mgr = CheckpointManager(pdir, keep=ELASTIC_KEEP)
        newest, path = mgr.latest()
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
        got = mgr.restore(step)
        row = dict(corrupted=newest, restored=got,
                   quarantined=os.path.exists(path + ".corrupt"))
        out["runs"]["corrupt"] = row
        print(f"[elastic corrupt] {json.dumps(row)}", flush=True)
        check(row["quarantined"] and got == ELASTIC_SAVE_EVERY * (
            newest // ELASTIC_SAVE_EVERY - 1),
            f"corruption: {row}")
        del step, loop
    finally:
        recovery.disable()
        health.disable()
        telemetry.disable()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    out["problems"] = problems
    if problems:
        raise AssertionError(f"elastic: {problems}")


def kernel_entries(results):
    """One entry per ported kernel for the ``kernels`` line: the
    representative main-path case (K1: f32 decode C=1 MHA, no window; K2:
    int8 f32 M=8 768->2304; flash: f32 with the padding bias and dropout
    0.1, as the BERT step calls it; cross-entropy: f32 (1280, 30522); the
    fused norm: bf16 LayerNorm at (8192, 768), the step's own; the chunk:
    Adam over the f32 BERT-base model at `OPTIM_LAYERS` layers; LAMB: the
    bf16 model, each phase's
    device time over all tensors, beside the plain LAMB update (both
    phases) and no library call) and the largest error over every case;
    the flash forward's entry also carries its bf16 case.
    The MoE gather: dispatch and combine at the slice's f32 shapes (8192
    tokens, 8 x 1280 slots, H 768), bf16 and f16 beside them; the gather
    and the cross-entropy forward also carry their host µs a call and
    launch plan.  Launches are the counts of the
    main-path runs (serving for K1/K2, the BERT, MoE and GPT training runs
    for the others); ``gpt_launches`` is the GPT phase's share,
    ``gpt_gqa_launches`` the gpt_gqa phase's, ``nmt_launches`` the nmt
    phase's training runs', ``elastic_launches`` the elastic phase's
    `ElasticLoop` run's, ``gluon_gpt_launches`` the gluon_gpt phase's
    (the example's two runs, GPT-2 small's `Trainer` run and the engine
    over it), and K1's ``spec_prefix_launches`` the
    spec_prefix phase's engine's.  The flash entries also carry k3's band
    and fold cases and the nmt phase's three attentions, the chunk GPT-2
    small's AdamW and transformer_base's Adam, cross-entropy and the norm
    their GPT and nmt shapes, K1 its verification width (C 5, MHA and GQA
    rep 4, a shared prefix).  The f16 instantiations of the flash and
    cross-entropy kernels have entries of their own (``..._f16``): BERT's
    padding with dropout and the MLM head's logits as representatives,
    GPT-2's shapes and the wide heads beside them, launches from the amp
    phase's fp16 runs (`kernels.DTYPE_LAUNCHES`)."""
    k1, k2, k3, k4, k5, k6, k7, k1q = (results[k] for k in (
        "k1", "k2", "k3", "k4", "k5", "k6", "k7", "k1_int8"))
    rep1 = next(c for c in k1 if c["dtype"] == "float32" and c["C"] == 1
                and c["Hkv"] == 12 and c["window"] is None and c["D"] == 64
                and c["pool_dtype"] == "float32")
    rep1m = next(c for c in k1 if c["pool_dtype"] != c["dtype"]
                 and c["C"] == 1)
    rep2 = next(c for c in k2 if c["bits"] == 8 and c["dtype"] == "float32"
                and c["M"] == 8 and c["N"] == 2304)
    rep3 = next(c for c in k3 if c["dtype"] == "float32"
                and c["case"] == "pad_dropout")
    rep3b = next(c for c in k3 if c["dtype"] == "bfloat16"
                 and c["case"] == "pad_dropout")
    rep4 = next(c for c in k4 if c["dtype"] == "float32" and c["V"] == 30522)
    # the GPT phase's shapes: causal flash at L 1024, cross-entropy at
    # (8192, 50257), each dtype
    gpt3 = {c["dtype"]: c for c in k3 if c["case"] == "gpt_causal_dropout"
            and c["dtype"] != "float16"}
    gpt4 = {c["dtype"]: c for c in k4 if c["N"] == 8192
            and c["dtype"] != "float16"}
    # the f16 cases (fp16 AMP's): BERT's padding with dropout and the MLM
    # head's logits as the representatives, GPT-2's shapes and the wide
    # heads beside them
    k3h = [c for c in k3 if c["dtype"] == "float16"]
    k4h = [c for c in k4 if c["dtype"] == "float16"]
    rep3h = next(c for c in k3h if c["case"] == "pad_dropout")
    rep4h = next(c for c in k4h if c["N"] == 1280)
    gpt3h = {c["dtype"]: c for c in k3h if c["case"] == "gpt_causal_dropout"}
    gpt4h = {c["dtype"]: c for c in k4h if c["N"] == 8192}
    nmt4 = {c["dtype"]: c for c in k4 if c["N"] == 3072}
    nmt5 = {c["dtype"]: c for c in k5 if c["rows"] == 4096
            and c["case"] == "ln"}
    rep5 = next(c for c in k5 if c["dtype"] == "bfloat16" and
                c["rows"] == 8192 and c["case"] == "ln")
    chunk = [c for c in k6 if c["rule"] != "lamb"
             and c["dtype"] != "float16"]
    lamb = [c for c in k6 if c["rule"] == "lamb" and c["dtype"] != "float16"]
    rep7 = next(c for c in chunk if c["dtype"] == "float32" and
                c["rule"] == "adam")
    rep8 = next(c for c in lamb if c["dtype"] == "bfloat16")
    rep_d = next(c for c in k7 if c["dtype"] == "float32" and
                 c["T"] == 8192 and c["op"] == "dispatch")
    rep_c = next(c for c in k7 if c["dtype"] == "float32" and
                 c["T"] == 8192 and c["op"] == "combine")
    e2e = results["e2e"]
    train = dict(results["train"], **results["moe"])
    train.update({"gpt_" + k: v for k, v in results["gpt"].items()})
    train.update({"gpt_gqa_" + k: v for k, v in results["gpt_gqa"].items()})
    train.update({"gpt_d256_" + k: v
                  for k, v in results["gpt_d256"].items()})
    nmt_runs = [results["nmt"][dt] for dt in ("float32", "bfloat16")
                if dt in results["nmt"]]
    train.update({f"nmt_{i}": r for i, r in enumerate(nmt_runs)})
    train.update({"optim_" + k: v for k, v in results["optim"].items()
                  if isinstance(v, dict) and "launches" in v
                  and not k.startswith("control_")})
    elastic_runs = {k: v for k, v in results["elastic"].get(
        "runs", {}).items() if "launches" in v}
    ggpt = results.get("gluon_gpt", {})
    gluon_gpt_runs = [r for r in list(ggpt.get("example", {}).values())
                      + [ggpt.get("full", {}), ggpt.get("serve", {})]
                      if "launches" in r]
    train.update({"elastic_" + k: v for k, v in elastic_runs.items()})
    k1_launch = e2e.get("float32", {}).get("launches", {}).get(
        "ragged_paged_attention", 0)
    k2_launch = sum(e2e.get(k, {}).get("launches", {}).get(
        "quantized_matmul", 0) for k in ("int8", "int4"))

    def train_launches(name):
        return sum(r["launches"][name] for r in train.values())

    def entry(name, src, replaces, launches, cases, rep, pre="", ms=None):
        mk = ms or pre + "ms"           # the kernel time's key; its bound's
        return {"name": name, "route": "cuda", "source": src,   # beside it
                "replaces": replaces, "launches": launches,
                "gpt_launches": sum(r["launches"].get(name, 0)
                                    for r in results["gpt"].values()),
                "gpt_gqa_launches": sum(r["launches"].get(name, 0)
                                        for r in results["gpt_gqa"].values()),
                "gpt_d256_launches": sum(
                    r["launches"].get(name, 0)
                    for r in results["gpt_d256"].values()),
                "nmt_launches": sum(r["launches"].get(name, 0)
                                    for r in nmt_runs),
                "elastic_launches": sum(r["launches"].get(name, 0)
                                        for r in elastic_runs.values()),
                "gluon_gpt_launches": sum(r["launches"].get(name, 0)
                                          for r in gluon_gpt_runs),
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": rep[mk], "kernel_ms": rep[mk],
                "plain_ms": rep[pre + "plain_ms"],
                "bound_ms": rep[mk[:-2] + "bound_ms"],
                "bound_by": rep[mk[:-2] + "bound_by"],
                "library_ms": rep[pre + "library_ms"]}

    fa_src = "mxnet_tpu_torch/csrc/flash_attention.cu"
    fa_py = "mxnet_tpu/ops/pallas/flash_attention.py"
    sx_src = "mxnet_tpu_torch/csrc/softmax_xent.cu"
    sx_py = "mxnet_tpu/ops/pallas/softmax_xent.py"
    fo_src = "mxnet_tpu_torch/csrc/fused_optimizer.cu"
    fo_py = "mxnet_tpu/ops/pallas/fused_optimizer.py"
    fwd = entry("flash_attention_fwd", fa_src, f"{fa_py}:284",
                train_launches("flash_attention_fwd"), k3, rep3)
    # the forward's bf16 case (the bf16 step's) beside the f32 one
    fwd.update(device_ms=rep3["device_ms"], bf16_ms=rep3b["ms"],
               bf16_device_ms=rep3b["device_ms"],
               bf16_library_ms=rep3b["library_ms"],
               bf16_bound_ms=rep3b["bound_ms"])

    tags = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}

    def gpt_shape(e, cases, pre="", model="gpt_"):
        for dt, c in cases.items():
            tag = model + tags[dt]
            e.update({f"{tag}_ms": c[pre + "ms"],
                      f"{tag}_plain_ms": c[pre + "plain_ms"],
                      f"{tag}_library_ms": c[pre + "library_ms"],
                      f"{tag}_bound_ms": c[pre + "bound_ms"]})
        return e
    gpt_shape(fwd, gpt3)
    # k3's band and fold cases (`FLASH_BAND_CASES`), each dtype
    band = [c for c in k3 if "kv_heads" in c and c["dtype"] != "float16"]

    def band_shape(e, pre="", cases=band):
        for c in cases:
            tag = c["case"] + "_" + tags[c["dtype"]]
            e.update({f"{tag}_{n}": c[pre + n] for n in (
                "ms", "plain_ms", "library_ms", "bound_ms")})
        return e
    band_shape(fwd)
    norm = entry("fused_norm", "mxnet_tpu_torch/csrc/fused_norm.cu",
                 "mxnet_tpu/ops/pallas/fused_norm.py:164",
                 train_launches("fused_norm"), k5, rep5)
    # the norm's device-only time, host µs a call and plan beside it
    norm.update(device_ms=rep5["device_ms"], host_us=rep5["host_us"],
                library_device_ms=rep5["library_device_ms"],
                plan=rep5["plan"])
    gpt_shape(norm, nmt5, model="nmt_")
    chunk_entry = gpt_shape(gpt_shape(
        entry("fused_optimizer_chunk", fo_src, f"{fo_py}:220",
              train_launches("fused_optimizer_chunk"), chunk, rep7),
        {c["dtype"]: c for c in chunk if c.get("model") == "gpt_small"}),
        {c["dtype"]: c for c in chunk
         if c.get("model") == "transformer_base"}, model="nmt_")
    # the nine rules, and each rule's BERT-base cases beyond Adam's
    chunk_entry["rules"] = list(CHUNK_RULE_NAMES)
    chunk_entry["optim_launches"] = sum(
        v["launches"]["fused_optimizer_chunk"]
        for k, v in train.items() if k.startswith("optim_"))
    for c in chunk:
        if c.get("model") != "bert_base" or c["rule"] == "adam":
            continue
        tag = c["rule"] + ("_f32" if c["dtype"] == "float32" else "_bf16")
        chunk_entry.update({f"{tag}_{n}": c[n] for n in (
            "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")})
    lamb_a = entry("lamb_phase_a", fo_src, f"{fo_py}:307",
                   train_launches("lamb_phase_a"), lamb, rep8,
                   ms="phase_a_ms")
    lamb_a.update(plan=rep8["phase_a_plan"])
    lamb_b = entry("lamb_phase_b", fo_src, f"{fo_py}:333",
                   train_launches("lamb_phase_b"), lamb, rep8,
                   ms="phase_b_ms")
    lamb_b.update(plan=rep8["phase_b_plan"])
    k1e = entry("ragged_paged_attention",
                "mxnet_tpu_torch/csrc/paged_attention.cu",
                "mxnet_tpu/ops/pallas/paged_attention.py:285", k1_launch, k1,
                rep1)
    # f32 queries over a bf16 pool (bf16 serving), decode C=1, beside it
    k1e.update(f32q_bf16pool_ms=rep1m["ms"],
               f32q_bf16pool_device_ms=rep1m["device_ms"],
               f32q_bf16pool_plain_ms=rep1m["plain_ms"],
               f32q_bf16pool_bound_ms=rep1m["bound_ms"],
               f32q_bf16pool_max_abs_err=rep1m["max_abs_err"])
    # the verification width over a shared prefix, each dtype and kv heads
    # and the wide heads (`K1_WIDE`)
    for c in k1:
        dt = "f32" if c["dtype"] == "float32" else "bf16"
        if c["C"] == K1_VERIFY_C:
            tag = f"verify_c{c['C']}_hkv{c['Hkv']}_{dt}"
        elif c["context"] > K1_MAXP * K1_PS:
            tag = f"long{c['context']}_{dt}"
        elif c["D"] != 64:
            tag = f"d{c['D']}_h{c['H']}_hkv{c['Hkv']}_c{c['C']}_{dt}"
        else:
            continue
        k1e.update({f"{tag}_{n}": c[n] for n in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "max_abs_err")})
    k1e["gpt_d256_serve_launches"] = results.get("gpt_d256_serve", {}).get(
        "launches", {}).get("ragged_paged_attention", 0)
    k1e["spec_prefix_launches"] = results["spec_prefix"].get(
        f"spec{SPEC_K}_prefix1", {}).get("launches", {}).get(
        "ragged_paged_attention", 0)
    # the int8 variant: f32 queries, decode C=1, MHA, no window, as the
    # int8-pool serving run calls it; every other case beside it
    rep1q = next(c for c in k1q if c["dtype"] == "float32" and c["C"] == 1
                 and c["Hkv"] == 12 and c["window"] is None
                 and c["D"] == 64 and c["context"] == K1_MAXP * K1_PS)
    k1q_e = entry("ragged_paged_attention_int8",
                  "mxnet_tpu_torch/csrc/paged_attention.cu",
                  "mxnet_tpu/ops/pallas/paged_attention.py:285",
                  sum(e2e.get(k, {}).get("launches", {}).get(
                      "ragged_paged_attention_int8", 0)
                      for k in INT8_SERVE), k1q, rep1q)
    k1q_e.update(device_ms=rep1q["device_ms"], plan=rep1q["plan"],
                 spec_prefix_launches=results["spec_prefix"].get(
                     "int8", {}).get("launches", {}).get(
                     "ragged_paged_attention_int8", 0))
    for c in k1q:
        if c is rep1q:
            continue
        dt = "f32" if c["dtype"] == "float32" else "bf16"
        tag = (f"long{c['context']}" if c["context"] > K1_MAXP * K1_PS
               else f"c{c['C']}_h{c['H']}_hkv{c['Hkv']}_d{c['D']}"
               f"_w{c['window'] or 0}") + f"_{dt}"
        k1q_e.update({f"{tag}_{n}": c[n] for n in (
            "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")})
    xent_fwd = gpt_shape(gpt_shape(entry(
        "softmax_xent_fwd", sx_src, f"{sx_py}:95",
        train_launches("softmax_xent_fwd"), k4, rep4), gpt4), nmt4,
        model="nmt_")
    xent_fwd.update(host_us=rep4["host_us"], plan=rep4["plan"])
    # the gather: f32 as the representative, each other dtype at the
    # slice's H 768 beside it, host µs a call and the plan
    gathers = []
    for op, rep in (("dispatch", rep_d), ("combine", rep_c)):
        e = entry(f"moe_{op}", "mxnet_tpu_torch/csrc/moe_dispatch.cu",
                  "mxnet_tpu/ops/pallas/moe_dispatch.py:139",
                  train_launches(f"moe_{op}"),
                  [c for c in k7 if c["op"] == op], rep)
        e.update(host_us=rep["host_us"], plan=rep["plan"])
        for c in k7:
            if c["op"] == op and c["T"] == 8192 and c["H"] == 768 and \
                    c["dtype"] != "float32":
                tag = "bf16" if c["dtype"] == "bfloat16" else "f16"
                e.update({f"{tag}_{n}": c[n] for n in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "host_us")})
        gathers.append(e)
    # the f16 entries: launches from the amp phase's fp16 runs
    def amp_launches(name):
        return sum(r["dtype_launches"].get(f"{name}:float16", 0)
                   for r in results["amp"].values())

    def f16_entry(name, src, replaces, cases, rep, pre="", shapes=(),
                  wide=()):
        e = entry(name + "_f16", src, replaces, amp_launches(name), cases,
                  rep, pre)
        e["dtype"] = "float16"
        for c in shapes:
            gpt_shape(e, c, pre)
        return band_shape(e, pre, list(wide))
    wide_h = [c for c in k3h if "kv_heads" in c]
    f16_entries = f16_rows(results, entry) + [
        f16_entry("flash_attention_fwd", fa_src, f"{fa_py}:284", k3h, rep3h,
                  shapes=(gpt3h,), wide=wide_h),
        f16_entry("flash_attention_bwd", fa_src, f"{fa_py}:489", k3h, rep3h,
                  "bwd_", shapes=(gpt3h,), wide=wide_h),
        f16_entry("softmax_xent_fwd", sx_src, f"{sx_py}:95", k4h, rep4h,
                  shapes=(gpt4h,)),
        f16_entry("softmax_xent_bwd", sx_src, f"{sx_py}:127", k4h, rep4h,
                  "bwd_", shapes=(gpt4h,))]
    return [
        k1e,
        k1q_e,
        entry("quantized_matmul",
              "mxnet_tpu_torch/csrc/quantized_matmul.cu",
              "mxnet_tpu/ops/pallas/quantized_matmul.py:341", k2_launch, k2,
              rep2),
        fwd,
        band_shape(gpt_shape(entry("flash_attention_bwd", fa_src,
                                   f"{fa_py}:489",
                                   train_launches("flash_attention_bwd"), k3,
                                   rep3, "bwd_"), gpt3, "bwd_"), "bwd_"),
        xent_fwd,
        gpt_shape(gpt_shape(entry("softmax_xent_bwd", sx_src, f"{sx_py}:127",
                                  train_launches("softmax_xent_bwd"), k4,
                                  rep4, "bwd_"), gpt4, "bwd_"),
                  nmt4, "bwd_", model="nmt_"),
        norm,
        chunk_entry,
        lamb_a,
        lamb_b,
        *gathers,
        *f16_entries,
    ]


def f16_rows(results, entry):
    """The f16 entries of rows 7-10, 12 and 13 (``..._f16``): K1 with f32
    queries over an f16 pool at decode C=1 (phase 5b's type 5) as the
    representative, every other k1_f16 case beside it, launches from the
    f16 serving run; K2 on f16 activations (int8, M=8, 768->2304), its
    launches those of the tune phase's ``int8_float16`` search and the
    call after it, as no serving or training path sends f16 activations
    to K2; the chunk over GPT-2 small's f16 leaves with f32 state, the
    f16-state case and the tuner's f16 trial beside it, launches from the
    gpt phase's f16 run; LAMB's phases over BERT-base's f16 leaves,
    launches from the optim phase's f16 run."""
    k1h = results["k1_f16"]
    k2h = [c for c in results["k2"] if c["dtype"] == "float16"]
    k6h = [c for c in results["k6"] if c["dtype"] == "float16"]
    tags = {"float32": "f32", "float16": "f16"}

    def dl(run, key):
        return (run or {}).get("dtype_launches", {}).get(key, 0)
    rep1 = next(c for c in k1h if c["dtype"] == "float32" and c["C"] == 1
                and c["Hkv"] == 12 and c["window"] is None and c["D"] == 64)
    k1 = entry("ragged_paged_attention_f16",
               "mxnet_tpu_torch/csrc/paged_attention.cu",
               "mxnet_tpu/ops/pallas/paged_attention.py:285",
               dl(results["e2e"].get("float16"),
                  "ragged_paged_attention:float16"), k1h, rep1)
    k1.update(dtype="float16", device_ms=rep1["device_ms"],
              plan=rep1["plan"])
    for c in k1h:
        if c is not rep1:
            tag = (f"q{tags[c['dtype']]}_c{c['C']}_h{c['H']}_hkv{c['Hkv']}"
                   f"_d{c['D']}_w{c['window'] or 0}")
            k1.update({f"{tag}_{n}": c[n] for n in (
                "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")})
    rep2 = next(c for c in k2h if c["bits"] == 8 and c["M"] == 8
                and c["N"] == 2304)
    tune2 = results["tune"].get("k2_int8_float16", {})
    k2 = entry("quantized_matmul_f16",
               "mxnet_tpu_torch/csrc/quantized_matmul.cu",
               "mxnet_tpu/ops/pallas/quantized_matmul.py:341",
               sum(tune2.get(k, 0) for k in ("trial_launches",
                                             "warm_launches",
                                             "next_launches")), k2h, rep2)
    k2.update(dtype="float16", launches_from=(
        "the tune phase: autotune.tune('quantized_matmul', (8, 2304, 768), "
        "'int8_float16') and the quantized_matmul call after it; no "
        "serving or training path sends f16 activations to K2"))
    for c in k2h:
        if c is not rep2:
            tag = f"int{c['bits']}_m{c['M']}_n{c['N']}_k{c['K']}"
            k2.update({f"{tag}_{n}": c[n] for n in (
                "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")})
    gpt_h = results["gpt"].get("float16_step_remat_off")
    rep7 = next(c for c in k6h if c["rule"] == "adamw"
                and c["state_dtype"] == "float32")
    fo_src = "mxnet_tpu_torch/csrc/fused_optimizer.cu"
    fo_py = "mxnet_tpu/ops/pallas/fused_optimizer.py"
    k7 = entry("fused_optimizer_chunk_f16", fo_src, f"{fo_py}:220",
               dl(gpt_h, "fused_optimizer_chunk:float16"),
               [c for c in k6h if c["rule"] != "lamb"], rep7)
    k7.update(dtype="float16", state_dtype="float32",
              library_note=rep7.get("library_note"))
    st16 = next(c for c in k6h if c["rule"] == "adamw"
                and c["state_dtype"] == "float16")
    k7.update({f"f16_state_{n}": st16[n] for n in (
        "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")})
    tune7 = results["tune"].get("gpt_f16", {})
    k7.update({f"tune_{n}": tune7.get(n) for n in (
        "ms", "plain_ms", "library_ms", "bound_ms", "trial_launches")})
    rep8 = next(c for c in k6h if c["rule"] == "lamb")
    opt_h = results["optim"].get("lamb_step_float16")
    lamb = []
    for ph, line in (("a", 307), ("b", 333)):
        e = entry(f"lamb_phase_{ph}_f16", fo_src, f"{fo_py}:{line}",
                  dl(opt_h, f"lamb_phase_{ph}:float16"), [rep8], rep8,
                  ms=f"phase_{ph}_ms")
        e.update(dtype="float16", plan=rep8[f"phase_{ph}_plan"])
        lamb.append(e)
    return [k1, k2, k7, *lamb]


def phase_done(results, name, t0):
    """Record and print a phase's seconds (``phase_seconds``): where the
    smoke's time limit goes."""
    sec = results.setdefault("phase_seconds", {})[name] = \
        time.perf_counter() - t0
    print(f"[phase {name}] {sec:.1f} s", flush=True)


def _stop(builds):
    """Wait for (or end) every fault build still running."""
    for _, proc in builds.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "chip_smoke.json"),
                    help="where the full per-case results are written")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible — this smoke runs on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from mxnet_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port package is not here ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    # f16 products sum in f32, on the kernel route and its oracle alike
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[versions] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "e2e": {}, "train": {}, "train_controls": {}, "tune": {},
               "moe": {}, "moe_controls": {}, "gpt": {},
               "gpt_controls": {}, "gpt_one_ulp": {}, "gpt_gqa": {},
               "gpt_gqa_controls": {}, "gpt_gqa_one_ulp": {},
               "gpt_d256": {}, "gpt_d256_controls": {},
               "gpt_d256_one_ulp": {},
               "spec_prefix": {}, "nmt": {}, "optim": {}, "amp": {},
               "amp_controls": {}, "amp_one_ulp": {}, "gluon": {},
               "gluon_gpt": {}, "np": {}, "elastic": {}}
    failed = []
    t0 = time.perf_counter()
    # build from the checkout's sources, never from a leftover library
    shutil.rmtree(os.path.join(HERE, "build", "mxnet_tpu_torch"),
                  ignore_errors=True)
    fault_builds = {}
    try:
        # the optim phase's planted faults build beside the kernels
        fault_builds = start_fault_builds()
        kernels.build_all(verbose=True)
        results["build_s"] = time.perf_counter() - t0
        results["build_seconds"] = dict(kernels.BUILD_SECONDS)
        print(f"[build] {results['build_s']:.1f} s "
              f"{json.dumps(results['build_seconds'])}", flush=True)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: kernel build failed", file=sys.stderr)
        _stop(fault_builds)
        return 1

    for name, fn in (("k1", k1_cases), ("k1_int8", k1_int8_cases),
                     ("k1_f16", k1_f16_cases), ("k2", k2_cases), ("k3", k3_cases),
                     ("k4", k4_cases), ("k5", k5_cases), ("k6", k6_cases),
                     ("k7", k7_cases)):
        t_phase = time.perf_counter()
        try:
            results[name] = fn(dev)
            for c in results[name]:
                print(f"[{name}] {json.dumps(c)}", flush=True)
            bad = [c for c in results[name] if not c["ok"]]
            if bad:
                raise AssertionError(f"{name}: {len(bad)} case(s) outside "
                                     f"tolerance")
        except Exception:
            traceback.print_exc()
            failed.append(name)
        phase_done(results, name, t_phase)
    for name, fn in (("e2e", lambda d, r, c: run_e2e(d, r)),
                     ("train", run_train), ("tune", run_tune),
                     ("moe", run_moe),
                     ("gpt", run_gpt), ("gpt_gqa", run_gpt_gqa),
                     ("gpt_d256", run_gpt_d256),
                     ("spec_prefix", run_spec_prefix), ("nmt", run_nmt),
                     ("optim", lambda d, r, c: run_optim(d, r, c,
                                                         fault_builds)),
                     ("amp", run_amp), ("gluon", run_gluon),
                     ("gluon_gpt", run_gluon_gpt), ("np", run_np),
                     ("elastic", run_elastic)):
        t_phase = time.perf_counter()
        try:
            fn(dev, results, card)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        phase_done(results, name, t_phase)
    _stop(fault_builds)
    results["seconds"] = time.perf_counter() - t0
    results["failed"] = failed
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": kernel_entries(results)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
