#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure exits non-zero:

1. device — the card's name and power limit, as nvidia-smi reports them;
2. build  — the four CUDA kernels of ``src/repro_torch/csrc`` built with
   nvcc for sm_90a (one process per source, started together);
2a. llama3.2-1b train (right after the build; it opens no profiler
   session) — the port's trainer (``train.Trainer``) on llama3.2-1b at
   full width, cut to 2 of its 16 layers, in bf16 with f32 AdamW moments,
   under the quantize CLI's teacher recipe (``TrainConfig(lr=1e-3,
   warmup=20, total_steps=150)``, 8 x 256 tokens a step; ``TRAIN``): a
   drill checkpointing every 50 steps under
   ``launch.supervisor.run_with_restarts``, crashed by an exception at
   step 120 and resumed from step 100 to 150, then an uninterrupted
   150-step run with no manager. Step ms (median, the first 3 apart),
   tokens/s, peak GiB, each save's seconds and bytes, the restore's
   seconds, the loss over the first and last 10 steps; gated on finite
   losses, a fall between those means, the resumed state equal to the
   uninterrupted one bit for bit (crc32 of the leaves) and no kernel
   launched (path ``llama3.2-1b-train``); and the reference's
   ``test_loss_decreases`` on the card (its tiny config, 30 steps), its
   loss 0.2 lower. The step-150 checkpoint is phase 2b's teacher;
2b. llama3.2-1b quantize (after the trainer, so that its KD profile
   is the process's first profiler session) — kernel #1 under its
   autograd Function (the KD phase's student linear,
   ``ops.lowrank_binary_matmul``) against autograd through its plain
   version at the gate shape (K 2048 -> N 8192 at rank 1600) with M =
   1024, f32 and bf16: output and the gradients of x, s1 and s2, forward
   and forward + backward timed. Then the port's quantization pipeline
   (``NanoQuantModel.quantize``) on llama3.2-1b at full width, cut to 2
   of its 16 layers (``QUANT_DEPTH``), in bf16, the teacher phase 2a
   trained, restored from its step-150 checkpoint by the code of
   ``launch.quantize --teacher-ckpt`` (no further step), calibrated on
   ``QUANT``'s 16 samples of 256 tokens (cut from the paper's 128 x
   2048), ``QuantConfig()`` at its defaults (1.0 bpw, ADMM 40, TuneFP 40,
   STE 60, KD 60), on the path ``llama3.2-1b-quantize``: #1 only, 7
   launches per block's check forward and 7 per layer in each KD step; the seconds of
   calibration, of each block and of KD, each block's error and init
   method, the KD loss at its first and last step and over its first and
   last pass of the batches, the ranks and the linears' bpw, peak memory;
   gated on finite block errors and KD losses and a packed leaf for every
   one of the 28 linears; the FP perplexity of that teacher and of the
   init teacher (``init_params`` from the seed) and the quantized
   model's on the quantize CLI's evaluation batches (8 x 256, seed 99),
   ``ppl_fp`` / ``ppl_fp_init`` / ``ppl_q``. One more KD step of the pipeline's own
   (``tune_scales_kd``) under the profiler gives its device ms by group
   (#1's forward, the backward's plain ops with the packed linears' share,
   the other ops). The artifact is saved, loaded and cast to f32 and served on the
   path ``llama3.2-1b-quantized`` (4 requests of the llama traffic,
   ``QUANT_SERVE``; #1 and #3), gated against the plain-oracle engine
   like the llama paths;
2c. the other families' quantization — #1 under the same autograd
   Function at deepseek-v2-lite-16b's expert grid
   (``ops.lowrank_binary_matmul_expert``: G 64, x per group, K 2048 -> N
   1408 at rank 800, the 120 capacity rows of a KD step), and #4 under it
   on the two-call route at llama-3.2-vision-90b's FFN (K 8192 -> N 28672
   at rank 6336, past #1's 4096, M 1024: #4 twice per forward, its rank
   intermediate rounded to x's dtype, held against the two-stage oracle),
   checked and timed as the gate shape's; then the pipeline, as for
   llama3.2-1b, on musicgen-medium (1 of its 48 layers; calibration frames
   of 4 codebooks), mamba2-370m (1 of 48), deepseek-v2-lite-16b (its dense
   layer and 1 of 26 MoE layers), zamba2-1.2b (7 of its 38 Mamba2 layers,
   so one application of the shared attention block, which is quantized
   first on its inputs gathered from the teacher stream) and
   llama-3.2-vision-90b (2 of its 100 layers grouped as one, a self block
   then the cross block, cut from its smallest group of 5 by the script's
   time limit; its teacher's gates drawn under ``GATE_LAWS``, JAX's zeros
   making each cross block the identity, and 1024 seeded image tokens per
   calibration sample; each block's seconds by part, ``block_parts``:
   TuneFP, LB-ADMM per linear, STE, packing, the rest) (``QUANT_DEPTH``),
   each at full width in bf16 on the path ``<arch>-quantize``: #1
   launched once per packed linear up to rank 4096 and #4 twice per one
   past it (the VLM's FFN) in each block's check forward and each KD
   step's student forward (an expert stack: one launch of the grid over
   its 64 experts, counted apart: 3 per MoE layer and forward; the shared
   block once per application, and once more for its check forward over
   the gathered inputs) and nothing else, the counts equal to the
   template's; deepseek's expert scales' gradients of
   one KD step (models cast to f32) non-zero on the kernel path and
   within the bf16 tolerance of the plain path's. zamba2-1.2b runs with
   the crash-safe journal on (a temporary directory) and then drills it
   in the same process on the path ``zamba2-1.2b-quantize-drill``
   (``DRILL``): a second journaled run with a crash planned when block 7
   starts (Mamba2 layer 6, the first block after the shared block's first
   application), which must fire exactly once; the resume of that
   journal, whose blocks 0-6 must come back resumed (no LB-ADMM, TuneFP
   or STE for them) and whose quantized params (``_crc_leaves``, all of
   them and the packed words alone) and report rows, ranks and KD losses
   must equal the uninterrupted run's bit for bit; a copy of the crashed
   journal with its last line corrupted, which ``entries_for_resume``
   must refuse naming ``layers[5]`` (block 6); and a resume under
   ``QuantConfig(seed=1)``, which must be refused as another run. Only the
   planned crash is caught. Each artifact is saved, loaded, cast to f32
   and served under 4 requests of its family's traffic on
   ``<arch>-quantized`` (musicgen #1 and #3, mamba2 #1, deepseek #1 with
   the G = 64 grid, zamba2 #1 and #3, the VLM #1, #3 and #4), gated
   against the plain-oracle engine like its family's paths; the VLM's
   also through ``generate`` of 4 prompts with 1024 seeded image tokens
   each (``llama-3.2-vision-90b-quantized-image``), gated likewise. Then
   ``python -m repro_torch.launch.serve --arch llama-3.2-vision-90b``
   twice (``SERVE_DEMO``): without an artifact (the smoke teacher
   quantized on the card, the reference CLI's demo) and with ``--fp``;
   each must exit 0 and print its serve lines;
2d. ``python -m repro_torch.launch.train --arch llama3.2-1b --steps 3
   --batch 1 --seq 4096`` (``TRAIN_CLI``: the published config, all 16
   layers, remat, loss_chunk 2048, sdpa_flash at train_4k's length) as a
   subprocess, gated on exit 0 and finite losses, its step seconds and
   peak GiB reported; one layer's attention at S 4096 in f32
   (``FLASH``), sdpa_flash against the plain sdpa: output and q / k / v
   gradients within 1e-5; then ``python -m repro_torch.launch.quantize
   --teacher-steps 20 --teacher-ckpt DIR`` at smoke size twice
   (``QUANT_CLI``): the second run trains no step and quantizes the first
   run's step-20 teacher (crc32 of its leaves);
3. llama3.2-1b kernels — kernels #1-#3 against their plain PyTorch
   versions on the card at the shapes the llama3.2-1b serving path gives
   them (decode M in {1, 8}, prefill M = 512; B = 8 slots, page_size 64,
   ragged block tables, null padding, one slot with an all-null table),
   f32 and bf16, with the reference harness's tolerances (relative
   max-abs 1e-5 f32, 3e-2 bf16); device times (CUDA events, median of
   21) of the kernel, its plain version and one PyTorch call computing
   the same function (a yardstick, never used by the port); the launch
   plan and the achieved share of the bound: ±1 products (#1, #4 and
   #3's projections) counted at the 989 TFLOP/s bf16 tensor rate the
   exact ±1 factors allow, in both dtypes, attention arithmetic (#2 and
   #3's walk) at the rate of the unit it runs on (bf16: the tensor cores;
   f32: the 67 TFLOP/s of the CUDA cores);
   for #1 and #4 also the instruction their ±1 products run on. #2 and
   #3 again at 32 table entries per slot (2048 rows, data from their own
   generator); #3 also with L2 flushed before each call (the engine
   finds its weights cold) and beside the unfused chain it replaces at
   the same inputs (#1 qkv, RoPE, #2, #1 wo; ``chain_ms``, a yardstick);
   then the speculative path's shapes: #1's merged QKV at the verify's
   M = 40, #3 on the draft view (eff_rank 480 of the QKV group's 992 and
   of wo's 992), #2 as the verify reads it (5 queries per slot through
   ``ops.paged_attention`` over a pool with stale rows past the
   frontier);
4. llama3.2-1b engine — llama3.2-1b at full width, cut to 1 of its 16
   layers (``DEPTH``), at 1.0 bpw with packed weights drawn from a seed,
   served by the
   continuous-batching engine (8 slots, max_len 256, 8 requests of
   17-200 prompt tokens and 32 new tokens, admitted mid-flight) on four
   paths: ``megakernel``, ``unfused`` (megakernel off), ``twocall``
   (``KernelPolicy(fused=False)``: every packed linear through two
   packed_matmul launches) and ``spec`` (self-speculative decoding, the
   draft at half of every rank, k = 4, megakernel on), each gated against
   the same engine on the plain oracles (``spec`` against ``megakernel``):
   greedy tokens identical, or a divergence at a plain-path top-2 logit
   margin below the logits tolerance; a speculative path must also have
   rolled back drafted tokens and account for every one; then plain
   against speculative decoding in bf16: plain, spec, plain, spec in this
   process (the first plain run gives the ``bf16`` tok/s and TTFT), each
   one's decode window under torch.profiler (device ms per committed
   token by kernel), and the plain run once more under the profiler for
   the device's busy share. Then the prefix cache: the ``prefix`` path
   (megakernel on) serves the ``PREFIX`` traffic (8 requests sharing a
   128-token system prompt, two of them full covers, tails of 63 and 65
   tokens among the others) and is gated against the plain-oracle engine
   serving it without sharing (every path's oracle serves without
   sharing); it must launch #1 (every linear), #2 (each hit's suffix
   prefill, S single-query launches per layer) and #3 (decode and the
   one-token re-prefill of a full cover), hit, copy on write at least
   twice and share pages. ``prefix-pressure`` serves the same requests on
   an overcommitted pool of 12 pages and must also evict cached pages and
   preempt. In bf16 the cache is on, off, on, off in this process (TTFT,
   host ms per admission, hit rate, copies on write, peak pages in use),
   then the admissions alone under the profiler, once per setting (device
   ms by kernel): over ``PREFIX``, and over ``GSP``, SGLang's
   generated-shared-prefix mix cut to one group (16 requests of a
   2048-token system prompt and a 128-token question, 32 new tokens);
   then ``GSP`` on a pool of 64 pages with the cache on and off (slots
   active at the peak, decode tok/s, TTFT). After every run the pool must
   be drained: no page mapped, only the index's pages in use, all tables
   zero, and nothing in use once the index is cleared. Then the request
   lifecycle (f32, before the bf16 runs): the ``chaos`` path serves the
   ``CHAOS`` traffic (the JAX package's chaos benchmark at llama3.2-1b's
   serving size: 24 requests arriving over engine steps, full-rank
   speculative decoding, prefix cache, megakernel, a pool of half the
   slots' rectangle, audited after every tick) in legs: the plain oracles;
   ``baseline`` (gated against them); ``chaos`` and ``chaos-repeat`` under
   the reference's 11-fault plan (every kind must fire, 3 expired, at
   least 2 cancelled, 2 failed with structured errors, 1 device fault;
   the survivors gated against the baseline; the repeat equal bit for
   bit); ``crash-restore`` (a snapshot of the live engine after 3 steps,
   the engine dropped, a fresh one restored) and ``drain-restore`` (the
   same after ``drain(timeout=0)``), both gated against the baseline for
   all 24 requests; every pool audited; #1-#3 must launch and #4 not.
   It times each leg's host ms per tick, the injected device error's
   recovery (and its device ms by kernel, profiled in the repeat) and
   each restore's re-prefill. The ``restart`` path writes the model with
   the port's ``save`` and serves it with ``python -m
   repro_torch.launch.serve --supervise``, crashing once: exit 7 once, a
   restart, resumed requests, exit 0, the snapshot removed; it times the
   recovery from the output's lines (``chiprun_out/restart.log``);
4a. llama3.2-1b-rect — the same model and ``LLAMA`` traffic on the
   rectangular KV cache (``ServeConfig(paged=False)``, the reference's
   identity oracle): the f32 plain-oracle engine, then the kernel
   engine with every launch count at 0 just before its run, which must
   launch #1 on every packed linear of every forward (4 per layer) and
   #2, #3 and #4 never (the rectangle is read by plain ops, as the
   reference reads it); its tokens gated against the rectangular plain
   engine's and the paged ``megakernel`` and ``unfused`` paths'; then
   ``generate(paged=False)`` of the traffic's 8 prompts cut to the
   shortest one's 17 tokens, gated against the rectangular kernel
   engine on those prompts. In bf16 (after the llama bf16 runs) the
   rectangle and the pool in turns (rect, pool, rect, pool): decode
   tok/s, TTFT, peak GiB and ``kv_cache_bytes``;
5. qwen1.5-110b kernels — kernel #4 (packed_matmul) at the four two-call
   stage shapes of the qwen1.5-110b MLP (rank 6976) at M in {1, 8, 64},
   plus an eff_rank view read in place; kernel #1 at its merged-QKV and
   wo shapes (rank 4064); kernel #2 at head_dim 128, 8 query heads per
   kv head; then the speculative path's shapes: #4's two launches of the
   draft's gate (rank 3488 of 6976, read in place) at M = 4 and #1's
   merged QKV at the verify's M = 20;
6. qwen1.5-110b engine — full width, cut to 2 of its 80 layers
   (``DEPTH``, so that the script keeps inside its time limit), at 1.0
   bpw, weights drawn on the card from the seed: 4 slots, max_len 128,
   4 requests of 16-64 prompt tokens and 16 new tokens, 2 admitted after
   three steps, on the paths ``qwen1.5-110b`` and ``qwen1.5-110b-spec``.
   The f32 runs are gated like the llama paths; then plain against
   speculative decoding in bf16 as for llama (the first plain run gives
   decode tok/s, TTFT and peak memory; the plain decode window's profile
   is the ``bf16_decode_profile``);
6a. tensor-parallel serving (``TP_PHASES``) — the engine over a
   ``(data=1, model=N)`` mesh (``InferenceEngine(mesh=)``), N ranks in N
   processes (``launch.mesh.run_ranks``) that all use this one card: NCCL
   refuses two ranks on one device, so the ranks' collectives run over
   gloo, staged through host memory (an N-card deployment exchanges
   device memory over NCCL instead; only that transport differs). Each
   rank draws the phase's model from the seed on the card as the
   unsharded phase did, takes its shards (``place_on_mesh`` under
   ``SERVE``) and runs #1, #2 and #4 on them, the all-reduces and the
   logits' all-gather between; the megakernel declines under TP.
   ``qwen1.5-110b-tp2`` (the qwen1.5-110b model at TP 2 under ``QWEN``,
   f32) and ``llama3.2-1b-tp4`` / ``llama3.2-1b-tp4-spec`` (the llama
   model at TP 4 under ``LLAMA``, f32, plain then self-speculative) after
   the qwen1.5-110b phase, and after the musicgen phase (its last family's
   unsharded paths) ``qwen3-moe-235b-a22b-tp2``,
   ``deepseek-v2-lite-16b-tp2``, ``musicgen-medium-tp2``,
   ``mamba2-370m-tp2``, ``zamba2-1.2b-tp2`` and
   ``llama-3.2-vision-90b-tp2`` (each family's model at TP 2 under its
   traffic, f32): an MoE rank holds E / 2 whole experts, routes every row
   with the replicated router and launches #1's grid over its own (G = 64
   for qwen3-moe, 32 for deepseek), MLA splits wq / w_uk / w_uv / wo by
   head and keeps w_dkv, w_kr and the latent pool whole, musicgen's
   codebook tables split on the vocabulary, a Mamba2 mixer (mamba2 and
   zamba2) runs on the rank's SSD heads (wz / wx / out_proj split, wB /
   wC / wdt whole, the gated norm's sum of squares all-reduced, the
   state's heads and d_inner columns), zamba2's shared block and the
   VLM's self and cross blocks on the rank's heads (the VLM's image K/V
   by kv head); phases of one size share one start of their ranks (each
   rank serves their models in turn, each drawn and dropped). On every
   rank: greedy tokens equal the unsharded path's (``megakernel``,
   ``spec``, ``qwen1.5-110b``, the family's path) up to near-ties of the
   plain path (an MoE's by ``moe_gate`` against its unsharded path's
   router log), an MoE's router choices equal on every rank; launches per
   forward by the family's template (#1 and #4 per layer and packed mixer
   projection, the expert grid at G = E / N, #2 per GQA self-attention
   block and decode forward, #3 none); per forward 2 all-reduces per
   attention block (an MoE layer's one carries its shared experts'
   partial) and per Mamba2 layer, 1 for the embedding, and one
   all-gather; the drained pool; the bytes the rank holds against the
   unsharded model's (packed words, expert words, all), its peak GiB and
   host ms per decode step (ranks time-sharing one card over gloo, not
   TP speed). The VLM's phase also runs one ``forward`` of
   ``VISION_IMAGE``'s prompts with their images on every rank, its
   last-position logits held to the plain path's (the same argmax per
   row, or a near-tie; the largest relative difference recorded) and its
   launches to the template (#1 for the cross blocks' wk / wv too);
7. qwen3-4b — full width, cut to 4 of its 36 layers (``DEPTH``; per-head
   qk_norm, which rules out #3) at 1.0 bpw, weights drawn on the card, under the llama
   traffic on the path ``qwen3-4b`` (#1 and #2 only), gated like the
   llama paths; then one bf16 run (decode tok/s, TTFT, peak memory);
8. qwen3-moe-235b-a22b — kernel #1 at its expert grid (G = 128 experts,
   x per group, rank 1088; gate/up K 4096 -> N 1536 and down K 1536 -> N
   4096; M 8, the capacity of a decode step and of a prefill of up to 64
   tokens, and M 40, a 256-token prefill's; f32 and bf16; and at M 8 at
   the grid of one rank of its TP 2 phase, G = 64) against its plain
   version, timed beside the batched library call over unpacked bf16
   factors; then the model at full width, cut to 2 of its 94
   layers (``DEPTH``; 128 experts, top-8), at 1.0 bpw, weights and
   routers drawn on the card, under the qwen1.5-110b traffic on the path
   ``qwen3-moe-235b-a22b`` (#1 and #2 only, #1 launched at the expert
   grid three times per MoE layer and forward). Its f32 gate also reads
   the router: a request's first expert choice that differs from the
   plain engine's must be at a plain-path router near-tie, and its
   tokens must be identical up to it or diverge at a plain-path logit
   near-tie (``moe_gate``). Then one bf16 run and its decode window
   under the profiler (device ms per step by kernel);
9. deepseek-v2-lite-16b — kernel #1 at the MLA attention's w_kr (N 64 at
   rank 32, below one 128-column tile in both stages) and w_dkv (N 512 at
   rank 384) at M 8, and at the 64-expert grid (x per group, rank 800;
   gate/up K 2048 -> N 1408, down K 1408 -> N 2048) at M 8 and 32, f32 and
   bf16, against its plain version beside its library call; then the
   model at full width, cut to 2 of its 27 layers (``DEPTH``: one dense, 1
   MoE of 64 experts top-6 plus 2 shared; MLA attention over a paged pool
   of compressed latents, kv_lora_rank 512 plus a 64-wide RoPE key per
   row) at 1.0 bpw, weights and routers drawn on the card, under the llama
   traffic on the path ``deepseek-v2-lite-16b``: #1 only, 15 launches per
   forward (four per layer for wq, w_dkv, w_kr and wo, three at the
   expert grid and two for the shared experts per MoE layer, two for the
   dense block; 240 at full depth), 3 of them at the grid; #2, #3 and #4
   never (MLA's read
   is plain torch ops, as the reference keeps it plain XLA). Its f32 gate
   is ``moe_gate``. Then one bf16 run (decode tok/s, TTFT, peak memory,
   the pool's bytes per token) and its decode window under the profiler,
   device ms per step split by op group (#1 at the grid, #1 elsewhere,
   MLA's attention ops, the MoE's dispatch ops, the lm head, the rest;
   ``deepseek_split``);
10. mamba2-370m — kernel #1 at the Mamba2 mixer's packed projections (wz,
   K 1024 -> N 2048 at rank 640, the shape of wx too; wB, -> 128 at rank
   96, a partial tile of the rank stage, the shape of wC too; out_proj,
   K 2048 -> 1024 at rank 640) at M 8 and 256, f32 and bf16, against its
   plain version beside its library call; then the model at full width,
   cut to 2 of its 48 Mamba2 blocks (``DEPTH``; d 1024, d_inner 2048, 32
   heads of 64, state 128, chunk 256, vocab 50280, tied head) at 1.0 bpw,
   weights drawn on the card, on the per-slot state cache (no pool) under
   the llama traffic with prompts of 17-520 tokens (``MAMBA``), on the
   path ``mamba2-370m``: #1 only, 10 launches per forward (wz, wx, wB, wC
   and out_proj per layer; wdt stays FP), #2, #3 and #4 never; gated like
   the llama paths. Then one bf16 run (decode tok/s, TTFT, peak memory,
   the state cache's bytes per slot) and its decode window under the
   profiler, device ms per step split by op group (``mamba_split``);
11. zamba2-1.2b — kernel #1 at the hybrid's mixer shapes (wz, K 2048 ->
   N 4096 at rank 1344, the shape of wx too; wdt, -> 64 at rank 32, a
   partial tile in both stages; out_proj, K 4096 -> 2048 at rank 1344) at
   M 8 and 256, and at one rank's shards of its TP 2 phase (wz on d_out
   2048, out_proj on d_in 2048) at M 8, f32 and bf16; #2 and #3 at the
   shared attention block's
   decode shape (B 8, 32 query heads over 32 kv heads: G = 1, D 64, pages
   of 64) over a ring-wrapped table of 64 entries (4096 rows, q_pos in
   [4096, 4400), cache_pos = q_pos % 4096, window 4096) and an unwrapped
   one of 4 entries, each against its plain version beside SDPA (the
   ``ring`` records of #2 and #3 on the kernels line); then the model at
   full width, cut to 6 of its 38 Mamba2 blocks (``DEPTH``; d 2048,
   d_inner 4096, 64 heads of 64, state 64; the shared MHA + FFN block,
   d_ff 8192, after every 6th block: 1 application per forward over one
   pool of ring pages) at 1.0 bpw, weights drawn on the card, on the paths
   ``zamba2-1.2b`` (the llama traffic, ``ZAMBA``: the window clamps to
   max_len 256, a ring of 4 pages that never wraps; megakernel on: #1
   and #3), ``zamba2-1.2b-unfused`` (megakernel off: #1 and #2) and
   ``zamba2-1.2b-wrap`` (``ZAMBA_WRAP``: 4 prompts of 4000-4080 tokens
   and 128 new each on 4 slots, max_len 4224: a ring of 64 pages that
   every request's writes wrap; #1 and #3), launches of #1, #2 and #3 per
   forward asserted from the template, gated like the llama paths (the
   wrap path's near-ties read the plain full-sequence forward with the
   window mask). Then one bf16 run over ``ZAMBA`` (decode tok/s, TTFT,
   peak memory, the ring pool's bytes per row and slot and the state's
   bytes per slot) and its decode window under the profiler, device ms
   per step split by op group (``zamba_split``);
12. llama-3.2-vision-90b — #3 at the VLM's self-attention decode (B 4 and
   8, 64 query heads over 8 kv heads: G 8, D 128, K 8192, merged-QKV and
   wo rank 4064, pages of 64 at 2 and 32 table entries) against its plain
   version beside its unfused chain; #1 at the image K/V projection (wk,
   K 8192 -> N 1024 at rank 864, M = 4 images x 1024 patches = 4096) and
   at the cross block's wq at M 4; #4 at the vision FFN's four two-call
   stages (rank 6336) at M 4, whole and at one rank's shards of its TP 2
   phase (w_gate's U on d_out 14336, w_down's V on 448 words of d_in);
   f32 and bf16. Then the model at full width,
   cut to 5 of its 100 layers (``DEPTH``: one group of 4 self-attention
   blocks over the paged pool and one gated cross-attention block over
   per-slot image K/V) at 1.0 bpw, weights drawn on the card, on the paths
   ``llama-3.2-vision-90b`` (the engine under the qwen1.5-110b traffic,
   ``VISION``; no request carries an image, as in the reference's engine,
   so the image K/V is zero; #1, #3 and #4) and
   ``llama-3.2-vision-90b-image`` (the port's ``generate`` of
   ``VISION_IMAGE``: 4 prompts of 32 tokens, each with its own 1024 seeded
   image tokens, 8 new; #1, its image K/V projection at M 4096, #3 and
   #4; the plain path's forward of those prompts and images gives the
   last-position logits the TP phase's image forward is held to),
   launches of #1-#4 per forward asserted from the template (a quiet
   fallback from #3 to its chain fails the run), each gated like the llama
   paths against the same entry point on the plain oracles. Then one bf16
   run over ``VISION`` (decode tok/s, TTFT, peak memory, the pool's bytes
   per token and the image K/V's bytes per slot) and its decode window
   under the profiler, device ms per step split by op group
   (``vision_split``), and the bf16 image prefill of ``VISION_IMAGE``
   under the profiler (host ms, device ms by kernel);
13. musicgen-medium — #1 at the audio model's merged QKV (G 3, K 1536 ->
   3 x 1536 at rank 736), merged gate-up (G 2, -> 2 x 6144 at rank 1184)
   and w_down (6144 -> 1536 at rank 1184) at M 8 and 256; #2 and #3 at
   its decode shape (B 8, 24 query heads over 24 kv heads: G 1, D 64, K
   1536, pages of 64) over 4 and 32 table entries, each against its
   plain version beside its library call (#3 also beside its unfused
   chain), f32 and bf16. Then the model at full width, cut to 2 of its
   48 layers (``DEPTH``; d 1536, 4 codebooks of 2048; the reference's
   llama-style block)
   at 1.0 bpw, weights drawn on the card, under ``MUSICGEN``: 8 requests
   of 17-200 prompt frames of 4 codebook ids (about 0.3-4 s of audio at
   EnCodec's 50 frames per second), 32 new frames each, on the paths
   ``musicgen-medium`` (megakernel on: #1 and #3) and
   ``musicgen-medium-unfused`` (#1 and #2), launches of #1-#4 per forward
   asserted from the template, each gated against the plain-oracle engine
   frame for frame (a divergence must fall at a plain-path near-tie of
   every codebook that differs). Then one bf16 run (decode frames/s and
   codebook tokens/s, TTFT, peak memory, the pool's bytes per token,
   exactly layers x 2 x 24 x 64 x 2) and its decode window under the profiler,
   device ms per step split by op group (``audio_split``) beside the host
   ms per step, and the device's busy share of the decode steps;
14. the seconds each phase took, the ``kernels`` JSON line (launches per
   serving path, each path's counts set to 0 just before its f32 run;
   ``chaos`` counts its kernel legs; ``restart`` launches in its child
   processes and is not counted), then the ``ok`` JSON line.

Details go to ``chiprun_out/chip_smoke.json``.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
SEED = 0
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_S = 67e12            # H100 SXM f32 outside the tensor cores
BF16_TC_FLOPS_S = 989e12       # H100 SXM bf16 tensor cores, dense: the rate
# the exact ±1 bf16 factors of kernels #1 and #4 allow, in both dtypes
TOL = {"f32": 1e-5, "bf16": 3e-2}
LOGITS_TOL = 1e-4
SLEEP_CYCLES = 20_000_000     # ~10 ms: holds the card while one timed call queues
L2_FLUSH_BYTES = 64 << 20     # past the H100's 50 MB L2
LONG_PAGES = 32               # table entries per slot of the long-context rows
PROFILE_MARGIN_S = 0.5        # idle host time at a profiled window's ends

# (name, source, TPU kernel it replaces); the order of the kernels line
KERNELS = (
    ("fused_lowrank_matmul_grouped", "src/repro_torch/csrc/binary_matmul.cu",
     "src/repro/kernels/binary_matmul.py:183"),
    ("paged_decode_attention", "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:117"),
    ("decode_step_megakernel_raw", "src/repro_torch/csrc/megakernel.cu",
     "src/repro/kernels/megakernel.py:195"),
    ("packed_matmul", "src/repro_torch/csrc/packed_matmul.cu",
     "src/repro/kernels/binary_matmul.py:78"),
)
FUSED, PAGED, MEGA, PACKED = range(4)

# traffic per model: prompt lengths drawn in [lo, hi), `up_front`
# submitted at once and the rest after `after` engine steps
LLAMA = {"arch": "llama3.2-1b", "n": 8, "lens": (17, 201), "up_front": 5,
         "after": 8, "new": 32, "max_batch": 8, "max_len": 256}
QWEN = {"arch": "qwen1.5-110b", "n": 4, "lens": (16, 65), "up_front": 2,
        "after": 3, "new": 16, "max_batch": 4, "max_len": 128}
# prefix-cache traffic, made to drive the index's edge cases (no published
# mix): one `system`-token prompt (2 pages) shared by all requests.
# Request 0 is it plus 64 tokens (page-aligned), request 6 an exact copy of
# request 0 (a full cover: its last page copied on write, one token
# re-prefilled), request 7 the system prompt alone (a full cover of 2
# pages); the other tails, 63 and 65 tokens among them (page off-by-ones),
# come from a generator of their own, at most 96 tokens so that each
# request has room for its 32 new tokens.
PREFIX = {"arch": "llama3.2-1b", "n": 8, "system": 128, "up_front": 5,
          "after": 8, "new": 32, "max_batch": 8, "max_len": 256,
          "tails": (64, 63, 65), "tail_lens": (1, 97)}
# the same requests on an overcommitted pool of 12 pages (31 in use at the
# peak without sharing, 18 with it): admissions evict the index's unmapped
# pages and decode preempts slots
PREFIX_PRESSURE = dict(PREFIX, kv_pool_pages=12)
# a published shared-prefix mix: the `generated-shared-prefix` dataset of
# SGLang's python/sglang/bench_serving.py at its defaults (per group one
# 2048-token system prompt, 16 prompts of it plus a 128-token question,
# 256 output tokens; 64 groups), cut to one group and 32 output tokens:
# 16 requests over 8 slots, max_len 2240 (35 pages). bf16 runs only.
GSP = {"arch": "llama3.2-1b", "n": 16, "system": 2048, "question": 128,
       "up_front": 8, "after": 8, "new": 32, "max_batch": 8,
       "max_len": 2240}
# GSP on a pool of 64 pages: one slot's 35 without sharing, all eight
# slots' 56 with it
GSP_TIGHT = dict(GSP, kv_pool_pages=64)

# qwen3-4b (dense, per-head qk_norm, which rules out the megakernel) under
# the llama traffic; qwen3-moe-235b-a22b (128 experts, top-8) under the
# qwen1.5-110b traffic
QWEN3 = dict(LLAMA, arch="qwen3-4b")
QWEN3_MOE = dict(QWEN, arch="qwen3-moe-235b-a22b")
# deepseek-v2-lite-16b (MLA, 64 experts top-6 plus 2 shared, the first
# layer dense) under the llama traffic: up to 4 pages of 64 latent rows per
# slot, prefills of up to 256 tokens (expert capacity 8 to 32)
DEEPSEEK = dict(LLAMA, arch="deepseek-v2-lite-16b")
# mamba2-370m (SSM: 48 Mamba2 blocks over a per-slot recurrent state, no
# attention) under the llama traffic with prompts of up to 520 tokens, so
# that about half of the admissions cross the 256-token SSD chunk; the
# state does not grow with max_len
MAMBA = dict(LLAMA, arch="mamba2-370m", lens=(17, 521), max_len=560)
# zamba2-1.2b (hybrid: 38 Mamba2 blocks, one shared attention block after
# every 6th over a ring-paged sliding-window pool) under the llama traffic:
# the 4096-row window clamps to max_len 256, a ring of 4 pages per slot
# that never wraps
ZAMBA = dict(LLAMA, arch="zamba2-1.2b")
# how a long-context zamba2 user meets the window: a document just under
# 4096 tokens, then a reply that runs past it. The ring is min(4224, 4096)
# = 4096 rows (64 pages); each request's 127 decode steps write positions
# n .. n + 126, so even a 4000-token prompt writes 31 positions at 4096
# and beyond, onto its oldest rows, while the window still masks them
ZAMBA_WRAP = {"arch": "zamba2-1.2b", "n": 4, "lens": (4000, 4081),
              "up_front": 4, "after": 0, "new": 128, "max_batch": 4,
              "max_len": 4224}

# llama-3.2-vision-90b (VLM: groups of 4 self-attention blocks, each
# followed by one gated cross-attention block over per-slot image K/V)
# under the qwen1.5-110b traffic. A request carries no image, as in the
# reference's engine, so every cross layer reads zero image K/V
VISION = dict(QWEN, arch="llama-3.2-vision-90b")
# the VLM's image entry point: ``generate`` of `n` prompts of `prompt`
# tokens, each with its own 1024 patch embeddings drawn from the seed, and
# `new` new tokens: the image K/V projection runs #1 at M = n x 1024
VISION_IMAGE = {"arch": "llama-3.2-vision-90b", "n": 4, "prompt": 32,
                "new": 8}
# musicgen-medium (audio: the dense block over frames of 4 codebook ids)
# under the llama traffic: prompts of 17-200 frames, about 0.3-4 s of audio
# at EnCodec's 50 frames per second (arXiv:2306.05284), 32 new frames
MUSICGEN = dict(LLAMA, arch="musicgen-medium")
# depth cuts that keep the script inside its time limit with the quantize
# phases, on a slow host too (halved again when the VLM's quantization came
# in, and the VLM's and qwen3-moe's halved once more when the
# tensor-parallel phases came in; qwen1.5-110b 5 -> 4 when the
# rectangular KV cache's phase came in). The TP phases of the audio and
# MoE families (43-53 s on an NVIDIA H100 80GB HBM3 at 700 W, started
# as one group of ranks since) were paid for by llama3.2-1b 4 -> 1,
# qwen1.5-110b 4 -> 2, qwen3-4b 9 -> 4, qwen3-moe 3 -> 2, deepseek 3 -> 2
# (its dense layer and one MoE layer), mamba2 4 -> 2 and musicgen 4 -> 2,
# with QUANT_DEPTH's musicgen and mamba2 2 -> 1 (PERF.md
# lists the seconds each saved). The TP phases of the SSM, hybrid and VLM
# families, joining that start of two ranks, added 3.0 s to it (27.8 s
# against 24.8 s on that card) and needed no cut. The layers each model
# is served at (width untouched; every other model at full depth)
DEPTH = {"llama3.2-1b": 1, "qwen1.5-110b": 2, "qwen3-4b": 4,
         "qwen3-moe-235b-a22b": 2, "llama-3.2-vision-90b": 5,
         "deepseek-v2-lite-16b": 2, "mamba2-370m": 2, "zamba2-1.2b": 6,
         "musicgen-medium": 2}

# the quantization pipeline on the card: llama3.2-1b at full width in its
# config's dtype (bf16), calibrated on `samples` sequences of `seq` tokens
# (the paper's 128 x 2048 cut to 16 x 256), QuantConfig() at its defaults;
# the artifact is served in f32 under 4 requests of the llama traffic
QUANT = {"arch": "llama3.2-1b", "samples": 16, "seq": 256}
QUANT_SERVE = dict(LLAMA, n=4, up_front=2)
# the depths quantized, each at full width (width untouched), cut to keep
# the script inside its time limit (llama3.2-1b, mamba2 and deepseek
# halved again when the tensor-parallel phases came in, so that a slow
# host keeps inside it too; musicgen and mamba2 2 -> 1 when the audio and
# MoE families' TP phases came in): llama3.2-1b 2 of its 16 layers (the
# trainer's teacher too: at 1 layer its loss did not fall in 150 steps,
# 12.1699 -> 12.2061), musicgen 1 of its 48 layers (frames of 4
# codebooks), mamba2 1 of 48, deepseek its dense layer and 1 MoE layer of
# 27 (every
# block kind once, the second on the first's quantized outputs),
# zamba2 7 of its 38 Mamba2 layers (one application of the shared block
# after layer 5, the drill's crash after it), llama-3.2-vision-90b 2 of its
# 100 layers (one self block, then the cross block: a block takes ≈ 58 s
# on an NVIDIA H100 80GB HBM3 at 700 W, so one group of its published 5
# would not fit the script); each artifact served in f32 under 4 requests
# of its family's traffic
QUANT_DEPTH = {"llama3.2-1b": 2, "musicgen-medium": 1, "mamba2-370m": 1,
               "deepseek-v2-lite-16b": 2, "zamba2-1.2b": 7,
               "llama-3.2-vision-90b": 2}
MUSICGEN_QUANT_SERVE = dict(MUSICGEN, n=4, up_front=2)
MAMBA_QUANT_SERVE = dict(MAMBA, n=4, up_front=2)
DEEPSEEK_QUANT_SERVE = dict(DEEPSEEK, n=4, up_front=2)
ZAMBA_QUANT_SERVE = dict(ZAMBA, n=4, up_front=2)
VISION_QUANT_SERVE = dict(VISION, n=4, up_front=2)
QUANT_SERVES = {"llama3.2-1b": QUANT_SERVE,
                "musicgen-medium": MUSICGEN_QUANT_SERVE,
                "mamba2-370m": MAMBA_QUANT_SERVE,
                "deepseek-v2-lite-16b": DEEPSEEK_QUANT_SERVE,
                "zamba2-1.2b": ZAMBA_QUANT_SERVE,
                "llama-3.2-vision-90b": VISION_QUANT_SERVE}
# the crash-safe pipeline's drill: the arch quantized with its journal on,
# crashed when block `crash_at` starts (zamba2's Mamba2 layer 6, the first
# block after the shared block's first application, so that the resume
# replays the reloaded shared block in the stream) and resumed. The MoE
# stays out: its dispatch's index_add_ sums in no fixed order on the card
DRILL = {"arch": "zamba2-1.2b", "crash_at": 7}
# the trainer on the card (phase 2a): llama3.2-1b at full width, cut to its
# QUANT_DEPTH, in its config's bf16 with f32 AdamW moments, under the
# quantize CLI's teacher recipe (TrainConfig(lr=1e-3, warmup=20,
# total_steps=150), `batch` sequences of QUANT["seq"] tokens a step). The
# drill checkpoints every `ckpt_every` steps, crashes at `crash_at` and
# resumes from the checkpoint before it; an uninterrupted run with no
# checkpoints gives the state the resumed run must equal bit for bit and
# the step times (the first `first_steps` apart). Its step-150 checkpoint is
# the teacher that phase 2b quantizes
TRAIN = {"arch": "llama3.2-1b", "steps": 150, "batch": 8, "ckpt_every": 50,
         "crash_at": 120, "first_steps": 3}
# ``python -m repro_torch.launch.train`` at the published config: all 16
# layers, remat on, loss_chunk 2048, and sdpa_flash at train_4k's length
TRAIN_CLI = ["--arch", "llama3.2-1b", "--steps", "3", "--batch", "1",
             "--seq", "4096", "--log-every", "1"]
TRAIN_CLI_TIMEOUT_S = 600
# sdpa_flash against the plain sdpa at that length: one llama3.2-1b layer's
# attention (32 query heads over 8 K/V heads, D 64) in f32
FLASH = {"S": 4096, "Hq": 32, "Hkv": 8, "D": 64}
# ``python -m repro_torch.launch.quantize`` with the teacher flags at smoke
# size, twice over one --teacher-ckpt directory (the pipeline's budget cut)
QUANT_CLI = ["--arch", "llama3.2-1b", "--teacher-steps", "20",
             "--calib-samples", "4", "--calib-seq", "32", "--admm-iters", "4",
             "--t-pre", "2", "--t-post", "2", "--t-glob", "2"]
QUANT_CLI_TIMEOUT_S = 300
# the autograd check's shape: llama3.2-1b's w_gate at M = 4 x 256 rows
AUTOGRAD = {"M": 1024, "K": 2048, "R": 1600, "N": 8192}
# the two-call route's (#4 twice) under the same Function: the VLM's FFN
# w_gate (K 8192 -> N 28672 at the 1.0 bpw rank 6336, past #1's 4096) at
# a KD step's M = 4 x 256 rows
TWOCALL_AUTOGRAD = {"M": 1024, "K": 8192, "R": 6336, "N": 28672}

# self-speculative decoding: the draft reads half of every packed rank
SPEC = {"spec_rank_frac": 0.5, "spec_k": 4}

# the JAX package's chaos benchmark (benchmarks/serve_bench.py run_chaos and
# build_trace, through repro_torch.testing) at llama3.2-1b's serving size:
# 24 requests from SEED + 44 (its chaos_seed offset), Poisson(0.6) arrival
# gaps in engine steps, prompts of 4-128 tokens (up to half of max_len, the
# reference's ratio), budgets of 2-32 new tokens, submitted by arrival step;
# 8 slots of max_len 256 over a pool of half their rectangle (64 pages of
# 16 rows); full-rank speculative decoding at a pinned k = 4, the prefix
# cache and the megakernel on, the pool audited after every tick. The plan
# is the reference's 11 faults (every kind), its dry-pool borrow a quarter
# of the pool as the reference's 3 of 12.
CHAOS = {"arch": "llama3.2-1b", "n": 24, "max_prompt": 128, "new": 32,
         "max_batch": 8, "max_len": 256, "page_size": 16,
         "kv_pool_pages": 64, "dry_pages": 16}
# process-level crash recovery: the llama3.2-1b artifact served by
# ``python -m repro_torch.launch.serve`` under its supervisor, crashing once
RESTART = ["--requests", "8", "--prompt-len", "64", "--max-new", "32",
           "--max-batch", "8", "--snapshot-every", "4",
           "--heartbeat-every", "1", "--crash-at-step", "6", "--supervise",
           "--hang-timeout", "120"]
RESTART_TIMEOUT_S = 600
# the serving CLI without an artifact on the card: ``python -m
# repro_torch.launch.serve --arch`` quantizes the arch's smoke teacher (the
# reference CLI's demo) or, with ``--fp``, serves that FP teacher
SERVE_DEMO = ["--arch", "llama-3.2-vision-90b", "--requests", "4",
              "--prompt-len", "16", "--max-new", "8", "--max-batch", "4"]
SERVE_DEMO_TIMEOUT_S = 300

# serving paths: (name, traffic, KernelPolicy fields, ServeConfig.megakernel,
# speculative settings, the path whose tokens gate it (None: the engine on
# the plain oracles), kernels that must launch, kernels that must not)
PATHS = (
    ("megakernel", LLAMA, {}, True, None, None, (FUSED, MEGA), ()),
    ("unfused", LLAMA, {}, False, None, None, (FUSED, PAGED), ()),
    ("twocall", LLAMA, {"fused": False}, None, None, None, (PACKED, PAGED),
     (FUSED, MEGA)),
    ("spec", LLAMA, {}, True, SPEC, "megakernel", (FUSED, PAGED, MEGA), ()),
    ("prefix", PREFIX, {}, True, None, None, (FUSED, PAGED, MEGA),
     (PACKED,)),
    ("prefix-pressure", PREFIX_PRESSURE, {}, True, None, None,
     (FUSED, PAGED, MEGA), (PACKED,)),
    ("qwen1.5-110b", QWEN, {}, None, None, None, (FUSED, PAGED, PACKED),
     (MEGA,)),
    ("qwen1.5-110b-spec", QWEN, {}, None, SPEC, "qwen1.5-110b",
     (FUSED, PAGED, PACKED), (MEGA,)),
    ("qwen3-4b", QWEN3, {}, None, None, None, (FUSED, PAGED), (MEGA, PACKED)),
    ("qwen3-moe-235b-a22b", QWEN3_MOE, {}, None, None, None, (FUSED, PAGED),
     (MEGA, PACKED)),
    ("deepseek-v2-lite-16b", DEEPSEEK, {}, None, None, None, (FUSED,),
     (PAGED, MEGA, PACKED)),
    ("mamba2-370m", MAMBA, {}, None, None, None, (FUSED,),
     (PAGED, MEGA, PACKED)),
    ("zamba2-1.2b", ZAMBA, {}, None, None, None, (FUSED, MEGA),
     (PAGED, PACKED)),
    ("zamba2-1.2b-unfused", ZAMBA, {}, False, None, None, (FUSED, PAGED),
     (MEGA, PACKED)),
    ("zamba2-1.2b-wrap", ZAMBA_WRAP, {}, None, None, None, (FUSED, MEGA),
     (PAGED, PACKED)),
    ("llama-3.2-vision-90b", VISION, {}, None, None, None,
     (FUSED, MEGA, PACKED), (PAGED,)),
    ("musicgen-medium", MUSICGEN, {}, True, None, None, (FUSED, MEGA),
     (PAGED, PACKED)),
    ("musicgen-medium-unfused", MUSICGEN, {}, False, None, None,
     (FUSED, PAGED), (MEGA, PACKED)),
    ("llama3.2-1b-quantized", QUANT_SERVE, {}, True, None, None,
     (FUSED, MEGA), (PACKED,)),
    ("musicgen-medium-quantized", MUSICGEN_QUANT_SERVE, {}, True, None, None,
     (FUSED, MEGA), (PAGED, PACKED)),
    ("mamba2-370m-quantized", MAMBA_QUANT_SERVE, {}, None, None, None,
     (FUSED,), (PAGED, MEGA, PACKED)),
    ("deepseek-v2-lite-16b-quantized", DEEPSEEK_QUANT_SERVE, {}, None, None,
     None, (FUSED,), (PAGED, MEGA, PACKED)),
    ("zamba2-1.2b-quantized", ZAMBA_QUANT_SERVE, {}, None, None, None,
     (FUSED, MEGA), (PAGED, PACKED)),
    ("llama-3.2-vision-90b-quantized", VISION_QUANT_SERVE, {}, None, None,
     None, (FUSED, MEGA, PACKED), (PAGED,)),
)

# tensor-parallel phases: (phase, arch, ranks, [(path, traffic, speculative
# settings, the unsharded path whose tokens gate it)]); every rank on the
# one card, over gloo. Each runs once its unsharded paths have run; the
# MoE phases are expert-parallel (E / N experts per rank) and gated by
# ``moe_gate`` against their unsharded path's router log; the SSM and
# hybrid phases split each Mamba2 mixer by SSD head; the VLM's phase also
# holds one forward with ``VISION_IMAGE``'s images to the unsharded one
TP_PHASES = (
    ("qwen1.5-110b-tp2", "qwen1.5-110b", 2,
     [("qwen1.5-110b-tp2", QWEN, None, "qwen1.5-110b")]),
    ("llama3.2-1b-tp4", "llama3.2-1b", 4,
     [("llama3.2-1b-tp4", LLAMA, None, "megakernel"),
      ("llama3.2-1b-tp4-spec", LLAMA, SPEC, "spec")]),
    ("qwen3-moe-235b-a22b-tp2", "qwen3-moe-235b-a22b", 2,
     [("qwen3-moe-235b-a22b-tp2", QWEN3_MOE, None, "qwen3-moe-235b-a22b")]),
    ("deepseek-v2-lite-16b-tp2", "deepseek-v2-lite-16b", 2,
     [("deepseek-v2-lite-16b-tp2", DEEPSEEK, None, "deepseek-v2-lite-16b")]),
    ("musicgen-medium-tp2", "musicgen-medium", 2,
     [("musicgen-medium-tp2", MUSICGEN, None, "musicgen-medium")]),
    ("mamba2-370m-tp2", "mamba2-370m", 2,
     [("mamba2-370m-tp2", MAMBA, None, "mamba2-370m")]),
    ("zamba2-1.2b-tp2", "zamba2-1.2b", 2,
     [("zamba2-1.2b-tp2", ZAMBA, None, "zamba2-1.2b")]),
    ("llama-3.2-vision-90b-tp2", "llama-3.2-vision-90b", 2,
     [("llama-3.2-vision-90b-tp2", VISION, None, "llama-3.2-vision-90b")]),
)
TOKENS = {}                      # path -> its f32 greedy tokens
# the VLM's plain-path forward of VISION_IMAGE's prompts with their images:
# (its last-position f32 logits, per row the top-2 margin and tolerance)
IMAGE_LOGITS = {}
ROUTER_LOGS = {}                 # MoE path -> its router log (moe_gate's)
# the rectangular KV cache's phase: llama3.2-1b under LLAMA, on the engine
# and generate with ServeConfig(paged=False)
RECT = "llama3.2-1b-rect"

# the kernels' names in a profiler trace, and the lm head's matmul
TRACE_NAMES = ((FUSED, "fused_lowrank_kernel"),
               (PAGED, "paged_attention_kernel"), (MEGA, "megakernel"),
               (PACKED, "packed_matmul_kernel"))
GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")


def log(msg):
    print(msg, flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    report = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    phases, t_phase = {}, [t_start]

    def phase(name):                  # seconds of each phase, for the report
        now = time.perf_counter()
        phases[name] = now - t_phase[0]
        t_phase[0] = now

    from repro_torch.kernels import build
    secs = build.build_all()
    log(f"build: {secs:.1f} s (nvcc, sm_90a, {len(build.SOURCES)} sources "
        f"in parallel)")
    report["build_s"] = secs
    phase("build")

    launches = {}                     # path -> launches of each kernel
    # the trainer first (it opens no profiler session), then the
    # quantization phase, whose KD step's profile is the process's first
    # profiler session, on the teacher it trained
    report[f"{TRAIN['arch']}-train"], teacher_ckpt = train_path(launches,
                                                                smi)
    phase(f"{TRAIN['arch']} train (drill and uninterrupted run)")
    autograd = check_autograd()
    report["llama3.2-1b-quantize"], artifact = quantize_path(
        "llama3.2-1b", launches, QUANT_DEPTH["llama3.2-1b"],
        teacher_ckpt=teacher_ckpt)
    shutil.rmtree(os.path.dirname(teacher_ckpt), ignore_errors=True)
    phase("llama3.2-1b quantize")
    report["llama3.2-1b-quantized"] = quantize_serve(
        "llama3.2-1b", artifact, launches)
    phase("llama3.2-1b quantized artifact f32 engine path")
    expert_autograd = check_autograd(expert=True)
    phase("#1's expert autograd Function at deepseek's grid")
    twocall_autograd = check_autograd(twocall=True)
    phase("#4 under the autograd Function at the VLM's FFN")
    for arch, depth in QUANT_DEPTH.items():
        if arch == QUANT["arch"]:
            continue
        report[f"{arch}-quantize"], artifact = quantize_path(
            arch, launches, depth)
        phase(f"{arch} quantize")
        if arch == DRILL["arch"]:
            report[f"{arch}-quantize-drill"] = quantize_drill(
                arch, depth, report[f"{arch}-quantize"], launches)
            phase(f"{arch} quantize drill (crash, resume, refusals)")
        report[f"{arch}-quantized"] = quantize_serve(arch, artifact,
                                                     launches)
        phase(f"{arch} quantized artifact f32 engine path")
    report["serve-demo"] = serve_demo_paths()
    phase("launch.serve demo quantization and --fp")
    report["launch-train"] = train_cli_path(smi)
    phase("launch.train at the full config and sdpa_flash at S 4096")
    report["launch-quantize-teacher"] = quantize_cli_path(smi)
    phase("launch.quantize --teacher-steps / --teacher-ckpt, twice")

    llama = make_llama()
    lines = check_llama_kernels(llama, report)
    lines[FUSED]["autograd"] = autograd
    lines[FUSED]["expert_autograd"] = expert_autograd
    phase("llama3.2-1b kernels")
    report["llama3.2-1b"] = serve_paths(llama, LLAMA, launches)
    report["llama3.2-1b-prefix"] = serve_paths(llama, PREFIX, launches)
    report["llama3.2-1b-prefix-pressure"] = serve_paths(
        llama, PREFIX_PRESSURE, launches)
    phase("llama3.2-1b f32 engine paths")
    report["llama3.2-1b-chaos"] = chaos_path(llama, launches)
    phase("llama3.2-1b f32 chaos path")
    report["llama3.2-1b-restart"] = restart_path(llama)
    phase("llama3.2-1b restart path")
    report[RECT] = rect_path(llama, launches)
    phase(f"{RECT}: f32 engine and generate on the rectangle")
    llama = cast(llama, torch.bfloat16)
    cmp = spec_compare(llama, LLAMA, report)
    report["llama3.2-1b"]["spec_bf16"] = cmp
    report["llama3.2-1b"]["bf16"] = cmp["runs"]["plain"][0]
    report["llama3.2-1b"]["bf16_profile"] = profile_engine(
        llama, LLAMA, report["llama3.2-1b"]["bf16"]["wall_s"])
    phase("llama3.2-1b bf16 runs and profiles")
    report[RECT]["bf16"] = rect_compare(llama, LLAMA, report)
    phase(f"{RECT}: bf16 rectangle against the pool")
    report["llama3.2-1b-prefix"]["bf16"] = prefix_compare(llama, PREFIX,
                                                          report)
    phase("llama3.2-1b bf16 prefix runs and profiles")
    report["llama3.2-1b-gsp"] = {
        "bf16": prefix_compare(llama, GSP, report),
        "bf16_tight": {kind: prefix_run(llama, GSP_TIGHT, report,
                                        kind == "on")
                       for kind in ("on", "off")}}
    del llama
    free()
    phase("llama3.2-1b bf16 shared-prefix (SGLang mix) runs and profiles")

    qwen = make_on_card("qwen1.5-110b")
    lines[PACKED] = check_qwen_kernels(qwen, report)
    lines[PACKED]["autograd"] = twocall_autograd
    phase("qwen1.5-110b kernels")
    report["qwen1.5-110b"] = serve_paths(qwen, QWEN, launches)
    phase("qwen1.5-110b f32 engine paths")
    qwen = cast(qwen, torch.bfloat16)
    free()
    cmp = spec_compare(qwen, QWEN, report)
    report["qwen1.5-110b"]["spec_bf16"] = cmp
    report["qwen1.5-110b"]["bf16"] = cmp["runs"]["plain"][0]
    report["qwen1.5-110b"]["bf16_decode_profile"] = cmp["decode_profile"][
        "plain"]
    del qwen
    free()
    phase("qwen1.5-110b bf16 runs and profiles")

    def tp_phases():
        # the TP phases whose unsharded paths have run, those of one size
        # in one start of their ranks
        todo = [p for p in TP_PHASES if p[0] not in report
                and all(v in TOKENS for *_, v in p[3])]
        for n in sorted({p[2] for p in todo}):
            group = [(name, arch, runs) for name, arch, k, runs in todo
                     if k == n]
            report.update(tp_phase(group, n, launches))
            phase(f"{', '.join(g[0] for g in group)}: tensor-parallel "
                  f"serving, {n} ranks on one card")
    tp_phases()

    qwen3 = make_on_card("qwen3-4b")
    report["qwen3-4b"] = serve_paths(qwen3, QWEN3, launches)
    phase("qwen3-4b f32 engine path")
    qwen3 = cast(qwen3, torch.bfloat16)
    free()
    report["qwen3-4b"]["bf16"] = bf16_run(qwen3, QWEN3, report)
    del qwen3
    free()
    phase("qwen3-4b bf16 run")

    moe = make_on_card("qwen3-moe-235b-a22b")
    line = check_expert_grid(moe, report)
    # the grid one rank of qwen3-moe-235b-a22b-tp2 launches: its 64 experts
    line += check_expert_grid(moe, report, ms=(8,), groups=64,
                              key="moe_kernel_checks_rank_local")
    lines[FUSED]["expert_grid"] = [
        {k: r[k] for k in r if k in (
            "group", "G", "M", "K", "R", "N", "dtype", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share",
            "max_abs_err", "workspace_mib")} for r in line]
    phase("qwen3-moe-235b-a22b kernels")
    res = report["qwen3-moe-235b-a22b"] = serve_paths(moe, QWEN3_MOE,
                                                       launches)
    phase("qwen3-moe-235b-a22b f32 engine path")
    moe = cast(moe, torch.bfloat16)
    free()
    res["bf16"] = bf16_run(moe, QWEN3_MOE, report)
    res["bf16_decode_profile"] = profile_decode(
        moe, QWEN3_MOE, [res["bf16"]["decode_step_ms"]])
    del moe
    free()
    phase("qwen3-moe-235b-a22b bf16 run and profile")

    ds = make_on_card("deepseek-v2-lite-16b")
    lines[FUSED]["deepseek"] = [
        {k: r[k] for k in r if k in (
            "group", "G", "M", "K", "R", "N", "dtype", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share",
            "max_abs_err")}
        for r in check_deepseek_kernels(ds, report) if r["dtype"] == "f32"]
    phase("deepseek-v2-lite-16b kernels")
    res = report["deepseek-v2-lite-16b"] = serve_paths(ds, DEEPSEEK, launches)
    phase("deepseek-v2-lite-16b f32 engine path")
    ds = cast(ds, torch.bfloat16)
    free()
    res["bf16"] = bf16_run(ds, DEEPSEEK, report)
    res["bf16"]["pool_bytes_per_token"] = pool_bytes_per_token(ds, DEEPSEEK)
    res["bf16_decode_profile"] = profile_decode(
        ds, DEEPSEEK, [res["bf16"]["decode_step_ms"]], split=deepseek_split)
    del ds
    free()
    phase("deepseek-v2-lite-16b bf16 run and profile")

    mamba = make_on_card("mamba2-370m")
    lines[FUSED]["mamba"] = [
        {k: r[k] for k in r if k in (
            "group", "G", "M", "K", "R", "N", "dtype", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share",
            "max_abs_err")}
        for r in check_mamba_kernels(mamba, report) if r["dtype"] == "f32"]
    phase("mamba2-370m kernels")
    res = report["mamba2-370m"] = serve_paths(mamba, MAMBA, launches)
    phase("mamba2-370m f32 engine path")
    mamba = cast(mamba, torch.bfloat16)
    free()
    res["bf16"] = bf16_run(mamba, MAMBA, report)
    res["bf16"]["state_bytes_per_slot"] = state_bytes_per_slot(mamba, MAMBA)
    res["bf16_decode_profile"] = profile_decode(
        mamba, MAMBA, [res["bf16"]["decode_step_ms"]], split=mamba_split)
    del mamba
    free()
    phase("mamba2-370m bf16 run and profile")

    zamba = make_on_card("zamba2-1.2b")
    rows = check_zamba_kernels(zamba, report)
    lines[FUSED]["zamba"] = [
        {k: r[k] for k in r if k in (
            "group", "G", "M", "K", "R", "N", "dtype", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share",
            "max_abs_err")}
        for r in rows if r["kernel"] == "fused_lowrank_matmul_grouped"
        and r["dtype"] == "f32"]
    for i, kern in ((PAGED, "paged_decode_attention"),
                    (MEGA, "decode_step_megakernel_raw")):
        lines[i]["ring"] = [
            {k: r[k] for k in r if k in (
                "model", "B", "pages", "G", "D", "window", "wrapped",
                "dtype", "ms", "plain_ms", "library_ms", "chain_ms",
                "bound_ms", "bound_by", "bound_share", "max_abs_err")}
            for r in rows if r["kernel"] == kern]
    phase("zamba2-1.2b kernels")
    res = report["zamba2-1.2b"] = serve_paths(zamba, ZAMBA, launches)
    report["zamba2-1.2b-wrap"] = serve_paths(zamba, ZAMBA_WRAP, launches)
    phase("zamba2-1.2b f32 engine paths")
    zamba = cast(zamba, torch.bfloat16)
    free()
    res["bf16"] = bf16_run(zamba, ZAMBA, report)
    res["bf16"].update(hybrid_bytes(zamba, ZAMBA))
    res["bf16_decode_profile"] = profile_decode(
        zamba, ZAMBA, [res["bf16"]["decode_step_ms"]], split=zamba_split)
    del zamba
    free()
    phase("zamba2-1.2b bf16 run and profile")

    vision = make_on_card("llama-3.2-vision-90b")
    rows = check_vision_kernels(vision, report)
    keep = ("model", "group", "stage", "B", "pages", "G", "D", "M", "K", "R",
            "N", "dtype", "ms", "plain_ms", "library_ms", "chain_ms",
            "cold_l2_ms", "bound_ms", "bound_by", "bound_share",
            "max_abs_err")
    for i, kern in ((FUSED, "fused_lowrank_matmul_grouped"),
                    (MEGA, "decode_step_megakernel_raw"),
                    (PACKED, "packed_matmul")):
        lines[i]["vision"] = [{k: r[k] for k in r if k in keep} for r in rows
                              if r["kernel"] == kern]
    phase("llama-3.2-vision-90b kernels")
    res = report["llama-3.2-vision-90b"] = serve_paths(vision, VISION,
                                                        launches)
    report["llama-3.2-vision-90b-image"] = vision_image_path(vision,
                                                             launches)
    phase("llama-3.2-vision-90b f32 engine and generate paths")
    vision = cast(vision, torch.bfloat16)
    free()
    res["bf16"] = bf16_run(vision, VISION, report)
    res["bf16"].update(vision_bytes(vision, VISION))
    res["bf16_decode_profile"] = profile_decode(
        vision, VISION, [res["bf16"]["decode_step_ms"]], split=vision_split)
    report["llama-3.2-vision-90b-image"]["bf16_prefill"] = \
        profile_image_prefill(vision)
    del vision
    free()
    phase("llama-3.2-vision-90b bf16 runs and profiles")

    mg = make_on_card("musicgen-medium")
    rows = check_musicgen_kernels(mg, report)
    for i, kern in ((FUSED, "fused_lowrank_matmul_grouped"),
                    (PAGED, "paged_decode_attention"),
                    (MEGA, "decode_step_megakernel_raw")):
        lines[i]["musicgen"] = [{k: r[k] for k in r if k in keep}
                                for r in rows if r["kernel"] == kern]
    phase("musicgen-medium kernels")
    res = report["musicgen-medium"] = serve_paths(mg, MUSICGEN, launches)
    phase("musicgen-medium f32 engine paths")
    mg = cast(mg, torch.bfloat16)
    free()
    res["bf16"] = bf16_run(mg, MUSICGEN, report)
    res["bf16"].update(audio_bytes(mg, MUSICGEN))
    res["bf16_decode_profile"] = profile_decode(
        mg, MUSICGEN, [res["bf16"]["decode_step_ms"]], split=audio_split,
        tail=embed_probe(mg))
    audio_summary(res, mg.cfg, report)
    del mg
    free()
    phase("musicgen-medium bf16 run and profile")
    tp_phases()


    kernels = []
    for i, (name, source, replaces) in enumerate(KERNELS):
        rec = lines[i]
        by_path = {p: n[i] for p, n in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": rec["max_abs_err"], "max_err": rec["rel_err"],
            "ms": rec["ms"], "kernel_ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": {k: rec[k] for k in rec if k in
                      ("model", "group", "stage", "G", "M", "K", "R", "N",
                       "B", "pages", "dtype")},
            **{k: rec[k] for k in ("instruction", "plan", "bound_share",
                                   "chain_ms", "cold_l2_ms", "long_context",
                                   "ring", "vision", "musicgen", "autograd",
                                   "expert_autograd")
               if k in rec}})
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - t_start
    report["phase_s"] = phases
    log("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phases.items()))
    log(f"script: {report['script_s']:.1f} s on {smi}")

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# models, timing, comparison
# ---------------------------------------------------------------------------


_LLAMA_TREE = {}                 # the host draw, made once per process


def llama_tree():
    """llama3.2-1b's packed tree at its :data:`DEPTH` (numpy), drawn on the
    host from the seed the first time it is asked for."""
    if "tree" not in _LLAMA_TREE:
        from repro_torch.configs import get_config
        from repro_torch.quant.surgery import abstract_quantized_params
        from repro_torch.testing import random_packed_params
        cfg = dataclasses.replace(get_config("llama3.2-1b"), dtype="float32",
                                  n_layers=DEPTH["llama3.2-1b"])
        _LLAMA_TREE["tree"] = random_packed_params(
            abstract_quantized_params(cfg, 1.0), SEED)
    return _LLAMA_TREE["tree"]


def make_llama(tree_file=None):
    """llama3.2-1b at 1.0 bpw in f32 at its :data:`DEPTH`, packed words and
    scales drawn on the host from the seed (≈ 10 s, once per process), or
    read from `tree_file`, a pickle of that draw (the TP ranks read the
    parent's: the same weights, without four more draws)."""
    import torch
    from repro_torch.api import NanoQuantModel
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3.2-1b"), dtype="float32",
                              n_layers=DEPTH["llama3.2-1b"])
    if tree_file is not None:
        with open(tree_file, "rb") as f:
            tree = pickle.load(f)
    else:
        tree = llama_tree()
    return NanoQuantModel.from_numpy(tree, cfg, device="cuda",
                                     dtype=torch.float32,
                                     quant={"target_bpw": 1.0, "min_dim": 48})


def make_on_card(arch):
    """`arch` at full width, 1.0 bpw, in f32, every leaf drawn on the card
    from the seed, at full depth or at its :data:`DEPTH` (qwen1.5-110b at
    full depth: 13.5 GB of packed words and 10 GB of f32 embedding and lm
    head; qwen3-moe-235b-a22b: 26.5 GiB of packed words, its routers
    f32)."""
    import torch
    from repro_torch.api import NanoQuantModel
    from repro_torch.configs import get_config
    from repro_torch.quant.surgery import abstract_quantized_params
    from repro_torch.testing import random_packed_params_device
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if arch in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tree = random_packed_params_device(abstract_quantized_params(cfg, 1.0),
                                       SEED, "cuda")
    torch.cuda.synchronize()
    log(f"{arch} f32 weights drawn on the card ({cfg.n_layers} layers): "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB in "
        f"{time.perf_counter() - t0:.3f} s")
    return NanoQuantModel(tree, cfg)


def cast(model, dtype):
    """The same model with its FP leaves cast to `dtype` (packed words and
    scales shared, not copied); the caller drops the f32 model."""
    from repro_torch.api import NanoQuantModel
    from repro_torch.convert import params_from_numpy
    name = str(dtype).removeprefix("torch.")
    return NanoQuantModel(params_from_numpy(model.params, model.device, dtype),
                          dataclasses.replace(model.cfg, dtype=name))


def free():
    """Release what dropped engines and models held: an engine and its
    request handles refer to each other, so only the cycle collector
    frees an engine's merged weights."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, reps=21, warmup=3, flush=None):
    """Median device time of one fn() call over `reps` calls, in ms. Before
    each call the card is held busy (``torch.cuda._sleep``) until the host
    has enqueued the call and its pair of events, so the events bracket
    device work only and not the host's launch overhead. A sample whose
    enqueueing outlasted the sleep is retaken with a sleep twice as long.
    One call at a time: a longer queue fills the card's launch queue and
    blocks the host. ``flush`` (a tensor) is overwritten on the card after
    the sleep and before the first event, so each call finds L2 cold."""
    import torch
    for _ in range(warmup):
        fn()
    times, cycles = [], SLEEP_CYCLES
    while len(times) < reps:
        start, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        if flush is not None:
            flush.zero_()
        a.record()
        fn()
        b.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        sleep_ms = start.elapsed_time(a)
        if enqueue_ms > sleep_ms:
            if cycles >= 16 * SLEEP_CYCLES:
                raise AssertionError(f"timing: enqueueing took {enqueue_ms:.2f}"
                                     f" ms, longer than the {sleep_ms:.2f} ms "
                                     f"sleep")
            cycles *= 2
            continue
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare(what, want, got, tol):
    """Relative max-abs error (scale max(1, max|want|)); raises past tol."""
    import torch
    assert want.shape == got.shape, (what, want.shape, got.shape)
    a, b = want.float(), got.float()
    if not torch.isfinite(b).all():
        raise AssertionError(f"{what}: kernel output not finite")
    abs_err = float((a - b).abs().max())
    rel = abs_err / max(1.0, float(a.abs().max()))
    if rel > tol:
        raise AssertionError(f"{what}: rel err {rel:.3e} > {tol}")
    return abs_err, rel


def bound(bytes_moved, *work):
    """Least device time (ms) of a function that must move `bytes_moved`
    and do the operations of `work`, (flops, the peak rate of the unit
    they run on) pairs, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = sum(flops / rate for flops, rate in work)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def lowrank_cost(K, dims, M):
    """Packed-weight bytes and f32 operations of M rows through low-rank
    binary linears of input width K and (rank, d_out) ``dims``, counting
    each linear at its own rank and output width: the padding that a
    merged group adds (rank up to the widest, masked by ``rmask``; output
    up to the widest, s1 = 0) is work the function does not need."""
    w_bytes = sum(4 * (K // 32 * r + -(-r // 32) * n + n + K)
                  for r, n in dims)
    flops = sum(2.0 * M * (K * r + r * n) for r, n in dims)
    return w_bytes, flops


def _timed(rec, kern, plain, library):
    rec.update(ms=time_ms(kern), plain_ms=time_ms(plain),
               library_ms=None if library is None else time_ms(library))
    return rec


def _dtypes():
    import torch
    return (("f32", torch.float32), ("bf16", torch.bfloat16))


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def layer0(model, stack="layers"):
    """Layer 0 of `stack` (its views) with its merged QKV / gate-up groups
    added."""
    from repro_torch.models.transformer import split_layers
    from repro_torch.quant.surgery import merge_projection_groups
    return merge_projection_groups(split_layers(model.params)[stack][0])


def check_llama_kernels(model, report):
    """#1 at every llama3.2-1b shape, #2 and #3 at its decode shape;
    returns the kernels line's records (#4 comes with qwen1.5-110b)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lp = layer0(model)
    cfg = model.cfg
    rows = check_fused(lp, ("qkv", "wo", "gate_up", "down"), (1, 8, 512), gen,
                       "llama3.2-1b")
    line = {FUSED: next(r for r in rows if (r["group"], r["M"], r["dtype"])
                        == ("gate_up", 8, "f32"))}
    for dt, tdt in _dtypes():
        case = _paged_case(cfg, tdt, gen, B=8, pages=4)
        rec = _check_paged(case, cfg, dt, "llama3.2-1b")
        rows.append(rec)
        if dt == "f32":
            line[PAGED] = rec
        rec = _check_mega(case, lp, cfg, dt)
        rows.append(rec)
        if dt == "f32":
            line[MEGA] = rec
    # long context: 32 entries per slot, from generators of their own so
    # that the rows above see the same data as before these rows existed
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for dt, tdt in _dtypes():
        case = _paged_case(cfg, tdt, gen, B=8, pages=LONG_PAGES,
                           seed=SEED + 4, min_mapped=LONG_PAGES // 2)
        for i, rec in ((PAGED, _check_paged(case, cfg, dt, "llama3.2-1b")),
                       (MEGA, _check_mega(case, lp, cfg, dt))):
            rows.append(rec)
            if dt == "f32":
                line[i]["long_context"] = {
                    k: rec[k] for k in rec if k in (
                        "pages", "dtype", "ms", "plain_ms", "library_ms",
                        "chain_ms", "cold_l2_ms", "bound_ms", "bound_by",
                        "bound_share", "max_abs_err")}
    report["kernel_checks"] = rows
    # the speculative path's shapes, from a generator of their own: #1's
    # merged QKV at the verify's M = B·(k+1), #3 on the draft view, #2 as
    # the verify reads it (k+1 queries over a pool with stale rows)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    s = SPEC["spec_k"] + 1
    spec_rows = check_fused(lp, ("qkv",), (LLAMA["max_batch"] * s,), gen,
                            "llama3.2-1b")
    for dt, tdt in _dtypes():
        case = _paged_case(cfg, tdt, gen, B=8, pages=4, seed=SEED + 6)
        spec_rows.append(_check_mega(case, lp, cfg, dt, eff=(
            _draft_rank(lp["attn"]["wqkv"]), _draft_rank(lp["attn"]["wo"]))))
        spec_rows.append(_check_paged_verify(case, cfg, dt, s))
    report["spec_kernel_checks"] = spec_rows
    return line


def _draft_rank(p):
    """The rank the draft reads of packed linear (or group) ``p``."""
    from repro_torch.quant.surgery import truncated_rank
    return truncated_rank(p["qv"].shape[-1], SPEC["spec_rank_frac"])


def check_fused(lp, names, ms, gen, model_name):
    """Kernel #1 on layer ``lp``'s packed groups ``names`` at each M."""
    import torch
    from repro_torch.kernels import binary_matmul, ref
    members = {"qkv": ("attn", "wqkv", ("wq", "wk", "wv")),
               "wo": ("attn", "wo", ("wo",)),
               "w_kr": ("attn", "w_kr", ("w_kr",)),
               "w_dkv": ("attn", "w_dkv", ("w_dkv",)),
               "gate_up": ("ffn", "wgu", ("w_gate", "w_up")),
               "down": ("ffn", "w_down", ("w_down",)),
               "wz": ("mixer", "wz", ("wz",)),
               "wB": ("mixer", "wB", ("wB",)),
               "wdt": ("mixer", "wdt", ("wdt",)),
               "out_proj": ("mixer", "out_proj", ("out_proj",)),
               "image_wk": ("xattn", "wk", ("wk",)),
               "cross_wq": ("xattn", "wq", ("wq",))}
    rows = []
    for name in names:
        blk, key, lins = members[name]
        g = lp[blk][key] if len(lins) > 1 else _group(lp[blk][key])
        G, KW, R = g["qv"].shape
        N = g["qu_t"].shape[-1]
        dims = [_dims(lp, nm) for nm in lins]
        for dt, tdt in _dtypes():
            V = torch.stack([ref.unpack_signs(w) for w in g["qv"]]).to(tdt)
            U = torch.stack([ref.unpack_signs(w) for w in g["qu_t"]]).to(tdt)
            s2, s1 = g["s2"][:, None].to(tdt), g["s1"][:, None].to(tdt)
            rm = g["rmask"][:, None].to(tdt)
            for m in ms:
                x = torch.randn((1, m, KW * 32), generator=gen, device="cuda"
                                ).to(tdt)
                args = (x, g["qv"], g["qu_t"], g["s1"], g["s2"], g["rmask"])

                def kern():
                    return binary_matmul.fused_lowrank_matmul_grouped(
                        *args, x_shared=True)

                def plain():
                    return binary_matmul.fused_lowrank_matmul_grouped_ref(
                        *args, x_shared=True)

                def library():
                    return torch.matmul(torch.matmul(x * s2, V) * rm, U) * s1
                abs_err, rel = compare(f"fused_lowrank {model_name} {name} "
                                       f"M={m} {dt}", plain(), kern(), TOL[dt])
                rec = _timed({"kernel": "fused_lowrank_matmul_grouped",
                              "model": model_name, "group": name, "G": G,
                              "M": m, "K": KW * 32, "R": R, "N": N,
                              "dtype": dt, "max_abs_err": abs_err,
                              "rel_err": rel}, kern, plain, library)
                w_bytes, flops = lowrank_cost(KW * 32, dims, m)
                io = nbytes(x) + sum(m * n for _, n in dims) * x.element_size()
                rec["bound_ms"], rec["bound_by"] = bound(
                    w_bytes + io, (flops, BF16_TC_FLOPS_S))
                _tensor_core_row(
                    rec, binary_matmul.fused_lowrank_matmul_grouped.plan)
                rows.append(rec)
                log(f"kernel fused_lowrank {model_name} {name:8s} M={m:<4d} "
                    f"{dt:4s} rel_err={rel:.2e} ms={rec['ms']:.4f} "
                    f"plain_ms={rec['plain_ms']:.4f} "
                    f"library_ms={rec['library_ms']:.4f} "
                    f"bound_ms={rec['bound_ms']:.5f} "
                    f"({100 * rec['bound_share']:.1f}% of it) "
                    f"slices={rec['plan']['slices']} "
                    f"grid={rec['plan']['grid']}")
            del V, U
    return rows


# the two packed_matmul launches of each qwen1.5-110b MLP linear
# (``lowrank_binary_matmul_twocall``): stage 1 reads qv with s_k = s2,
# stage 2 reads qu_t with s_n = s1
STAGES = (("gate_up.1", "w_gate", "qv"), ("gate_up.2", "w_gate", "qu_t"),
          ("down.1", "w_down", "qv"), ("down.2", "w_down", "qu_t"))


def check_qwen_kernels(model, report):
    """#4 at the four qwen1.5-110b two-call stage shapes (M in {1, 8, 64})
    and on an eff_rank view (R' = 4096 of 6976, read in place); #1 at the
    merged-QKV and wo shapes (rank 4064); #2 at head_dim 128, G 8.
    Returns the kernels line's record of #4 (w_down stage 1, M = 8, f32)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lp = layer0(model)
    rows = []
    for stage, lin, leaf in STAGES:
        p = lp["ffn"][lin]
        sk, sn = (p["s2"], None) if leaf == "qv" else (None, p["s1"])
        for m in (1, 8, 64):
            for dt, tdt in _dtypes():
                rows.append(_check_packed(stage, p[leaf], sk, sn, m, dt, tdt,
                                          gen))
    p = lp["ffn"]["w_gate"]
    view = p["qv"][:, :4096]
    for dt, tdt in _dtypes():
        rows.append(_check_packed("gate_up.1 eff_rank 4096", view, p["s2"],
                                  None, 8, dt, tdt, gen))
    rows += check_fused(lp, ("qkv", "wo"), (1, 8, 64), gen, "qwen1.5-110b")
    for dt, tdt in _dtypes():
        rows.append(_check_paged(_paged_case(model.cfg, tdt, gen, B=4,
                                             pages=2),
                                 model.cfg, dt, "qwen1.5-110b"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for dt, tdt in _dtypes():               # long context, own generators
        rows.append(_check_paged(
            _paged_case(model.cfg, tdt, gen, B=4, pages=LONG_PAGES,
                        seed=SEED + 5, min_mapped=LONG_PAGES // 2),
            model.cfg, dt, "qwen1.5-110b"))
    report["qwen_kernel_checks"] = rows
    # the speculative path's shapes: #4's two launches of the draft's
    # gate (rank 3488 of 6976, read in place) at M = B; #1's merged QKV at
    # the verify's M = B·(k+1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    p = lp["ffn"]["w_gate"]
    rp = _draft_rank(p)
    spec_rows = []
    for stage, w, sk, sn in ((f"gate_up.1 eff_rank {rp}", p["qv"][:, :rp],
                              p["s2"], None),
                             (f"gate_up.2 eff_rank {rp}",
                              p["qu_t"][:rp // 32], None, p["s1"])):
        for dt, tdt in _dtypes():
            spec_rows.append(_check_packed(stage, w, sk, sn,
                                           QWEN["max_batch"], dt, tdt, gen))
    spec_rows += check_fused(lp, ("qkv",),
                             (QWEN["max_batch"] * (SPEC["spec_k"] + 1),), gen,
                             "qwen1.5-110b")
    report["spec_kernel_checks"] += spec_rows
    del lp
    free()
    return next(r for r in rows if r.get("stage") == "down.1"
                and (r["M"], r["dtype"]) == (8, "f32"))


# kernel #1 at qwen3-moe-235b-a22b's expert grid: (row name, expert linear)
# at M = 8, the capacity of a decode step of 4 slots and of a prefill of up
# to 64 tokens (ceil(T·8/128·1.25) rounded up to 8, at least 8), and M = 40,
# a 256-token prefill's; w_up has w_gate's shape
EXPERT_ROWS = (("gate_up", "w_gate"), ("down", "w_down"))
EXPERT_MS = (8, 40)


def check_expert_grid(model, report, ms=EXPERT_MS, seed=SEED + 10,
                      key="moe_kernel_checks", groups=None):
    """#1 with the expert axis as its group axis (G = n_experts, x per
    group; with `groups`, the first `groups` experts, a tensor-parallel
    rank's block) at layer 0's expert stacks, at each M of `ms`, f32 and
    bf16, against its plain version; the yardstick is the batched form of
    the merged rows' library call over unpacked bf16 factors. The rows go
    to ``report[key]``; returns the f32 M = 8 rows for the kernels line."""
    import torch
    from repro_torch.kernels import binary_matmul, ref
    from repro_torch.models.transformer import split_layers
    gen = torch.Generator(device="cuda").manual_seed(seed)
    moe = split_layers(model.params)["layers"][0]["moe"]
    arch = model.cfg.name
    rows = []
    for group, lin in EXPERT_ROWS:
        p = moe[lin]
        if groups is not None:
            p = {k: v[:groups].contiguous() for k, v in p.items()}
        G, KW, R = p["qv"].shape
        K, N = KW * 32, p["qu_t"].shape[-1]
        args = (p["qv"], p["qu_t"], p["s1"], p["s2"])
        for dt, tdt in _dtypes():
            V = ref.unpack_signs(p["qv"], tdt)               # (G, K, R)
            U = ref.unpack_signs(p["qu_t"], tdt)             # (G, R, N)
            s2, s1 = p["s2"][:, None].to(tdt), p["s1"][:, None].to(tdt)
            for m in ms:
                x = torch.randn((G, m, K), generator=gen, device="cuda"
                                ).to(tdt)

                def kern():
                    return binary_matmul.fused_lowrank_matmul_grouped(
                        x, *args, x_shared=False)

                def plain():
                    return binary_matmul.fused_lowrank_matmul_grouped_ref(
                        x, *args, x_shared=False)

                def library():
                    return torch.bmm(torch.bmm(x * s2, V), U) * s1
                abs_err, rel = compare(f"fused_lowrank expert grid {group} "
                                       f"M={m} {dt}", plain(), kern(),
                                       TOL[dt])
                rec = _timed({"kernel": "fused_lowrank_matmul_grouped",
                              "model": arch, "group": group,
                              "G": G, "M": m, "K": K, "R": R, "N": N,
                              "x_shared": False, "dtype": dt,
                              "max_abs_err": abs_err, "rel_err": rel}, kern,
                             plain, library)
                w_bytes = nbytes(*args)
                io = nbytes(x) + G * m * N * x.element_size()
                rec["bound_ms"], rec["bound_by"] = bound(
                    w_bytes + io,
                    (2.0 * G * m * (K * R + R * N), BF16_TC_FLOPS_S))
                _tensor_core_row(
                    rec, binary_matmul.fused_lowrank_matmul_grouped.plan)
                rec["workspace_mib"] = rec["plan"]["workspace_bytes"] / 2**20
                rows.append(rec)
                log(f"kernel fused_lowrank {arch} expert grid {group:7s} "
                    f"G={G} M={m:<3d} {dt:4s} rel_err={rel:.2e} "
                    f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                    f"library_ms={rec['library_ms']:.4f} "
                    f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}; "
                    f"{100 * rec['bound_share']:.1f}% of it) "
                    f"slices={rec['plan']['slices']} "
                    f"grid={rec['plan']['grid']} workspace "
                    f"{rec['workspace_mib']:.1f} MiB")
            del V, U
            free()
    report[key] = rows
    return [r for r in rows if (r["M"], r["dtype"]) == (8, "f32")]


def check_deepseek_kernels(model, report):
    """#1 at deepseek-v2-lite-16b's shapes against its plain version, f32
    and bf16: the attention's w_kr (N 64 at rank 32, below one 128-column
    tile in both stages) and w_dkv (N 512 at rank 384) at M 8, timed
    beside ``torch.matmul`` over the unpacked factors, and the expert grid
    (G = 64, x per group, rank 800) at M 8, the capacity of a decode step
    of 8 slots and of a prefill of up to 64 tokens, and M 32, a 256-token
    prefill's. Returns every row."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = check_fused(layer0(model), ("w_kr", "w_dkv"), (8,), gen,
                       model.cfg.name)
    key = "deepseek_kernel_checks"
    check_expert_grid(model, report, ms=(8, 32), seed=SEED + 12, key=key)
    report[key] = rows + report[key]
    free()
    return report[key]


def check_mamba_kernels(model, report):
    """#1 at mamba2-370m's mixer shapes against its plain version, f32 and
    bf16, at M 8 (a decode step of 8 slots) and M 256 (one SSD chunk of
    prefill): wz (K 1024 -> N 2048, rank 640; wx has the same shape), wB
    (-> 128 at rank 96, a partial tile of the rank stage; wC the same)
    and out_proj (K 2048 -> 1024, rank 640), timed beside
    ``torch.matmul`` over the unpacked factors. Returns every row."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = check_fused(layer0(model), ("wz", "wB", "out_proj"), (8, 256),
                       gen, model.cfg.name)
    report["mamba_kernel_checks"] = rows
    free()
    return rows


def rank_shard(cfg, lp, n=2, rank=0):
    """Rank `rank`'s shards of one layer's params `lp` (no leading axes)
    over a (1, n) serving mesh, as ``place_on_mesh`` cuts them for the
    tensor-parallel phases (no process group: placement needs none)."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.quant.surgery import place_on_mesh
    mesh = Mesh(("data", "model"), (1, n), {"data": 0, "model": rank}, None,
                torch.device("cuda"), "gloo")
    return place_on_mesh({"layers": lp}, cfg, mesh)["layers"]


def check_zamba_kernels(model, report):
    """#1 at zamba2-1.2b's mixer shapes against its plain version, f32 and
    bf16, at M 8 and 256: wz (K 2048 -> N 4096, rank 1344; wx has the same
    shape), wdt (-> 64 at rank 32: a partial tile in both stages, like
    deepseek's w_kr, with a K 32 times longer) and out_proj (K 4096 ->
    2048, rank 1344), timed beside ``torch.matmul`` over the unpacked
    factors. Then #2 and #3 at the shared block's decode shape (B 8, G 1,
    D 64, pages of 64, window 4096; #3 with the shared block's merged QKV
    and wo), over a ring-wrapped table of 64 entries (q_pos in [4096,
    4400), cache_pos = q_pos % 4096) and an unwrapped one of 4 entries,
    f32 and bf16. #1 also at one rank's shards of zamba2-1.2b-tp2 (wz on
    d_out 2048, out_proj on d_in 2048: 64 of 128 SSD heads) at M 8.
    Returns every row."""
    import torch
    from repro_torch.quant.surgery import merge_projection_groups
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    cfg = model.cfg
    rows = check_fused(layer0(model), ("wz", "wdt", "out_proj"), (8, 256),
                       gen, cfg.name)
    rows += check_fused(rank_shard(cfg, layer0(model)), ("wz", "out_proj"),
                        (8,), gen, f"{cfg.name} tp2 rank 0")
    lp = merge_projection_groups(model.params["shared_attn"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for dt, tdt in _dtypes():
        for case in (_ring_case(cfg, tdt, gen, B=8, pages=64),
                     _paged_case(cfg, tdt, gen, B=8, pages=4, seed=SEED + 15,
                                 window=cfg.sliding_window)):
            for rec in (_check_paged(case, cfg, dt, cfg.name),
                        _check_mega(case, lp, cfg, dt)):
                rec["wrapped"] = case["wrapped"]
                rows.append(rec)
    report["zamba_kernel_checks"] = rows
    del lp
    free()
    return rows


def check_vision_kernels(model, report):
    """#3 at llama-3.2-vision-90b's self-attention decode (B 4 and 8, 64
    query heads over 8 kv heads: G 8, D 128, K 8192, merged-QKV rank 4064,
    wo rank 4064, pages of 64 rows at 2 and 32 table entries, the last
    slot all-null) against its plain version, beside its unfused chain;
    #1 at the image K/V projection (the first cross layer's wk, K 8192 ->
    N 1024 at rank 864, at M = 4 images x 1024 patches = 4096) and at the
    cross block's wq (K 8192 -> 8192 at rank 4064) at the decode's M 4,
    beside ``torch.matmul`` over the unpacked factors; #4 at the four
    two-call stages of the first self block's FFN (rank 6336) at M 4, the
    decode's most frequent launches, and at one rank's shards of
    llama-3.2-vision-90b-tp2 (w_gate's qu_t on d_out 14336, w_down's qv on
    448 words of d_in). f32 and bf16. Returns every row."""
    import torch
    from repro_torch.models.transformer import split_layers
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    cfg = model.cfg
    lp = layer0(model, "self_layers")
    rows = []
    for dt, tdt in _dtypes():
        for B in (4, 8):
            for pages in (2, LONG_PAGES):
                case = _paged_case(cfg, tdt, gen, B=B, pages=pages,
                                   seed=SEED + 17)
                rows.append(_check_mega(case, lp, cfg, dt))
                del case
    free()
    cp = split_layers(model.params)["cross_layers"][0]
    m = VISION["max_batch"]
    rows += check_fused(cp, ("image_wk",),
                        (VISION_IMAGE["n"] * cfg.n_image_tokens,), gen,
                        cfg.name)
    rows += check_fused(cp, ("cross_wq",), (m,), gen, cfg.name)
    local = rank_shard(cfg, lp)
    for layer, model_name in ((lp, cfg.name),
                              (local, f"{cfg.name} tp2 rank 0")):
        for stage, lin, leaf in STAGES:
            p = layer["ffn"][lin]
            sk, sn = (p["s2"], None) if leaf == "qv" else (None, p["s1"])
            for dt, tdt in _dtypes():
                rows.append(_check_packed(stage, p[leaf], sk, sn, m, dt, tdt,
                                          gen, model_name))
    report["vision_kernel_checks"] = rows
    del lp, cp, local
    free()
    return rows


def check_musicgen_kernels(model, report):
    """#1 at musicgen-medium's groups against its plain version, f32 and
    bf16, at M 8 (a decode step of 8 slots) and M 256 (a prefill bucket):
    the merged QKV (G 3, K 1536 -> 3 x 1536, rank 736), the merged gate-up
    (G 2, -> 2 x 6144, rank 1184) and w_down (K 6144 -> 1536, rank 1184),
    timed beside ``torch.matmul`` over the unpacked factors. Then #2 and #3
    at its decode shape (B 8, 24 query heads over 24 kv heads: G 1, D 64,
    K 1536; #3 with layer 0's merged QKV and wo) over 4 and 32 table
    entries of 64-row pages, f32 and bf16. Returns every row."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    cfg = model.cfg
    lp = layer0(model)
    rows = check_fused(lp, ("qkv", "gate_up", "down"), (8, 256), gen,
                       cfg.name)
    for dt, tdt in _dtypes():
        for pages in (4, LONG_PAGES):
            case = _paged_case(cfg, tdt, gen, B=MUSICGEN["max_batch"],
                               pages=pages, seed=SEED + 22)
            rows += [_check_paged(case, cfg, dt, cfg.name),
                     _check_mega(case, lp, cfg, dt)]
            del case
    report["musicgen_kernel_checks"] = rows
    del lp
    free()
    return rows


def _check_packed(stage, w, sk, sn, m, dt, tdt, gen,
                  model_name="qwen1.5-110b"):
    import torch
    from repro_torch.kernels import binary_matmul, ref
    KW, N = w.shape
    K = KW * 32
    x = torch.randn((m, K), generator=gen, device="cuda").to(tdt)

    def kern():
        return binary_matmul.packed_matmul(x, w, sk, sn)

    def plain():
        return binary_matmul.packed_matmul_ref(x, w, sk, sn)
    abs_err, rel = compare(f"packed_matmul {stage} M={m} {dt}", plain(),
                           kern(), TOL[dt])
    W = ref.unpack_signs(w, tdt)          # the yardstick's pre-unpacked factor
    skt = None if sk is None else sk.to(tdt)
    snt = None if sn is None else sn.to(tdt)

    def library():
        y = torch.matmul(x if skt is None else x * skt, W)
        return y if snt is None else y * snt
    rec = _timed({"kernel": "packed_matmul", "model": model_name,
                  "stage": stage, "M": m, "K": K, "N": N, "dtype": dt,
                  "max_abs_err": abs_err, "rel_err": rel,
                  "contiguous": w.is_contiguous()}, kern, plain, library)
    del W
    scale_bytes = 4 * (K if sk is not None else 0) + 4 * (N if sn is not None
                                                          else 0)
    io = nbytes(x) + m * N * x.element_size() + scale_bytes
    rec["bound_ms"], rec["bound_by"] = bound(
        4 * KW * N + io, (2.0 * m * K * N, BF16_TC_FLOPS_S))
    _tensor_core_row(rec, binary_matmul.packed_matmul.plan)
    log(f"kernel packed_matmul {model_name} {stage:22s} M={m:<3d} {dt:4s} "
        f"rel_err={rel:.2e} ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.5f} "
        f"({rec['bound_by']}; {100 * rec['bound_share']:.1f}% of it) "
        f"ks={rec['plan']['ks']}")
    return rec


def _tensor_core_row(rec, plan):
    """What a row of kernel #1 or #4 adds: the instruction its ±1 products
    run on, the launch plan of the timed call and the achieved share of
    the bound."""
    from repro_torch.kernels import binary_matmul
    rec.update(instruction=binary_matmul.INSTRUCTION, plan=dict(plan),
               bound_share=rec["bound_ms"] / rec["ms"])


def _dims(lp, name, eff_rank=None):
    """(rank, d_out) of layer ``lp``'s unmerged packed linear ``name``,
    the rank capped at ``eff_rank`` when a view reads fewer columns."""
    p = next(lp[blk][name] for blk in ("attn", "ffn", "mixer", "xattn")
             if name in lp.get(blk, {}))
    r = int(p["qv"].shape[-1])
    return min(r, eff_rank or r), int(p["qu_t"].shape[-1])


def _group(p):
    import torch
    return {"qv": p["qv"][None], "qu_t": p["qu_t"][None],
            "s1": p["s1"][None].float(), "s2": p["s2"][None].float(),
            "rmask": torch.ones((1, p["qv"].shape[-1]), device="cuda")}


def _paged_case(cfg, tdt, gen, B, pages, seed=SEED + 1, min_mapped=1,
                window=0):
    """B slots over a pool of 64-row pages, `pages` per slot: ragged
    tables (min_mapped..pages mapped), null-page padding, the last slot
    all-null; cache_pos == q_pos (a linear cache), `window` the read's. A
    case of another seed than the default draws its queries and
    activations from `gen` too; the default's come from torch's global
    generator, as they always have."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    PS = 64
    n_pages = B * pages + 1
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    kp = torch.randn((n_pages, PS, hkv, hd), generator=gen, device="cuda"
                     ).to(tdt)
    vp = torch.randn((n_pages, PS, hkv, hd), generator=gen, device="cuda"
                     ).to(tdt)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, pages), np.int32)
    pos = np.zeros(B, np.int32)
    used = 0
    for b in range(B - 1):
        k = int(rng.integers(min_mapped, pages + 1))
        bt[b, :k] = perm[used:used + k]
        used += k
        pos[b] = int(rng.integers((k - 1) * PS, k * PS))
    pos = torch.from_numpy(pos).cuda()
    return {"k_pool": kp, "v_pool": vp,
            "block_table": torch.from_numpy(bt).cuda(), "pos": pos,
            "cache_pos": pos, "window": window, "wrapped": False,
            "valid_rows": int(_valid(pos, pos, pages * PS, window).sum()),
            "B": B, "pages": pages, "gen": None if seed == SEED + 1 else gen}


def _ring_case(cfg, tdt, gen, B, pages, seed=SEED + 16):
    """The hybrid's shared-attention decode over ring tables: B slots,
    each mapping a whole ring of `pages` 64-row pages (in a shuffled
    order), every one past its first wrap: q_pos in [rows, rows + 304),
    cache_pos = q_pos % rows, the window the config's."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    PS = 64
    rows = pages * PS
    n_pages = B * pages + 1
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    kp = torch.randn((n_pages, PS, hkv, hd), generator=gen, device="cuda"
                     ).to(tdt)
    vp = torch.randn((n_pages, PS, hkv, hd), generator=gen, device="cuda"
                     ).to(tdt)
    bt = rng.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(
        B, pages)
    pos = torch.from_numpy(rng.integers(rows, rows + 304, size=B
                                        ).astype(np.int32)).cuda()
    cpos = pos % rows
    window = cfg.sliding_window
    return {"k_pool": kp, "v_pool": vp,
            "block_table": torch.from_numpy(bt).cuda(), "pos": pos,
            "cache_pos": cpos, "window": window, "wrapped": True,
            "valid_rows": int(_valid(pos, cpos, rows, window).sum()),
            "B": B, "pages": pages, "gen": gen}


def _valid(q_pos, cache_pos, rows, window):
    """(B, rows) bool: the virtual rows each slot's query attends (the
    kernels' validity: row r holds position q_pos - (cache_pos - r) mod
    rows, valid when not negative and inside the window)."""
    import torch
    from repro_torch.kernels import paged_attention
    return paged_attention._row_valid(torch.arange(rows, device="cuda"),
                                      q_pos, cache_pos, rows, window, False)


def _walk_rate(dt):
    """The peak rate of the unit the page walk's arithmetic runs on: the
    tensor cores for a bf16 pool (at every shape these rows use: D 64 or
    128, 4 or 8 query heads per kv head, 64-row pages), the CUDA cores in
    f32."""
    return BF16_TC_FLOPS_S if dt == "bf16" else F32_FLOPS_S


def _randn(case, shape, dtype):
    import torch
    return torch.randn(shape, generator=case["gen"], device="cuda").to(dtype)


def _check_paged(case, cfg, dt, model_name):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention, ref
    B, hq, hkv, hd = case["B"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kp, vp = case["k_pool"], case["v_pool"]
    q = _randn(case, (B, 1, hq, hd), kp.dtype)
    bt, pos, cpos = case["block_table"], case["pos"], case["cache_pos"]
    scale, window = 1.0 / math.sqrt(hd), case["window"]
    args = (q, kp, vp, bt, pos, cpos)

    def kern():
        return paged_attention.paged_decode_attention(*args, window=window,
                                                      scale=scale)

    def plain():
        return ref.paged_attention_ref(*args, window=window, scale=scale)
    abs_err, rel = compare(f"paged_attention {model_name} {dt}", plain(),
                           kern(), TOL[dt])
    # yardstick: SDPA over the pages gathered beforehand, same mask
    rows = bt.shape[1] * kp.shape[1]
    kg = kp[bt.long()].reshape(B, rows, hkv, hd).transpose(1, 2)
    vg = vp[bt.long()].reshape(B, rows, hkv, hd).transpose(1, 2)
    mask = _valid(pos, cpos, rows, window)[:, None, None, :]
    qt = q.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    rec = _timed({"kernel": "paged_decode_attention", "model": model_name,
                  "B": B, "pages": bt.shape[1], "D": hd, "G": hq // hkv,
                  "window": window, "dtype": dt, "max_abs_err": abs_err,
                  "rel_err": rel}, kern, plain, library)
    kv_bytes = case["valid_rows"] * hkv * hd * 2 * kp.element_size()
    b = kv_bytes + 2 * nbytes(q) + nbytes(bt) + 2 * nbytes(pos)
    rec["bound_ms"], rec["bound_by"] = bound(
        b, (4.0 * hq * hd * case["valid_rows"], _walk_rate(dt)))
    rec.update(plan=dict(paged_attention.paged_decode_attention.plan),
               bound_share=rec["bound_ms"] / rec["ms"])
    log(f"kernel paged_attention {model_name} B={B} pages={bt.shape[1]} "
        f"D={hd} G={hq // hkv}"
        + (f" window={window}" if window else "")
        + (" ring-wrapped" if case.get("wrapped") else "")
        + f" {dt:4s} rel_err={rel:.2e} ms={rec['ms']:.4f} "
        f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.5f} ({100 * rec['bound_share']:.1f}% of "
        f"it) splits={rec['plan']['splits']}")
    return rec


def _check_paged_verify(case, cfg, dt, S):
    """#2 as the speculative verify reads it: S queries per slot through
    ``ops.paged_attention`` (S launches at shifted positions) over the
    case's pool, whose rows past each slot's frontier hold stale values;
    each slot's first query is placed so that its S rows lie in its
    mapped pages, and query j sees the rows of queries 0..j."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    B, hq, hkv, hd = case["B"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kp, vp, bt = case["k_pool"], case["v_pool"], case["block_table"]
    PS = kp.shape[1]
    room = ((bt != 0).sum(1) * PS - S).clamp(min=0)
    pos = torch.minimum(case["pos"].long(), room).to(torch.int32)
    q = _randn(case, (B, S, hq, hd), kp.dtype)
    scale = 1.0 / math.sqrt(hd)
    policy = kops.KernelPolicy(mode="cuda")

    def kern():
        return kops.paged_attention(q, kp, vp, bt, pos, pos, scale=scale,
                                    policy=policy)

    def plain():
        return ref.paged_attention_ref(q, kp, vp, bt, pos, pos, scale=scale)
    abs_err, rel = compare(f"paged_attention verify S={S} {dt}", plain(),
                           kern(), TOL[dt])
    # yardstick: SDPA over the pages gathered beforehand, each query's mask
    rows = bt.shape[1] * PS
    kg = kp[bt.long()].reshape(B, rows, hkv, hd).transpose(1, 2)
    vg = vp[bt.long()].reshape(B, rows, hkv, hd).transpose(1, 2)
    qpos = pos.long()[:, None] + torch.arange(S, device="cuda")
    mask = (torch.arange(rows, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]
    qt = q.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    rec = _timed({"kernel": "paged_decode_attention", "model": "llama3.2-1b",
                  "B": B, "S": S, "pages": bt.shape[1], "D": hd,
                  "G": hq // hkv, "dtype": dt, "max_abs_err": abs_err,
                  "rel_err": rel}, kern, plain, library)
    p = pos.long().cpu()
    read_rows = int((p + S).sum())                    # rows 0..pos+S-1
    seen_rows = int(sum((p + j + 1).sum() for j in range(S)))
    b = (read_rows * hkv * hd * 2 * kp.element_size() + 2 * nbytes(q)
         + nbytes(bt) + 2 * nbytes(pos))
    rec["bound_ms"], rec["bound_by"] = bound(
        b, (4.0 * hq * hd * seen_rows, _walk_rate(dt)))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"kernel paged_attention verify B={B} S={S} pages={bt.shape[1]} "
        f"{dt:4s} rel_err={rel:.2e} ms={rec['ms']:.4f} plain_ms="
        f"{rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.5f} ({100 * rec['bound_share']:.1f}% "
        f"of it; {S} launches)")
    return rec


def _check_mega(case, lp, cfg, dt, eff=None):
    """#3 at the case's shape; ``eff`` = (eff_rank, eff_rank_o) reads the
    draft view of the QKV group and of wo in place."""
    import torch
    from repro_torch.kernels import megakernel, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.models import layers
    B, hd = case["B"], cfg.head_dim
    kp, vp = case["k_pool"], case["v_pool"]
    x = _randn(case, (B, cfg.d_model), kp.dtype)
    mqkv, wo = lp["attn"]["wqkv"], lp["attn"]["wo"]
    bt, pos, cpos = case["block_table"], case["pos"], case["cache_pos"]
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    kw = dict(dims=(nq, nkv), head_dim=hd, theta=cfg.rope_theta,
              scale=1.0 / math.sqrt(hd), window=case["window"])
    if eff is not None:
        kw.update(eff_rank=eff[0], eff_rank_o=eff[1])
        mqkv, wo = {**mqkv, "eff_rank": eff[0]}, {**wo, "eff_rank": eff[1]}
    args = (x, mqkv, wo, kp, vp, bt, pos, cpos)

    def kern():
        return megakernel.decode_step_megakernel_raw(*args, **kw)

    def plain():
        return ref.decode_step_ref(*args, **kw)

    def chain():
        """The unfused chain the kernel replaces, at the same inputs (the
        engine's pool writes of the fresh k/v left out, as they are from
        the kernel): #1 qkv, RoPE, #2, #1 wo."""
        q, k, _ = layers.dense_merged(mqkv, x[:, None], (nq, nkv, nkv))
        q = layers.apply_rope(q.reshape(B, 1, cfg.n_heads, hd), pos[:, None],
                              cfg.rope_theta)
        layers.apply_rope(k.reshape(B, 1, cfg.n_kv_heads, hd), pos[:, None],
                          cfg.rope_theta)
        o = kops.paged_attention(q, kp, vp, bt, pos, cpos, scale=kw["scale"],
                                 window=kw["window"])
        return layers.dense(wo, o.reshape(B, 1, nq))
    got, want = kern(), plain()
    errs = [compare(f"megakernel pages={bt.shape[1]} eff_rank={eff} {nm} "
                    f"{dt}", w, g, TOL[dt])
            for nm, w, g in zip(("y", "k_new", "v_new"), want, got)]
    abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    rec = _timed({"kernel": "decode_step_megakernel_raw",
                  "model": cfg.name, "B": B, "pages": bt.shape[1],
                  "G": cfg.n_heads // cfg.n_kv_heads, "D": hd,
                  "window": kw["window"], "dtype": dt,
                  "max_abs_err": abs_err, "rel_err": rel,
                  **({} if eff is None else {"eff_rank": list(eff)})},
                 kern, plain, None)
    rec["plan"] = dict(megakernel.decode_step_megakernel_raw.plan)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rec["cold_l2_ms"] = time_ms(kern, flush=flush)
    rec["chain_ms"] = time_ms(chain)
    del flush
    K, Ko = mqkv["qv"].shape[1] * 32, wo["qv"].shape[0] * 32
    e_qkv, e_o = eff if eff is not None else (None, None)
    qkv_bytes, qkv_flops = lowrank_cost(
        K, [_dims(lp, nm, e_qkv) for nm in ("wq", "wk", "wv")], B)
    wo_bytes, wo_flops = lowrank_cost(Ko, [_dims(lp, "wo", e_o)], B)
    kv_bytes = case["valid_rows"] * nkv * 2 * kp.element_size()
    io = (nbytes(x, bt, pos) + B * cfg.d_model * x.element_size()
          + B * 2 * nkv * kp.element_size())
    rec["bound_ms"], rec["bound_by"] = bound(
        qkv_bytes + wo_bytes + kv_bytes + io,
        (qkv_flops + wo_flops, BF16_TC_FLOPS_S),
        (4.0 * cfg.n_heads * hd * case["valid_rows"], _walk_rate(dt)))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"kernel megakernel {cfg.name} B={B} pages={bt.shape[1]} "
        + (f"window={kw['window']} " if kw["window"] else "")
        + ("ring-wrapped " if case.get("wrapped") else "")
        + f"{'' if eff is None else f'eff_rank={eff} '}{dt:4s} rel_err="
        f"{rel:.2e} ms={rec['ms']:.4f} cold_l2_ms={rec['cold_l2_ms']:.4f} "
        f"chain_ms={rec['chain_ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}; "
        f"{100 * rec['bound_share']:.1f}% of it) grid={rec['plan']['grid']} "
        f"walk splits={rec['plan']['walk']['splits']}")
    return rec


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def _requests(cfg, traffic):
    import numpy as np
    if "max_prompt" in traffic:
        return [t[2] for t in _chaos_trace(cfg, traffic)]
    if "question" in traffic:
        return _gsp_requests(cfg, traffic)
    if "system" in traffic:
        return _prefix_requests(cfg, traffic)
    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(*traffic["lens"], size=traffic["n"])
    # the audio family's prompts are frames of one id per codebook
    frame = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    return [rng.integers(0, cfg.vocab_size, size=(int(n),) + frame
                         ).astype(np.int64) for n in lens]


def _prefix_requests(cfg, traffic):
    """The system prompt plus each request's tail (see ``PREFIX``)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 8)
    system = rng.integers(0, cfg.vocab_size, size=traffic["system"])
    n_drawn = traffic["n"] - len(traffic["tails"]) - 2
    tails = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in
             list(traffic["tails"])
             + list(rng.integers(*traffic["tail_lens"], size=n_drawn))]
    prompts = [np.concatenate([system, t]) for t in tails]
    prompts += [prompts[0].copy(), system.copy()]
    return [p.astype(np.int64) for p in prompts]


def _gsp_requests(cfg, traffic):
    """The system prompt plus a question of its own for each request (see
    ``GSP``)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 9)
    system = rng.integers(0, cfg.vocab_size, size=traffic["system"])
    return [np.concatenate([system, rng.integers(
        0, cfg.vocab_size, size=traffic["question"])]).astype(np.int64)
        for _ in range(traffic["n"])]


def _engine(model, traffic, policy, megakernel=None, spec=None,
            prefix_cache=True, mesh=None, paged=True):
    from repro_torch.serve.engine import ServeConfig
    return model.engine(ServeConfig(greedy=True, page_size=64,
                                    megakernel=megakernel, debug=True,
                                    prefix_cache=prefix_cache, paged=paged,
                                    kv_pool_pages=traffic.get(
                                        "kv_pool_pages")),
                        max_batch=traffic["max_batch"],
                        max_len=traffic["max_len"], policy=policy,
                        mesh=mesh, **(spec or {}))


def _submit(eng, prompts, uids, traffic):
    from repro_torch.serve.scheduler import Request
    for uid in uids:
        eng.submit(Request(uid, prompts[uid], max_new_tokens=traffic["new"]))


def serve(model, traffic, policy, megakernel=None, spec=None,
          prefix_cache=True, on_engine=None, mesh=None, engine=None,
          paged=True, prompts=None):
    """The traffic's requests (or `prompts`): `up_front` submitted at once,
    the rest after `after` engine steps (mid-flight admission);
    speculative with `spec` (ServeConfig fields); on the rectangle with
    ``paged=False``; `on_engine(eng)` runs before the first submission;
    `engine`: one built already by :func:`_engine` (the arguments that
    build one are then unused). Checks the drained pool: no slot maps a
    page, only the prefix index holds pages, every table row is zero, and
    clearing the index empties the pool. Returns (outputs, engine, wall
    seconds, the engine's stats before the clearing, with
    ``peak_used_pages``)."""
    eng = engine if engine is not None else _engine(
        model, traffic, policy, megakernel, spec, prefix_cache, mesh, paged)
    if on_engine is not None:
        on_engine(eng)
    if prompts is None:
        prompts = _requests(model.cfg, traffic)
    n, k = traffic["n"], traffic["up_front"]
    t0 = time.perf_counter()
    _submit(eng, prompts, range(k), traffic)
    for _ in range(traffic["after"]):
        eng.step()
    _submit(eng, prompts, range(k, n), traffic)
    done = eng.run()
    wall = time.perf_counter() - t0
    kv = eng.kv
    if sorted(done) != list(range(n)) or eng.active.any() \
            or eng.scheduler.pending:
        raise AssertionError("engine did not finish every request cleanly")
    for uid, r in done.items():
        if len(r.output) != traffic["new"]:
            raise AssertionError(f"request {uid}: {len(r.output)} tokens")
    if kv is None:                    # the rectangle or the state cache
        return {u: r.output for u, r in done.items()}, eng, wall, \
            dict(eng.stats)
    if kv.ref.any() or kv.used_pages != kv.cached_page_count \
            or any(t.any() for t in kv.tables.values()):
        raise AssertionError("engine did not release every page")
    st = dict(eng.stats, peak_used_pages=kv.peak_used_pages)
    if eng.prefix is not None:
        eng.prefix.clear()
    if kv.used_pages:
        raise AssertionError(f"{kv.used_pages} pages held after the prefix "
                             f"index was cleared")
    return {u: r.output for u, r in done.items()}, eng, wall, st


def _margin(model, prompt, prefix, image=None, books=None):
    """Top-2 logit margin and tolerance of the plain path at the step
    that produced the next token after `prefix` (teacher-forced). The
    VLM's forward reads `image` (1, n_img, d), or zeros: the image K/V an
    engine's request meets. The audio family's frame has one margin per
    codebook, each over that codebook's logits: of `books` (the codebooks
    whose ids differ), the one furthest from a near-tie is returned, with
    its index."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import KernelPolicy, kernel_policy
    from repro_torch.models import transformer as TT
    cfg = model.cfg
    toks = np.concatenate([prompt, np.asarray(prefix, np.int64)])[None]
    if cfg.family == "vlm" and image is None:
        image = torch.zeros((1, cfg.n_image_tokens, cfg.d_model),
                            dtype=TT.torch_dtype(cfg), device=model.device)
    with kernel_policy(KernelPolicy(mode="ref")), torch.inference_mode():
        lg = TT.forward(model.params, cfg,
                        torch.from_numpy(toks).to(model.device),
                        image)[0, -1]
    lg = lg.float().reshape(-1, lg.shape[-1])     # (1, V), or (K, V)
    top = torch.topk(lg, 2, dim=-1).values
    margins = (top[:, 0] - top[:, 1]).tolist()
    tols = [LOGITS_TOL * max(1.0, float(r.abs().max())) for r in lg]
    book = max(books if books is not None else range(len(margins)),
               key=lambda b: margins[b] / tols[b])
    return margins[book], tols[book], book


def gate(model, traffic, name, got, want, prompts=None, images=None):
    """Identical greedy tokens, or a first divergence at a near-tie of
    the plain path (top-2 margin below the logits tolerance). `prompts`
    default to the traffic's; `images` (B, n_img, d), the VLM's, one per
    prompt. An audio frame diverges at each codebook whose id differs,
    and each must be at a near-tie of that codebook's logits."""
    import numpy as np
    if prompts is None:
        prompts = _requests(model.cfg, traffic)
    audio = model.cfg.family == "audio"
    worst = None
    for uid in sorted(want):
        diff = [i for i, (a, b) in enumerate(zip(want[uid], got[uid]))
                if np.any(a != b)]
        if not diff:
            continue
        i = diff[0]
        books = list(np.nonzero(want[uid][i] != got[uid][i])[0]) \
            if audio else None
        margin, tol, book = _margin(model, prompts[uid], want[uid][:i],
                                    None if images is None
                                    else images[uid:uid + 1], books)
        log(f"engine {name}: request {uid} diverges at token {i}"
            + (f" (codebooks {books}; the widest margin at codebook {book})"
               if audio else "")
            + f": plain-path top-2 margin {margin:.3e} (tolerance "
            f"{tol:.3e})")
        if margin >= tol:
            raise AssertionError(f"engine {name}: request {uid} token {i} "
                                 f"differs at a margin past the tolerance")
        worst = max(worst or 0.0, margin)
    return worst


class _EngineLog:
    """What the MoE gate reads from one engine run: every router call's
    chosen experts, with, for each row, the request it serves and the index
    of the token its forward emits (None for an inactive slot's row; every
    row of an admission, its pad rows too, serves the admitted request:
    they all take expert capacity), and the boundary gap of the router's
    logits (k-th less (k+1)-th, over max(1, max|logit|)); with `margins`,
    also each emitted token's top-2 logit margin and tolerance. Used as a
    context (it wraps ``layers._route`` and ``engine.sample_token`` while
    open), its ``attach`` given to ``serve(on_engine=)``."""

    def __init__(self, margins=False):
        self.calls, self.margins, self.want_margins = [], {}, margins
        self.rows = None
        self._last = None

    def __enter__(self):
        import torch
        from repro_torch.models import layers
        from repro_torch.serve import engine as E
        self._saved = (layers._route, E.sample_token)
        route, sample = self._saved

        def logged_route(p, cfg, xf):
            out = route(p, cfg, xf)
            lg = layers._matmul_f32(xf.float(), p["router"]["w"].float())
            top = torch.topk(lg, cfg.n_experts_per_tok + 1, dim=-1).values
            gap = (top[:, -2] - top[:, -1]) / lg.abs().amax(-1).clamp_min(1)
            rows = self.rows
            owners = rows if isinstance(rows, list) else [rows] * xf.shape[0]
            self.calls.append((owners, out[1].sort(-1).values.cpu(),
                               gap.cpu()))
            return out

        def margin_sample(logits, generator, scfg):
            lf = logits[:, -1].float()
            top = torch.topk(lf, 2, dim=-1).values
            self._last = ((top[:, 0] - top[:, 1]).cpu(), (
                LOGITS_TOL * lf.abs().amax(-1).clamp_min(1.0)).cpu())
            return sample(logits, generator, scfg)
        layers._route = logged_route
        if self.want_margins:
            E.sample_token = margin_sample
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        from repro_torch.serve import engine as E
        layers._route, E.sample_token = self._saved

    def record(self):
        """What ``moe_gate`` reads of this log, as host arrays (picklable:
        a TP rank gates against it)."""
        import types
        return types.SimpleNamespace(
            calls=[(o, ti.numpy(), gap.numpy()) for o, ti, gap in self.calls],
            margins=dict(self.margins))

    @staticmethod
    def restore(rec):
        """A :meth:`record` as a log ``moe_gate`` reads."""
        import types
        import torch
        return types.SimpleNamespace(
            calls=[(o, torch.from_numpy(ti), torch.from_numpy(gap))
                   for o, ti, gap in rec.calls], margins=rec.margins)

    def attach(self, eng):
        from repro_torch.serve.engine import _Resume
        decode, admit, emit = eng._decode_tick, eng._admit_impl, eng._emit

        def decode_tick(finished):
            self.rows = [(t.handle.uid, len(t.toks))
                         if t is not None and eng.active[s] else None
                         for s, t in enumerate(eng._tasks)]
            return decode(finished)

        def admit_impl(slot, item):
            prior = item.emitted if isinstance(item, _Resume) else []
            self.rows = (eng._item_handle(item).uid, len(prior))
            return admit(slot, item)

        def logged_emit(slot, token):
            if self.want_margins:
                t = eng._tasks[slot]
                m, tol = self._last
                r = 0 if m.shape[0] == 1 else slot
                self.margins[t.handle.uid, len(t.toks)] = (float(m[r]),
                                                            float(tol[r]))
            return emit(slot, token)
        eng._decode_tick, eng._admit_impl = decode_tick, admit_impl
        eng._emit = logged_emit


def moe_gate(name, got, want, log_got, log_want):
    """The MoE path's f32 gate. An MoE's experts are chosen by the top-k of
    the router's logits, so a request's tokens may leave the plain path's
    at a near-tie of those logits as well as of the lm head's. Per request:
    the first router call whose chosen experts differ on one of its rows
    must be one where the plain path's k-th and (k+1)-th router logits are
    within the logits tolerance; tokens must be identical up to the token
    that call's forward emits, or else diverge first at a plain-path top-2
    logit margin below the logits tolerance. Router calls past a request's
    first divergence are consequences and not gated. Returns the near-ties
    that explained a divergence (None when nothing diverged)."""
    import torch
    if [c[0] for c in log_got.calls] != [c[0] for c in log_want.calls]:
        raise AssertionError(f"engine {name}: the two runs' schedules differ")
    first_tok = {}
    for uid in want:
        diff = [i for i, (a, b) in enumerate(zip(want[uid], got[uid]))
                if a != b]
        first_tok[uid] = diff[0] if diff else None
    first_route = {}
    for (owners, ti_g, _), (_, ti_w, gap) in zip(log_got.calls,
                                                 log_want.calls):
        for r in torch.nonzero((ti_g != ti_w).any(-1)).flatten().tolist():
            if owners[r] is not None and owners[r][0] not in first_route:
                first_route[owners[r][0]] = (owners[r][1], float(gap[r]))
    ties = []
    for uid in sorted(want):
        i, rt = first_tok[uid], first_route.get(uid)
        if rt is not None and (i is None or rt[0] <= i):
            tok, gap = rt
            log(f"engine {name}: request {uid} routes differently at the "
                f"forward of token {tok}: plain-path router boundary gap "
                f"{gap:.3e} (tolerance {LOGITS_TOL:.0e})"
                + ("" if i is None else f"; tokens diverge at {i}"))
            if gap >= LOGITS_TOL:
                raise AssertionError(f"engine {name}: request {uid} routes "
                                     f"differently past the tolerance")
            ties.append({"uid": uid, "router_gap": gap, "token": tok,
                         "diverges_at": i})
        elif i is not None:
            margin, tol = log_want.margins[uid, i]
            log(f"engine {name}: request {uid} diverges at token {i}: "
                f"plain-path top-2 margin {margin:.3e} (tolerance "
                f"{tol:.3e})")
            if margin >= tol:
                raise AssertionError(f"engine {name}: request {uid} token {i}"
                                     f" differs at a margin past the "
                                     f"tolerance")
            ties.append({"uid": uid, "logit_margin": margin,
                         "diverges_at": i})
    return ties or None


def _counters():
    from repro_torch.kernels import binary_matmul, megakernel, paged_attention
    return (binary_matmul.fused_lowrank_matmul_grouped,
            paged_attention.paged_decode_attention,
            megakernel.decode_step_megakernel_raw,
            binary_matmul.packed_matmul)


def _peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def serve_paths(model, traffic, launches):
    """The f32 engine on the plain oracles without prefix sharing, then
    each serving path of the traffic with every launch count set to 0 just
    before its run; each path's tokens are gated against the plain
    engine's (a speculative path's against its plain kernel path's) and
    its launches checked."""
    import contextlib
    import torch
    from repro_torch.kernels import binary_matmul
    from repro_torch.kernels.ops import KernelPolicy
    arch = traffic["arch"]
    cfg = model.cfg
    moe = cfg.family == "moe"
    oracle_log = _EngineLog(margins=True) if moe else None
    torch.cuda.reset_peak_memory_stats()
    with oracle_log or contextlib.nullcontext():
        want, eng, ref_wall, _ = serve(
            model, traffic, KernelPolicy(mode="ref"), prefix_cache=False,
            on_engine=oracle_log and oracle_log.attach)
    del eng
    free()
    res = {"ref_wall_s": ref_wall, "ref_peak_gib": _peak_gib()}
    log(f"engine {arch} f32 plain oracles, unshared: wall {ref_wall:.2f} "
        f"s, peak {res['ref_peak_gib']:.2f} GiB")
    counters = _counters()
    paths = [p for p in PATHS if p[1] is traffic]
    outs = {}
    prompts = _requests(cfg, traffic)
    for name, _, fields, mk, spec, versus, needed, forbidden in paths:
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        grid = binary_matmul.fused_lowrank_matmul_grouped.grid_launches
        grid.clear()
        # the MoE path's log keeps its token margins too: a TP path is
        # gated against it
        path_log = _EngineLog(margins=True) if moe else None
        with path_log or contextlib.nullcontext():
            got, eng, wall, st = serve(
                model, traffic, KernelPolicy(mode="cuda", **fields), mk,
                spec, on_engine=path_log and path_log.attach)
        launches[name] = [c.launches for c in counters]
        grid = dict(grid)
        outs[name] = TOKENS[name] = got
        if moe:
            ROUTER_LOGS[name] = path_log.record()
        acceptance = eng.spec.acceptance_rate() if spec else None
        ring_rows = eng.kv.ring_pages * eng.kv.page_size \
            if eng.kv is not None and eng.kv.has_ring else None
        del eng
        free()
        log(f"engine path {name}: launches " + ", ".join(
            f"{k[0]}={n}" for k, n in zip(KERNELS, launches[name])))
        missing = [KERNELS[i][0] for i in needed if launches[name][i] == 0]
        if missing:
            raise AssertionError(f"engine path {name}: {missing} never "
                                 f"launched")
        stray = [KERNELS[i][0] for i in forbidden if launches[name][i]]
        if stray:
            raise AssertionError(f"engine path {name}: {stray} launched")
        if moe:
            # every forward (an admission's prefill or a decode step) runs
            # each MoE layer's three expert linears as one launch of #1
            # over all the experts
            n_grid = grid.get((cfg.n_experts, False), 0)
            forwards = st["admissions"] + st["decode_steps"]
            n_moe = cfg.n_layers - cfg.first_k_dense
            if n_grid != 3 * n_moe * forwards:
                raise AssertionError(
                    f"engine path {name}: {n_grid} launches of #1 at the "
                    f"expert grid (G = {cfg.n_experts}, x per group), "
                    f"expected 3 x {n_moe} layers x {forwards} forwards")
            per_forward = len(_mla_positions(cfg)) if cfg.is_mla else None
            n_fused = launches[name][FUSED]
            if per_forward and n_fused != per_forward * forwards:
                raise AssertionError(
                    f"engine path {name}: {n_fused} launches of #1, "
                    f"expected {per_forward} x {forwards} forwards")
            near_ties = moe_gate(name, got, want, path_log, oracle_log)
            margin = None if near_ties is None else max(
                t.get("logit_margin", t.get("router_gap"))
                for t in near_ties)
        else:
            if cfg.family == "ssm":
                # five launches of #1 per Mamba2 block and forward (wz,
                # wx, wB, wC, out_proj; wdt stays FP), nothing else
                forwards = st["admissions"] + st["decode_steps"]
                per_forward = 5 * cfg.n_layers
                if launches[name][FUSED] != per_forward * forwards:
                    raise AssertionError(
                        f"engine path {name}: {launches[name][FUSED]} "
                        f"launches of #1, expected {per_forward} x "
                        f"{forwards} forwards")
            if cfg.family == "vlm":
                vision_launches(name, cfg, st, launches[name], mk)
            if cfg.family == "audio":
                audio_launches(name, cfg, st, launches[name], mk)
            if cfg.family == "hybrid":
                hybrid_launches(name, cfg, st, launches[name], mk)
                last = {u: len(p) + traffic["new"] - 2
                        for u, p in enumerate(prompts)}
                log(f"engine path {name}: rings of {ring_rows} rows; the "
                    f"last position each request wrote: {last}")
                short = {u: p for u, p in last.items() if p < ring_rows}
                if traffic is ZAMBA_WRAP and short:
                    raise AssertionError(
                        f"engine path {name}: requests {short} never "
                        f"wrapped their ring of {ring_rows} rows")
            margin = gate(model, traffic, name, got,
                          want if versus is None else outs[versus])
        res[name] = {"wall_s": wall, "max_divergence_margin": margin,
                     "stats": st, "peak_gib": _peak_gib(),
                     "grid_launches": {f"G={g} x_shared={x}": n
                                       for (g, x), n in grid.items()}}
        if moe:
            res[name].update(near_ties=near_ties,
                             expert_grid_launches=n_grid,
                             router_calls=len(path_log.calls),
                             forwards=forwards)
        if spec:
            # every drafted token is accepted or rolled back, and some
            # are rolled back, so that trim ran on the card
            if st["spec_draft_tokens"] != st["spec_accepted_tokens"] + \
                    st["spec_rollback_tokens"] or \
                    st["spec_rollback_tokens"] == 0:
                raise AssertionError(f"engine path {name}: spec counters "
                                     f"{st}")
            res[name]["acceptance_rate"] = acceptance
        if "system" in traffic and not (
                st["prefix_hit_tokens"] > 0 and st["cow_copies"] >= 2
                and st["shared_pages"] > 0):
            raise AssertionError(f"engine path {name}: prefix counters "
                                 f"{st}")
        if "kv_pool_pages" in traffic and not (
                st["evicted_pages"] > 0 and st["preemptions"] > 0):
            raise AssertionError(f"engine path {name}: no eviction or no "
                                 f"preemption on the overcommitted pool "
                                 f"{st}")
        log(f"engine {arch} f32 {name}: tokens match the "
            + ("plain" if versus is None else versus) + " path"
            + ("" if margin is None else " up to near-ties")
            + f"; {st['tokens_emitted']} tokens, {st['decode_steps']} decode "
            f"steps, {st['preemptions']} preemptions, wall {wall:.2f} s, "
            f"peak {res[name]['peak_gib']:.2f} GiB"
            + ("" if not moe else
               f"; #1 launched {n_grid} times at the expert grid (G = "
               f"{cfg.n_experts}, x per group) over {forwards} forwards")
            + (
                "" if not spec else
                f"; acceptance {acceptance:.3f}, {st['spec_rollback_tokens']} "
                f"tokens and {st['spec_rollback_pages']} pages rolled back")
            + ("" if "system" not in traffic else
               f"; {st['prefix_hit_tokens']} of "
               f"{st['prefix_lookup_tokens']} prompt tokens hit, "
               f"{st['cow_copies']} copies on write, "
               f"{st['shared_pages']} pages shared at the peak, "
               f"{st['evicted_pages']} evicted"))
    res["launches_by_path"] = {p[0]: launches[p[0]] for p in paths}
    return res


# ---------------------------------------------------------------------------
# the rectangular KV cache (ServeConfig(paged=False))
# ---------------------------------------------------------------------------


def rect_path(model, launches):
    """llama3.2-1b's f32 engine on the rectangle: the plain oracles, then
    the kernel path with every launch count set to 0 just before its run
    (#1 on every packed linear of every forward, 4 per layer; #2, #3 and
    #4 never: the rectangle is read by plain ops and no rank passes 4096).
    Its tokens are gated against the rectangular plain engine's and the
    paged paths' (``TOKENS``), and ``generate(paged=False)`` of the
    traffic's prompts cut to one length against the rectangular kernel
    engine on those prompts."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import KernelPolicy
    from repro_torch.serve.engine import ServeConfig, generate
    traffic, cfg, name = LLAMA, model.cfg, RECT
    torch.cuda.reset_peak_memory_stats()
    want, eng, ref_wall, _ = serve(model, traffic, KernelPolicy(mode="ref"),
                                   paged=False)
    del eng
    free()
    res = {"ref_wall_s": ref_wall, "ref_peak_gib": _peak_gib()}
    counters = _counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    got, eng, wall, st = serve(model, traffic, KernelPolicy(mode="cuda"),
                               paged=False)
    launches[name] = [c.launches for c in counters]
    if eng.kv is not None:
        raise AssertionError(f"engine path {name}: a pool was built")
    res.update(wall_s=wall, peak_gib=_peak_gib(), stats=st,
               kv_cache_bytes=eng.kv_cache_bytes())
    del eng
    free()
    log(f"engine path {name}: launches " + ", ".join(
        f"{k[0]}={n}" for k, n in zip(KERNELS, launches[name])))
    forwards = st["admissions"] + st["decode_steps"]
    per_forward = 4 * cfg.n_layers     # merged QKV, wo, merged gate-up, down
    if launches[name] != [per_forward * forwards, 0, 0, 0]:
        raise AssertionError(
            f"engine path {name}: launches {launches[name]}, expected "
            f"{per_forward} of #1 x {forwards} forwards and no other kernel")
    res["vs_plain"] = gate(model, traffic, name, got, want)
    for versus in ("megakernel", "unfused"):
        res[f"vs_{versus}"] = gate(model, traffic, name, got, TOKENS[versus])
    res["identical"] = {k: all(np.array_equal(got[u], w[u]) for u in w)
                        for k, w in (("plain", want),
                                     ("megakernel", TOKENS["megakernel"]),
                                     ("unfused", TOKENS["unfused"]))}
    TOKENS[name] = got
    # generate: one batched prefill of equal prompts, then decode steps on
    # the rectangle, against the rectangular engine on the same prompts
    n = min(len(p) for p in _requests(cfg, traffic))
    prompts = [p[:n] for p in _requests(cfg, traffic)]
    eng_toks, eng, _, _ = serve(model, traffic, KernelPolicy(mode="cuda"),
                                paged=False, prompts=prompts)
    del eng
    free()
    t0 = time.perf_counter()
    gen, _ = generate(model.params, cfg, np.stack(prompts),
                      ServeConfig(greedy=True, paged=False,
                                  max_new_tokens=traffic["new"]),
                      policy=KernelPolicy(mode="cuda"))
    gen = gen.cpu().numpy()
    res["generate_s"] = time.perf_counter() - t0
    res["generate_vs_engine"] = gate(
        model, traffic, f"{name} generate", {u: gen[u] for u in eng_toks},
        eng_toks, prompts=prompts)
    res["generate_identical"] = all(np.array_equal(gen[u], eng_toks[u])
                                    for u in eng_toks)
    log(f"engine {traffic['arch']} f32 {name}: tokens match the "
        f"rectangular plain engine's, the megakernel and unfused paged "
        f"paths' (identical: {res['identical']}); generate(paged=False) of "
        f"{len(prompts)} prompts of {n} tokens matches the rectangular "
        f"engine (identical: {res['generate_identical']}); "
        f"{st['tokens_emitted']} tokens, {st['decode_steps']} decode steps, "
        f"#1 {per_forward} per forward, no #2 / #3 / #4; wall {wall:.2f} s, "
        f"peak {res['peak_gib']:.2f} GiB, rectangle "
        f"{res['kv_cache_bytes']} bytes")
    return res


def rect_compare(model, traffic, report):
    """bf16 on the kernel path, the rectangle against the paged pool in
    turns (rect, pool, rect, pool) in this one process: decode tok/s,
    TTFT, peak GiB and the cache's bytes of each."""
    runs = {"rect": [], "pool": []}
    for kind in ("rect", "pool", "rect", "pool"):
        runs[kind].append(bf16_run(model, traffic, report,
                                   paged=kind == "pool"))
    return runs


# ---------------------------------------------------------------------------
# tensor-parallel serving: N ranks on the one card
# ---------------------------------------------------------------------------


def _held_bytes(tree, skip=()):
    """(bytes of packed words, bytes of every leaf) that the tensors of a
    parameter tree hold on the card, each storage counted once (a layer of
    an engine's split stack is a view); subtrees named in `skip` left
    out."""
    import torch
    seen, held = set(), [0, 0]

    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k not in skip:
                    walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st.data_ptr() in seen:
                return
            seen.add(st.data_ptr())
            held[1] += st.nbytes()
            if t.dtype == torch.int32:
                held[0] += st.nbytes()
    walk(tree)
    return held


def _expert_stacks(tree):
    """The routed expert stacks of a parameter tree (stacked or an
    engine's per-layer list): every ``moe`` dict's linears but its router
    and shared experts."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == "moe" and isinstance(v, dict):
                    out.extend(v[n] for n in v if n not in ("router",
                                                            "shared"))
                else:
                    walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(tree)
    return out


def tp_bytes(eng_params, full_params):
    """Bytes of this rank's shards, measured over the tensors its engine
    holds (the merged QKV / gate-up copies apart, as ``merged_rank``),
    against the unsharded model's tensors: the packed words, and every
    leaf; an MoE's routed expert words also on their own (``expert_*``,
    E / N experts per rank) and the packed words without them
    (``other_packed_share``)."""
    merged = ("wqkv", "wgu")
    tot = dict(zip(("packed_rank", "all_rank"),
                   _held_bytes(eng_params, merged)))
    tot.update(zip(("packed_full", "all_full"), _held_bytes(full_params)))
    tot["merged_rank"] = _held_bytes(eng_params)[1] - tot["all_rank"]
    tot["packed_share"] = tot["packed_rank"] / tot["packed_full"]
    tot["all_share"] = tot["all_rank"] / tot["all_full"]
    tot["expert_rank"] = _held_bytes(_expert_stacks(eng_params))[0]
    tot["expert_full"] = _held_bytes(_expert_stacks(full_params))[0]
    if tot["expert_full"]:
        tot["expert_share"] = tot["expert_rank"] / tot["expert_full"]
        tot["other_packed_share"] = (
            (tot["packed_rank"] - tot["expert_rank"])
            / (tot["packed_full"] - tot["expert_full"]))
    return tot


class _Redraw:
    """A rank's unsharded model after it was dropped: its config, and the
    model drawn again from the seed only if a token gate reads its plain
    forward (at a divergence)."""

    def __init__(self, make, cfg):
        self._make, self.cfg, self._model = make, cfg, None

    def __getattr__(self, name):
        if self._model is None:
            self._model = self._make()
        return getattr(self._model, name)


def tp_rank(rank, phases, n, want, device="cuda:0", tree_file=None,
            logs=None):
    """One rank of one or more tensor-parallel phases over a (1, n) mesh
    of ranks (gloo ranks share the card): for each (name, arch, runs) of
    `phases` in turn, :func:`_tp_serve` and its seconds. Only rank 0
    logs."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rank:
        sys.stdout = open(os.devnull, "w")
    mesh = make_serving_mesh(n, device=device)
    out = {}
    for name, arch, runs in phases:
        t0 = time.perf_counter()
        out[name] = _tp_serve(mesh, arch, runs, want, tree_file, logs)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def _tp_serve(mesh, arch, runs, want, tree_file, logs):
    """One rank's share of a tensor-parallel phase: the phase's model drawn
    from the seed on the card (the unsharded phase's weights, bit for
    bit), an engine for each of `runs` built over `mesh`, and then the
    unsharded model dropped, so that the rank holds only its shards (and
    the peak counts its engines only). Each path's launch counts and
    collectives are set to 0 just before its run and its tokens gated
    against the unsharded path's `want` (a divergence only at a
    plain-path near-tie; an MoE's by ``moe_gate`` against the unsharded
    path's router log in `logs`, which also reads the router). llama's
    host draw is read from the parent's `tree_file`."""
    import contextlib
    import torch
    from repro_torch.kernels import binary_matmul
    from repro_torch.kernels.ops import KernelPolicy
    from repro_torch.sharding import comm

    def make():
        return make_llama(tree_file) if arch == "llama3.2-1b" \
            else make_on_card(arch)
    model = make()
    pol = KernelPolicy(mode="cuda")
    engines = {name: _engine(model, traffic, pol, None, spec, True, mesh)
               for name, traffic, spec, _ in runs}
    out = {"bytes": tp_bytes(engines[runs[0][0]].params, model.params),
           "device": str(mesh.device), "backend": mesh.backend,
           "cfg": model.cfg}
    model = _Redraw(make, model.cfg)
    free()
    if model.cfg.family == "vlm":
        out["image"] = tp_image_forward(engines[runs[0][0]],
                                        want[f"{arch}-image"])
    counters = _counters()
    grid = binary_matmul.fused_lowrank_matmul_grouped.grid_launches
    moe = model.cfg.family == "moe"
    for name, traffic, spec, versus in runs:
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        grid.clear()
        comm.reset_stats()
        path_log = _EngineLog() if moe else None
        with path_log or contextlib.nullcontext():
            got, eng, wall, st = serve(
                model, traffic, None, engine=engines.pop(name),
                on_engine=path_log and path_log.attach)
        counts = [c.launches for c in counters]
        collectives = dict(comm.STATS)
        grids = dict(grid)
        if moe:
            ties = moe_gate(name, got, want[versus], path_log,
                            _EngineLog.restore(logs[versus]))
            margin = None if ties is None else max(
                t.get("logit_margin", t.get("router_gap")) for t in ties)
        else:
            margin = gate(model, traffic, name, got, want[versus])
        res = {"tokens": {u: t.tolist() for u, t in got.items()},
               "launches": counts, "collectives": collectives,
               "grid_launches": grids,
               "stats": st, "wall_s": wall, "peak_gib": _peak_gib(),
               "max_divergence_margin": margin,
               "kv_cache_bytes": eng.kv_cache_bytes(),
               "decode_step_ms": 1e3 * st["decode_time_s"]
               / max(1, st["decode_steps"])}
        if moe:
            res["near_ties"] = ties
            res["routes"] = [ti.numpy() for _, ti, _ in path_log.calls]
        if spec:
            res["acceptance_rate"] = eng.spec.acceptance_rate()
        out[name] = res
        del eng
        free()
    return out


def tp_image_forward(eng, want):
    """The VLM's ``forward`` of ``VISION_IMAGE``'s prompts with their
    images over this rank's shards (those of engine `eng`, under its
    policy; launch counts and collectives set to 0 just before): its
    last-position f32 logits against the plain path's `want` (see
    :func:`_image_logits`): the same argmax per row, or a near-tie of the
    plain path there; the largest difference relative to max(1,
    max|logit|) recorded. Its launches and collectives against the
    template of one forward with an image: #1 for each self block's
    merged QKV and wo and each cross block's wq, wk, wv (the image K/V
    of the rank's kv heads) and wo, #4 six times per block (the two-call
    FFN), 2 all-reduces per block and the embedding's, one all-gather."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import kernel_policy
    from repro_torch.models import transformer as TT
    from repro_torch.sharding import comm
    cfg = eng.cfg
    toks, img = _vision_image_inputs(cfg, torch.float32, eng.device)
    counters = _counters()
    for c in counters:
        c.launches = 0
    comm.reset_stats()
    with kernel_policy(eng.policy), torch.inference_mode():
        lg = TT.forward(eng.params, cfg, torch.from_numpy(toks).to(
            eng.device), img)[:, -1].float().cpu().numpy()
    counts = [c.launches for c in counters]
    coll = dict(comm.STATS)
    logits, margins, tols = want
    rel = float(np.abs(lg - logits).max() / max(1.0, np.abs(logits).max()))
    ties = [b for b in range(len(lg)) if lg[b].argmax() != logits[b].argmax()]
    for b in ties:
        if margins[b] >= tols[b]:
            raise AssertionError(
                f"image forward: row {b}'s argmax differs from the plain "
                f"path's at a margin of {margins[b]:.3e} (tolerance "
                f"{tols[b]:.3e})")
    groups = cfg.n_layers // cfg.cross_attn_every
    want_counts = [2 * (cfg.n_layers - groups) + 4 * groups, 0, 0,
                   6 * cfg.n_layers]
    if counts != want_counts or coll["all_reduce"] != 2 * cfg.n_layers + 1 \
            or coll["all_gather"] != 1:
        raise AssertionError(f"image forward: launches {counts} (template "
                             f"{want_counts}), collectives {coll}")
    return {"max_rel_diff": rel, "near_tie_rows": ties, "launches": counts,
            "collectives": coll, "rows": len(lg)}


def tp_template(name, cfg, res, n):
    """A TP path's launches and collectives on one rank of `n` against
    its family's template: G forwards (one all-gather of the logits each;
    an admission's prefill or a decode step, or a speculative draft or
    verify). Per forward 2 all-reduces per attention block (its wo and its
    FFN's w_down, or its MoE layer's one, which carries the shared
    experts' partial too; the hybrid's shared block per application, the
    VLM's cross blocks as its self blocks) and per Mamba2 layer (the gated
    norm's sum of squares and out_proj), and the embedding's one. #1 per
    Mamba2 layer for each packed mixer projection (wz, wx, wB, wC,
    out_proj, and wdt where it packs); per attention block the merged QKV
    and wo (MLA: wq, w_dkv, w_kr, wo; a cross block without an image: wq
    and wo) and, for a dense FFN or the shared experts, gate-up and w_down
    on #1 (rank up to MAX_FUSED_RANK) or on #4 (two-call: 4 + 2
    launches); an MoE layer's three expert linears on #1 at the
    rank-local grid (G = E / n, x per group). #2 once per GQA self
    attention block of a plain decode step (MLA reads its latents with
    plain ops, the VLM's cross blocks with plain ops); #3 never."""
    from repro_torch.core.bpw import rank_for_bpw
    from repro_torch.core.layout import quantizable_linear
    from repro_torch.kernels import binary_matmul
    from repro_torch.models.transformer import n_shared_apps
    st, c, counts = res["stats"], res["collectives"], res["launches"]
    L, G = cfg.n_layers, c["all_gather"]
    spec = st["spec_cycles"] > 0
    if not spec and G != st["admissions"] + st["decode_steps"]:
        raise AssertionError(f"{name}: {G} logits all-gathers, expected one "
                             f"per forward ({st})")
    mamba = L if cfg.is_ssm_layer_stack else 0
    blocks = n_shared_apps(cfg) if cfg.is_ssm_layer_stack else L
    cross = L // cfg.cross_attn_every if cfg.family == "vlm" else 0
    reduces = 2 * mamba + 2 * blocks + 1
    if c["all_reduce"] != reduces * G:
        raise AssertionError(f"{name}: {c['all_reduce']} all-reduces over "
                             f"{G} forwards, expected {reduces} each")
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    mixer = sum(quantizable_linear(k, shape, 48) for k, shape in (
        ("wz", (d, di)), ("wx", (d, di)), ("wB", (d, gn)), ("wC", (d, gn)),
        ("wdt", (d, H)), ("out_proj", (di, d))))
    n_moe = L - cfg.first_k_dense if cfg.family == "moe" else 0
    ffns = (blocks - n_moe) + (n_moe if cfg.n_shared_experts else 0)
    d_ff = cfg.dense_d_ff if cfg.first_k_dense else cfg.d_ff
    twocall = ffns and binary_matmul.MAX_FUSED_RANK < rank_for_bpw(
        d_ff, cfg.d_model, 1.0, 32)
    attn = 4 if cfg.is_mla else 2
    per = mixer * mamba + attn * blocks + 3 * n_moe \
        + (0 if twocall else 2) * ffns
    want = {FUSED: per * G, PACKED: (6 * ffns if twocall else 0) * G,
            MEGA: 0}
    if not spec:
        want[PAGED] = 0 if cfg.is_mla else (blocks - cross) \
            * st["decode_steps"]
    bad = {KERNELS[i][0]: (counts[i], k) for i, k in want.items()
           if counts[i] != k}
    if bad or (spec and counts[PAGED] == 0):
        raise AssertionError(f"{name}: launches (got, template) {bad}, #2 "
                             f"{counts[PAGED]}")
    if n_moe:
        local = res["grid_launches"].get((cfg.n_experts // n, False), 0)
        if local != 3 * n_moe * G or any(
                k[0] == cfg.n_experts for k in res["grid_launches"]):
            raise AssertionError(
                f"{name}: #1 at the expert grids {res['grid_launches']}, "
                f"expected 3 x {n_moe} layers x {G} forwards at G = "
                f"{cfg.n_experts // n} (x per group) and none at G = "
                f"{cfg.n_experts}")
    return {"per_forward": {"fused": per, "all_reduce": reduces},
            "forwards": G}


def tp_phase(phases, n, launches, backend="gloo"):
    """Start `n` ranks once for `phases`, (name, arch, runs) each (see
    :data:`TP_PHASES`): over gloo, all on the one card; over nccl, rank r
    on card r (``scripts/tp_nccl_probe.py``). Check every rank's results:
    the same tokens on every rank (each already gated in its rank), an
    MoE's routers' choices the same on every rank, the template, the
    drained pools. Returns {phase name: its report}; the launch lists gain
    each path's rank-0 counts."""
    import tempfile
    from repro_torch.launch.mesh import run_ranks
    versus = [v for _, _, runs in phases for *_, v in runs]
    want = {v: TOKENS[v] for v in versus}
    archs = {arch for _, arch, _ in phases}
    want.update({k: v for k, v in IMAGE_LOGITS.items()
                 if k.removesuffix("-image") in archs})
    logs = {v: ROUTER_LOGS[v] for v in versus if v in ROUTER_LOGS}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nq-tp-") as tmp:
        tree_file = None
        if any(arch == "llama3.2-1b" for _, arch, _ in phases):
            tree_file = os.path.join(tmp, "llama.pkl")
            with open(tree_file, "wb") as f:
                pickle.dump(llama_tree(), f, protocol=5)
        out = run_ranks(tp_rank, n, backend, args=(
            phases, n, want, "cuda:0" if backend == "gloo" else None,
            tree_file, logs))
    spawn_s = time.perf_counter() - t0
    return {name: _tp_report({r: out[r][name] for r in range(n)}, n, runs,
                             launches, backend, spawn_s)
            for name, _, runs in phases}


def _tp_report(out, n, runs, launches, backend, spawn_s):
    """One phase's report from its ranks' results `out` (see
    :func:`tp_phase`)."""
    import numpy as np
    cfg = out[0]["cfg"]
    shared = backend == "gloo"
    where = "one card" if shared else f"{n} cards"
    timing = "ranks time-sharing one card over gloo, not TP speed" if shared \
        else "a card per rank over NCCL"
    report = {"ranks": n, "backend": backend, "devices": [
        out[r]["device"] for r in range(n)],
        "transport": "every rank on one card; collectives staged through "
                     "host memory over gloo (ranks time-sharing the card, "
                     "not TP speed)" if shared
                     else "a card per rank; collectives over NCCL",
        "phase_s": out[0]["seconds"], "spawn_s": spawn_s,
        "bytes": {r: out[r]["bytes"] for r in range(n)}}
    if "image" in out[0]:
        img = report["image_forward"] = {r: out[r]["image"]
                                         for r in range(n)}
        log(f"{cfg.name} forward with images over {n} {backend} ranks on "
            f"{where}: last-position f32 logits of {img[0]['rows']} prompts "
            f"against the plain path's: largest relative difference "
            + "/".join(f"{img[r]['max_rel_diff']:.3e}" for r in range(n))
            + ", argmax equal"
            + ("" if not any(img[r]["near_tie_rows"] for r in range(n))
               else " but at near-ties")
            + f" on every rank; per rank: launches " + ", ".join(
                f"{k[0]}={c}" for k, c in zip(KERNELS, img[0]["launches"]))
            + f", {img[0]['collectives']['all_reduce']} all-reduces and "
            f"{img[0]['collectives']['all_gather']} all-gathers")
    for name, traffic, spec, versus in runs:
        routes = [out[r][name].pop("routes", None) for r in range(n)]
        for r in range(n):
            out[r][name]["template"] = tp_template(f"{name} rank {r}", cfg,
                                                   out[r][name], n)
            if out[r][name]["tokens"] != out[0][name]["tokens"]:
                raise AssertionError(f"{name}: rank {r}'s tokens differ "
                                     f"from rank 0's")
            if routes[0] is not None and not (
                    len(routes[r]) == len(routes[0]) and all(
                        np.array_equal(a, b)
                        for a, b in zip(routes[r], routes[0]))):
                raise AssertionError(f"{name}: rank {r}'s routers chose "
                                     f"other experts than rank 0's")
        res = dict(out[0][name])
        del res["tokens"]
        res["grid_launches"] = {f"G={g} x_shared={x}": k for (g, x), k in
                                res["grid_launches"].items()}
        res["per_rank"] = {r: {k: out[r][name][k] for k in (
            "peak_gib", "wall_s", "decode_step_ms", "launches")}
            for r in range(n)}
        launches[name] = res["launches"]
        report[name] = res
        b = out[0]["bytes"]
        experts = "" if not b.get("expert_full") else (
            f"; expert words {b['expert_rank'] / 1e9:.3f} of "
            f"{b['expert_full'] / 1e9:.3f} GB ({b['expert_share']:.3f}), "
            f"other packed words {b['other_packed_share']:.3f}")
        log(f"engine {name} f32 over {n} {backend} ranks on {where}: tokens "
            f"match the {versus} path"
            + ("" if res["max_divergence_margin"] is None
               else " up to near-ties")
            + (f" on every rank, the routers' choices equal on every rank"
               if cfg.family == "moe" else " on every rank")
            + "; per rank: launches " + ", ".join(
                f"{k[0]}={c}" for k, c in zip(KERNELS, res["launches"]))
            + f" ({res['grid_launches']}), "
            f"{res['collectives']['all_reduce']} all-reduces and "
            f"{res['collectives']['all_gather']} all-gathers, packed words "
            f"{b['packed_share']:.3f} and all bytes {b['all_share']:.3f} of "
            f"the unsharded model's (held: " + "/".join(
                f"{out[r]['bytes']['all_rank'] / 1e9:.3f}" for r in range(n))
            + f" GB, merged copies {b['merged_rank'] / 1e9:.3f} GB{experts}"
            f"), peak "
            + "/".join(f"{out[r][name]['peak_gib']:.2f}" for r in range(n))
            + " GiB, " + "/".join(f"{out[r][name]['decode_step_ms']:.1f}"
                                  for r in range(n))
            + f" host ms per decode step ({timing})"
            + ("" if not spec else
               f"; acceptance {res['acceptance_rate']:.3f}"))
    return report


# ---------------------------------------------------------------------------
# the request-lifecycle layer: chaos and restart
# ---------------------------------------------------------------------------


def hybrid_launches(name, cfg, st, counts, megakernel):
    """The hybrid's launches of #1, #2 and #3 against its template: a
    prefill forward (one per admission) runs the six packed mixer
    projections of each Mamba2 block (wz, wx, wB, wC, wdt, out_proj) and,
    per application of the shared block, its merged QKV, wo, merged
    gate-up and w_down through #1; a decode forward the same mixer
    launches and per application either #3 (QKV, the ring walk and wo in
    one launch) plus the FFN's two launches of #1, or, with the
    megakernel off, #2 and four launches of #1."""
    from repro_torch.models.transformer import n_shared_apps
    apps, mixer = n_shared_apps(cfg), 6 * cfg.n_layers
    mega = megakernel is not False
    prefill, decode = st["admissions"], st["decode_steps"]
    want = {FUSED: (mixer + 4 * apps) * prefill
            + (mixer + (2 if mega else 4) * apps) * decode,
            MEGA: apps * decode if mega else 0,
            PAGED: 0 if mega else apps * decode, PACKED: 0}
    got = {i: counts[i] for i in want}
    if got != want:
        raise AssertionError(f"engine path {name}: launches {got}, expected "
                             f"{want} from {prefill} prefill and {decode} "
                             f"decode forwards")
    log(f"engine path {name}: per decode forward {mixer} + "
        f"{(2 if mega else 4) * apps} launches of #1 and {apps} of "
        f"{'#3' if mega else '#2'}; per prefill forward "
        f"{mixer + 4 * apps} of #1 ({prefill} prefills, {decode} decode "
        f"steps)")


def vision_launches(name, cfg, st, counts, megakernel, image=False):
    """The VLM's launches of #1-#4 against its template: a prefill forward
    (one per admission) runs through #1 each self block's merged QKV and
    wo and each cross block's wq and wo (with an image also its wk and
    wv: the image K/V, projected once), and through #4 the two-call FFN of
    every block (rank 6336: the merged gate-up's two groups and w_down,
    two launches each: six); a decode forward the same FFN launches, #1
    for each cross block's wq and wo, and per self block either #3 (QKV,
    the page walk and wo in one launch) or, with the megakernel off, #2
    and two launches of #1."""
    groups = cfg.n_layers // cfg.cross_attn_every
    n_self = cfg.n_layers - groups
    mega = megakernel is not False
    prefill, decode = st["admissions"], st["decode_steps"]
    per_prefill = 2 * n_self + (4 if image else 2) * groups
    want = {FUSED: per_prefill * prefill
            + (2 * groups + (0 if mega else 2 * n_self)) * decode,
            MEGA: n_self * decode if mega else 0,
            PAGED: 0 if mega else n_self * decode,
            PACKED: 6 * cfg.n_layers * (prefill + decode)}
    got = {i: counts[i] for i in want}
    if got != want:
        raise AssertionError(f"engine path {name}: launches {got}, expected "
                             f"{want} from {prefill} prefill and {decode} "
                             f"decode forwards")
    log(f"engine path {name}: per decode forward {6 * cfg.n_layers} "
        f"launches of #4, {2 * groups + (0 if mega else 2 * n_self)} of "
        f"#1 and {n_self} of {'#3' if mega else '#2'}; per prefill forward "
        f"{per_prefill} of #1 ({prefill} prefills, {decode} decode steps)")


def audio_launches(name, cfg, st, counts, megakernel):
    """The audio model's launches of #1-#4 against its template: a
    prefill forward (one per admission; no request's prompt shares a
    prefix, so no suffix prefill runs #2) launches #1 four times per layer
    (merged QKV, wo, merged gate-up, w_down); a decode forward launches per
    layer either #3 (QKV, the page walk and wo in one launch) and #1 for
    the FFN's two groups, or, with the megakernel off, #2 and four
    launches of #1. #4 never runs: every rank is within #1's reach."""
    n, mega = cfg.n_layers, megakernel is not False
    prefill, decode = st["admissions"], st["decode_steps"]
    want = {FUSED: 4 * n * prefill + (2 if mega else 4) * n * decode,
            MEGA: n * decode if mega else 0,
            PAGED: 0 if mega else n * decode, PACKED: 0}
    got = {i: counts[i] for i in want}
    if got != want or st["prefix_hit_tokens"]:
        raise AssertionError(f"engine path {name}: launches {got}, expected "
                             f"{want} from {prefill} prefill and {decode} "
                             f"decode forwards ({st['prefix_hit_tokens']} "
                             f"prompt frames hit the prefix index)")
    log(f"engine path {name}: per decode forward {(2 if mega else 4) * n} "
        f"launches of #1 and {n} of {'#3' if mega else '#2'}; per prefill "
        f"forward {4 * n} of #1 ({prefill} prefills, {decode} decode steps)")


def _vision_image_inputs(cfg, dtype, device="cuda"):
    """``VISION_IMAGE``'s prompts (numpy, from the seed) and images (drawn
    on the card, `device`, from the seed, in `dtype`)."""
    import numpy as np
    from repro_torch.testing import image_embeds_device
    t = VISION_IMAGE
    rng = np.random.default_rng(SEED + 20)
    toks = rng.integers(0, cfg.vocab_size, size=(t["n"], t["prompt"])
                        ).astype(np.int64)
    return toks, image_embeds_device(cfg, t["n"], SEED + 21, device, dtype)


def _image_logits(model, toks, img):
    """The plain path's forward of `toks` with their images `img`: its
    last-position f32 logits (host), and per row the top-2 margin and the
    logits tolerance, which a tensor-parallel forward is held to."""
    import torch
    from repro_torch.kernels.ops import KernelPolicy, kernel_policy
    from repro_torch.models import transformer as TT
    with kernel_policy(KernelPolicy(mode="ref")), torch.inference_mode():
        lg = TT.forward(model.params, model.cfg,
                        torch.from_numpy(toks).to(model.device),
                        img)[:, -1].float()
    top = torch.topk(lg, 2, dim=-1).values
    return (lg.cpu().numpy(), (top[:, 0] - top[:, 1]).cpu().numpy(),
            (LOGITS_TOL * lg.abs().amax(-1).clamp_min(1.0)).cpu().numpy())


def vision_image_path(model, launches, name="llama-3.2-vision-90b-image"):
    """The ``llama-3.2-vision-90b-image`` path (or `name`, the quantized
    artifact's): the port's ``generate`` of
    ``VISION_IMAGE`` (4 prompts, each with its own 1024 seeded patch
    embeddings: one batched prefill projecting every cross layer's image
    K/V once, #1 at M 4096, then decode steps over a pool of 4 slots), in
    f32 on the plain oracles, then on the kernels with every launch count
    set to 0 just before; tokens gated as the engine paths' (a near-tie
    read with the request's image), launches checked against the
    template."""
    import torch
    from repro_torch.kernels.ops import KernelPolicy
    from repro_torch.serve.engine import ServeConfig, generate
    cfg = model.cfg
    toks, img = _vision_image_inputs(cfg, torch.float32)
    scfg = ServeConfig(greedy=True, max_new_tokens=VISION_IMAGE["new"],
                       page_size=64)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want, _ = generate(model.params, cfg, toks, scfg, image_embeds=img,
                       policy=KernelPolicy(mode="ref"))
    want = want.cpu().numpy()
    ref_wall = time.perf_counter() - t0
    free()
    if name == "llama-3.2-vision-90b-image":
        IMAGE_LOGITS[name] = _image_logits(model, toks, img)
        free()
    counters = _counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got, _ = generate(model.params, cfg, toks, scfg, image_embeds=img,
                      policy=KernelPolicy(mode="cuda"))
    got = got.cpu().numpy()
    wall = time.perf_counter() - t0
    launches[name] = [c.launches for c in counters]
    free()
    log(f"engine path {name}: launches " + ", ".join(
        f"{k[0]}={n}" for k, n in zip(KERNELS, launches[name])))
    vision_launches(name, cfg, {"admissions": 1,
                                "decode_steps": VISION_IMAGE["new"]},
                    launches[name], None, image=True)
    margin = gate(model, None, name, dict(enumerate(got)),
                  dict(enumerate(want)), prompts=list(toks), images=img)
    res = {"ref_wall_s": ref_wall, "wall_s": wall,
           "max_divergence_margin": margin, "peak_gib": _peak_gib(),
           "tokens": got.tolist(), "launches": launches[name]}
    log(f"engine {name} f32: generate of {len(toks)} prompts of "
        f"{toks.shape[1]} tokens with {cfg.n_image_tokens} image tokens "
        f"each, {VISION_IMAGE['new']} new: tokens match the plain path"
        + ("" if margin is None else " up to near-ties")
        + f"; wall {wall:.2f} s (plain {ref_wall:.2f} s), peak "
        f"{res['peak_gib']:.2f} GiB")
    return res


def _chaos_trace(cfg, traffic):
    import numpy as np
    from repro_torch.testing import chaos_trace
    return chaos_trace(np.random.default_rng(SEED + 44), traffic["n"],
                       cfg.vocab_size, max_prompt=traffic["max_prompt"],
                       max_new=traffic["new"])


def _chaos_engine(model, policy, faults=None):
    from repro_torch.serve.engine import ServeConfig
    return model.engine(ServeConfig(
        greedy=True, page_size=CHAOS["page_size"],
        kv_pool_pages=CHAOS["kv_pool_pages"], prefix_cache=True,
        spec_rank_frac=1.0, spec_k=4, spec_k_min=4, debug=True,
        megakernel=True), max_batch=CHAOS["max_batch"],
        max_len=CHAOS["max_len"], policy=policy, faults=faults)


def _audit(eng, leg):
    """The quiesced pool: audit, only the index's pages in use, nothing
    borrowed, and an empty pool once the index is cleared."""
    eng.check_invariants()
    kv = eng.kv
    if kv.used_pages != kv.cached_page_count or kv.external:
        raise AssertionError(f"chaos {leg}: {kv.used_pages} pages in use, "
                             f"{kv.cached_page_count} cached, "
                             f"{len(kv.external)} borrowed")
    eng.prefix.clear()
    if kv.used_pages:
        raise AssertionError(f"chaos {leg}: {kv.used_pages} pages leaked")


class _RecoveryWindow:
    """The injected device error's recovery in one chaos leg: from the
    fault to the end of the re-admission of the last slot it preempted
    (each ends in a host read of its first token), in host ms; with
    `profile`, the device ms of that window by kernel."""

    def __init__(self, eng, profile=False):
        import torch
        from torch.profiler import ProfilerActivity
        self.t0 = self.t1 = None
        self.waiting, self.resumed, self.prof = set(), 0, None
        on_fault, admit = eng._on_device_fault, eng._admit

        def fault(err):
            if profile:
                self.prof = torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA])
                self.prof.start()
            self.t0 = time.perf_counter()
            live = {t.handle.uid for t in eng._tasks if t is not None}
            on_fault(err)
            self.waiting = {u for u in live if not eng.handles[u].finished}
            self.resumed = len(self.waiting)

        def timed_admit(slot, item):
            out = admit(slot, item)
            if self.waiting:
                self.waiting = {u for u in self.waiting if u not in
                                eng.slot_of and not eng.handles[u].finished}
                if not self.waiting:
                    self.t1 = time.perf_counter()
                    if self.prof is not None:
                        torch.cuda.synchronize()
                        self.prof.stop()
            return out
        eng._on_device_fault, eng._admit = fault, timed_admit

    def result(self):
        if self.t1 is None:
            return None
        out = {"ms": 1e3 * (self.t1 - self.t0), "resumed": self.resumed}
        if self.prof is not None:
            out["device_ms_by_kernel"] = _by_kernel(self.prof)
        return out


def _chaos_leg(model, trace, policy, plan=None, window=None):
    """One chaos leg driven by arrival step; returns its record, the
    handles and the engine's stats. `window`: None, "time" or "profile"
    for the device error's recovery."""
    from repro_torch.serve.scheduler import Request
    from repro_torch.testing import drive_chaos
    eng = _chaos_engine(model, policy, plan)
    rec = None if window is None else _RecoveryWindow(eng, window == "profile")
    t0 = time.perf_counter()
    handles = drive_chaos(eng, trace, Request, plan)
    wall = time.perf_counter() - t0
    st = dict(eng.stats)
    leg = {"wall_s": wall, "steps": st["steps"],
           "host_ms_per_tick": 1e3 * wall / st["steps"],
           "statuses": {u: h.status for u, h in handles.items()},
           "tokens": {u: list(h.tokens) for u, h in handles.items()},
           "stats": st, "fired": list(plan.fired) if plan else None,
           "recovery": None if rec is None else rec.result()}
    for h in handles.values():
        if not h.finished or (h.status != "done" and not (
                h.error is not None and h.error.uid == h.uid
                and h.error.status == h.status and h.error.reason)):
            raise AssertionError(f"chaos: request {h.uid} is {h.status} "
                                 f"without a structured RequestError")
    _audit(eng, "leg")
    del eng, handles
    free()
    return leg


def _restore_leg(model, trace, drain, path):
    """Three steps of the kernel engine with every request submitted, a
    snapshot (after ``drain(timeout=0)`` with `drain`; of the live engine
    without), the engine dropped, a fresh engine restored from the file
    and run. Returns every request's tokens and the restored engine's
    re-prefill: host ms of the resumes' admissions, and from restore()
    to the last of them."""
    from repro_torch.kernels.ops import KernelPolicy
    from repro_torch.serve import recovery
    from repro_torch.serve.scheduler import Request
    eng = _chaos_engine(model, KernelPolicy(mode="cuda"))
    for _, uid, prompt, budget in trace:
        eng.submit(Request(uid, prompt, max_new_tokens=budget))
    for _ in range(3):
        eng.step()
    if drain:
        eng.drain(timeout=0)
        eng.check_invariants()
        if eng.kv.used_pages != eng.kv.cached_page_count:
            raise AssertionError("drain left pages mapped")
    before = {u: [int(t) for t in r.output] for u, r in eng.done.items()}
    recovery.save_snapshot(eng, path)
    del eng
    free()
    eng = _chaos_engine(model, KernelPolicy(mode="cuda"))
    t0 = time.perf_counter()
    handles = recovery.restore(eng, recovery.load_snapshot(path))
    os.unlink(path)
    resumes = sum(1 for h in handles.values() if h.tokens)
    times, last = [], [None]
    _time_resumes(eng, resumes, times, last)
    after = {u: [int(t) for t in r.output] for u, r in eng.run().items()}
    _audit(eng, "restore")
    if set(before) | set(after) != {t[1] for t in trace}:
        raise AssertionError("a restore leg lost a request")
    out = {"tokens": {**before, **after}, "done_before": len(before),
           "restored": len(handles), "resumes": resumes,
           "reprefill_ms": times,
           "restore_to_last_resume_ms": None if last[0] is None
           else 1e3 * (last[0] - t0)}
    del eng, handles               # the handles refer to the engine too
    free()
    return out


def _time_resumes(eng, n, times, last):
    """Record the host ms of each of `eng`'s resume admissions in `times`,
    and in ``last[0]`` the moment the `n`-th ended."""
    from repro_torch.serve.engine import _Resume
    admit = eng._admit

    def timed(slot, item):
        t = time.perf_counter()
        out = admit(slot, item)
        if isinstance(item, _Resume):
            times.append(1e3 * (time.perf_counter() - t))
            if len(times) == n:
                last[0] = time.perf_counter()
        return out
    eng._admit = timed


def chaos_path(model, launches):
    """The ``chaos`` path: the chaos benchmark on full-width llama3.2-1b
    through kernels #1-#3. Legs: the plain oracles, ``baseline`` (gated
    against them), ``chaos`` and ``chaos-repeat`` under one plan source,
    ``crash-restore`` and ``drain-restore``. Launch counts are set to 0
    just before the baseline leg and read after the last leg."""
    import tempfile
    from repro_torch.kernels.ops import KernelPolicy
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.testing import chaos_plan
    cfg = model.cfg
    trace = _chaos_trace(cfg, CHAOS)
    src = chaos_plan(trace, dry_pages=CHAOS["dry_pages"])
    res = {"oracle": _chaos_leg(model, trace, KernelPolicy(mode="ref"))}
    want = res["oracle"]["tokens"]
    counters = _counters()
    for c in counters:
        c.launches = 0
    kern = KernelPolicy(mode="cuda")
    res["baseline"] = _chaos_leg(model, trace, kern)
    base = res["baseline"]["tokens"]
    if set(res["baseline"]["statuses"].values()) != {"done"}:
        raise AssertionError("chaos baseline: a request did not finish")
    res["baseline"]["max_divergence_margin"] = gate(
        model, CHAOS, "chaos baseline", base, want)
    for leg, window in (("chaos", "time"), ("chaos-repeat", "profile")):
        res[leg] = _chaos_leg(model, trace, kern,
                              FaultPlan(src, seed=SEED + 44), window)
    a, b = res["chaos"], res["chaos-repeat"]
    if (a["fired"], a["statuses"], a["tokens"]) != \
            (b["fired"], b["statuses"], b["tokens"]):
        raise AssertionError("chaos-repeat is not chaos bit for bit")
    st = a["stats"]
    kinds = {k for _, k, _ in a["fired"]}
    if kinds != {f.kind for f in src} or st["expired"] != 3 \
            or st["cancelled"] < 2 or st["failed"] != 2 \
            or st["device_faults"] != 1:
        raise AssertionError(f"chaos: fired {sorted(kinds)}, terminals "
                             + str({k: st[k] for k in (
                                 "cancelled", "expired", "failed",
                                 "device_faults")}))
    survivors = sorted(u for u, s in a["statuses"].items() if s == "done")
    if not survivors:
        raise AssertionError("chaos: no survivor")
    res["chaos"]["max_divergence_margin"] = gate(
        model, CHAOS, "chaos survivors", a["tokens"],
        {u: base[u] for u in survivors})
    d = tempfile.mkdtemp(prefix="chaos-")
    for leg, drain in (("crash-restore", False), ("drain-restore", True)):
        res[leg] = _restore_leg(model, trace, drain,
                                os.path.join(d, f"{leg}.json"))
        res[leg]["max_divergence_margin"] = gate(
            model, CHAOS, f"chaos {leg}", res[leg]["tokens"], base)
    os.rmdir(d)
    launches["chaos"] = [c.launches for c in counters]
    log("engine path chaos: launches " + ", ".join(
        f"{k[0]}={n}" for k, n in zip(KERNELS, launches["chaos"])))
    missing = [KERNELS[i][0] for i in (FUSED, PAGED, MEGA)
               if launches["chaos"][i] == 0]
    if missing or launches["chaos"][PACKED]:
        raise AssertionError(f"chaos: launches {launches['chaos']}")
    res["launches"] = launches["chaos"]
    rec, prof = a["recovery"], b["recovery"]
    log(f"engine llama3.2-1b f32 chaos: {len(survivors)} of {CHAOS['n']} "
        f"survivors match the baseline"
        + ("" if res["chaos"]["max_divergence_margin"] is None
           else " up to near-ties")
        + f"; terminals cancelled {st['cancelled']} expired {st['expired']} "
        f"failed {st['failed']}, device faults {st['device_faults']}, "
        f"{st['preemptions']} preemptions; fired {a['fired']}; chaos-repeat "
        f"bit for bit; host ms per tick (debug audit) baseline "
        f"{res['baseline']['host_ms_per_tick']:.2f}, chaos "
        f"{a['host_ms_per_tick']:.2f}, repeat {b['host_ms_per_tick']:.2f}; "
        f"device error to every survivor decoding again: "
        + ("not measured" if rec is None else
           f"{rec['ms']:.2f} ms for {rec['resumed']} resumed slots")
        + ("" if prof is None or "device_ms_by_kernel" not in prof else
           "; its device ms by kernel (repeat): " + ", ".join(
               f"{k} {v:.3f}" for k, v in prof["device_ms_by_kernel"].items()
               if v))
        + "; re-prefill host ms: " + "; ".join(
            f"{leg} {sum(res[leg]['reprefill_ms']):.1f} over "
            f"{res[leg]['resumes']} resumes (restore to last "
            + ("not measured" if res[leg]["restore_to_last_resume_ms"]
               is None else f"{res[leg]['restore_to_last_resume_ms']:.1f}")
            + ")" for leg in ("crash-restore", "drain-restore")))
    return res


def restart_path(model):
    """The ``restart`` path: the llama3.2-1b artifact written by the port's
    ``save``, served by ``python -m repro_torch.launch.serve --supervise``
    with a crash at step 6. The child must exit 7 once, the supervisor
    restart it, and the new child resume the in-flight requests from the
    snapshot and exit 0, removing the snapshot. Times each line of the
    output as it arrives: time to recover is crash line → first heartbeat
    after the resume (process start, CUDA init, artifact load, kernel
    libraries loaded from build/, restore and the re-prefill step), less
    the supervisor's backoff, which is reported apart."""
    import re
    import shutil
    import signal
    import tempfile
    import threading
    d = tempfile.mkdtemp(prefix="restart-")
    art, snap = os.path.join(d, "artifact"), os.path.join(d, "snap.json")
    t0 = time.perf_counter()
    model.save(art)
    save_s = time.perf_counter() - t0
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--quantized-ckpt", art, "--snapshot", snap, *RESTART]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1")
    lines = []
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT, start_new_session=True)

    def pump():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=RESTART_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise AssertionError(f"restart: no exit within {RESTART_TIMEOUT_S} "
                             f"s:\n" + "\n".join(t for _, t in lines[-20:]))
    end = time.perf_counter() - t0
    reader.join(timeout=10)
    text = "\n".join(t for _, t in lines)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "restart.log"), "w") as f:
        f.write("\n".join(f"{t:9.3f} {x}" for t, x in lines) + "\n")

    def at(pattern, after=0.0):
        return next(((t, m) for t, x in lines if t >= after
                     for m in [re.search(pattern, x)] if m), (None, None))
    t_crash, _ = at(r"\[serve\] injected crash at step")
    t_resume, m = at(r"\[serve\] resumed (\d+) in-flight requests")
    _, mb = at(r"child exited rc=7; restart 1/\d+ in (\d+)s")
    t_launch2, _ = at(r"\[supervisor\] launching \(attempt 2\)")
    t_loaded2, _ = at(r"\[serve\] loaded artifact", after=t_launch2 or end)
    t_beat, _ = at(r"\[serve\] heartbeat step=1 ", after=t_resume or end)
    resumed = int(m.group(1)) if m else 0
    if rc != 0 or text.count("[serve] injected crash at step") != 1 \
            or text.count("child exited rc=7") != 1 \
            or text.count("[supervisor] launching") != 2 or resumed < 1 \
            or "[supervisor] child finished cleanly" not in text \
            or os.path.exists(snap) or None in (t_crash, t_beat, mb):
        raise AssertionError(f"restart: rc {rc}, resumed {resumed}, "
                             f"snapshot left {os.path.exists(snap)}:\n"
                             + text[-3000:])
    shutil.rmtree(d)
    backoff = float(mb.group(1))
    res = {"artifact_save_s": save_s, "rc": rc, "resumed": resumed,
           "backoff_s": backoff, "crash_to_resume_line_s": t_resume - t_crash,
           "crash_to_first_heartbeat_s": t_beat - t_crash,
           "time_to_recover_s": t_beat - t_crash - backoff,
           "launch_to_loaded_s": t_loaded2 - t_launch2,
           "loaded_to_resume_line_s": t_resume - t_loaded2,
           "resume_line_to_first_heartbeat_s": t_beat - t_resume,
           "resume_line_to_end_s": end - t_resume, "wall_s": end}
    log(f"restart llama3.2-1b: artifact saved in {save_s:.2f} s; child "
        f"exited 7 once, restarted, resumed {resumed} requests, exit 0; "
        f"crash to resume line {res['crash_to_resume_line_s']:.2f} s "
        f"(backoff {backoff:.0f} s; launch to artifact loaded "
        f"{res['launch_to_loaded_s']:.2f} s, loaded to resume line "
        f"{res['loaded_to_resume_line_s']:.2f} s), resume line to first "
        f"heartbeat (re-prefill step) "
        f"{res['resume_line_to_first_heartbeat_s']:.2f} s, time to recover "
        f"less backoff {res['time_to_recover_s']:.2f} s, resume line to end "
        f"{res['resume_line_to_end_s']:.2f} s, wall {end:.2f} s")
    return res


def serve_demo_paths():
    """``python -m repro_torch.launch.serve`` with ``SERVE_DEMO`` on the
    card, twice: without an artifact (the smoke teacher quantized on the
    card, the reference CLI's demo) and with ``--fp`` (the FP teacher
    served). Each must exit 0 and print its model line and its serve
    lines; their launches happen in the child processes and are not
    counted. The output goes to ``serve_demo.log`` in ``OUT_DIR``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1")
    n, new = int(SERVE_DEMO[3]), int(SERVE_DEMO[7])
    res, logs = {}, []
    for kind, extra, line in (
            ("demo", [], "[serve] quantized random-init teacher (demo)"),
            ("fp", ["--fp"], "[serve] FP random-init teacher (--fp)")):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve",
               *SERVE_DEMO, *extra]
        t0 = time.perf_counter()
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 env=env, cwd=ROOT,
                                 timeout=SERVE_DEMO_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise AssertionError(f"launch.serve {kind}: no exit within "
                                 f"{SERVE_DEMO_TIMEOUT_S} s") from e
        wall = time.perf_counter() - t0
        logs.append(f"$ {' '.join(cmd[1:])}\n{out.stdout}{out.stderr}")
        served = f"requests, {n * new} tokens"
        if out.returncode != 0 or line not in out.stdout \
                or "[serve] engine=continuous on cuda" not in out.stdout \
                or f"{n} {served}" not in out.stdout:
            raise AssertionError(f"launch.serve {kind}: rc "
                                 f"{out.returncode}:\n{out.stdout[-2000:]}"
                                 f"{out.stderr[-2000:]}")
        res[kind] = {"rc": out.returncode, "wall_s": wall,
                     "lines": [x for x in out.stdout.splitlines()
                               if x.startswith("[serve]")
                               and "heartbeat" not in x]}
        log(f"launch.serve {' '.join(SERVE_DEMO + extra)}: exit 0 in "
            f"{wall:.2f} s; " + "; ".join(res[kind]["lines"][:3]))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "serve_demo.log"), "w") as f:
        f.write("\n".join(logs))
    return res


def bf16_run(model, traffic, report, spec=None, paged=True):
    """The bf16 engine on the kernel path (speculative with `spec`; on the
    rectangle with ``paged=False``): decode tok/s (tokens emitted by
    decode steps over their host wall time), host ms per step (per cycle
    when speculative), TTFT, peak memory and the cache's attention bytes
    (``kv_cache_bytes``), and the host µs per step of the engine's
    tick-boundary reaping (``_reap``, run with no fault plan); with `spec`
    also the acceptance rate and the tokens committed per slot and cycle
    (a + 1 on average)."""
    import torch
    from repro_torch.kernels.ops import KernelPolicy
    torch.cuda.reset_peak_memory_stats()
    reap_s = [0.0]

    def time_reap(eng):
        reap = eng._reap

        def timed():
            t0 = time.perf_counter()
            reap()
            reap_s[0] += time.perf_counter() - t0
        eng._reap = timed
    _, eng, wall, st = serve(model, traffic, KernelPolicy(mode="cuda"),
                             spec=spec, on_engine=time_reap, paged=paged)
    ttft = sorted(h.ttft for h in eng.handles.values())
    acceptance = eng.spec.acceptance_rate() if spec else None
    kv_bytes = eng.kv_cache_bytes()
    del eng
    free()
    decode_tokens = st["tokens_emitted"] - st["admissions"]
    res = {"wall_s": wall, "decode_tok_s": decode_tokens
           / st["decode_time_s"], "ttft_s": ttft, "stats": st,
           "peak_gib": _peak_gib(),
           "decode_step_ms": 1e3 * st["decode_time_s"] / st["decode_steps"],
           "reap_us_per_step": 1e6 * reap_s[0] / st["steps"],
           "kv_cache_bytes": kv_bytes}
    what = "step"
    if spec:
        slot_cycles = st["decode_steps"] * traffic["max_batch"] \
            - st["wasted_slot_steps"]
        res.update(acceptance_rate=acceptance,
                   committed_per_slot_cycle=decode_tokens / slot_cycles)
        what = (f"cycle; {res['committed_per_slot_cycle']:.2f} tokens "
                f"committed per slot and cycle, acceptance {acceptance:.3f}")
    log(f"engine {traffic['arch']} bf16{' spec' if spec else ''}"
        f"{'' if paged else ' rect'} on "
        f"{report['device']}: decode {res['decode_tok_s']:.1f} tok/s "
        f"({res['decode_step_ms']:.1f} ms per {what}; "
        f"{traffic['max_batch']} slots; reaping "
        f"{res['reap_us_per_step']:.1f} µs per step), TTFT median "
        f"{ttft[len(ttft) // 2] * 1e3:.1f} ms (max {ttft[-1] * 1e3:.1f} ms), "
        f"peak {res['peak_gib']:.2f} GiB, KV cache {kv_bytes} bytes, wall "
        f"{wall:.2f} s")
    return res


def spec_compare(model, traffic, report):
    """bf16 plain decoding against speculative decoding on the kernel path,
    in turns (plain, spec, plain, spec) in this one process, since host
    time per step moves ±30% between processes; then the decode window of
    each under the profiler: device ms per committed token by kernel."""
    runs = {"plain": [], "spec": []}
    for kind in ("plain", "spec", "plain", "spec"):
        runs[kind].append(bf16_run(model, traffic, report,
                                   SPEC if kind == "spec" else None))
    prof = {kind: profile_decode(
        model, traffic, [r["decode_step_ms"] for r in runs[kind]],
        SPEC if kind == "spec" else None) for kind in runs}
    return {"runs": runs, "decode_profile": prof}


def _time_admissions(eng, times):
    """Record the host ms of each of `eng`'s admissions in `times`. An
    admission ends in a host read of its first token, so this is its wall
    time, device work included."""
    admit = eng._admit

    def timed(slot, item):
        t0 = time.perf_counter()
        try:
            return admit(slot, item)
        finally:
            times.append(1e3 * (time.perf_counter() - t0))
    eng._admit = timed


def prefix_run(model, traffic, report, prefix_cache):
    """The bf16 engine on the kernel path over a prefix traffic, with the
    prefix cache on or off: TTFT, host ms per admission, the hit rate, the
    copies on write, the pool's peak of pages in use, the most slots
    active at once, evictions, preemptions and decode tok/s."""
    import torch
    from repro_torch.kernels.ops import KernelPolicy
    times = []
    torch.cuda.reset_peak_memory_stats()
    _, eng, wall, st = serve(model, traffic, KernelPolicy(mode="cuda"),
                             megakernel=True, prefix_cache=prefix_cache,
                             on_engine=lambda e: _time_admissions(e, times))
    ttft = sorted(h.ttft for h in eng.handles.values())
    del eng
    free()
    hit = st["prefix_hit_tokens"] / st["prefix_lookup_tokens"] \
        if st["prefix_lookup_tokens"] else 0.0
    res = {"wall_s": wall, "ttft_s": ttft,
           "ttft_median_ms": 1e3 * ttft[len(ttft) // 2],
           "ttft_max_ms": 1e3 * ttft[-1], "admission_ms": times,
           "admission_ms_mean": sum(times) / len(times), "hit_rate": hit,
           "cow_copies": st["cow_copies"],
           "shared_pages": st["shared_pages"],
           "peak_used_pages": st["peak_used_pages"],
           "peak_active": st["peak_active"],
           "evicted_pages": st["evicted_pages"],
           "preemptions": st["preemptions"],
           "decode_tok_s": (st["tokens_emitted"] - st["admissions"])
           / st["decode_time_s"], "stats": st, "peak_gib": _peak_gib()}
    pool = traffic.get("kv_pool_pages")
    log(f"engine {traffic['arch']} bf16 prefix cache "
        f"{'on' if prefix_cache else 'off'}, {traffic['n']} requests of "
        f"{traffic['system']}-token system prompt"
        + ("" if pool is None else f", pool of {pool} pages")
        + f" on {report['device']}: TTFT "
        f"median {res['ttft_median_ms']:.1f} ms (max "
        f"{res['ttft_max_ms']:.1f} ms), {res['admission_ms_mean']:.2f} ms "
        f"per admission "
        f"({', '.join(f'{t:.1f}' for t in times)}), hit rate {hit:.3f}, "
        f"{st['cow_copies']} copies on write, {st['shared_pages']} pages "
        f"shared at the peak, peak {st['peak_used_pages']} pages in use, "
        f"{st['peak_active']} slots active at the peak, "
        f"{st['evicted_pages']} pages evicted, {st['preemptions']} "
        f"preemptions, decode {res['decode_tok_s']:.1f} tok/s, wall "
        f"{wall:.2f} s")
    return res


def profile_admissions(model, traffic, prefix_cache):
    """The traffic's admissions alone, under the profiler: every request
    asks for one new token, so it finishes at its admission and no decode
    step runs, while the prefix index sees the same prompts in the same
    order. Device ms by kernel, the launches of #1-#3 and the host ms of
    each admission."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ops import KernelPolicy
    counters = _counters()
    before = [c.launches for c in counters]
    times = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, eng, _, st = serve(model, dict(traffic, new=1),
                              KernelPolicy(mode="cuda"), megakernel=True,
                              prefix_cache=prefix_cache,
                              on_engine=lambda e: _time_admissions(e,
                                                                   times))
        torch.cuda.synchronize()
    del eng
    free()
    n_launch = {KERNELS[i][0]: c.launches - b
                for i, (c, b) in enumerate(zip(counters, before))}
    busy_s, _ = _device_kernels(prof)
    if busy_s == 0:
        log("engine bf16 admission profile: device time not measured")
        return None
    by_kernel = _by_kernel(prof)
    log(f"engine {traffic['arch']} bf16 admissions, prefix cache "
        f"{'on' if prefix_cache else 'off'}: {1e3 * busy_s:.2f} device ms "
        f"for {len(times)} admissions ({sum(times):.1f} host ms), "
        f"{st['prefix_hit_tokens']} tokens hit; by kernel: "
        + ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items() if v)
        + "; launches: " + ", ".join(f"{k} {v}" for k, v in n_launch.items()
                                     if v))
    return {"device_ms": 1e3 * busy_s, "by_kernel_ms": by_kernel,
            "launches": n_launch, "host_ms": times,
            "prefix_hit_tokens": st["prefix_hit_tokens"]}


def prefix_compare(model, traffic, report):
    """bf16 serving with the prefix cache on and off, in turns (on, off,
    on, off) in this one process, then one profiled window of the
    admissions alone per setting."""
    runs = {"on": [], "off": []}
    for kind in ("on", "off", "on", "off"):
        runs[kind].append(prefix_run(model, traffic, report, kind == "on"))
    prof = {kind: profile_admissions(model, traffic, kind == "on")
            for kind in runs}
    return {"runs": runs, "admission_profile": prof}


# The profiles record device activity only: every number read from them is
# device time, and recording the host's ops as well made a profiled run of
# small ops about 11x slower on the H100's host.


def _settle():
    """Idle host time at a profiled window's two ends, the card drained
    first: the profiler keeps only the device events that it places
    inside the window's host-clock bounds, and it places them through a
    conversion between the two clocks, so events at either end of a
    window that starts or ends with its work went unrecorded in some runs
    (a decode window's first host read; its last step and probe)."""
    import torch
    torch.cuda.synchronize()
    time.sleep(PROFILE_MARGIN_S)


def _device_events(prof):
    from torch.autograd import DeviceType
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)


def _device_kernels(prof):
    dev = _device_events(prof)
    busy_s = sum(e.self_device_time_total for e in dev) * 1e-6
    top = [{"kernel": e.key[:80], "calls": e.count,
            "device_ms": e.self_device_time_total * 1e-3} for e in dev[:10]]
    return busy_s, top


def _by_kernel(prof):
    """Device ms by kernel #1-#4, the lm head's matmul and every other
    (small) PyTorch op."""
    out = {KERNELS[i][0]: 0.0 for i in range(len(KERNELS))}
    out.update({"lm_head": 0.0, "small_ops": 0.0})
    for e in _device_events(prof):
        name = next((KERNELS[i][0] for i, k in TRACE_NAMES if k in e.key),
                    None)
        if name is None:
            name = "lm_head" if any(g in e.key.lower() for g in GEMM_NAMES) \
                else "small_ops"
        out[name] += e.self_device_time_total * 1e-3
    return out


def profile_engine(model, traffic, wall):
    """The bf16 engine run once more under torch.profiler: device time by
    kernel and the device's busy share of the unprofiled run's wall time
    (one stream, so kernel times add up without overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ops import KernelPolicy
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(model, traffic, KernelPolicy(mode="cuda"))
        torch.cuda.synchronize()
    busy_s, top = _device_kernels(prof)
    if busy_s == 0:
        log("engine bf16 profile: device time not measured (the profiler "
            "recorded no device events)")
        return None
    log(f"engine {traffic['arch']} bf16 profile: device busy {busy_s:.3f} s "
        f"of the {wall:.3f} s unprofiled wall ({100 * busy_s / wall:.1f}%); "
        "top: " + "; ".join(f"{t['kernel'][:40]} x{t['calls']} "
                            f"{t['device_ms']:.1f} ms" for t in top[:5]))
    return {"device_busy_s": busy_s, "wall_s": wall, "top": top}


def profile_decode(model, traffic, host_ms, spec=None, split=None,
                   tail=None):
    """The bf16 engine again (speculative with `spec`), admitting every
    request unprofiled and then profiling the decode-only steps that
    follow: device time per decode step (per cycle when speculative) and
    per committed token, by kernel, beside ``host_ms``, the unprofiled
    runs' host ms per step. ``split(prof, cfg, steps)``, when given, adds
    its device ms per step by op group as ``by_group_ms_per_step``.
    ``tail()``, when given, runs inside the profile after the decode
    window, for the split to read (the window's first events may go
    unrecorded in a process that profiled before; its last ones are
    kept)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ops import KernelPolicy
    eng = _engine(model, traffic, KernelPolicy(mode="cuda"), spec=spec)
    prompts = _requests(model.cfg, traffic)
    _submit(eng, prompts, range(traffic["n"]), traffic)
    while eng.scheduler.pending:
        eng.step()
    eng.step()                       # the first step with every slot filled
    torch.cuda.synchronize()
    steps0, tokens0 = eng.stats["decode_steps"], eng.stats["tokens_emitted"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _settle()
        while eng.in_flight:
            if eng.scheduler.pending:
                raise AssertionError("an admission fell in the decode window")
            eng.step()
        if tail is not None:
            tail()
        _settle()
    steps = eng.stats["decode_steps"] - steps0
    tokens = eng.stats["tokens_emitted"] - tokens0
    acceptance = eng.spec.acceptance_rate() if spec else None
    del eng
    free()
    busy_s, top = _device_kernels(prof)
    kind = "spec" if spec else "plain"
    groups = None if split is None or busy_s == 0 or steps == 0 else \
        split(prof, model.cfg, steps)
    if busy_s == 0 or steps == 0:
        log(f"engine bf16 {kind} decode profile: device time not measured")
        return None
    per_step = 1e3 * busy_s / steps
    by_kernel = {k: v / tokens for k, v in _by_kernel(prof).items()}
    log(f"engine {traffic['arch']} bf16 {kind} decode profile: {steps} "
        f"{'cycles' if spec else 'steps'}, {tokens} tokens committed, device "
        f"busy {per_step:.2f} ms per {'cycle' if spec else 'step'} against "
        f"{', '.join(f'{h:.2f}' for h in host_ms)} ms of host time "
        f"unprofiled; {1e3 * busy_s / tokens:.3f} device ms per committed "
        f"token: " + ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items()
                               if v))
    if groups is not None:
        log(f"engine {traffic['arch']} bf16 {kind} decode profile: device ms "
            f"per step by op group: " + ", ".join(
                f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in groups.items()))
    return {"decode_steps": steps, "committed_tokens": tokens,
            "device_ms_per_step": per_step, "by_group_ms_per_step": groups,
            "device_ms_per_token": 1e3 * busy_s / tokens,
            "by_kernel_ms_per_token": by_kernel, "host_ms_per_step": host_ms,
            "acceptance_rate": acceptance,
            "top_per_step": [dict(t, calls=t["calls"] / steps,
                                  device_ms=t["device_ms"] / steps)
                             for t in top]}


def pool_bytes_per_token(model, traffic):
    """Bytes of the engine's paged pool (every layer's cache leaves) per
    row it holds: ``kv_cache_bytes`` over n_pages x page_size."""
    from repro_torch.kernels.ops import KernelPolicy
    eng = _engine(model, traffic, KernelPolicy(mode="cuda"))
    out = eng.kv_cache_bytes() / (eng.kv.n_pages * eng.kv.page_size)
    log(f"engine {traffic['arch']} {model.cfg.dtype} pool: "
        f"{eng.kv_cache_bytes()} bytes over {eng.kv.n_pages} pages of "
        f"{eng.kv.page_size} rows: {out:.0f} bytes per token")
    del eng
    free()
    return out


def state_bytes_per_slot(model, traffic):
    """Bytes of the engine's per-slot state cache (the SSM family: every
    layer's f32 ``ssm`` state and conv rings) per slot; it does not grow
    with max_len."""
    from repro_torch.kernels.ops import KernelPolicy
    eng = _engine(model, traffic, KernelPolicy(mode="cuda"))
    if eng.kv is not None or eng.kv_cache_bytes():
        raise AssertionError("the SSM engine built a KV pool")
    leaves = eng.cache["layers"]
    out = eng.cache_bytes() / traffic["max_batch"]
    log(f"engine {traffic['arch']} {model.cfg.dtype} state cache: "
        f"{eng.cache_bytes()} bytes for {traffic['max_batch']} slots: "
        f"{out:.0f} bytes per slot ("
        + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}"
                    for k, v in leaves.items()) + ")")
    del eng
    free()
    return out


def hybrid_bytes(model, traffic):
    """The hybrid engine's cache per unit: the ring pool's bytes per row
    and slot (every application's k and v) and the Mamba2 state's bytes
    per slot (which do not grow with max_len)."""
    from repro_torch.kernels.ops import KernelPolicy
    eng = _engine(model, traffic, KernelPolicy(mode="cuda"))
    kv = eng.kv
    ring = eng.kv_cache_bytes() / (kv.n_pages * kv.page_size)
    state = (eng.cache_bytes() - eng.kv_cache_bytes()) / traffic["max_batch"]
    log(f"engine {traffic['arch']} {model.cfg.dtype} cache: a pool of "
        f"{kv.n_pages} pages of {kv.page_size} rows ({kv.ring_pages} ring "
        f"pages per slot), {eng.kv_cache_bytes()} bytes: {ring:.0f} bytes "
        f"per ring row and slot; state {state:.0f} bytes per slot ("
        + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}"
                    for k, v in eng.cache["layers"].items()) + ")")
    del eng
    free()
    return {"ring_bytes_per_row": ring, "state_bytes_per_slot": state}


def _zamba_positions(cfg):
    """What each launch of #1 in one decode forward of the hybrid with the
    megakernel on computes, in launch order: per Mamba2 block its six
    mixer projections, and after every ``attn_every``-th block the shared
    FFN's merged gate-up and w_down (the attention is one launch of #3)."""
    from repro_torch.models.transformer import shared_app
    out = []
    for i in range(cfg.n_layers):
        out += [f"mixer.{k}" for k in ("wz", "wx", "wB", "wC", "wdt",
                                       "out_proj")]
        if shared_app(cfg, i) is not None:
            out += ["ffn.wgu", "ffn.w_down"]
    return out


def zamba_split(prof, cfg, steps):
    """Device ms per decode step of the hybrid by op group, from the
    kernels' order on the one stream, the window cut into steps as in
    :func:`deepseek_split` (a step whose launches of #1 are not one whole
    forward, :func:`_zamba_positions`, is left out and counted). #1 is
    ``fused_mixer`` or ``fused_shared_ffn`` by its place in the forward;
    the shared block's attention kernel (#3, or #2) is ``attention``;
    every other kernel goes by what ran before it: after a block's wdt
    ``ssm_ops`` (softplus and the decay, the three conv steps, the state
    update, the read-out, the gated norm), after its out_proj
    ``state_commit`` (the residual, the state's select and copy into the
    cache, the next norm, the shared block's first norm), after the last
    launch of #1 a matmul is the ``lm_head``; the rest (the fresh k / v
    rows' page writes and the residuals and norm around the shared FFN,
    its activation, the embedding, sampling, copies) ``other``. Raises
    when no step is whole."""
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    chunks = [[]]
    for e in evs:
        chunks[-1].append(e)
        if "DtoH" in e.name or "Device -> P" in e.name:
            chunks.append([])
    order = _zamba_positions(cfg)
    attn_names = (TRACE_NAMES[MEGA][1], TRACE_NAMES[PAGED][1])
    out = dict.fromkeys(("fused_mixer", "ssm_ops", "state_commit",
                         "attention", "fused_shared_ffn", "lm_head",
                         "other"), 0.0)
    used = 0
    for chunk in chunks:
        if sum("fused_lowrank_kernel" in e.name for e in chunk) != len(order):
            continue
        used += 1
        pos = last = None
        head = False
        for e in chunk:
            ms = e.time_range.elapsed_us() * 1e-3
            gemm = any(g in e.name.lower() for g in GEMM_NAMES)
            if "fused_lowrank_kernel" in e.name:
                pos = 0 if pos is None else pos + 1
                last = order[pos]
                group = "fused_mixer" if last.startswith("mixer.") \
                    else "fused_shared_ffn"
            elif any(k in e.name for k in attn_names):
                last, group = "attention", "attention"
            elif head or last is None:
                group = "other"
            elif pos == len(order) - 1 and gemm:
                group, head = "lm_head", True
            elif last == "mixer.wdt":
                group = "ssm_ops"
            elif last == "mixer.out_proj":
                group = "state_commit"
            else:
                group = "other"
            out[group] += ms
    if not used:
        raise AssertionError(f"decode profile: none of {steps} steps holds "
                             f"one whole forward of {len(order)} launches "
                             f"of #1")
    log(f"decode profile split: {used} of {steps} steps whole")
    return dict({k: v / used for k, v in out.items()}, steps_used=used)


def mamba_split(prof, cfg, steps):
    """Device ms per decode step of a Mamba2 model by op group, from the
    kernels' order on the one stream, the window cut into steps as in
    :func:`deepseek_split` (a step whose launches of #1 are not one whole
    forward, 5 per layer, is left out and counted). #1 is ``fused``;
    every kernel between a layer's wC and its out_proj is ``ssm_ops`` (the
    FP wdt projection, softplus and the decay, the three conv steps, the
    state update, the read-out, the gated norm); between a layer's
    out_proj and the next layer's wz (or the lm head) ``state_commit``
    (the residual, the state's select and copy into the cache, the next
    block norm); the last forward's matmul after its last out_proj is
    ``lm_head``; the rest (the embedding, the first block norm, sampling,
    copies) ``other``. Raises when no step is whole."""
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    chunks = [[]]
    for e in evs:
        chunks[-1].append(e)
        if "DtoH" in e.name or "Device -> P" in e.name:
            chunks.append([])
    per_forward = 5 * cfg.n_layers
    out = dict.fromkeys(("fused", "ssm_ops", "state_commit", "lm_head",
                         "other"), 0.0)
    used = 0
    for chunk in chunks:
        if sum("fused_lowrank_kernel" in e.name for e in chunk) \
                != per_forward:
            continue
        used += 1
        pos, head = None, False
        for e in chunk:
            ms = e.time_range.elapsed_us() * 1e-3
            gemm = any(g in e.name.lower() for g in GEMM_NAMES)
            if "fused_lowrank_kernel" in e.name:
                pos = 0 if pos is None else pos + 1
                group = "fused"
            elif pos is None or head:
                group = "other"
            elif pos % 5 == 3:
                group = "ssm_ops"
            elif pos == per_forward - 1 and gemm:
                group, head = "lm_head", True
            elif pos % 5 == 4:
                group = "state_commit"
            else:
                group = "other"
            out[group] += ms
    if not used:
        raise AssertionError(f"decode profile: none of {steps} steps holds "
                             f"one whole forward of {per_forward} launches "
                             f"of #1")
    log(f"decode profile split: {used} of {steps} steps whole")
    return dict({k: v / used for k, v in out.items()}, steps_used=used)


def _mla_positions(cfg):
    """What each launch of #1 in one forward of an MLA model with merged
    groups computes, in launch order: four per layer (wq, w_dkv, w_kr, wo:
    no group merges them), then per dense block its wgu and w_down, per
    MoE layer three at the expert grid and, with shared experts, their wgu
    and w_down (240 for deepseek-v2-lite-16b)."""
    dense = ["attn.wq", "attn.w_dkv", "attn.w_kr", "attn.wo", "ffn.wgu",
             "ffn.w_down"]
    moe = ["attn.wq", "attn.w_dkv", "attn.w_kr", "attn.wo", "grid.w_gate",
           "grid.w_up", "grid.w_down"]
    if cfg.n_shared_experts:
        moe += ["shared.wgu", "shared.w_down"]
    return dense * cfg.first_k_dense \
        + moe * (cfg.n_layers - cfg.first_k_dense)


def deepseek_split(prof, cfg, steps):
    """Device ms per decode step of an MLA MoE model by op group, from the
    kernels' order on the one stream. The window is cut into steps at each
    step's device-to-host copy of the sampled tokens; a step whose launches
    of #1 are not one whole forward (the profiler may drop a record) is
    left out and counted. Within a step, #1 goes to the expert grid or
    elsewhere by its launch's place in the forward; every other kernel goes
    to the group of the launch of #1 before it: after wq, w_dkv or w_kr it
    is MLA's attention (RoPE, the latent norm, the page writes, the
    gather, the absorbed einsums, the softmax); after an MoE layer's wo,
    an expert linear or the shared wgu it is the MoE's (residual, norm,
    router, dispatch, activations, combine); after the last launch of the
    forward a matmul is the lm head; the rest (norms, residuals, the dense
    block's activation, embedding, sampling, copies) is ``other``. Raises
    when no step is whole."""
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    chunks = [[]]
    for e in evs:
        chunks[-1].append(e)
        if "DtoH" in e.name or "Device -> P" in e.name:
            chunks.append([])
    order = _mla_positions(cfg)
    first_moe = 6 * cfg.first_k_dense        # position of the first MoE wq
    out = dict.fromkeys(("fused_expert_grid", "fused_elsewhere",
                         "mla_attention_ops", "moe_dispatch_ops", "lm_head",
                         "other"), 0.0)
    used = 0
    for chunk in chunks:
        if sum("fused_lowrank_kernel" in e.name for e in chunk) != len(order):
            continue
        used += 1
        pos = last = None
        for e in chunk:
            ms = e.time_range.elapsed_us() * 1e-3
            if "fused_lowrank_kernel" in e.name:
                pos = 0 if pos is None else pos + 1
                last = order[pos]
                group = "fused_expert_grid" if last.startswith("grid.") \
                    else "fused_elsewhere"
            elif last in ("attn.wq", "attn.w_dkv", "attn.w_kr"):
                group = "mla_attention_ops"
            elif last is not None and pos >= first_moe and last in (
                    "attn.wo", "grid.w_gate", "grid.w_up", "grid.w_down",
                    "shared.wgu"):
                group = "moe_dispatch_ops"
            elif pos == len(order) - 1 and \
                    any(g in e.name.lower() for g in GEMM_NAMES):
                group = "lm_head"
            else:
                group = "other"
            out[group] += ms
    if not used:
        raise AssertionError(f"decode profile: none of {steps} steps holds "
                             f"one whole forward of {len(order)} launches "
                             f"of #1")
    log(f"decode profile split: {used} of {steps} steps whole")
    return dict({k: v / used for k, v in out.items()}, steps_used=used)


def vision_bytes(model, traffic):
    """The VLM engine's cache per unit: the self layers' pool bytes per row
    it holds (every self layer's k and v) and the image K/V bytes per slot
    (every cross layer's), each checked against its shapes."""
    from repro_torch.kernels.ops import KernelPolicy
    eng = _engine(model, traffic, KernelPolicy(mode="cuda"))
    kv, cfg = eng.kv, model.cfg

    def size(stack):
        return sum(t.numel() * t.element_size()
                   for t in eng.cache[stack].values())
    pool, image = size("self_layers"), size("cross_kv")
    per_token = pool / (kv.n_pages * kv.page_size)
    per_slot = image / traffic["max_batch"]
    es = eng.cache["cross_kv"]["k"].element_size()
    groups = cfg.n_layers // cfg.cross_attn_every
    row = 2 * cfg.n_kv_heads * cfg.head_dim * es
    if per_token != (cfg.n_layers - groups) * row or \
            per_slot != groups * cfg.n_image_tokens * row or \
            eng.kv_cache_bytes() != pool + image:
        raise AssertionError(f"vision cache bytes {per_token}, {per_slot}")
    log(f"engine {traffic['arch']} {cfg.dtype} cache: a pool of "
        f"{kv.n_pages} pages of {kv.page_size} rows, {pool} bytes: "
        f"{per_token:.0f} bytes per token; image K/V {image} bytes for "
        f"{traffic['max_batch']} slots: {per_slot:.0f} bytes per slot")
    del eng
    free()
    return {"pool_bytes_per_token": per_token,
            "image_kv_bytes_per_slot": per_slot}


def vision_split(prof, cfg, steps):
    """Device ms per decode step of the VLM by op group, from the kernels'
    order on the one stream, the window cut into steps at the host reads
    of the sampled tokens (a step whose launches of #1 are not one whole
    forward's, two per cross block, is left out and counted). #4 is
    ``packed_ffn`` (every FFN's two-call stages), #3 ``megakernel`` (the
    self layers' attention), #2 ``paged_attention`` (the megakernel off),
    #1 ``fused_cross`` (each cross block's wq and wo); every other kernel
    between a cross block's wq and its wo is ``cross_attention_ops`` (the
    q norm, the two score and value products over the 1024 image keys,
    the softmax), a matmul after the forward's last launch of #4 the
    ``lm_head``, and the rest ``other`` (norms, residuals, the FFN's
    activation, the fresh k / v rows' page writes, the gates, the
    embedding, sampling, copies). Raises when no step is whole."""
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    chunks = [[]]
    for e in evs:
        chunks[-1].append(e)
        if "DtoH" in e.name or "Device -> P" in e.name:
            chunks.append([])
    groups = cfg.n_layers // cfg.cross_attn_every
    names = {TRACE_NAMES[PACKED][1]: "packed_ffn",
             TRACE_NAMES[MEGA][1]: "megakernel",
             TRACE_NAMES[PAGED][1]: "paged_attention",
             TRACE_NAMES[FUSED][1]: "fused_cross"}
    out = dict.fromkeys(("packed_ffn", "megakernel", "paged_attention",
                         "fused_cross", "cross_attention_ops", "lm_head",
                         "other"), 0.0)
    used = 0
    for chunk in chunks:
        fused = [i for i, e in enumerate(chunk)
                 if TRACE_NAMES[FUSED][1] in e.name]
        if len(fused) != 2 * groups:
            continue
        used += 1
        last4 = max((i for i, e in enumerate(chunk)
                     if TRACE_NAMES[PACKED][1] in e.name), default=-1)
        n_fused = 0
        for i, e in enumerate(chunk):
            ms = e.time_range.elapsed_us() * 1e-3
            group = next((g for k, g in names.items() if k in e.name), None)
            if group == "fused_cross":
                n_fused += 1
            elif group is None:
                if n_fused % 2:
                    group = "cross_attention_ops"
                elif i > last4 and any(g in e.name.lower()
                                       for g in GEMM_NAMES):
                    group = "lm_head"
                else:
                    group = "other"
            out[group] += ms
    if not used:
        raise AssertionError(f"decode profile: none of {steps} steps holds "
                             f"one whole forward of {2 * groups} launches "
                             f"of #1")
    log(f"decode profile split: {used} of {steps} steps whole")
    return dict({k: v / used for k, v in out.items()}, steps_used=used)


def audio_bytes(model, traffic):
    """The audio engine's pool bytes per token (every layer's k and v row
    of one frame), checked against the shapes: layers x 2 x 24 x 64 x 2
    bytes in bf16 (294,912 at full depth)."""
    from repro_torch.kernels.ops import KernelPolicy
    eng = _engine(model, traffic, KernelPolicy(mode="cuda"))
    kv, cfg = eng.kv, model.cfg
    per_token = eng.kv_cache_bytes() / (kv.n_pages * kv.page_size)
    es = eng.cache["layers"]["k"].element_size()
    if per_token != cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * es:
        raise AssertionError(f"audio pool bytes per token {per_token}")
    log(f"engine {traffic['arch']} {cfg.dtype} pool: a pool of "
        f"{kv.n_pages} pages of {kv.page_size} rows, {eng.kv_cache_bytes()} "
        f"bytes: {per_token:.0f} bytes per token (one frame of "
        f"{cfg.n_codebooks} codebook ids)")
    del eng
    free()
    return {"pool_bytes_per_token": per_token}


def embed_probe(model):
    """A call of the audio embedding (the sum of the per-codebook tables)
    at a decode step's shape, ending in a host read: run as
    ``profile_decode``'s tail, after the last step's host read, its
    kernels are the window's last chunk, which :func:`audio_split`
    counts. The frames are allocated here, before any profile."""
    import torch
    from repro_torch.models import transformer as TT
    cfg = model.cfg
    toks = torch.zeros((MUSICGEN["max_batch"], 1, cfg.n_codebooks),
                       dtype=torch.long, device="cuda")

    def probe():
        with torch.inference_mode():
            TT.embed_tokens(model.params, cfg, toks)
            toks.cpu()
    return probe


def audio_split(prof, cfg, steps):
    """Device ms per decode step of the audio model by op group, from the
    kernels' order on the one stream, the window cut into steps at the
    host reads of the sampled frames (a step whose launches of #1 are not
    one whole forward's, two per layer with the megakernel on and four
    with it off, is left out and counted). #3 is ``megakernel``, #2
    ``paged_attention`` (the megakernel off), #1 ``fused``; a step's first
    kernels (the host-to-card copies of the frames, positions and tables
    before them are not kernels), as many as the embedding alone launched
    in the window's last chunk that holds a kernel (:func:`embed_probe`,
    after the last step's host read), are
    the ``embedding`` sum of the 4 codebook tables, a matmul after the
    step's last launch of #1 the ``lm_head``, and the rest ``other``
    (norms, residuals, the FFN's activation, the fresh k / v rows' page
    writes, the greedy argmax, copies). Raises when that chunk holds no
    kernel or a kernel of #1-#4 (it is then no embedding alone), or when
    no step is whole."""
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    chunks = [[]]
    for e in evs:
        chunks[-1].append(e)
        if "DtoH" in e.name or "Device -> P" in e.name:
            chunks.append([])
    def copy(e):
        return "Memcpy" in e.name or "Memset" in e.name or "->" in e.name
    # the probe's kernels: the window's last chunk that holds a kernel (the
    # probe's closing host read can go unrecorded, leaving its kernels in
    # the unterminated last chunk rather than the one before it)
    probe = next((c for c in reversed(chunks)
                  if any(not copy(e) for e in c)), [])
    n_embed = sum(not copy(e) for e in probe)
    if n_embed == 0 or any(k in e.name for e in probe
                           for _, k in TRACE_NAMES):
        raise AssertionError(f"decode profile: {n_embed} kernels between "
                             f"the window's last two host reads, not the "
                             f"embedding alone")
    names = {TRACE_NAMES[MEGA][1]: "megakernel",
             TRACE_NAMES[PAGED][1]: "paged_attention",
             TRACE_NAMES[FUSED][1]: "fused"}
    out = dict.fromkeys(("embedding", "megakernel", "paged_attention",
                         "fused", "lm_head", "other"), 0.0)
    used = 0
    for chunk in chunks:
        fused = [i for i, e in enumerate(chunk)
                 if TRACE_NAMES[FUSED][1] in e.name]
        if len(fused) not in (2 * cfg.n_layers, 4 * cfg.n_layers):
            continue
        used += 1
        kernels = 0
        for i, e in enumerate(chunk):
            ms = e.time_range.elapsed_us() * 1e-3
            group = next((g for k, g in names.items() if k in e.name), None)
            if group is None:
                if not copy(e) and kernels < n_embed:
                    group = "embedding"
                elif i > fused[-1] and any(g in e.name.lower()
                                           for g in GEMM_NAMES):
                    group = "lm_head"
                else:
                    group = "other"
            kernels += not copy(e)
            out[group] += ms
    if not used:
        raise AssertionError(f"decode profile: none of {steps} steps holds "
                             f"one whole forward's launches of #1")
    log(f"decode profile split: {used} of {steps} steps whole; the "
        f"embedding launches {n_embed} kernels")
    return dict({k: v / used for k, v in out.items()}, steps_used=used,
                embedding_kernels=n_embed)


def audio_summary(res, cfg, report):
    """The audio model's bf16 line: decode frames/s and codebook tokens/s
    (frames x codebooks), host and device ms per step, the device's busy
    share of the decode steps (device ms over the unprofiled host ms per
    step), TTFT, peak memory and the pool's bytes per token."""
    run, prof = res["bf16"], res["bf16_decode_profile"]
    run["decode_frames_s"] = run["decode_tok_s"]
    run["decode_codebook_tokens_s"] = cfg.n_codebooks * run["decode_tok_s"]
    dev_ms = None if prof is None else prof["device_ms_per_step"]
    run["decode_busy_share"] = None if dev_ms is None \
        else dev_ms / run["decode_step_ms"]
    ttft = run["ttft_s"]
    log(f"engine {cfg.name} bf16 on {report['device']}: decode "
        f"{run['decode_frames_s']:.1f} frames/s "
        f"({run['decode_codebook_tokens_s']:.1f} codebook tokens/s), host "
        f"{run['decode_step_ms']:.2f} ms per step, device "
        + ("not measured" if dev_ms is None else
           f"{dev_ms:.2f} ms per step (busy "
           f"{100 * run['decode_busy_share']:.1f}%)")
        + f", TTFT median {ttft[len(ttft) // 2] * 1e3:.1f} ms (max "
        f"{ttft[-1] * 1e3:.1f} ms), peak {run['peak_gib']:.2f} GiB, pool "
        f"{run['pool_bytes_per_token']:.0f} bytes per token")


def profile_image_prefill(model):
    """The VLM's image prefill in bf16: ``generate`` of ``VISION_IMAGE``
    with no new token (the batched prefill, each cross layer's image K/V
    projected once, and the rows' insertion into the pool), once to warm
    up and once under the profiler: host ms, and device ms by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ops import KernelPolicy
    from repro_torch.serve.engine import ServeConfig, generate
    cfg = model.cfg
    toks, img = _vision_image_inputs(cfg, torch.bfloat16)
    scfg = ServeConfig(greedy=True, max_new_tokens=0, page_size=64)

    def run():
        t0 = time.perf_counter()
        generate(model.params, cfg, toks, scfg, image_embeds=img,
                 policy=KernelPolicy(mode="cuda"))
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    run()
    host_s = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    busy_s, top = _device_kernels(prof)
    free()
    if busy_s == 0:
        log("image prefill profile: device time not measured")
        return None
    by_kernel = _by_kernel(prof)
    log(f"engine {cfg.name} bf16 image prefill ({len(toks)} prompts of "
        f"{toks.shape[1]} tokens, {cfg.n_image_tokens} image tokens each): "
        f"host {1e3 * host_s:.1f} ms, device {1e3 * busy_s:.1f} ms: "
        + ", ".join(f"{k} {v:.2f}" for k, v in by_kernel.items() if v))
    return {"host_ms": 1e3 * host_s, "device_ms": 1e3 * busy_s,
            "by_kernel_ms": by_kernel, "top": top}


# ---------------------------------------------------------------------------
# the quantization pipeline on the card
# ---------------------------------------------------------------------------

def packed_per_forward(tree, apps=1, lead=None):
    """Launches of (#1, #4) in one forward of a packed tree with no merged
    groups (a params tree or its template): a packed linear of rank up to
    ``MAX_FUSED_RANK`` launches #1 once per layer of its stack (the
    stack's leading axes, :func:`lead_axes`: the VLM's self layers have
    two), a stack of experts being one launch over all of them, an
    unstacked linear (the hybrid's shared block, two-dimensional words)
    once per application, `apps`; one past that rank launches #4 twice
    per layer (the two-call route)."""
    from repro_torch.kernels.binary_matmul import MAX_FUSED_RANK
    from repro_torch.models.transformer import lead_axes
    if "qu_t" in tree:
        shape = tree["qu_t"].shape
        n = math.prod(shape[:lead]) if len(shape) > 2 else apps
        return (n, 0) if tree["qv"].shape[-1] <= MAX_FUSED_RANK \
            else (0, 2 * n)
    out = [0, 0]
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = packed_per_forward(v, apps,
                                     lead_axes(k) if lead is None else lead)
            out = [a + b for a, b in zip(out, sub)]
    return tuple(out)


def check_autograd(expert=False, twocall=False):
    """The packed linear's autograd Function (#1's; #4's past rank 4096)
    against autograd through its plain version, f32 and bf16:
    ``ops.lowrank_binary_matmul`` (the KD phase's student linear) at
    ``AUTOGRAD``'s shape, or with `expert`
    ``ops.lowrank_binary_matmul_expert`` at deepseek-v2-lite-16b's expert
    grid (G = 64, x per group; w_gate's K 2048 -> N 1408 at the 1.0 bpw
    rank; the capacity rows a KD step's 4 x 256 tokens give), or with
    `twocall` the same Function on the two-call route at
    ``TWOCALL_AUTOGRAD``'s shape, past #1's rank: #4 twice, its rank
    intermediate rounded to x's dtype, held against the two-stage oracle
    (``ref.lowrank_binary_matmul_ref``) that rounds it likewise. The output
    and the gradients of x, s1 and s2 within the kernel tolerances, the
    forward one launch (two of #4 on the two-call route, none of #1); the
    forward and the forward + backward timed
    (CUDA events, median of 21) beside the same forward + backward
    through library matmuls over factors unpacked beforehand in x's dtype
    (a yardstick). The bound of the forward + backward: its inputs read
    and outputs written once, and the four products the function needs at
    the bf16 tensor rate the exact ±1 factors allow: z = ((x ⊙ s2) @ V) @
    Uᵀ in the forward, ((g ⊙ s1) @ U) @ Vᵀ for ∂x and ∂s2, and ∂s1 =
    Σ_rows g ⊙ z with no product (the Function's backward recomputes z,
    two products more than the bound counts). Returns the f32 and bf16
    records."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.bpw import rank_for_bpw
    from repro_torch.kernels import binary_matmul, ops, ref
    kern_i, n_fwd = (PACKED, 2) if twocall else (FUSED, 1)
    if expert:
        cfg = get_config("deepseek-v2-lite-16b")
        G, K, N = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        R = rank_for_bpw(N, K, 1.0, 32)
        tokens = 4 * QUANT["seq"]  # a KD step's batch: 4 calibration rows
        M = max(8, -(-math.ceil(tokens * cfg.n_experts_per_tok / G
                                * cfg.capacity_factor) // 8) * 8)
        lead, fn, label = (G,), ops.lowrank_binary_matmul_expert, "expert "
    else:
        shape = TWOCALL_AUTOGRAD if twocall else AUTOGRAD
        (M, K, R, N), G = (shape[k] for k in "MKRN"), 1
        lead, fn = (), ops.lowrank_binary_matmul
        label = "two-call " if twocall else ""
    kern_name = "#4" if twocall else "#1"
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + 30 + expert + 2 * twocall)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, lead + shape,
                             generator=gen, device="cuda", dtype=torch.int32)

    def rand(*shape):
        return torch.rand(lead + shape, generator=gen, device="cuda")

    def per_row(t):                # a scale over the rows of its group
        return t[:, None] if expert else t

    def plain(xx, qv_, qu_, a, b):
        if expert:
            return binary_matmul.fused_lowrank_matmul_grouped_ref(
                xx, qv_, qu_, a, b, x_shared=False)
        if twocall:
            return ref.lowrank_binary_matmul_ref(xx, qv_, qu_, a, b)
        return ref.lowrank_binary_matmul_fused_ref(xx, qv_, qu_, a, b)
    rows = []
    for dt, tdt in _dtypes():
        x = torch.randn(lead + (M, K), generator=gen, device="cuda").to(tdt)
        qv, qu = words(K // 32, R), words(R // 32, N)
        s1 = (rand(N) + 0.5) / R ** 0.5
        s2 = (rand(K) + 0.5) / K ** 0.5
        gy = torch.randn(lead + (M, N), generator=gen, device="cuda").to(tdt)
        leaves = [t.clone().requires_grad_() for t in (x, s1, s2)]

        def run(f):
            y = f(leaves[0], qv, qu, leaves[1], leaves[2])
            return (y, *torch.autograd.grad(y, leaves, gy))
        n0 = [c.launches for c in _counters()]
        kern = run(fn)
        n1 = [c.launches for c in _counters()]
        if n1[kern_i] - n0[kern_i] != n_fwd or sum(n1) - sum(n0) != n_fwd:
            raise AssertionError(f"{kern_name} {label}autograd: the forward "
                                 f"is not {n_fwd} launch(es) of "
                                 f"{kern_name} alone: {n0} -> {n1}")
        errs = [compare(f"{kern_name} {label}autograd {dt} {nm}", a, b,
                        TOL[dt])
                for nm, a, b in zip(("y", "dx", "ds1", "ds2"), run(plain),
                                    kern)]
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fn(x, qv, qu, s1, s2))
        v, u = ref.unpack_signs(qv, tdt), ref.unpack_signs(qu, tdt)

        def library(xx, qv_, qu_, a, b):
            return torch.matmul(torch.matmul(xx * per_row(b).to(tdt), v), u) \
                * per_row(a).to(tdt)
        w_bytes, flops = lowrank_cost(K, ((R, N),), M)
        io = 2 * nbytes(x, gy) + nbytes(s1, s2)   # x, dx, gy, y; ds1, ds2
        bound_ms, bound_by = bound(G * w_bytes + io,
                                   (2 * G * flops, BF16_TC_FLOPS_S))
        rec = {"M": M, "K": K, "R": R, "N": N, "dtype": dt,
               "max_abs_err": max(e[0] for e in errs),
               "rel_err": max(e[1] for e in errs), "forward_ms": fwd_ms,
               "ms": time_ms(lambda: run(fn)),
               "plain_ms": time_ms(lambda: run(plain)),
               "library_ms": time_ms(lambda: run(library)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if expert:
            rec["G"] = G
        del v, u
        log(f"{kern_name} {label}autograd {dt} "
            + (f"G {G} " if expert else "")
            + f"M {M} K {K} R {R} N {N}: output and dx, ds1, ds2 match the "
            f"plain version (rel err {rec['rel_err']:.2e}); forward "
            f"{fwd_ms:.3f} ms, forward + backward {rec['ms']:.3f} ms (plain "
            f"{rec['plain_ms']:.3f}, library over unpacked factors "
            f"{rec['library_ms']:.3f}, bound {bound_ms:.4f} ms by "
            f"{bound_by})")
        rows.append(rec)
    free()
    return rows


def quantize_path(arch, launches, depth=None, teacher_ckpt=None):
    """The port's quantization pipeline on `arch` at full width, at full
    depth or `depth` layers (``QUANT``'s calibration, ``QuantConfig()``),
    with every launch count set to 0 just before it; see phases 2b and 2c
    of the module docstring. #1 must launch once per packed linear of rank
    up to 4096 (an expert stack: once over its experts; the hybrid's
    shared block once per application) and #4 twice per packed linear past
    it (the VLM's FFN) in each block's check forward and in each KD step's
    student forward, and nothing else; the MoE's expert grids are counted
    apart, and one KD step's expert scale gradients are held against the
    plain path's (:func:`kd_expert_grads`). ``DRILL``'s arch runs with the
    journal on (a temporary directory). The VLM's blocks are timed by part
    (:func:`block_parts`). With `teacher_ckpt` the teacher is the one
    trained there (:func:`trained_teacher`), and the record adds its FP
    perplexity, the init teacher's and the quantized model's on the
    quantize CLI's evaluation batches. Returns (its record, the saved
    artifact's directory)."""
    import tempfile
    import torch
    from repro_torch.api import NanoQuantModel
    from repro_torch.checkpoint.journal import _crc_leaves
    from repro_torch.kernels import binary_matmul
    from repro_torch.models.transformer import n_shared_apps
    from repro_torch.quant.surgery import abstract_quantized_params
    name = f"{arch}-quantize"
    t0 = time.perf_counter()
    cfg, teacher, calib, qcfg = quantize_inputs(arch, depth)
    trained = None
    if teacher_ckpt:
        teacher, trained, evalb = trained_teacher(cfg, teacher, teacher_ckpt)
    setup_s = time.perf_counter() - t0
    d = tempfile.mkdtemp(prefix="quantize-")
    journal = os.path.join(d, "journal") if arch == DRILL["arch"] else None
    counters = _counters()
    grid = binary_matmul.fused_lowrank_matmul_grouped.grid_launches
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    grid.clear()
    parts = []
    with (block_parts(parts) if cfg.family == "vlm"
          else contextlib.nullcontext()):
        model = NanoQuantModel.quantize(teacher, cfg, calib, qcfg,
                                        verbose=False, journal_dir=journal,
                                        device="cuda")
    launches[name] = n = [c.launches for c in counters]
    grid = dict(grid)
    peak = _peak_gib()
    rep = model.report
    secs = rep["seconds"]
    for row, sec in zip(rep["blocks"], secs["blocks"]):
        log(f"quantize {arch} {row['block']}: {sec:.2f} s, block_err "
            f"{row['block_err']:.6g}, pre_loss {row['pre_loss']:.6g}, "
            f"ste_loss {row['ste_loss']:.6g}, init {row['init_method']}"
            + (f", fallbacks {row['fallbacks']}" if row["fallbacks"] else ""))
    for rec, sec in zip(parts, secs["blocks"]):
        rec["block_s"] = sec
        rec["target_and_stream_s"] = sec - rec["quantize_block_s"]
        log(f"quantize {arch} {rec['block']} by part: TuneFP "
            f"{rec['tunefp_s']:.2f} s ({qcfg.t_pre} steps), LB-ADMM "
            f"{sum(a['s'] for a in rec['admm']):.2f} s ("
            + ", ".join(f"{a['linear']} {a['s']:.2f} s at rank {a['rank']}"
                        for a in rec["admm"])
            + f"; {qcfg.admm_iters} iterations each), STE "
            f"{rec['ste_s']:.2f} s ({qcfg.t_post} steps), packing "
            f"{rec['pack_s']:.2f} s, preconditioners, check forward and the "
            f"rest {rec['rest_s']:.2f} s, target forward "
            f"{rec['target_and_stream_s']:.2f} s")
    kd = rep.get("kd_losses", [])
    # KD's steps cycle over the calibration batches: its first and last
    # pass read the same batches
    n_cal = len(calib)
    kd_pass = (sum(kd[:n_cal]) / n_cal, sum(kd[-n_cal:]) / n_cal) \
        if len(kd) >= n_cal else (float("nan"), float("nan"))
    sizes = model.size_report()
    ranks = {}
    for key, r in model.ranks.items():      # the same in every block
        ranks.setdefault(key.split(".", 1)[1], set()).add(r)
    ranks = {k: sorted(v) for k, v in ranks.items()}
    apps = n_shared_apps(cfg)
    per_forward = packed_per_forward(model.params, apps)
    # the hybrid's shared block also runs one check forward of its own,
    # over its gathered inputs
    shared = packed_per_forward(model.params["shared_attn"]) if apps \
        else (0, 0)
    want = [(1 + qcfg.t_glob) * f + g for f, g in zip(per_forward, shared)]
    log(f"quantize {cfg.name} {cfg.dtype} ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, calibration {QUANT['samples']} x {QUANT['seq']}"
        + (", journaled" if journal else "") + "): "
        f"teacher and data {setup_s:.2f} s, calibration "
        f"{secs['calibration']:.2f} s, "
        + (f"journal {secs['journal']:.2f} s, " if journal else "")
        + (f"gather {secs['gather']:.2f} s, " if "gather" in secs else "")
        + f"blocks {sum(secs['blocks']):.2f} s, "
        f"KD {secs['kd']:.2f} s ({qcfg.t_glob} steps), wall "
        f"{rep['wall_s']:.2f} s, peak {peak:.2f} GiB; KD loss "
        f"{kd[0]:.6g} -> {kd[-1]:.6g} (first and last pass over the "
        f"{n_cal} batches: {kd_pass[0]:.6g} -> {kd_pass[1]:.6g}); ranks "
        f"{ranks}; linears bpw "
        f"{sizes['linears_bpw']:.4f}; launches " + ", ".join(
            f"{k[0]}={c}" for k, c in zip(KERNELS, n))
        + f"; #1 by (groups, x shared) {grid}")
    bad = [r["block"] for r in rep["blocks"]
           if not math.isfinite(r["block_err"])]
    if bad or not kd or not all(math.isfinite(v) for v in kd):
        raise AssertionError(f"quantize {arch}: non-finite block errors "
                             f"{bad} or KD losses {kd}")
    tmpl = packed_per_forward(abstract_quantized_params(
        cfg, qcfg.target_bpw, qcfg.min_dim, qcfg.rank_align,
        qcfg.pack_k_align), apps)
    if per_forward != tmpl:
        raise AssertionError(f"quantize {arch}: (#1, #4) launches per "
                             f"forward {per_forward}, the template's {tmpl}")
    if [n[FUSED], n[PACKED]] != want or n[PAGED] or n[MEGA]:
        raise AssertionError(
            f"quantize {arch}: launches {n}, expected {want} of (#1, #4) "
            f"({[f + g for f, g in zip(per_forward, shared)]} in the blocks' "
            f"check forwards + {qcfg.t_glob} KD steps x {per_forward}) and "
            f"none of the others")
    res = {"launches_per_forward": per_forward}
    if trained is not None:
        # on the artifact's kernel path, after the path's counts were read
        trained["ppl_q"] = model.perplexity(evalb)
        res.update(trained)
        log(f"quantize {arch}: teacher trained {trained['teacher']['step']} "
            f"steps (crc32 {trained['teacher']['crc32']:#010x}); ppl_fp "
            f"{trained['ppl_fp']:.4f} (init teacher "
            f"{trained['ppl_fp_init']:.4f}), ppl_q {trained['ppl_q']:.4f} "
            f"on 8 x {QUANT['seq']} evaluation tokens (seed 99)")
        if not all(math.isfinite(trained[k]) for k in
                   ("ppl_fp", "ppl_fp_init", "ppl_q")):
            raise AssertionError(f"quantize {arch}: perplexities {trained}")
    if parts:
        res["block_parts"] = parts
    if cfg.family == "moe":
        n_moe = cfg.n_layers - cfg.first_k_dense
        want_grid = 3 * n_moe * (1 + qcfg.t_glob)
        if grid.get((cfg.n_experts, False)) != want_grid:
            raise AssertionError(f"quantize {arch}: #1 at the expert grid "
                                 f"{grid}, expected {want_grid} launches")
        res["kd_expert_grads"] = kd_expert_grads(teacher, model.params, cfg,
                                                 calib[0], qcfg)
    fallbacks = {r["block"]: r["fallbacks"] for r in rep["blocks"]
                 if r["fallbacks"]}
    if fallbacks:
        log(f"quantize {arch}: blocks off the lb_admm rung: {fallbacks}")
    if journal:
        res.update(crc=_crc_leaves(model.params),
                   packed_crc=_crc_leaves(packed_words(model.params)),
                   ranks_by_block=model.ranks)
        log(f"quantize {arch}: journal of {len(rep['blocks'])} blocks in "
            f"{journal}; quantized params crc32 {res['crc']:#010x}, packed "
            f"words {res['packed_crc']:#010x}")
    split = kd_split(teacher, model.params, cfg, calib[0], qcfg)
    art = os.path.join(d, "artifact")
    t0 = time.perf_counter()
    model.save(art)
    save_s = time.perf_counter() - t0
    res.update({"setup_s": setup_s, "seconds": secs,
                "wall_s": rep["wall_s"], "peak_gib": peak,
                "blocks": rep["blocks"], "kd_losses": kd,
                "kd_pass_means": kd_pass,
                "kd_lowered_loss": kd_pass[1] < kd_pass[0], "ranks": ranks,
                "sizes": sizes, "launches": n,
                "grid_launches": {f"G={g} x_shared={x}": c
                                  for (g, x), c in grid.items()},
                "fallbacks": fallbacks, "kd_step_split": split,
                "save_s": save_s, "n_layers": cfg.n_layers,
                "quant_config": dataclasses.asdict(qcfg),
                "calibration": dict(QUANT, arch=arch)})
    del model, teacher
    free()
    return res, art


def kd_expert_grads(teacher, qparams, cfg, batch, qcfg):
    """One KD step's loss (the pipeline's ``_kd_loss_chunked`` of the
    student against the teacher) differentiated on the kernel path and on
    the plain oracles, both models cast to f32 (in bf16 the oracles' rank
    intermediate, rounded to bf16, moves the router's choices and with
    them whole rows of an expert's gradient): every expert stack's s1 / s2
    gradient must be non-zero on the kernel path (the experts' grid
    launches carry a gradient) and within the bf16 tolerance of the plain
    path's, relative to its largest entry."""
    import torch
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import pipeline as P
    from repro_torch.core import util
    from repro_torch.kernels.ops import KernelPolicy, kernel_policy
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(cfg, dtype="float32")
    teacher, qparams = (params_from_numpy(t, "cuda", torch.float32)
                        for t in (teacher, qparams))
    toks = batch["tokens"].to("cuda")
    with torch.no_grad():
        hT = T.backbone(teacher, cfg, toks)
    trainable, frozen = util.partition(qparams, P._is_scale_path)
    grads = {}
    for mode in ("cuda", "ref"):
        tr = P._requires_grad(trainable)
        with kernel_policy(KernelPolicy(mode=mode)), torch.enable_grad():
            qp = util.combine(tr, frozen)
            loss = P._kd_loss_chunked(T.backbone(qp, cfg, toks), hT, qp,
                                      teacher, cfg, qcfg.kd_temp)
            g = P._grads(loss, tr)
        grads[mode] = {p: t for p, t in util.leaves_with_path(g)
                       if "/moe/w_" in p}
    out = {}
    for path, got in grads["cuda"].items():
        want = grads["ref"][path].float()
        top = float(want.abs().max())
        if not float(got.abs().max()) > 0 or not top > 0:
            raise AssertionError(f"KD expert gradient {path}: zero")
        rel = float((got.float() - want).abs().max()) / top
        norm_rel = float((got.float() - want).norm() / want.norm())
        out[path] = {"max_abs": float(got.abs().max()), "rel_err": rel,
                     "norm_rel_err": norm_rel}
        if rel > TOL["bf16"]:
            raise AssertionError(f"KD expert gradient {path}: rel err "
                                 f"{rel:.3e} > {TOL['bf16']} against the "
                                 f"plain path")
    log("quantize KD step: the expert scales' gradients on the kernel path "
        "are non-zero and match the plain path's: " + ", ".join(
            f"{p} max {r['max_abs']:.3e} rel err {r['rel_err']:.2e}"
            for p, r in out.items()))
    free()
    return out


@contextlib.contextmanager
def block_parts(rows):
    """Time each quantized block's parts on the card from outside the
    pipeline: ``core.pipeline``'s ``_quantize_block``, ``_tune`` (TuneFP,
    or STE when it tunes the latents), ``_init_latent`` (LB-ADMM and
    balancing of one linear), ``_pack_latent`` and ``linear_paths`` are
    wrapped for the scope, each call ended by a device sync; nothing is
    added to the pipeline's report. Appends one record per block to
    `rows`: the seconds of TuneFP, of each linear's LB-ADMM (with its
    rank), of STE and of packing, and the rest of ``_quantize_block``
    (preconditioners, the check forward, the guards)."""
    import torch
    from repro_torch.core import pipeline as P
    saved = {n: getattr(P, n) for n in ("_quantize_block", "_tune",
                                         "_init_latent", "_pack_latent",
                                         "linear_paths")}

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def quantize_block(apply_fn, bp_fp, Xq_b, Y, ctx_b, stats, bref, label,
                       *a, **k):
        rec = {"block": label, "tunefp_s": 0.0, "ste_s": 0.0, "pack_s": 0.0,
               "admm": [], "linears": []}
        rows.append(rec)
        t0 = clock()
        out = saved["_quantize_block"](apply_fn, bp_fp, Xq_b, Y, ctx_b,
                                       stats, bref, label, *a, **k)
        rec["quantize_block_s"] = clock() - t0
        rec["rest_s"] = rec["quantize_block_s"] - rec["tunefp_s"] \
            - rec["ste_s"] - rec["pack_s"] - sum(x["s"] for x in rec["admm"])
        return out

    def tune(apply_fn, bp, pred, *a, **k):
        t0 = clock()
        out = saved["_tune"](apply_fn, bp, pred, *a, **k)
        key = "ste_s" if pred is P._is_latent_path else "tunefp_s"
        rows[-1][key] += clock() - t0
        return out

    def init_latent(*a, **k):
        t0 = clock()
        lat, r = saved["_init_latent"](*a, **k)
        rec = rows[-1]
        names = rec["linears"]              # a fallback rung starts over
        rec["admm"].append({"linear": names[len(rec["admm"]) % len(names)],
                            "rank": r, "s": clock() - t0})
        return lat, r

    def pack_latent(*a, **k):
        t0 = clock()
        out = saved["_pack_latent"](*a, **k)
        rows[-1]["pack_s"] += clock() - t0
        return out

    def paths(*a, **k):
        out = saved["linear_paths"](*a, **k)
        rows[-1]["linears"] = [".".join(p) for p in out]
        return out
    for name, fn in (("_quantize_block", quantize_block), ("_tune", tune),
                     ("_init_latent", init_latent),
                     ("_pack_latent", pack_latent), ("linear_paths", paths)):
        setattr(P, name, fn)
    try:
        yield rows
    finally:
        for name, fn in saved.items():
            setattr(P, name, fn)


# the profiler's range around each autograd node's backward
BACKWARD_RANGE = "autograd::engine::evaluate_function: "


def kd_split(teacher, qparams, cfg, batch, qcfg):
    """One more KD step, the pipeline's own (``tune_scales_kd`` over one
    batch with ``t_glob`` 1), under the profiler: its device ms split into
    #1's and #4's forwards (the student's packed linears, by the kernels'
    names), the backward's plain ops (kernels launched by ATen ops under
    the autograd engine's ``evaluate_function`` ranges; the packed
    linears' share of them, under ``_LowrankBinaryMatmulBackward``,
    beside) and the other ops (teacher forward, the student's other ops
    and the loss, the optimizer), with the step's host ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import pipeline as P
    one = dataclasses.replace(qcfg, t_glob=1)

    def step():
        t0 = time.perf_counter()
        P.tune_scales_kd(teacher, qparams, cfg, [batch], one)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)
    step()                                   # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _settle()
        host_ms = step()
        _settle()
    events = prof.events()
    fused, packed_mm = TRACE_NAMES[FUSED][1], TRACE_NAMES[PACKED][1]
    total = first = two = 0.0
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ms = e.time_range.elapsed_us() * 1e-3
            total += ms
            first += ms if fused in e.name else 0.0
            two += ms if packed_mm in e.name else 0.0

    def backward_fn(e):
        """The autograd node whose backward launched e's kernels, or
        None outside the backward."""
        while e is not None:
            if e.name.startswith(BACKWARD_RANGE):
                return e.name[len(BACKWARD_RANGE):]
            e = e.cpu_parent
        return None
    backward = packed = 0.0
    for e in events:
        node = (backward_fn(e) if e.device_type == DeviceType.CPU
                and e.kernels else None)
        if node is not None:
            ms = sum(k.duration for k in e.kernels
                     if fused not in k.name and packed_mm not in k.name) \
                * 1e-3
            backward += ms
            packed += ms if node == "_LowrankBinaryMatmulBackward" else 0.0
    if total == 0:
        log("quantize KD step profile: device time not measured")
        return {"host_ms": host_ms, "device_ms": None}
    groups = {"#1 forward": first, "backward plain ops": backward,
              "other ops": total - first - two - backward}
    if two:
        groups["#4 forward"] = two
    log(f"quantize KD step: device {total:.1f} ms: " + ", ".join(
        f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in groups.items())
        + f" (of the backward, the packed linears' {packed:.1f} ms); host "
        f"{host_ms:.1f} ms")
    return {"host_ms": host_ms, "device_ms": total, "by_group_ms": groups,
            "packed_backward_ms": packed}


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def _timed_step(step_fn, ms, losses):
    """`step_fn` timed between device syncs, each step's ms and loss kept."""
    import torch

    def run(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*a)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[3]["loss"]))
        return out
    return run


def train_path(launches, smi):
    """The trainer on ``TRAIN``'s arch at full width, cut to its
    ``QUANT_DEPTH`` (phase 2a of the module docstring), with every launch
    count set to 0 just before it: the drill (a run checkpointing every
    ``ckpt_every`` steps under ``launch.supervisor.run_with_restarts``,
    crashed by an exception at ``crash_at`` and resumed from the last
    checkpoint to the end), then an uninterrupted run with no manager.
    Gated on finite losses, the uninterrupted run's last-10 mean loss
    below its first-10 mean, the reference's 0.2 margin on its tiny config
    (:func:`train_learns`), the resumed state (params, AdamW moments and
    step) equal to the uninterrupted one's bit for bit, the planned crash
    alone caught, and no kernel launched. Returns (its record, the
    checkpoint directory, whose last step is the trained teacher)."""
    import tempfile
    import torch
    from repro_torch.checkpoint.journal import _crc_leaves
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import train_iterator
    from repro_torch.launch.supervisor import run_with_restarts
    from repro_torch.train import TrainConfig, Trainer, make_train_step
    arch = TRAIN["arch"]
    name = f"{arch}-train"
    cfg = dataclasses.replace(get_config(arch), n_layers=QUANT_DEPTH[arch])
    tcfg = TrainConfig(lr=1e-3, warmup=20, total_steps=TRAIN["steps"])
    B, seq = TRAIN["batch"], QUANT["seq"]
    ckpt = os.path.join(tempfile.mkdtemp(prefix="train-"), "ckpt")
    saves, restores, attempts, said = [], [], [], []

    class TimedManager(CheckpointManager):
        def save(self, step, tree, **kw):
            t0 = time.perf_counter()
            path = super().save(step, tree, **kw)
            saves.append({"step": step, "s": time.perf_counter() - t0,
                          "bytes": _dir_bytes(path)})
            return path

        def restore_latest(self, template):
            t0 = time.perf_counter()
            out = super().restore_latest(template)
            if out is not None:
                restores.append({"step": out[0],
                                 "s": time.perf_counter() - t0})
            return out

    counters = _counters()
    for c in counters:
        c.launches = 0
    drill_ms, drill_losses = [], []

    def attempt(n):
        mgr = TimedManager(ckpt)
        start = mgr.latest_step() or 0
        tr = Trainer(cfg, tcfg, train_iterator(cfg, B, seq,
                                               start_step=start),
                     mgr, ckpt_every=TRAIN["ckpt_every"],
                     step_fn=_timed_step(make_train_step(cfg, tcfg),
                                         drill_ms, drill_losses),
                     log_every=TRAIN["ckpt_every"], log_fn=log,
                     device="cuda")
        t0 = time.perf_counter()
        tr.restore_or_init()
        torch.cuda.synchronize()
        attempts.append({"attempt": n, "start_step": tr.step,
                         "restore_or_init_s": time.perf_counter() - t0})
        budget = TRAIN["steps"] - tr.step
        if n == 0:
            budget = min(budget, TRAIN["crash_at"] - tr.step)
        tr.run(budget)
        if n == 0:
            raise RuntimeError(f"injected trainer crash at step {tr.step}")
        attempt.state = tr.state

    t0 = time.perf_counter()
    restarts = run_with_restarts(attempt, max_restarts=1,
                                 log=lambda m: (said.append(m), log(m)))
    drill_s = time.perf_counter() - t0
    want = f"injected trainer crash at step {TRAIN['crash_at']}"
    resume_at = TRAIN["crash_at"] // TRAIN["ckpt_every"] * TRAIN["ckpt_every"]
    if restarts != 1 or not any(want in m for m in said) \
            or [a["start_step"] for a in attempts] != [0, resume_at]:
        raise AssertionError(f"train drill: restarts {restarts}, attempts "
                             f"{attempts}, supervisor said {said}")
    resumed = attempt.state
    del attempt.state

    plain_ms, plain_losses = [], []
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tcfg, train_iterator(cfg, B, seq),
                 step_fn=_timed_step(make_train_step(cfg, tcfg), plain_ms,
                                     plain_losses),
                 log_every=TRAIN["ckpt_every"], log_fn=log, device="cuda")
    t0 = time.perf_counter()
    tr.run(TRAIN["steps"])
    plain_s = time.perf_counter() - t0
    peak = _peak_gib()
    launches[name] = n = [c.launches for c in counters]

    crc = {"resumed": _crc_leaves(resumed), "uninterrupted":
           _crc_leaves(tr.state)}
    # the state's parts apart only when the whole differs (a 5 GB read each)
    crc_parts = None if crc["resumed"] == crc["uninterrupted"] else {
        part: [_crc_leaves(st[i]) for st in (resumed, tr.state)]
        for i, part in enumerate(("params", "adamw", "eff"))}
    k = TRAIN["first_steps"]
    step_ms = sorted(plain_ms[k:])[len(plain_ms[k:]) // 2]
    first10, last10 = (sum(plain_losses[:10]) / 10,
                       sum(plain_losses[-10:]) / 10)
    rec = {"n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": B,
           "seq": seq, "steps": TRAIN["steps"],
           "train_config": dataclasses.asdict(tcfg),
           "step_ms_median": step_ms, "first_step_ms": plain_ms[:k],
           "tokens_per_s": B * seq / (step_ms / 1e3), "peak_gib": peak,
           "uninterrupted_s": plain_s, "drill_s": drill_s,
           "saves": saves, "restores": restores, "attempts": attempts,
           "loss_first10": first10, "loss_last10": last10,
           "losses": plain_losses, "drill_losses": drill_losses,
           "crc32": crc, "crc32_parts": crc_parts,
           "bit_identical": crc["resumed"] == crc["uninterrupted"],
           "launches": n, "device": smi}
    log(f"train {cfg.name} {cfg.dtype} ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {B} x {seq} tokens a step, remat {cfg.remat}) on "
        f"{smi}: step {step_ms:.2f} ms median (first {k}: "
        + ", ".join(f"{x:.1f}" for x in plain_ms[:k]) + " ms), "
        f"{rec['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GiB; loss "
        f"{first10:.4f} -> {last10:.4f} (first and last 10 steps); saves "
        + ", ".join(f"step {x['step']} {x['s']:.2f} s {x['bytes'] / 1e9:.2f}"
                    f" GB" for x in saves)
        + "; restore " + ", ".join(f"step {x['step']} {x['s']:.2f} s"
                                   for x in restores)
        + f"; drill {drill_s:.2f} s, uninterrupted {plain_s:.2f} s; "
        f"resumed crc32 {crc['resumed']:#010x}, uninterrupted "
        f"{crc['uninterrupted']:#010x}; launches {n}")
    rec["tiny"] = tiny = train_learns()
    bad = [x for x in plain_losses + drill_losses if not math.isfinite(x)]
    if bad:
        raise AssertionError(f"train: non-finite losses {bad[:5]}")
    # the synthetic chain over 128256 tokens gives no transition to learn
    # in 150 steps (PERF.md §6): the full-width loss must fall, the
    # reference's 0.2 margin is held on its own tiny config (train_learns)
    if not last10 < first10:
        raise AssertionError(f"train: loss {first10} -> {last10} did not "
                             f"fall")
    if not rec["bit_identical"]:
        raise AssertionError(f"train drill: the resumed state differs from "
                             f"the uninterrupted run's: {crc_parts}")
    if any(n):
        raise AssertionError(f"train: kernels launched {n}")
    del resumed, tr
    free()
    return rec, ckpt


def train_learns():
    """The reference's ``tests/test_train.py::test_loss_decreases`` on the
    card through the port's train step: its tiny dense config (d 64,
    vocab 256, bf16, untied head), ``TrainConfig(lr=2e-3, warmup=5,
    total_steps=40)``, 30 steps of 8 x 32 tokens; the last 5 losses' mean
    must be 0.2 below the first 5's. Returns (first-5 mean, last-5
    mean)."""
    from repro_torch.data import train_iterator
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                      loss_chunk=0, remat=False)
    tcfg = TrainConfig(lr=2e-3, warmup=5, total_steps=40)
    state = init_train_state(cfg, tcfg, device="cuda")
    step = make_train_step(cfg, tcfg)
    it = train_iterator(cfg, batch=8, seq=32)
    losses = []
    for _ in range(30):
        *state, m = step(*state, next(it))
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"train the reference's tiny config (tests/test_train.py): loss "
        f"{first:.4f} -> {last:.4f} over 30 steps")
    if not all(math.isfinite(x) for x in losses) or not last < first - 0.2:
        raise AssertionError(f"train tiny: loss {losses}")
    return {"first5": first, "last5": last}


def trained_teacher(cfg, init_teacher, ckpt):
    """The teacher ``launch.quantize --teacher-ckpt`` takes from `ckpt`
    (``train_teacher``: ``Trainer.restore_or_init`` over the directory, no
    further step), checked at ``TRAIN``'s last step, and the FP
    perplexities of it and of `init_teacher` on the CLI's evaluation
    batches (8 x ``QUANT["seq"]``, seed 99). Returns (teacher, record,
    the evaluation batches)."""
    from repro_torch.api import NanoQuantModel
    from repro_torch.data.synthetic import calib_batches
    from repro_torch.launch.quantize import train_teacher
    evalb = calib_batches(cfg, 8, QUANT["seq"], seed=99)
    ppl_init = NanoQuantModel.from_fp(init_teacher, cfg).perplexity(evalb)
    teacher, info = train_teacher(cfg, TRAIN["steps"], QUANT["seq"], ckpt,
                                  "cuda", log=log)
    if info["step"] != TRAIN["steps"] or info["trained_steps"]:
        raise AssertionError(f"quantize: the teacher checkpoint gave {info}")
    ppl_fp = NanoQuantModel.from_fp(teacher, cfg).perplexity(evalb)
    return teacher, {"teacher": info, "ppl_fp_init": ppl_init,
                     "ppl_fp": ppl_fp}, evalb


def train_cli_path(smi):
    """``python -m repro_torch.launch.train`` with ``TRAIN_CLI`` (the
    published llama3.2-1b config: 16 layers, remat, loss_chunk 2048 and
    sdpa_flash at S 4096) as a subprocess with no checkpoint directory,
    gated on exit 0 and finite losses; then one layer's attention at S
    4096 in f32 (``FLASH``), ``sdpa_flash`` (after the dispatch's GQA head
    repeat) against the plain ``sdpa``: the output and the q / k / v
    gradients of a seeded cotangent within the f32 tolerance, each timed
    forward + backward. Output in ``OUT_DIR/launch_train.log``."""
    import torch
    from repro_torch.models import layers as L
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=TRAIN_CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"launch.train: no exit within "
                             f"{TRAIN_CLI_TIMEOUT_S} s") from e
    wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "launch_train.log"), "w") as f:
        f.write(f"$ {' '.join(cmd[1:])}\n{out.stdout}{out.stderr}")
    steps = [ln for ln in out.stdout.splitlines()
             if ln.startswith("[trainer] step=")]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in steps]
    step_s = [float(ln.split("(")[1].split("s/step")[0]) for ln in steps]
    peak = [ln for ln in out.stdout.splitlines() if "peak device" in ln]
    n_steps = int(TRAIN_CLI[TRAIN_CLI.index("--steps") + 1])
    if out.returncode != 0 or len(losses) != n_steps \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"launch.train: rc {out.returncode}, losses "
                             f"{losses}:\n{out.stdout[-2000:]}"
                             f"{out.stderr[-2000:]}")
    peak_gib = float(peak[-1].split()[-2]) if peak else float("nan")
    res = {"rc": out.returncode, "wall_s": wall, "losses": losses,
           "step_s": step_s, "peak_gib": peak_gib, "args": TRAIN_CLI}
    log(f"launch.train {' '.join(TRAIN_CLI)}: exit 0 in {wall:.2f} s on "
        f"{smi}; losses {losses}; step s {step_s}; peak {peak_gib:.2f} GiB")

    g = torch.Generator(device="cuda").manual_seed(SEED + 70)
    S, Hq, Hkv, D = FLASH["S"], FLASH["Hq"], FLASH["Hkv"], FLASH["D"]
    q, k, v = (torch.randn((1, S, h, D), generator=g, device="cuda")
               for h in (Hq, Hkv, Hkv))
    ct = torch.randn((1, S, Hq, D), generator=g, device="cuda")
    pos = torch.arange(S, device="cuda")
    scale = 1.0 / math.sqrt(D)
    got = {}
    for kind in ("flash", "plain"):
        tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "flash":
            G = Hq // Hkv
            o = L.sdpa_flash(tq, tk.repeat_interleave(G, dim=2),
                             tv.repeat_interleave(G, dim=2), pos, pos, scale,
                             0, 512, 1024)
        else:
            o = L.sdpa(tq, tk, tv, L._mask(pos, pos, 0), scale)
        grads = torch.autograd.grad(o, (tq, tk, tv), ct)
        torch.cuda.synchronize()
        got[kind] = (o.detach(), grads, (time.perf_counter() - t0) * 1e3)
    pairs = [("out", got["plain"][0], got["flash"][0])] + [
        (f"d{n}", a, b) for n, a, b in zip("qkv", got["plain"][1],
                                           got["flash"][1])]
    errs = {n: compare(f"sdpa_flash vs sdpa at S {S}: {n}", a, b,
                       TOL["f32"])[1] for n, a, b in pairs}
    res["flash_vs_plain"] = {"rel_err": errs, "flash_ms": got["flash"][2],
                             "plain_ms": got["plain"][2], **FLASH}
    log(f"sdpa_flash vs sdpa at S {S} (Hq {Hq}, Hkv {Hkv}, D {D}, f32) on "
        f"{smi}: rel err " + ", ".join(f"{k} {v:.3g}" for k, v in
                                       errs.items())
        + f"; forward + backward {got['flash'][2]:.1f} ms (flash), "
        f"{got['plain'][2]:.1f} ms (plain), first call each")
    del got, pairs, q, k, v, ct
    free()
    return res


def quantize_cli_path(smi):
    """``python -m repro_torch.launch.quantize`` with ``QUANT_CLI`` and
    ``--teacher-ckpt`` over one directory, twice: the first run trains the
    smoke teacher 20 steps and saves it, the second must train none (its
    log says so) and quantize the same teacher (the crc32 of its leaves in
    each run's report.json). Output in ``OUT_DIR/launch_quantize.log``."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1")
    d = tempfile.mkdtemp(prefix="quantize-cli-")
    runs, logs = [], []
    for i in range(2):
        out_dir = os.path.join(d, f"nq{i}")
        cmd = [sys.executable, "-m", "repro_torch.launch.quantize",
               *QUANT_CLI, "--teacher-ckpt", os.path.join(d, "teacher"),
               "--out", out_dir]
        t0 = time.perf_counter()
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 env=env, cwd=ROOT,
                                 timeout=QUANT_CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise AssertionError(f"launch.quantize run {i}: no exit within "
                                 f"{QUANT_CLI_TIMEOUT_S} s") from e
        wall = time.perf_counter() - t0
        logs.append(f"$ {' '.join(cmd[1:])}\n{out.stdout}{out.stderr}")
        if out.returncode != 0:
            raise AssertionError(f"launch.quantize run {i}: rc "
                                 f"{out.returncode}:\n{out.stdout[-2000:]}"
                                 f"{out.stderr[-2000:]}")
        with open(os.path.join(out_dir, "report.json")) as f:
            rep = json.load(f)
        runs.append({"wall_s": wall, "teacher": rep["teacher"],
                     "ppl_fp": rep["ppl_fp"], "ppl_q": rep["ppl_q"],
                     "lines": [x for x in out.stdout.splitlines()
                               if x.startswith("[quantize] teacher")]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "launch_quantize.log"), "w") as f:
        f.write("\n".join(logs))
    shutil.rmtree(d, ignore_errors=True)
    steps = int(QUANT_CLI[QUANT_CLI.index("--teacher-steps") + 1])
    t0, t1 = (r["teacher"] for r in runs)
    log("launch.quantize " + " ".join(QUANT_CLI) + " --teacher-ckpt, twice, "
        f"on {smi}: "
        + "; ".join(f"{r['lines']} in {r['wall_s']:.2f} s, ppl_fp "
                    f"{r['ppl_fp']:.4f}, ppl_q {r['ppl_q']:.4f}"
                    for r in runs)
        + f"; teacher crc32 {t0['crc32']:#010x} / {t1['crc32']:#010x}")
    if (t0["trained_steps"], t1["trained_steps"]) != (steps, 0) \
            or t0["step"] != steps or t1["step"] != steps \
            or t0["crc32"] != t1["crc32"] \
            or f"teacher at step {steps}: 0 steps trained" not in \
            " ".join(runs[1]["lines"]):
        raise AssertionError(f"launch.quantize --teacher-ckpt: {runs}")
    return {"runs": runs}


def quantize_inputs(arch, depth=None):
    """(cfg, FP teacher on the card, calibration batches, QuantConfig()) of
    `arch` at full width and full depth or `depth` layers, the teacher
    drawn from ``SEED`` (the same tensors at every call). A VLM cut below
    one group of ``cross_attn_every`` layers groups its `depth` layers as
    one (the repo's SMOKE grouping: self blocks, then the cross block);
    its teacher's gates are redrawn under ``GATE_LAWS`` (JAX's zeros make
    every cross block the identity) and its calibration batches carry
    ``n_image_tokens`` seeded image embeddings per sample."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import QuantConfig
    from repro_torch.data.synthetic import calib_batches
    from repro_torch.models import transformer as T
    from repro_torch.testing import with_gates
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
        if cfg.family == "vlm" and depth < cfg.cross_attn_every:
            cfg = dataclasses.replace(cfg, cross_attn_every=depth)
    teacher = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    if cfg.family == "vlm":
        teacher = with_gates(teacher, SEED + 50)
    calib = calib_batches(cfg, QUANT["samples"], QUANT["seq"])
    torch.cuda.synchronize()
    return cfg, teacher, calib, QuantConfig()


def packed_words(tree):
    """The packed ±1 words (qv, qu_t) of a params tree, keyed as in it."""
    if not isinstance(tree, dict):
        return None
    out = {k: (v if k in ("qv", "qu_t") else packed_words(v))
           for k, v in tree.items()}
    return {k: v for k, v in out.items() if v is not None} or None


def quantize_drill(arch, depth, base, launches):
    """The crash-safe pipeline's drill (phase 2c of the module docstring)
    on ``DRILL``'s arch at `depth` layers, against `base`, the record of
    its uninterrupted journaled run: a journaled run crashed when block
    ``DRILL["crash_at"]`` starts, its resume, a corrupted copy of the
    crashed journal and a resume under another QuantConfig. Only the one
    planned ``InjectedPipelineCrash`` is caught; every check that fails
    raises. The launch counts are set to 0 before the crashed run and read
    after the resume (path ``<arch>-quantize-drill``). Returns its
    record."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint.journal import (JournalError, QuantJournal,
                                                _crc_leaves, run_fingerprint)
    from repro_torch.core.pipeline import blocks_of, nanoquant_quantize
    from repro_torch.quant.faults import (InjectedPipelineCrash, QuantFault,
                                          QuantFaultPlan, _corrupt_last_line)
    name, at = f"{arch}-quantize-drill", DRILL["crash_at"]
    cfg, teacher, calib, qcfg = quantize_inputs(arch, depth)
    labels = [f"{b.stack}[{b.idx}]" for b in blocks_of(cfg)]
    n_blocks = len(labels)
    d = tempfile.mkdtemp(prefix="quantize-drill-")
    journal = os.path.join(d, "journal")
    counters = _counters()
    for c in counters:
        c.launches = 0
    plan = QuantFaultPlan([QuantFault(block=at, kind="crash_block")])
    crashed = []
    t0 = time.perf_counter()
    try:
        nanoquant_quantize(teacher, cfg, calib, qcfg, verbose=False,
                           journal_dir=journal, faults=plan,
                           heartbeat=crashed.append)
        raise AssertionError(f"drill {arch}: the crash planned at block "
                             f"{at} never fired")
    except InjectedPipelineCrash as e:
        if e.block != at:
            raise AssertionError(f"drill {arch}: crashed at block {e.block}, "
                                 f"planned at {at}") from e
    crash_s = time.perf_counter() - t0
    crash_launches = [c.launches for c in counters]
    journaled = QuantJournal(journal).n_completed_blocks()
    if plan.fired != [(at, "crash_block")] or journaled != at:
        raise AssertionError(f"drill {arch}: fired {plan.fired}, {journaled} "
                             f"blocks journaled; expected one crash at "
                             f"block {at} after {at} blocks")
    shutil.copytree(journal, os.path.join(d, "corrupt"))
    resumed = []
    t0 = time.perf_counter()
    qp, rep = nanoquant_quantize(teacher, cfg, calib, qcfg, verbose=False,
                                 journal_dir=journal, resume=True,
                                 heartbeat=resumed.append)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches[name] = n = [c.launches for c in counters]
    blocks = [b for b in resumed if b.startswith("block=")]
    want = ([f"block={i}/{n_blocks} {labels[i]} resumed" for i in range(at)]
            + [f"block={i}/{n_blocks} {labels[i]} start"
               for i in range(at, n_blocks)])
    if [b for b in blocks if b.endswith((" resumed", " start"))] != want:
        raise AssertionError(f"drill {arch}: the resume's blocks {blocks}, "
                             f"expected {at} resumed and the rest computed")
    crc, packed_crc = _crc_leaves(qp), _crc_leaves(packed_words(qp))
    same = {"crc": crc == base["crc"],
            "packed_crc": packed_crc == base["packed_crc"],
            "blocks": rep["blocks"] == base["blocks"],
            "ranks": rep["ranks"] == base["ranks_by_block"],
            "kd_losses": rep.get("kd_losses") == base["kd_losses"]}
    if not all(same.values()):
        diff = [i for i, (a, b) in enumerate(zip(rep["blocks"],
                                                  base["blocks"])) if a != b]
        raise AssertionError(f"drill {arch}: the resumed run differs from "
                             f"the uninterrupted one: {same}; rows differ at "
                             f"blocks {diff}; crc {crc:#010x} vs "
                             f"{base['crc']:#010x}")
    del qp
    fingerprint = run_fingerprint(teacher, cfg, qcfg, calib, n_blocks)
    corrupt = os.path.join(d, "corrupt")
    _corrupt_last_line(os.path.join(corrupt, "journal.jsonl"))
    want_block = labels[at - 1]
    try:
        QuantJournal(corrupt).entries_for_resume(fingerprint)
        raise AssertionError(f"drill {arch}: a corrupted journal was "
                             f"accepted")
    except JournalError as e:
        if e.block != want_block:
            raise AssertionError(f"drill {arch}: the corrupted journal was "
                                 f"refused naming {e.block!r}, not "
                                 f"{want_block!r}: {e}") from e
        corrupt_msg = str(e)
    t0 = time.perf_counter()
    try:
        nanoquant_quantize(teacher, cfg, calib,
                           dataclasses.replace(qcfg, seed=1), verbose=False,
                           journal_dir=journal, resume=True)
        raise AssertionError(f"drill {arch}: a resume under another "
                             f"QuantConfig was accepted")
    except JournalError as e:
        if "quant_config" not in str(e):
            raise AssertionError(f"drill {arch}: refused for {e}") from e
        other_msg = str(e)
    other_s = time.perf_counter() - t0
    secs = rep["seconds"]
    log(f"drill {arch}: the crash planned at block {at} ({labels[at]}) "
        f"fired once after {at} journaled blocks, {crash_s:.2f} s; the "
        f"resume reloaded blocks 0-{at - 1} and computed {at}-"
        f"{n_blocks - 1}, {resume_s:.2f} s (calibration "
        f"{secs['calibration']:.2f} s, journal {secs['journal']:.2f} s, "
        f"gather {secs['gather']:.2f} s, blocks {sum(secs['blocks']):.2f} "
        f"s, KD {secs['kd']:.2f} s); quantized params crc32 {crc:#010x} "
        f"and packed words {packed_crc:#010x} equal the uninterrupted "
        f"run's, and so do its {n_blocks} report rows, ranks and "
        f"{len(rep['kd_losses'])} KD losses; the corrupted journal refused "
        f"naming {want_block}; a resume under QuantConfig(seed=1) refused "
        f"in {other_s:.2f} s; launches " + ", ".join(
            f"{k[0]}={c}" for k, c in zip(KERNELS, n))
        + f" (the crashed run's {crash_launches[FUSED]} of #1)")
    if any(n[i] for i in (PAGED, MEGA, PACKED)) or not n[FUSED]:
        raise AssertionError(f"drill {arch}: launches {n}")
    shutil.rmtree(d)
    del teacher
    free()
    return {"crash_at": at, "crash_block": labels[at], "fired": plan.fired,
            "crash_s": crash_s, "resume_s": resume_s, "other_run_s": other_s,
            "resume_seconds": secs, "crc": crc, "packed_crc": packed_crc,
            "equal": same, "resumed_blocks": at,
            "computed_blocks": n_blocks - at, "launches": n,
            "crash_launches": crash_launches,
            "corrupt_refusal": corrupt_msg, "other_run_refusal": other_msg}


def quantize_serve(arch, art, launches):
    """The quantized artifact of `arch` loaded and cast to f32, served on
    the plain oracles and on the path ``<arch>-quantized`` under its
    ``QUANT_SERVES`` traffic, gated like its family's serving paths."""
    import shutil
    import torch
    from repro_torch.api import NanoQuantModel
    t0 = time.perf_counter()
    model = cast(NanoQuantModel.load(art), torch.float32)
    load_s = time.perf_counter() - t0
    log(f"quantized {arch} artifact loaded in {load_s:.2f} s and cast to "
        f"f32")
    res = serve_paths(model, QUANT_SERVES[arch], launches)
    res["load_s"] = load_s
    if model.cfg.family == "vlm":
        res["image"] = vision_image_path(model, launches,
                                         f"{arch}-quantized-image")
    del model
    free()
    shutil.rmtree(os.path.dirname(art))
    return res


if __name__ == "__main__":
    main()
