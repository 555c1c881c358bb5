#!/usr/bin/env python3
"""Smoke run of the PyTorch port (galvatron_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
its result line:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build every kernel from ``galvatron_tpu_torch/ops/csrc`` with nvcc for
   sm_90a (one nvcc per source, all at once), with the ``-Xptxas -v`` report;
2. the paged decode kernel against its plain PyTorch version on the same
   CUDA tensors, at the serving path's shapes (llama-7b decode: 4 rows, 32
   heads, head_dim 128, 16-token blocks, 128 blocks per row, bf16), a GQA
   shape, fp32, one row of 16384 positions, 7-token blocks, and gpt-1.5b's
   decode (4 rows, 25 heads of 64, one per kv head, 16-token blocks, 64
   blocks per row, bf16: the kernel's head_dim-64 instance); bf16 must be
   within one output ulp of the plain version computed in fp32, fp32 within
   1e-5. One JSON line per shape with the split plan, the kernel's, the
   plain version's and the library call's (SDPA over gathered K/V, timed
   only) times, and the least time the card could take (bytes over 3.35
   TB/s, or operations over the peak rate of the input type);
3. the flash forward and backward kernels against their plain versions on
   the same CUDA tensors: the training path's shape (b=8, h=32, s=2048,
   d=128, bf16, the stacked qkv projection view), ragged s=100 at d=64, GQA
   with kv_rep 4, fp32, the training shape, ragged s=100 and GQA at fp16
   (the fp16 training path's TMA route) and fp16 at d=40 (the CUDA-core
   kernels' fp16 instances). fp32 within 1e-5 (out, lse) and 1e-4
   (gradients); bf16 per element within one output ulp plus a share of
   the row's rms (``bf16_parity_excess`` within ``BF16_PARITY_TOL``), fp16
   the same with fp16's ulp (``fp16_parity_excess``, ``FP16_PARITY_TOL``). A
   control, the plain versions with one key tile dropped, must fail the
   same checks. One JSON line per case with the errors, the control's,
   kernel, plain, library (SDPA with is_causal over pre-roped q/k, and its
   autograd backward; timed only) and bound times, and on the TMA route the
   forward's two launches (k pre-pass, main kernel) and the backward's three
   (pre-pass, dk/dv, dq) from a profiler window. Each wrapper's route counts
   must show the TMA route for bf16 and fp16 at head_dim 64 / 128 (the
   CUDA-core one for fp32 and other head dims), a second backward call
   on the same inputs must give the same bits of dq, dk and dv, and on the
   TMA route query 0's dq (exactly 0: its one key is itself) must be 0.
   Then the grid kernels (forward, dk/dv, dq) against their plain versions
   the same way: the GPT-2 XL training shape (b=8, h=25, s=1024, d=64,
   causal, no RoPE, the stacked projection view), non-causal (b=8, h=16,
   s=512: bert-large's attention at batch 8), RoPE past the blocked envelope
   (b=1, h=4, s=16384, d=128), GQA with kv_rep 4, fp32, a bf16 call writing
   fp32 output, and the encoders' shapes unmasked in the stacked view at
   the batches phase 22 runs them (bert-large's b=32, h=16, s=512, d=64;
   vit-large's 196 patches at b=64, h=16, d=64; vit-huge's h=16, s=256,
   d=80 on the CUDA-core kernels at b=2 and b=16) and T5's at the batches
   phase 23 runs them (t5-large's b=16, h=16, s=512, d=64 unmasked and
   causal; t5-3b's 32 heads of d=32 at b=4, on the CUDA-core kernels), and
   the fp16 instances (the CUDA-core kernels, held by ``fp16_parity_excess``
   within ``FP16_PARITY_TOL``) at the GPT-2 XL shape, phase 25 (a)'s
   opt-1.3b shape (b=8, h=32, s=2048, d=64, causal, stacked), non-causal,
   fp32 output, RoPE at (1, 4, 2048, 128), GQA kv_rep 4 and vit-huge's d=80;
   the forward's,
   the dk/dv and the dq kernels' own device times (and the pre-passes' with
   RoPE) come from profiler windows, with the same route checks on all
   three (TMA for bf16, the CUDA-core kernels for fp32 and fp16) and the repeat
   check on the backward. Then the ring-hop mode of the three (context
   parallelism, phase 17): the forward unmasked with fp32 output on a past
   K/V block at (2, 32, 8192, 128) bf16 (phase 17 (b)'s local batch), and
   the backward on that block
   given the lse / delta of a two-block fold (a causal diagonal block, then
   the past one), which is not the block's own forward; held to the plain
   versions (computed 8 heads at a time) by the grid bands with the
   dropped-tile control, timed beside the plain versions, SDPA non-causal
   forward and backward and the bounds.
   Then the four fused norm kernels (RMSNorm and LayerNorm, forward and
   backward) against their plain versions: the training shapes (16384 rows x
   4096 RMSNorm, 16384 x 2048 LayerNorm) in bf16 and fp32, and edge shapes (1,
   4 and 1000 rows; H = 128 and 5120; ``fused_add_rmsnorm``; a stride-0
   incoming gradient), and LayerNorm at Swin's widths and rows (phase 24 (a)'s
   stage-0 128 x 3136 rows of 128 and last merge's 128 x 49 rows of 2048 timed;
   256, 512, 1024 and swin-large's 384 and 3072), and the fp16 instances at
   the two training shapes and Swin's stage-0 rows, timed. fp32 within 1e-5
   (y, statistics) and 1e-4 (dx); bf16 y and dx by ``bf16_parity_excess``
   within 2^-10, fp16 by ``fp16_parity_excess`` within 2^-13; dscale and
   dbias within 1e-4 of the vector's rms. Two controls must fail the same
   checks: a row normalised with the wrong H, and column sums
   with a strip of rows left out. Kernel, plain, library (``F.rms_norm`` /
   ``F.layer_norm`` and their autograd backward; timed only) and bound times;
4. llama-7b width at 2 layers in fp32: prefill + 8 decode steps through
   ``forward_with_cache_paged`` on the card (kernel) and on the CPU (plain
   version); logits within 1e-3, kernel launches == layers x decode steps;
   then the same at 4 rows with ``fused_norm=True``: every norm of every
   call through the RMSNorm forward kernel; (c) beside the first, the same
   weights cast to fp16 run the same tokens on the card (the paged kernel's
   fp16 instance, layers x decode steps launches): finite logits within
   ``FORWARD_FP16_TOL`` of the fp32 card logits' rms;
5. llama-7b width, gpt-1.5b width and, with ``fused_norm=True``, llama-7b
   and opt-1.3b width, each at ``PARITY_LAYERS`` (1) layer in fp32, batch 1,
   s=512: two ``train_step``s on the card (flash kernels: blocked for
   llama, grid for GPT) and on the CPU (plain versions) from the same
   weights and batches; losses within 1e-3 and each kernel of the model's
   path launched layers x steps times, the other family's none. Then bf16
   over fp32 masters, batch 2 at the preset's sequence length: one forward
   + backward through the tensor-core kernels against the same step with
   the wrappers swapped for their plain versions on the card; the loss
   within 1e-3 and every parameter gradient within 2^-5 relative error, and
   the control beyond it (a dropped key tile; with ``fused_norm`` the norm
   plain versions swapped in too, and a strip of rows left out of dscale).
   The ReLU model (opt) is held to 2^-3, since gates that flip within a bf16
   rounding of zero move its gradients by ~5 % whatever differs, and its
   gelu twin at the same width to 2^-5;
6. the serving path: ``cli serve --model_size llama-7b --kv_num_blocks -1``
   (32 layers, bf16, random weights from a seed) in a thread of this
   process; 4 concurrent POST /api requests of ~50/300/700-byte prompts and
   one sharing a prefix, 32 greedy tokens each, then a repeated prompt; the
   paged kernel's launch count must equal 32 x the engine's decode steps
   and POST /drain must report no leak;
7. the LLaMA training path: ``cli train --model_size llama-7b --num_layers 4
   --train_iters 10`` (batch 8, seq 2048, bf16 over fp32 masters, AdamW)
   in-process: every loss finite, 10 ``train_iter`` JSONL records, each
   blocked flash kernel launched 4 x 10 times, every call on the TMA route,
   and the grid kernels none;
   iter_ms (mean of iterations 2-10), tokens/s, MFU and peak device memory;
   then ``torch.profiler`` over two steady steps of the same configuration:
   device busy and idle share and the top kernels by device time;
8. the GPT training path: ``cli train --model_size gpt-1.5b --train_iters
   10`` (all 48 layers, batch 8, seq 1024, bf16 over fp32 masters, AdamW)
   in-process, with the same checks and numbers: each grid kernel launched
   48 x 10 times and the blocked kernels none; then its profiler window;
9. the LLaMA training path with the fused norms: ``trainer.train`` of
   phase 7's configuration with ``ModelConfig.fused_norm=True`` (a config
   field, there is no flag): the RMSNorm forward and backward kernels each
   launched (2 x 4 + 1) x 10 times, the LayerNorm kernels none, the flash
   counts as in phase 7; its numbers beside phase 7's, and its profiler
   window with the norm kernels as a category of their own;
10. the OPT training path with the fused norms: ``trainer.train`` of
   opt-1.3b (all 24 layers, batch 8, seq 2048, bf16 over fp32 masters) with
   ``fused_norm=True``: the LayerNorm kernels each launched (2 x 24 + 1) x
   10 times, the RMSNorm kernels none, each grid flash kernel 24 x 10 times;
   the same configuration with ``fused_norm=False`` for 4 iterations gives
   the number it stands against; then the fused path's profiler window.

11. per-layer hybrid parallelism at world size 1: ``cli train --model_size
   llama-7b --num_layers 4 --galvatron_config_path PLAN`` (batch 8 x 2048,
   bf16, 10 iterations) with a plan the phase writes, recompute ``none``,
   ``full``, ``selective``, ``none`` per layer: finite losses, no collective,
   each blocked flash forward launched (4 + 2) x 10 times (the full layer's
   and the selective layer's recompute run their forward again), the
   backward 4 x 10, all on the TMA route; iter_ms beside phase 7's and a
   profiler window;
12. two ranks sharing card 0 (``LOCAL_RANK`` 0 each) over gloo, started as
   two ``cli train`` processes (``--rank-worker``: ``trainer.train`` of the
   same flags, counting each flash launch by its head count) under a plan
   that changes the DP degree at every boundary (tp=2 + SP ddp; tp=1 zero3
   with full recompute; tp=2 selective; tp=1 zero2; vocab_tp 2), each rank
   under a wall-clock limit: (a) fp32, the plan's first two layers at
   llama-7b width, batch 2 x 512, 2 steps: losses within 1e-3 of the same
   layers' world-size-1 plan in this process, and every rank's parameter
   pieces within 2 x 2 x lr of that run's (AdamW's band); (b) bf16, the
   whole plan at 4 layers, batch 8 x 2048, 2 steps: losses within 2e-2
   relative of phase 11's (same weights and batches), each rank's flash
   forward / backward launched 12 / 8 times on the TMA route at 16 heads
   for the tp=2 layers and 32 for the tp=1 layers; host-staged collectives
   and iter_ms (a gloo-loopback transport figure, not a parallelism
   result). (a) and then (b) run in one pair of rank processes
   (``--then``). 12b (phase name ``nccl``): the same over NCCL on cards 0
   and 1 where the machine has two; otherwise reported absent.
13. pipelines through the same ``--rank-worker`` launcher and strategy
   JSONs (phase name ``pipeline``): (a) four ranks share card 0 over gloo,
   pp=2 x tp=2 (SP), 1F1B, fp32, llama-7b width at 2 layers, batch 4 x 512,
   chunks 2, 2 steps: losses within 1e-3 of the same layers at world size 1
   in this process and every rank's pieces within AdamW's band of its
   parameters; (b) two ranks share the card, pp=2, bf16, llama-7b width at
   phase 7's 4 layers (batch 8 x 2048), chunks 8, under GPipe, 1F1B and
   interleaved 1F1B (vpp=2), 2 steps each, one after another in one pair of
   rank processes (``--then`` between their flags): losses within 2e-2 relative of
   phase 11's, each rank's blocked flash forward and backward launched
   (its stage's layers x 8 x 2) times on the TMA route, and 1F1B's stage-0
   peak memory below GPipe's; (c) gpt-1.5b at all 48 layers, 1F1B over
   the division 25 / 23, two ranks on the card, batch 8 x 1024, chunks 4,
   2 steps: the grid kernels and the tied table across stages, losses
   within 2e-2 relative of phase 8's, each rank's grid kernels (its
   stage's layers x 4 x 2) on the TMA route. Host-staged messages, p2p
   counts, iter_ms (a gloo transport figure) and peak memory per rank.
   (a)'s four ranks run at the same time as (b) and (c)'s two, two worlds
   on card 0 at once: (b)'s and (c)'s iter_ms and every ``seconds`` say so,
   and the card's used memory is sampled while both run.
   13b (phase name ``nccl``): (b) over NCCL on cards 0 and 1 where the
   machine has two, beside phases 11 and 12b; otherwise reported absent.

14. profiling and search (phase name ``search``), each step a ``cli`` mode
   in this process: (a) ``cli profile --model_size llama-7b`` at full width
   (batch 8 x 2048, bf16) with the adaptive layer counts (an attempt that
   runs out of memory halves them and says so); the
   flash kernels on the TMA route; the cost model's world-1 step at 4
   layers from this profile within 0.67-1.5 x phase 7's iter_ms of this
   run; (b) ``cli profile-hardware`` at world 1 writes the reference's
   degenerate JSON; (c) ``cli search --num_layers 4 --num_devices 1
   --settle_bsz 8 --validate_top_k 2`` at 40, 28 and 22 GB on that
   profile, each plan through ``cli check-plan --strict 1`` and ``cli
   train`` for 10 iterations: finite losses, each flash kernel launched
   (layers + recomputed layers) x chunks x iterations (the backward layers
   x chunks x iterations) on the TMA route; iter_ms beside search_cost_ms
   and the peak memory beside the plan's memory_mb and the budget
   (recorded, not gated); (d) ``cli search --num_devices 2`` on
   ``configs/hardware/reference_2x8_ib.json`` at phase 12 (a)'s shape, the
   plan trained by two ranks sharing the card over gloo: fp32 losses
   within 1e-3 of world size 1; (e) the full-depth search (8 devices, 32
   GB) on the 14 (a) profile beside ``configs/strategies/llama-7b_8dev_32gb.json``,
   through ``check-plan``, on the native DP route. 14b (phase name
   ``nccl``): ``cli profile-hardware`` over NCCL on cards 0 and 1 where the
   machine has two; otherwise reported absent.

15. the training services (phase name ``services``), llama-7b width:
   (a) two corpora written with ``write_indexed_dataset`` from seeded
   documents of 500-4000 tokens, 2 layers, batch 8 x 2048, bf16, a 0.7 / 0.3
   ``--data_mixture`` with ``--prefetch_depth 2``: run A trains 6 steps in
   this process; run B trains 3 with ``--save`` (an interval save at 3), then
   a second process ``--load``s, verifies the data cursor and trains to 6:
   its losses within 1e-6 relative of A's (bitwise expected), save and
   restore seconds and GB/s; one byte of the newest step flipped, a third
   run (in this process) must log ``ckpt_fallback`` and resume from step 3;
   (b) that step restored under ``--pp_deg 2`` by two ranks sharing the card
   over gloo, one step, while (c) and (e) run in this process: within 1e-4
   relative of A's step 3; (c) ``cli serve --load``
   on the paged backend answers 4 greedy requests, the first token of the
   prompt with the widest top-2 margin equal to the restored model's
   training-forward argmax, ``paged_decode`` launched layers x decode steps;
   (d) phase 9's configuration (phase 7's with ``fused_norm=True``) under
   ``--mixed_precision fp16``, 10 iterations: finite losses, the blocked
   flash kernels 40 / 40 on the TMA route at fp16, the RMSNorm kernels
   90 / 90 at fp16, step 0 within 1e-2 relative of phase 9's bf16 step 0,
   the loss-scale trajectory, skipped steps and iter_ms beside phase 9's;
   (e) ``--rampup_batch_size 4 4 32`` to 16 at 2 layers, 6 steps: the batch
   sizes ``BatchSizeRampup`` gives.

16. the slot backend, GPT serving, ``cli generate`` and the serialized path
   (phase name ``slots``), in this process: (a) ``cli serve --model_size
   llama-7b`` at its default backend (the contiguous slot cache; 32 layers,
   bf16, ``--num_slots 4 --prefill_chunk 32``) driven as phase 6 (its
   prompts, 32 greedy tokens each, the repeated prompt repeats, /healthz
   ``kv_backend: slot``, a clean drain, ``paged_decode`` launched 0 times),
   its tokens held to phase 6's by the margin rule (``MARGIN_TOL``: equal up
   to the first difference, and there the two tokens' logits from a forward
   of the common prefix within 2^-4 of the logits' rms); (b) ``cli serve
   --model_size gpt-1.5b`` (all 48 layers) with ``--kv_num_blocks -1``,
   ``paged_decode`` launched 48 x decode steps, then at the slot backend,
   held to the paged run by the margin rule; (c) ``cli generate
   --model_size llama-7b --max_new_tokens 32`` of phase 6's first two
   prompts: JSON lines whose completions are ``generate_np``'s tokens,
   held to (a)'s by the margin rule; (d) ``cli serve --num_slots 0`` at 2
   layers: one request whose tokens equal ``generate_np``'s. TTFT p50/p95,
   decode step ms, tokens/s and peak memory of (a) and (b) beside phase 6's.

17. context parallelism (phase name ``cp``), ``cli train``'s own call
   (``--rank-worker``) on two ranks sharing card 0 over gloo: (a) fp32,
   llama-7b width at 2 layers, batch 2 x 1024, layer 0 cp 2 ring and layer 1
   cp 2 a2a, 2 steps: losses within 1e-5 of the same layers at world size 1
   in this process and every rank's pieces within 1e-4 (one AdamW step) of
   its parameters; the same run without the CP gradient sum, beside it on
   the card, must leave both; (b) bf16, llama-7b width at 4 layers, batch 2 x 16384
   (``--seq_length 16384``), vocab_tp 2, the plan cp 2 ring ddp / cp 2 ring
   zero3 with full recompute / cp 2 a2a zero2 / tp 2 with SP, 2 steps:
   losses within 2e-2 relative of the same 4 layers at world size 1 on the
   same weights and batches; each rank's grid flash launches by (batch,
   heads, sequence, mask), as the wrappers count them, equal to what the
   plan implies (a ring layer one causal and ring-position unmasked
   forwards at (2, 32, 8192), twice under full recompute, as many dk/dv and
   dq launches; the a2a core and the tp layer one causal each at (2, 16,
   16384)), all on
   the TMA route and no blocked launch; iter_ms (host-staged transport),
   peak memory per rank and host-staged collectives beside world size 1's;
   (a) and (b) run one after another in one pair of rank processes
   (``--then``), (a)'s control world beside (a);
   (c) ``ring_attention`` and ``ulysses_attention`` (flash core) on two
   ranks of their own, started beside (a)'s worlds,
   at (2, 32, 4096, 128) bf16, forward and backward, held to the grid
   plain versions over the whole sequence on one device by
   ``bf16_parity_excess`` (2^-5 the output, 2^-4 the gradients), and to the
   fp32 attention within the plain versions' own reading against it plus
   that band; a ring without its past hop must read out of both. 17b (phase name ``nccl``): (b) over NCCL on cards 0 and 1 where
   the machine has two; otherwise reported absent.
18. mixture-of-experts and expert parallelism (phase name ``moe``), 8
   experts: (d) ``cli profile`` of an h 1024 model (8 heads of 128, ffn
   2816, 2 layers, 512 tokens a row, profiled at ``MOE_PROFILE_BATCH`` 16),
   ``cli search --enable_ep 1`` at batch 4 for two devices on it and
   ``check-plan``: the plan must carry ep > 1; (a) that plan in fp32 on
   two ranks sharing card 0 over gloo against world size 1: losses within
   1e-5, parameters within 1e-4, beside a control run (ep 1, each rank
   routing its own tokens) that must leave both; each rank's MoE
   moves (logits gathers, dispatch and combine all-to-alls) as the plan
   implies;
   (b) ``cli train`` at llama-7b width, 2 layers, batch 8 x 2048, bf16, 10
   iterations at world size 1 (iter_ms, tokens/s, peak memory; blocked flash
   launches = layers x iterations, all TMA), a profile window splitting the
   step into routing, dispatch, expert GEMMs and combine, then ep 2 with DDP
   on two ranks over gloo, 2 steps (rank 0 profiled; after (a) in (a)'s pair
   of rank processes, (a) running once (b)'s world size 1 is done): losses within 2e-2
   relative of world size 1's, each rank's peak below world size 1's, its
   launches and MoE moves as the plan implies; (c) ``cli serve`` of the MoE
   model at 4 layers on the paged backend driven as phase 6 (paged_decode
   launches = layers x decode steps), then with the kernel's plain version
   in its place, phase 6's prompts sent one at a time to both and held by
   the MoE margin rule (``MARGIN_TOL``, routing near-ties included).

19. packed sequences (phase name ``packed``), llama-7b width at 2 layers, bf16,
   ``fused_norm=True``, the einsum attention (the flash kernels carry no
   segment mask): (a) one step of trivially packed rows (8 x 2048, one
   full-row document a row) against one step of the same tokens unpacked,
   from the same weights: loss and updated parameters equal to the last bit
   (a launch that parts them is named, and the step held to 1e-6 relative
   instead), the RMSNorm kernels (2 x 2 + 1) each and no flash launch; one
   profiled packed step gives the attention's share of the device time;
   (b) ``cli train --pack_sequences 1`` (``trainer.train`` for the field)
   on a seeded corpus of documents of 100-1100 tokens packed into 2048-token
   rows, batch 8, 6 steps: the loss falls, iter_ms, non-pad and raw
   tokens/s, packing efficiency, peak memory and the norm launches; the same
   first step with the segment mask dropped must give another loss.
20. the overlap plan fields (phase name ``overlap``): ``cli search
   --enable_tp_overlap 1`` for two devices at llama-7b width, 2 layers,
   batch 4 x 2048 (analytic costs), which must emit a tp 2 + SP + tp_overlap
   layer; then two ranks sharing card 0 over gloo, one pair of processes
   running one after another: (a) fp32 at h 1024, 2 layers, batch 4 x 512,
   2 steps, tp 2 + SP with ``--global_tp_overlap`` on and off (losses
   within 1e-6 relative, ring hops only when on) and dp 2 zero2 with
   ``--grad_overlap`` on and off (losses equal to the last bit, both layers'
   buckets issued by the backward); (b) / (c) the searched plan in bf16, 2
   steps, and the same plan with tp_overlap off: losses within 1e-4
   relative, each rank's blocked flash kernels 2 x 2 at 16 heads on the TMA
   route; iter_ms on and off (a gloo transport figure). 20b (phase name
   ``nccl``): the searched plan over NCCL on cards 0 and 1, on / off / on, 6
   steps each, where the machine has two; otherwise reported absent.
21. HF import / export and ALiBi (phase name ``hf``): (a) ``cli export-hf``
   of seed-0 weights at llama-7b width, 2 layers (drawn on the card), the
   directory's safetensors headers read back by this script (F32, offsets
   tiling the data, ``format: pt``), ``load_hf_checkpoint`` bitwise equal to
   the exported weights; ``cli train --load_hf`` 2 bf16 steps at 4 x 2048
   (the blocked flash kernels 2 x 2 each, TMA); ``cli serve --load_hf`` on
   the paged backend driven as phase 6 (``paged_decode`` launched layers x
   decode steps), every prompt's tokens held to ``generate_np`` on the
   served weights by the margin rule; (b) the same round trip at gpt-1.5b
   width, 2 layers, and 2 train steps at 4 x 1024 on the grid kernels; (c) a
   Baichuan-1 directory written by this script at baichuan-13b width (5120,
   40 heads, ffn 13696, vocab 64000), 2 layers: ``config.json`` with
   ``model_max_length`` 4096, fused ``W_pack``, two bf16 ``.bin`` shards and
   their index; ``load_hf_checkpoint`` gives ``pos_embed='alibi'`` and the
   bf16 weights widened bitwise (host RSS sampled during the import); fp32
   logits of a 2 x 128 batch on the card against the CPU within
   ``BAICHUAN_LOGIT_TOL`` (loss within ``BAICHUAN_LOSS_RTOL`` relative), no
   kernel launched under ``attn_impl='flash'``; ``cli train --load_hf`` 2 bf16
   steps at 4 x 2048 (iter_ms, peak memory, no flash launch); tp 2 on two
   gloo ranks sharing the card (vocab tp 2), fp32, 1 x 2048, 2 steps: losses within
   ``BAICHUAN_TP_RTOL`` relative of world size 1 in this process, and the
   control (every rank the first n/tp slopes), run beside it, must miss;
   (d) ``cli serve --model_size baichuan-13b`` at 20 of its 40 layers,
   bf16, on the slot then the paged backend, driven as phase 6: tokens held across the
   backends (equal, or the margin rule), every paged decode step on the
   einsum route (``generation.decode_routes``) and no ``paged_decode``
   launch; decode ms a step.
22. the encoders (phase name ``encoder``), in this process: (a) ``cli train
   --model_size bert-large`` (all 24 layers, h 1024, 16 heads, s 512), bf16,
   batch 32 x 512, 3 steps, the masked-LM objective: each grid kernel
   launched 24 x 3 times, unmasked at (32, 16, 512), on the TMA route, no
   other kernel; loss, iter_ms, tokens/s and peak memory; then bert-large at
   2 layers in fp32, one forward of 2 x 512 on the card (the grid forward on
   the CUDA-core route) against the CPU: logits within
   ``ENCODER_LOGIT_TOL``, loss within ``ENCODER_LOSS_RTOL`` relative; (b)
   vit-large (all 24 layers, 196 patches) with ``fused_norm=True``, bf16, 64
   images, 3 steps: the grid kernels 24 x 3 each at (64, 16, 196) on the TMA
   route and the LayerNorm kernels (2 x 24 + 1) x 3 each at H 1024; (c)
   vit-huge at full width, 2 layers (head_dim 80): fp32 forward and backward
   of 2 images on the card against the CPU (logits, loss, every gradient
   within ``ENCODER_GRAD_RTOL`` of its largest value), then a bf16 step of 16
   images, every grid launch on the CUDA-core route; (d) ``cli profile`` of
   bert-large at 4 layers, ``cli search`` for one device on it, ``cli
   check-plan --strict 1`` of the plan and ``cli train`` of it for 2 steps
   (grid launches as the plan's recompute implies, TMA); (e) ``cli serve``
   and ``cli generate`` of bert-base refused with the reference's messages.
23. the T5 encoder-decoder (phase name ``encdec``), in this process but for (d)
   (run after phase 24, its rank processes shared with 24 (c)): (a) ``cli train
   --model_size t5-large`` (all 24 + 24 layers, h 1024, 16 heads, 512 + 512
   tokens), bf16, batch 16, 3 steps: finite, falling losses; the grid kernels
   24 x 3 each unmasked at (16, 16, 512) (the encoder) and 24 x 3 each causal
   (the decoder's self-attention), all on the TMA route, and nothing else (no
   blocked kernel, no other shape: cross-attention is einsum, no
   ``paged_decode``); iter_ms, decoder tokens/s, MFU and peak memory; (b)
   t5-large width at 2 + 2 layers, fp32, 2 rows, forward and backward on the
   card (the grid kernels on the CUDA-core route) against the CPU: logits, loss
   and every gradient within ``ENCDEC_TOLS``; (c) the same at t5-3b width (32
   heads of 32, ffn 16384), then a bf16 step of 4 rows, every grid launch on
   the CUDA-core route; (d) pp = 2 on two gloo ranks sharing the card, t5-large
   width at 4 + 4 layers, fp32, GPipe then 1F1B in one pair of rank processes
   (``--then``; with 24 (c)'s runs when both phases run): losses within
   ``ENCDEC_PIPE_RTOL`` relative of world size 1 run here, the first run's
   parameters within AdamW's band; (e) ``cli profile`` (two layer types), ``cli
   search`` for one device under a budget, ``cli check-plan --strict 1`` and
   ``cli train`` of the plan for 2 steps at t5-large width, 4 + 4 layers; (f)
   ``cli serve`` and ``cli generate`` of t5-base refused with the reference's
   messages, and a cp = 2 plan refused by ``build_runtime`` with the
   reference's.
24. the Swin pyramid (phase name ``swin``), in this process but for (c) (run
   after (e), in 23 (d)'s pair of rank processes when both phases run): (a)
   ``trainer.train`` of ``--model_size swin-base`` (all 24 layers in stages of
   2, 2, 18 and 2; 224-pixel images, 56 x 56 patches, windows of 7) with
   ``fused_norm=True``, bf16, 128 images (the Swin paper's per-GPU batch), 3
   steps: finite losses; the LayerNorm kernels (2 x 24 + 3 + 1) x 3 times each,
   by width 128 / 256 / 512 / 1024 (the layers), 512 / 1024 / 2048 (the patch
   merges) and 1024 (the final norm), and nothing else (the window attention is
   einsum: no flash kernel, no ``paged_decode``); iter_ms, images/s, MFU by the
   Swin count and peak memory; (b) swin-base and swin-large widths at depths
   (2, 2, 2, 2), fp32, 2 images, forward and backward on the card against the
   CPU: logits, loss and every gradient within ``ENCDEC_TOLS``; then a bf16
   swin-large step with the fused norms: its stage-0 width 192 takes the plain
   version by the shared ``H % 128`` gate, 384 and wider the kernels; (c) pp =
   2 on two gloo ranks sharing the card, swin-base width at depths (2, 2, 2,
   2), fp32, GPipe then 1F1B in one pair of rank processes: losses within
   ``SWIN_PIPE_RTOL`` relative of world size 1 run here, the first run's
   parameters within AdamW's band; (d) ``cli profile`` (one layer type a
   stage), ``cli search`` for one device under a budget, ``cli check-plan
   --strict 1`` and ``cli train`` of the plan for 2 steps at the same depths;
   (e) ``cli serve`` and ``cli generate`` of swin-base refused with the
   reference's messages.
25. fp16 on the grid and LayerNorm kernels' paths (phase name ``fp16``):
   (a) opt-1.3b at full width (h 2048, 32 heads of 64, ffn 8192), 4 of its
   24 layers, ``fused_norm=True``, ``--mixed_precision fp16``, batch 8 x
   2048, 6 iterations, then one bf16 step of the same model and batch:
   finite losses, step 0 within 1e-2 relative of the bf16 step 0, the
   loss-scale trajectory, iter_ms and peak memory; the grid kernels 4 x 6
   each at fp16 on the CUDA-core route (no TMA launch), the LayerNorm
   kernels (2 x 4 + 1) x 6 each at fp16, nothing else; (b) bert-large at
   full width, 2 layers, fp16, batch 32 x 512, 3 iterations (and the bf16
   step): the grid kernels unmasked at (32, 16, 512) 2 x 3 each at fp16 on
   the CUDA-core route.

The last two lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes everything
measured to PATH as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float16": 989e12,  # dense tensor cores
              "torch.float32": 67e12}  # fp32 off the tensor cores
SERVE_LAYERS = 32
TRAIN_ITERS = 10
# the training paths' models: (preset, layers driven, batch, seq)
TRAIN_PATHS = {"llama": ("llama-7b", 4, 8, 2048), "gpt": ("gpt-1.5b", 48, 8, 1024),
               "opt": ("opt-1.3b", 24, 8, 2048)}
# the main-path training runs, in order: (phase, model, fused_norm, iterations)
TRAIN_RUNS = {"llama": (7, "llama", False, TRAIN_ITERS), "gpt": (8, "gpt", False, TRAIN_ITERS),
              "llama_fused": (9, "llama", True, TRAIN_ITERS),
              "opt_fused": (10, "opt", True, TRAIN_ITERS),
              # the number phase 10 stands against; not a main path of its own
              "opt_plain": (10, "opt", False, 4)}
# bf16 train step, kernels against plain versions on the card (phase 5):
# |loss difference| and the largest per-tensor relative gradient error.
# An H100 read 7.8e-5 and 0.009 at llama-7b width; the dropped-tile control
# 1.7e-3 and 0.146.
TRAIN_BF16_LOSS_TOL = 1e-3
TRAIN_BF16_GRAD_TOL = 2 ** -5
# The same for a ReLU model (opt): a pre-activation within a bf16 rounding of
# zero gates the other way in the two steps, a first-order change of that
# unit's gradient whatever made the rounding differ. At opt-1.3b width, 2
# layers, an H100 read 0.050 with only the flash wrappers swapped, 0.036 with
# only the norm wrappers swapped and 0.007 for the same model with gelu. So
# the ReLU step is held to 2^-3 (its control reads 0.58) and its gelu twin at
# the same width to TRAIN_BF16_GRAD_TOL.
TRAIN_BF16_RELU_GRAD_TOL = 2 ** -3
RESULTS: dict = {}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


_T0 = time.perf_counter()


def log(*a):
    """Print a line; a line that starts with "phase" is also kept, with the
    seconds since the script started, in ``RESULTS["timeline"]`` (the
    ``--out`` file), so a run shows where its time went."""
    print(*a, flush=True)
    if a and isinstance(a[0], str) and a[0].startswith("phase"):
        RESULTS.setdefault("timeline", []).append([round(time.perf_counter() - _T0, 1),
                                                   a[0][:80]])


@contextlib.contextmanager
def card_used_peak(torch, every_s=0.05):
    """The most memory in use on card 0, by every process on it, while the
    block runs (``torch.cuda.mem_get_info`` read every ``every_s``
    seconds): ``{"gb": ...}``, filled when the block ends."""
    out, done = {"gb": 0.0}, threading.Event()

    def sample():
        while True:
            free, total = torch.cuda.mem_get_info(0)
            out["gb"] = max(out["gb"], (total - free) / 1e9)
            if done.wait(every_s):
                return

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        done.set()
        t.join()


# ---------------------------------------------------------------------------
# phase 0: the card
# ---------------------------------------------------------------------------


def phase_card(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    info = {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "device_count": torch.cuda.device_count(),
            "device_name": torch.cuda.get_device_name(0)}
    log("phase 0 card:", json.dumps(info))
    RESULTS["card"] = info
    return smi


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from galvatron_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    total = time.perf_counter() - t0
    for name, entry in logs.items():
        report = [ln.strip() for ln in entry["ptxas"].splitlines()
                  if any(w in ln for w in ("registers", "spill", "Compiling entry", "warning"))]
        log(f"phase 1 build: {name} in {entry['seconds']:.2f} s -> {entry['path']}")
        for ln in report:
            log("  ptxas:", ln)
    log(f"phase 1 build: all kernels in {total:.2f} s")
    RESULTS["build"] = {"seconds": total,
                        **{n: {"seconds": e["seconds"], "ptxas": e["ptxas"]} for n, e in logs.items()}}


# ---------------------------------------------------------------------------
# phase 2: kernel parity and timing
# ---------------------------------------------------------------------------


_DAM = {}


def _dam(torch):
    """Queue ~40 ms of matmuls. Work queued behind them is launched by the
    host while the device is still busy, so events around it bracket device
    time alone."""
    if not _DAM:
        _DAM["a"] = torch.randn(8192, 8192, device="cuda").to(torch.bfloat16)
        _DAM["out"] = torch.empty_like(_DAM["a"])
    for _ in range(24):
        torch.mm(_DAM["a"], _DAM["a"], out=_DAM["out"])


def time_ms(torch, fn, flush, iters=20):
    """Mean device time of one call between CUDA events, L2 flushed before
    each (each decode layer reads its own pool slice cold). All calls are
    queued behind :func:`_dam` and read back after one synchronize: a
    wrapper's host work (checks, allocations, the ctypes call) would
    otherwise leave the device waiting inside the timed span of a kernel
    that runs for 0.1 ms."""
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda.synchronize()
    _dam(torch)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def paged_case(torch, dtype, b, n, kv, d, bs, mb, offsets, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nblocks = 1 + b * mb
    q = torch.randn(b, 1, n, d, generator=gen)
    k = torch.randn(nblocks, bs, kv, d, generator=gen)
    v = torch.randn(nblocks, bs, kv, d, generator=gen)
    tables = (torch.randperm(nblocks - 1, generator=gen)[: b * mb] + 1).reshape(b, mb)
    dev = "cuda"
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            tables.to(dev, torch.int32), torch.tensor(offsets, dtype=torch.int32, device=dev))


def paged_bound(torch, case):
    """Least time for this call on this data: each input byte the function
    needs read once (q, the tables, the offsets, K and V rows at positions
    <= each row's offset), the output written once; 4·d operations per
    (query head, attended token)."""
    q, k, v, tables, offsets = case
    b, _, n, d = q.shape
    _, bs, kv, _ = k.shape
    mb = tables.shape[1]
    esz = q.element_size()
    tokens = int((offsets.clamp(max=mb * bs - 1) + 1).sum().item())
    nbytes = 2 * q.numel() * esz + tables.numel() * 4 + offsets.numel() * 4 \
        + 2 * tokens * kv * d * esz
    flops = 4.0 * tokens * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch):
    import torch.nn.functional as F

    from galvatron_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    main_shape = dict(b=4, n=32, kv=32, d=128, bs=16, mb=128)
    import random

    rnd = random.Random(0)
    rand_offsets = [rnd.randrange(0, 2048) for _ in range(4)]
    cases = [
        ("paged_decode main edges", bf16, dict(main_shape), [0, 15, 16, 2047]),
        ("paged_decode main", bf16, dict(main_shape), rand_offsets),
        ("paged_decode gqa", bf16, dict(main_shape, kv=8), rand_offsets),
        ("paged_decode fp32", fp32, dict(main_shape), rand_offsets),
        # the fp16 instance at the main shape (phase 4 (c)'s decode path)
        ("paged_decode main fp16", fp16, dict(main_shape), rand_offsets),
        # one row of 16384 positions: the split plan's other end
        ("paged_decode long row", bf16, dict(main_shape, b=1, mb=1024), [16383]),
        # --kv_block_size 7: pages that straddle every warp tile
        ("paged_decode bs7", bf16, dict(main_shape, bs=7, mb=293), rand_offsets),
        # gpt-1.5b's decode (phase 16 (b)): 25 heads of 64, one per kv head
        # (the kernel's NE = 2 instance), 64 blocks a row (max_seq_len 1024)
        ("paged_decode gpt", bf16, dict(b=4, n=25, kv=25, d=64, bs=16, mb=64),
         [rnd.randrange(0, 1024) for _ in range(4)]),
    ]
    lines = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (label, dtype, shape, offsets) in enumerate(cases):
        t0 = time.perf_counter()
        case = paged_case(torch, dtype, shape["b"], shape["n"], shape["kv"], shape["d"],
                          shape["bs"], shape["mb"], offsets, seed=i)
        splits = fa._paged_splits(shape["b"], shape["kv"], shape["mb"] * shape["bs"], sms)
        before = fa.paged_decode_attention.launches
        dtype_before = fa.paged_decode_attention.dtypes[str(dtype)]
        out = fa.paged_decode_attention(*case)
        torch.cuda.synchronize()
        check(fa.paged_decode_attention.launches == before + 1, f"{label}: kernel did not launch")
        check(fa.paged_decode_attention.dtypes[str(dtype)] == dtype_before + 1,
              f"{label}: the launch was not counted as {dtype}")
        ref32 = fa.paged_decode_attention_plain(
            *[t.float() if t.is_floating_point() else t for t in case])
        err = (out.float() - ref32).abs()
        max_err = err.max().item()
        if dtype != fp32:
            # one bf16 (fp16) ulp of the fp32 plain result, plus the fp32
            # tolerance (the two sum in different orders; it matters only
            # where the result cancels to near zero, below ~1e-3)
            kind, bits = ("bf16", 7) if dtype == bf16 else ("fp16", 10)
            ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(1e-30))) - bits)
            check(bool(torch.all(err <= ulp + 1e-5)),
                  f"{label}: beyond one {kind} ulp + 1e-5 (max err {max_err})")
            tol = f"1 {kind} ulp of the fp32 plain result + 1e-5"
        else:
            check(max_err <= 1e-5, f"{label}: max abs err {max_err} > 1e-5")
            tol = "1e-5"
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        q, k, v, tables, offs = case
        b, _, n, d = q.shape
        kvh = k.shape[2]
        s = tables.shape[1] * k.shape[1]
        kg = k[tables.long()].reshape(b, s, kvh, d).transpose(1, 2)
        vg = v[tables.long()].reshape(b, s, kvh, d).transpose(1, 2)
        kg = kg.repeat_interleave(n // kvh, dim=1).contiguous()
        vg = vg.repeat_interleave(n // kvh, dim=1).contiguous()
        mask = (torch.arange(s, device="cuda")[None] <= offs[:, None].long())[:, None, None, :]
        qh = q.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask)
        lib_err = (lib_out.transpose(1, 2).float() - ref32).abs().max().item()
        kernel_ms = time_ms(torch, lambda: fa.paged_decode_attention(*case), flush)
        plain_ms = time_ms(torch, lambda: fa.paged_decode_attention_plain(*case), flush)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask), flush)
        bound_ms, bound_by = paged_bound(torch, case)
        parts = device_ms_by_name(torch, lambda: (flush.zero_(), fa.paged_decode_attention(
            *case)), ["paged_decode_split", "paged_decode_combine"])
        line = {"shape": label, "dtype": str(dtype).replace("torch.", ""), **shape,
                "offsets": offsets, "splits": splits[0], "split_len": splits[1],
                "max_abs_err": max_err, "tolerance": tol,
                "kernel_ms": kernel_ms, "split_ms": parts["paged_decode_split"],
                "combine_ms": parts["paged_decode_combine"], "plain_ms": plain_ms,
                "library_ms": library_ms, "library_max_abs_err": lib_err,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "launches": fa.paged_decode_attention.launches - before,
                "seconds": time.perf_counter() - t0}
        log(json.dumps(line))
        lines[label] = line
        del case, kg, vg, out, ref32
    torch.cuda.empty_cache()
    RESULTS["paged"] = lines  # "kernels" is the ten-kernel line's key
    return lines


# ---------------------------------------------------------------------------
# phase 3: flash forward / backward kernels, parity and timing
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (label, dtype name, b, h, kv heads, s, d, stacked)
    ("flash main", "bfloat16", 8, 32, 32, 2048, 128, True),
    ("flash ragged s100 d64", "bfloat16", 8, 32, 32, 100, 64, False),
    ("flash gqa kv_rep 4", "bfloat16", 8, 32, 8, 2048, 128, False),
    ("flash fp32", "float32", 2, 32, 32, 2048, 128, True),
    # the fp16 training path's shape (--mixed_precision fp16) and the twins
    # of the two bf16 cases above: the TMA route's fp16 instances
    ("flash main fp16", "float16", 8, 32, 32, 2048, 128, True),
    ("flash ragged s100 d64 fp16", "float16", 8, 32, 32, 100, 64, False),
    ("flash gqa kv_rep 4 fp16", "float16", 8, 32, 8, 2048, 128, False),
    # fp16 off the tensor-core head dims: the CUDA-core kernels' __half instances
    ("flash d40 fp16", "float16", 2, 8, 8, 512, 40, False),
]



@contextlib.contextmanager
def _patched(obj, **attrs):
    """Set attributes of ``obj`` for the length of a with block."""
    old = {name: getattr(obj, name) for name in attrs}
    for name, value in attrs.items():
        setattr(obj, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(obj, name, value)


def _route_taken(fa, routes, before):
    """The one route a wrapper's call took, from its ``routes`` counts
    before and after the call."""
    taken = [r for r in fa.ROUTES if routes[r] != before[r]]
    check(len(taken) == 1 and routes[taken[0]] == before[taken[0]] + 1,
          f"route counts {before} -> {routes}")
    return taken[0]


def _dropped_tile_keep(torch):
    """The plain versions' causal mask with keys 0-63 dropped for the rows
    from max(64, s/2): what a kernel that skipped that tile would compute.
    The parity checks must reject it."""

    def keep(s, device):
        r = torch.arange(s, device=device)
        mask = r[:, None] >= r[None, :]
        mask[max(64, s // 2):, :64] = False
        return mask

    return keep


def _kind(dtype) -> str:
    """bf16 or fp16: the name of a 16-bit dtype in tolerances and keys."""
    return "fp16" if str(dtype) == "torch.float16" else "bf16"


def _flash_err(torch, fa, got, ref, which, dtype=None):
    """(error, limit) of a flash kernel result against its plain version, by
    the input ``dtype`` (``got``'s unless given: a 16-bit call writing fp32
    output still rounds p and ds to its type): fp32 the max abs error
    against 1e-5 (forward) or 1e-4 (backward); bf16 ``fa.bf16_parity_excess``
    against ``fa.BF16_PARITY_TOL``; fp16 ``fa.fp16_parity_excess`` against
    ``fa.FP16_PARITY_TOL``."""
    dtype = dtype or got.dtype
    if dtype == torch.float32:
        return (got.float() - ref.float()).abs().max().item(), {"fwd": 1e-5, "bwd": 1e-4}[which]
    if dtype == torch.float16:
        return fa.fp16_parity_excess(got, ref), fa.FP16_PARITY_TOL[which]
    return fa.bf16_parity_excess(got, ref), fa.BF16_PARITY_TOL[which]


def flash_case(torch, dtype, b, h, kvh, s, d, stacked, seed):
    """q/k/v as the training path hands them over (views of the stacked
    (b, s, 3, h, d) projection when ``stacked``), rope tables, and do."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(dtype)
    qkv = qkv.permute(0, 2, 3, 1, 4)
    if stacked:
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    else:
        q = qkv[:, 0]
        k, v = qkv[:, 1, :kvh].contiguous(), qkv[:, 2, :kvh].contiguous()
    import numpy as np

    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2) / d))
    freqs = np.outer(np.arange(s), inv)
    cos = torch.from_numpy(np.cos(freqs).astype(np.float32)).cuda()
    sin = torch.from_numpy(np.sin(freqs).astype(np.float32)).cuda()
    do = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, do, cos, sin


def flash_bounds(dtype, b, h, kvh, s, d):
    """Least times of the forward and the backward on these shapes: each
    input read once and each output written once over 3.35 TB/s, or the
    causal pairs' products (2 in the forward, 5 in the backward, 2·d
    operations each per (query, key) pair at or below the diagonal) over the
    input type's peak, whichever is larger."""
    esz = 2 if dtype in ("bfloat16", "float16") else 4
    pairs = b * h * s * (s + 1) / 2
    qo = b * h * s * d * esz          # one (b, h, s, d) operand
    kv = b * kvh * s * d * esz        # k or v
    tables = 2 * s * (d // 2) * 4
    lse = b * h * s * 4
    fwd_bytes = qo + 2 * kv + tables + qo + lse            # q, k, v, tables -> out, lse
    bwd_bytes = 3 * qo + 2 * kv + lse + tables + 3 * qo    # q,k,v,do,out,lse -> dq,dk,dv
    peak = PEAK_FLOPS["torch." + dtype]
    out = {}
    for name, nbytes, prods in (("fwd", fwd_bytes, 2), ("bwd", bwd_bytes, 5)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = prods * 2 * d * pairs / peak * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def phase_flash(torch):
    import math

    import torch.nn.functional as F

    from galvatron_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lines = {}
    for i, (label, dname, b, h, kvh, s, d, stacked) in enumerate(FLASH_CASES):
        dtype = getattr(torch, dname)
        q, k, v, do, cos, sin = flash_case(torch, dtype, b, h, kvh, s, d, stacked, seed=10 + i)
        rep, sm = h // kvh, 1.0 / math.sqrt(d)
        before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
        routes_before = (dict(fa.flash_fwd.routes), dict(fa.flash_bwd.routes))
        out, lse = fa.flash_fwd(q, k, v, cos, sin, sm, rep)
        grads = fa.flash_bwd(q, k, v, do, out, lse, cos, sin, sm, rep)
        fwd_route, bwd_route = (_route_taken(fa, w.routes, r)
                                for w, r in zip((fa.flash_fwd, fa.flash_bwd), routes_before))
        again = fa.flash_bwd(q, k, v, do, out, lse, cos, sin, sm, rep)
        torch.cuda.synchronize()
        check((fa.flash_fwd.launches, fa.flash_bwd.launches) == (before[0] + 1, before[1] + 2),
              f"{label}: a kernel did not launch")
        repeat_bitwise = all(torch.equal(g, a) for g, a in zip(grads, again))
        del again
        # aligned operands take the TMA route for bf16 and fp16 at head_dim 64 / 128
        tma = dtype in (torch.bfloat16, torch.float16) and d in (64, 128)
        check((fwd_route, bwd_route) == (("tma",) * 2 if tma else ("cuda_core",) * 2),
              f"{label}: routes {fwd_route} / {bwd_route}")
        check(repeat_bitwise, f"{label}: two backward calls on the same inputs differ")
        ref_out, ref_lse = fa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm, rep)
        kf, vf = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        ref_grads = fa.flash_bwd_blocked_plain(q, kf, vf, do, out, lse, cos, sin, sm)
        # the control: the plain versions with one key tile dropped
        with _patched(fa, _causal_keep=_dropped_tile_keep(torch)):
            ctl_out, _ = fa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm, rep)
            ctl_grads = fa.flash_bwd_blocked_plain(q, kf, vf, do, out, lse, cos, sin, sm)
        fwd_abs = (out.float() - ref_out.float()).abs().max().item()
        bwd_abs = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref_grads))
        lse_err = (lse - ref_lse).abs().max().item()
        lse_tol = 1e-5 if dtype == torch.float32 else 1e-4
        fwd_err, fwd_lim = _flash_err(torch, fa, out, ref_out, "fwd")
        bwd_err = [_flash_err(torch, fa, g, r, "bwd")[0] for g, r in zip(grads, ref_grads)]
        bwd_lim = _flash_err(torch, fa, grads[0], ref_grads[0], "bwd")[1]
        ctl_fwd = _flash_err(torch, fa, ctl_out, ref_out, "fwd")[0]
        ctl_bwd = [_flash_err(torch, fa, c, r, "bwd")[0] for c, r in zip(ctl_grads, ref_grads)]
        if dtype == torch.float32:
            tol = "fp32: max abs err, out/lse 1e-5, gradients 1e-4"
        else:
            kind = "bf16" if dtype == torch.bfloat16 else "fp16"
            tol = (f"{kind}: |err| - 1 ulp over the row's rms ({kind}_parity_excess), "
                   f"out {fwd_lim}, gradients {bwd_lim}; lse 1e-4")
        finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
        # query 0's one key is itself, so its dq is 0 in exact arithmetic; the
        # TMA dq kernel sums that dp as the pre-pass sums delta and gives 0
        dq_row0_zero = bool((grads[0][:, :, 0] == 0).all())
        del ctl_out, ctl_grads
        # yardstick: SDPA (is_causal) over pre-roped q/k, and its autograd backward
        qr = fa._rope_f32(q, cos, sin).to(dtype).detach().requires_grad_(True)
        kr = fa._rope_f32(kf, cos, sin).to(dtype).detach().requires_grad_(True)
        vr = vf.detach().clone().requires_grad_(True)
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        kernel_fwd = time_ms(torch, lambda: fa.flash_fwd(q, k, v, cos, sin, sm, rep), flush)
        kernel_bwd = time_ms(torch, lambda: fa.flash_bwd(q, k, v, do, out, lse, cos, sin, sm, rep),
                             flush)
        plain_fwd = time_ms(torch, lambda: fa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm, rep),
                            flush, iters=5)
        plain_bwd = time_ms(torch, lambda: fa.flash_bwd_blocked_plain(
            q, kf, vf, do, out, lse, cos, sin, sm), flush, iters=5)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True), flush)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), do, retain_graph=True), flush)
        bounds = flash_bounds(dname, b, h, kvh, s, d)
        # the tensor-core path is two launches: the k pre-pass, the main kernel
        fwd_names = ["fwd::rope_k_kernel", "fwd::main_kernel"]
        split = (device_ms_by_name(torch, lambda: (flush.zero_(), fa.flash_fwd(
            q, k, v, cos, sin, sm, rep)), fwd_names) if tma else dict.fromkeys(fwd_names))
        # ... and the backward three: the pre-pass, the dk/dv and the dq kernel
        bwd_names = ["bwd::prepass_kernel", "bwd::dkdv_kernel", "bwd::dq_kernel"]
        bwd_split = (device_ms_by_name(torch, lambda: (flush.zero_(), fa.flash_bwd(
            q, k, v, do, out, lse, cos, sin, sm, rep)), bwd_names)
            if tma else dict.fromkeys(bwd_names))
        line = {"case": label, "dtype": dname, "b": b, "h": h, "kv_heads": kvh, "s": s, "d": d,
                "stacked": stacked, "tolerance": tol,
                "fwd_err": fwd_err, "bwd_err_dq_dk_dv": bwd_err,
                "control_fwd_err": ctl_fwd, "control_bwd_err_dq_dk_dv": ctl_bwd,
                "fwd_max_abs_err": fwd_abs, "lse_max_abs_err": lse_err,
                "bwd_max_abs_err": bwd_abs,
                "fwd_ms": kernel_fwd, "bwd_ms": kernel_bwd,
                "fwd_rope_k_ms": split["fwd::rope_k_kernel"],
                "fwd_main_ms": split["fwd::main_kernel"],
                "fwd_route": fwd_route, "bwd_route": bwd_route,
                "bwd_repeat_bitwise": repeat_bitwise, "dq_row0_zero": dq_row0_zero,
                "bwd_prepass_ms": bwd_split["bwd::prepass_kernel"],
                "bwd_dkdv_ms": bwd_split["bwd::dkdv_kernel"], "bwd_dq_ms": bwd_split["bwd::dq_kernel"],
                "fwd_plain_ms": plain_fwd, "bwd_plain_ms": plain_bwd,
                "fwd_library_ms": lib_fwd, "bwd_library_ms": lib_bwd,
                "fwd_bound_ms": bounds["fwd"][0], "fwd_bound_by": bounds["fwd"][1],
                "bwd_bound_ms": bounds["bwd"][0], "bwd_bound_by": bounds["bwd"][1]}
        log(json.dumps(line))
        lines[label] = line
        check(finite, f"{label}: non-finite kernel output")
        check(dq_row0_zero or not tma, f"{label}: query 0's dq is not 0 on the TMA route")
        check(fwd_err <= fwd_lim, f"{label}: forward err {fwd_err} > {fwd_lim}")
        check(lse_err <= lse_tol, f"{label}: lse err {lse_err} > {lse_tol}")
        for name, e, c in zip("qkv", bwd_err, ctl_bwd):
            check(e <= bwd_lim, f"{label}: d{name} err {e} > {bwd_lim}")
            check(c > bwd_lim, f"{label}: the dropped-tile control passes for d{name} ({c})")
        check(ctl_fwd > fwd_lim, f"{label}: the dropped-tile control passes the forward check")
        del q, k, v, do, out, lse, grads, ref_out, ref_lse, ref_grads, kf, vf, qr, kr, vr
        del lib_out
        torch.cuda.empty_cache()
    RESULTS["flash"] = lines
    return lines


GRID_CASES = [
    # (label, dtype name, b, h, kv heads, s, d, causal, rope, stacked, out fp32)
    ("grid gpt", "bfloat16", 8, 25, 25, 1024, 64, True, False, True, False),
    ("grid non-causal", "bfloat16", 8, 16, 16, 512, 64, False, False, False, False),
    ("grid rope s16384", "bfloat16", 1, 4, 4, 16384, 128, True, True, False, False),
    ("grid gqa kv_rep 4", "bfloat16", 8, 32, 8, 1024, 64, True, False, False, False),
    ("grid fp32", "float32", 2, 25, 25, 1024, 64, True, False, True, False),
    ("grid out fp32", "bfloat16", 8, 25, 25, 1024, 64, True, False, True, True),
    # the encoders' shapes, unmasked, in the layer's stacked projection view
    # (phase 22): bert-large's 512 tokens at 22 (a)'s batch 32, vit-large's
    # 196 patches at 64 images (rows and keys past s in the last tile),
    # vit-huge's head_dim 80 at 256 patches (the CUDA-core kernels) at 2 and
    # at 22 (c)'s 16 images; "grid non-causal" is bert-large's shape at
    # batch 8, unstacked, kept as earlier readings took it
    ("grid encoder s512 d64", "bfloat16", 32, 16, 16, 512, 64, False, False, True, False),
    ("grid encoder s196 d64", "bfloat16", 64, 16, 16, 196, 64, False, False, True, False),
    ("grid encoder s256 d80", "bfloat16", 2, 16, 16, 256, 80, False, False, True, False),
    ("grid encoder s256 d80 b16", "bfloat16", 16, 16, 16, 256, 80, False, False, True, False),
    # T5 (phase 23): t5-large's (16, 16, 512, 64) at 23 (a)'s batch, the
    # encoder unmasked and the decoder causal, and t5-3b's 32 heads of 32 at
    # 23 (c)'s batch (the CUDA-core kernels), in the stacked view
    ("grid t5 s512 d64", "bfloat16", 16, 16, 16, 512, 64, False, False, True, False),
    ("grid t5 causal s512 d64", "bfloat16", 16, 16, 16, 512, 64, True, False, True, False),
    ("grid t5-3b s512 d32", "bfloat16", 4, 32, 32, 512, 32, False, False, True, False),
    # the fp16 instances (the CUDA-core kernels; phase 25's paths): the GPT-2
    # XL shape, opt-1.3b's, bert-large's unmasked at batch 8, the ring hop's fp32
    # output, RoPE (the kernel rotates q and k itself: no pre-pass), GQA, and
    # vit-huge's head_dim 80
    ("grid gpt fp16", "float16", 8, 25, 25, 1024, 64, True, False, True, False),
    # phase 25 (a)'s opt-1.3b shape and batch, the kernels line's fp16 case
    ("grid opt fp16", "float16", 8, 32, 32, 2048, 64, True, False, True, False),
    ("grid non-causal fp16", "float16", 8, 16, 16, 512, 64, False, False, False, False),
    ("grid out fp32 fp16", "float16", 8, 25, 25, 1024, 64, True, False, True, True),
    ("grid rope s2048 fp16", "float16", 1, 4, 4, 2048, 128, True, True, False, False),
    ("grid gqa kv_rep 4 fp16", "float16", 8, 32, 8, 1024, 64, True, False, False, False),
    ("grid encoder s256 d80 fp16", "float16", 2, 16, 16, 256, 80, False, False, True, False),
]


def _dropped_grid_keep(torch):
    """The grid plain versions' mask (causal or full) with keys 0-63
    dropped for the rows from max(64, s/2): the control."""

    def keep(s, causal, device):
        r = torch.arange(s, device=device)
        mask = r[:, None] >= r[None, :] if causal else torch.ones(
            s, s, dtype=torch.bool, device=device)
        mask[max(64, s // 2):, :64] = False
        return mask

    return keep


def grid_bounds(dtype, b, h, kvh, s, d, causal, rope, out_esz):
    """Least times of the grid forward, the whole backward and each of its
    two kernels on these shapes: inputs read once and outputs written once
    over 3.35 TB/s, or the products over the (query, key) pairs that are
    not masked (2·d operations each; 2 products in the forward, 5 in the
    backward, 4 in the dk/dv kernel: s, dp, dv, dk; 3 in the dq kernel: s,
    dp, dq) over the input type's peak, whichever is larger."""
    esz = 2 if dtype in ("bfloat16", "float16") else 4
    pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
    qo = b * h * s * d * esz
    kv = b * kvh * s * d * esz
    tables = 2 * s * (d // 2) * 4 if rope else 0
    row = b * h * s * 4
    ins_bwd = 2 * qo + 2 * kv + 2 * row + tables          # q, do, k, v, lse, delta
    parts = {
        "fwd": (qo + 2 * kv + tables + b * h * s * d * out_esz + row, 2),
        "bwd": (ins_bwd + 3 * qo, 5),
        "dkdv": (ins_bwd + 2 * qo, 4),
        "dq": (ins_bwd + qo, 3),
    }
    peak = PEAK_FLOPS["torch." + dtype]
    out = {}
    for name, (nbytes, prods) in parts.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = prods * 2 * d * pairs / peak * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def device_ms_by_name(torch, fn, names, iters=10, windows=3):
    """Mean device time per call of the kernels whose names contain each of
    ``names``, from a torch.profiler window over ``iters`` calls. A window in
    which the tracer recorded none of them is taken again, up to ``windows``
    in all (seen on card machines: a window missing every kernel of a run
    whose launches the wrappers counted)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        intervals = _kernel_intervals(prof)
        out = {n: sum(end - start for kname, start, end in intervals if n in kname) / 1e3 / iters
               for n in names}
        if all(v > 0 for v in out.values()):
            break
    seen = sorted({kname[:60] for kname, _, _ in intervals})
    check(all(v > 0 for v in out.values()),
          f"the profiler saw none of {names} in {windows} windows: {out}; it saw {seen[:8]}")
    return out


def phase_grid(torch):
    """The grid forward and the grid dk/dv and dq kernels against their
    plain versions on the card, with the dropped-tile control, and their
    times beside the plain versions', SDPA's and the bounds."""
    import math

    import torch.nn.functional as F

    from galvatron_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lines = {}
    for i, (label, dname, b, h, kvh, s, d, causal, rope, stacked, out_fp32) in enumerate(
            GRID_CASES):
        t0 = time.perf_counter()
        dtype = getattr(torch, dname)
        q, k, v, do, cos, sin = flash_case(torch, dtype, b, h, kvh, s, d, stacked, seed=30 + i)
        tables = (cos, sin) if rope else None
        rep, sm = h // kvh, 1.0 / math.sqrt(d)
        out_dtype = torch.float32 if out_fp32 else None
        before = (fa.flash_grid_fwd.launches, fa.flash_grid_bwd_parts.dkv_launches,
                  fa.flash_grid_bwd_parts.dq_launches)
        route_counts = (fa.flash_grid_fwd.routes, fa.flash_grid_bwd_parts.dkv_routes,
                        fa.flash_grid_bwd_parts.dq_routes)
        routes_before = [dict(r) for r in route_counts]
        dtype_counts = (fa.flash_grid_fwd.dtypes, fa.flash_grid_bwd_parts.dkv_dtypes,
                        fa.flash_grid_bwd_parts.dq_dtypes)
        dtypes_before = [c[str(dtype)] for c in dtype_counts]
        out, lse = fa.flash_grid_fwd(q, k, v, tables, sm, causal, rep, out_dtype)
        delta = (do.float() * out.float()).sum(-1, keepdim=True).contiguous()
        grads = fa.flash_grid_bwd_parts(q, k, v, do, lse, delta, tables, sm, causal, rep)
        fwd_route, dkv_route, dq_route = (_route_taken(fa, r, b_)
                                          for r, b_ in zip(route_counts, routes_before))
        again = fa.flash_grid_bwd_parts(q, k, v, do, lse, delta, tables, sm, causal, rep)
        torch.cuda.synchronize()
        after = (fa.flash_grid_fwd.launches, fa.flash_grid_bwd_parts.dkv_launches,
                 fa.flash_grid_bwd_parts.dq_launches)
        check(after == (before[0] + 1, before[1] + 2, before[2] + 2),
              f"{label}: a kernel did not launch")
        check([c[str(dtype)] - n for c, n in zip(dtype_counts, dtypes_before)] == [1, 2, 2],
              f"{label}: the launches were not counted as {dtype}")
        repeat_bitwise = all(torch.equal(g, a) for g, a in zip(grads, again))
        del again
        tma = dtype == torch.bfloat16 and d in (64, 128)
        check((fwd_route, dkv_route, dq_route) == ((("tma" if tma else "cuda_core"),) * 3),
              f"{label}: forward / dk/dv / dq routes {fwd_route} / {dkv_route} / {dq_route}")
        check(repeat_bitwise, f"{label}: two backward calls on the same inputs differ")
        check(out.dtype == (out_dtype or dtype), f"{label}: out is {out.dtype}")
        kf, vf = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        ref_out, ref_lse = fa.flash_fwd_grid_plain(q, k, v, tables, sm, causal, rep, out_dtype)
        ref_grads = fa.flash_bwd_grid_plain(q, kf, vf, do, lse, delta, tables, sm, causal)
        with _patched(fa, _grid_keep=_dropped_grid_keep(torch)):
            ctl_out, _ = fa.flash_fwd_grid_plain(q, k, v, tables, sm, causal, rep, out_dtype)
            ctl_grads = fa.flash_bwd_grid_plain(q, kf, vf, do, lse, delta, tables, sm, causal)
        def rule(g, r, w):  # by the input dtype, whatever the output's
            return _flash_err(torch, fa, g, r, w, dtype)
        fwd_err, fwd_lim = rule(out, ref_out, "fwd")
        bwd = [rule(g, r, "bwd") for g, r in zip(grads, ref_grads)]
        bwd_err, bwd_lim = [e for e, _ in bwd], bwd[0][1]
        ctl_fwd = rule(ctl_out, ref_out, "fwd")[0]
        ctl_bwd = [rule(c, r, "bwd")[0] for c, r in zip(ctl_grads, ref_grads)]
        abs_err = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref_grads)]
        fwd_abs = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        lse_tol = 1e-5 if dtype == torch.float32 else 1e-4
        finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
        del ctl_out, ctl_grads
        # yardstick: SDPA over (pre-roped) q/k, and its autograd backward
        if rope:
            qr, kr = fa._rope_f32(q, cos, sin).to(dtype), fa._rope_f32(kf, cos, sin).to(dtype)
        else:
            qr, kr = q.contiguous(), kf.contiguous()
        qr, kr = qr.detach().requires_grad_(True), kr.detach().requires_grad_(True)
        vr = vf.detach().clone().requires_grad_(True)
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        fwd_ms = time_ms(torch, lambda: fa.flash_grid_fwd(q, k, v, tables, sm, causal, rep,
                                                           out_dtype), flush)
        bwd_ms = time_ms(torch, lambda: fa.flash_grid_bwd_parts(
            q, k, v, do, lse, delta, tables, sm, causal, rep), flush)
        # the forward's launches (with RoPE on the TMA route: the k pre-pass,
        # then the main kernel); the dk/dv call's (with RoPE on the TMA route:
        # the pre-pass, then the dk/dv kernel), then the dq kernel's
        fwd_names = (["fwd::main_kernel"] + (["fwd::rope_k_kernel"] if rope else [])
                     if tma else ["flash_grid_fwd_kernel"])
        fwd_split = device_ms_by_name(torch, lambda: (flush.zero_(), fa.flash_grid_fwd(
            q, k, v, tables, sm, causal, rep, out_dtype)), fwd_names)
        dkv_names = (["bwd::dkdv_kernel"] + (["bwd::prepass_kernel"] if rope else [])
                     if tma else ["flash_grid_dkdv_kernel"])
        dq_name = "bwd::dq_kernel" if tma else "flash_grid_dq_kernel"
        split = device_ms_by_name(torch, lambda: (flush.zero_(), fa.flash_grid_bwd_parts(
            q, k, v, do, lse, delta, tables, sm, causal, rep)), dkv_names + [dq_name])
        dkdv_ms = sum(split[n] for n in dkv_names)
        plain_iters = 3 if s > 4096 else 5
        plain_fwd = time_ms(torch, lambda: fa.flash_fwd_grid_plain(
            q, k, v, tables, sm, causal, rep, out_dtype), flush, iters=plain_iters)
        plain_bwd = time_ms(torch, lambda: fa.flash_bwd_grid_plain(
            q, kf, vf, do, lse, delta, tables, sm, causal), flush, iters=plain_iters)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=causal), flush)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), do, retain_graph=True), flush)
        bounds = grid_bounds(dname, b, h, kvh, s, d, causal, rope, 4 if out_fp32 else
                             q.element_size())
        line = {"case": label, "dtype": dname, "b": b, "h": h, "kv_heads": kvh, "s": s, "d": d,
                "causal": causal, "rope": rope, "stacked": stacked,
                "out_dtype": str(out.dtype).replace("torch.", ""),
                "tolerance": ("fp32: max abs err, out/lse 1e-5, gradients 1e-4"
                              if dtype == torch.float32 else
                              f"{_kind(dtype)}: |err| - 1 ulp over the row's rms "
                              f"({_kind(dtype)}_parity_excess), out {fwd_lim}, gradients "
                              f"{bwd_lim}; lse 1e-4"),
                "fwd_err": fwd_err, "bwd_err_dq_dk_dv": bwd_err,
                "control_fwd_err": ctl_fwd, "control_bwd_err_dq_dk_dv": ctl_bwd,
                "fwd_max_abs_err": fwd_abs, "lse_max_abs_err": lse_err,
                "bwd_max_abs_err_dq_dk_dv": abs_err,
                "fwd_route": fwd_route, "dkv_route": dkv_route, "dq_route": dq_route,
                "bwd_repeat_bitwise": repeat_bitwise,
                "fwd_ms": fwd_ms, "fwd_main_ms": fwd_split[fwd_names[0]],
                "fwd_rope_k_ms": fwd_split.get("fwd::rope_k_kernel"),
                "bwd_ms": bwd_ms, "dkdv_ms": dkdv_ms,
                "dkdv_prepass_ms": split.get("bwd::prepass_kernel"),
                "dq_ms": split[dq_name], "fwd_plain_ms": plain_fwd, "bwd_plain_ms": plain_bwd,
                "fwd_library_ms": lib_fwd, "bwd_library_ms": lib_bwd,
                **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
                **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
                "seconds": time.perf_counter() - t0}
        log(json.dumps(line))
        lines[label] = line
        check(finite, f"{label}: non-finite kernel output")
        check(fwd_err <= fwd_lim, f"{label}: forward err {fwd_err} > {fwd_lim}")
        check(lse_err <= lse_tol, f"{label}: lse err {lse_err} > {lse_tol}")
        check(ctl_fwd > fwd_lim, f"{label}: the dropped-tile control passes the forward check")
        for name, e, c in zip("qkv", bwd_err, ctl_bwd):
            check(e <= bwd_lim, f"{label}: d{name} err {e} > {bwd_lim}")
            check(c > bwd_lim, f"{label}: the dropped-tile control passes for d{name} ({c})")
        del q, k, v, do, out, lse, delta, grads, ref_out, ref_lse, ref_grads, kf, vf
        del qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    RESULTS["grid"] = lines
    return lines


# the ring-hop mode of the grid kernels (context parallelism, phase 17): a
# past block of 8192 keys against 8192 queries, 32 heads of 128, bf16 in and
# fp32 out, at llama-7b width with 16384-token sequences split over cp = 2;
# two sequences, 17 (b)'s local batch (its cp layers have dp = 1)
RING_HOP = dict(b=2, h=32, s=8192, d=128)
RING_HOP_PLAIN_HEADS = 8  # the plain versions' (s x s) fp32 scores, 8 heads at a time


def _by_heads(torch, fn, *tensors, heads=RING_HOP_PLAIN_HEADS):
    """``fn`` over slices of ``heads`` heads of each (b, h, s, ...) tensor,
    its outputs (a tensor or a tuple of them) concatenated along the heads."""
    outs = [fn(*(t[:, i:i + heads] for t in tensors))
            for i in range(0, tensors[0].shape[1], heads)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


def phase_ring_hop(torch):
    """Phase 3's ring-hop cases: (i) the grid forward unmasked with fp32
    output on a past K/V block, (ii) the grid backward on that block given
    the lse / delta of a two-block fold (the diagonal block causal, the past
    one unmasked), which is not the block's own forward. Each against its
    plain version (computed 8 heads at a time), with the dropped-tile
    control, and timed beside the plain version, SDPA (non-causal) and the
    bound."""
    import math

    import torch.nn.functional as F

    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.parallel import ring

    b, h, s, d = (RING_HOP[k] for k in "bhsd")
    sm = 1.0 / math.sqrt(d)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    q, kb, vb, do, _, _ = flash_case(torch, torch.bfloat16, b, h, h, s, d, False, seed=60)
    _, ka, va, _, _, _ = flash_case(torch, torch.bfloat16, b, h, h, s, d, False, seed=61)
    routes = (fa.flash_grid_fwd.routes, fa.flash_grid_bwd_parts.dkv_routes,
              fa.flash_grid_bwd_parts.dq_routes)
    before = [dict(r) for r in routes]
    # (i) the past hop's forward
    out, lse = fa.flash_grid_fwd(q, kb, vb, None, sm, False, 1, torch.float32)
    # the fold: the diagonal block, then the past one
    o0, lse0 = fa.flash_grid_fwd(q, ka, va, None, sm, True, 1, torch.float32)
    m, l, acc = ring._lse_combine(lse0, torch.ones_like(lse0), o0, out, lse)
    l = l.clamp_min(1e-30)
    out_g, lse_g = (acc / l).to(torch.bfloat16), (m + torch.log(l)).contiguous()
    delta = (do.float() * out_g.float()).sum(-1, keepdim=True).contiguous()
    del o0, acc, m, l
    # (ii) the past hop's backward on the global statistics
    grads = fa.flash_grid_bwd_parts(q, kb, vb, do, lse_g, delta, None, sm, False)
    torch.cuda.synchronize()
    after = [dict(r) for r in routes]
    taken = {name: {r: after[i][r] - before[i][r] for r in fa.ROUTES}
             for i, name in enumerate(("fwd", "dkv", "dq"))}
    check(taken == {"fwd": {"tma": 2, "cuda_core": 0}, "dkv": {"tma": 1, "cuda_core": 0},
                    "dq": {"tma": 1, "cuda_core": 0}}, f"ring hop: routes {taken}")

    def plain_fwd(q_, k_, v_):
        return fa.flash_fwd_grid_plain(q_, k_, v_, None, sm, False, 1, torch.float32)

    def plain_bwd(q_, k_, v_, do_, lse_, delta_):
        return fa.flash_bwd_grid_plain(q_, k_, v_, do_, lse_, delta_, None, sm, False)

    ref_out, ref_lse = _by_heads(torch, plain_fwd, q, kb, vb)
    ref_grads = _by_heads(torch, plain_bwd, q, kb, vb, do, lse_g, delta)
    with _patched(fa, _grid_keep=_dropped_grid_keep(torch)):
        ctl_out, _ = _by_heads(torch, plain_fwd, q, kb, vb)
        ctl_grads = _by_heads(torch, plain_bwd, q, kb, vb, do, lse_g, delta)
    fwd_err = fa.bf16_parity_excess(out, ref_out)
    ctl_fwd = fa.bf16_parity_excess(ctl_out, ref_out)
    bwd_err = [fa.bf16_parity_excess(g, r) for g, r in zip(grads, ref_grads)]
    ctl_bwd = [fa.bf16_parity_excess(c, r) for c, r in zip(ctl_grads, ref_grads)]
    lse_err = (lse - ref_lse).abs().max().item()
    fwd_abs = (out - ref_out).abs().max().item()
    abs_err = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref_grads)]
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    del ctl_out, ctl_grads, ref_out, ref_grads
    torch.cuda.empty_cache()
    # yardstick: SDPA unmasked on the same block, and its autograd backward
    qr, kr, vr = (t.detach().contiguous().requires_grad_(True) for t in (q, kb, vb))
    lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=False)
    fwd_ms = time_ms(torch, lambda: fa.flash_grid_fwd(q, kb, vb, None, sm, False, 1,
                                                      torch.float32), flush)
    bwd_ms = time_ms(torch, lambda: fa.flash_grid_bwd_parts(q, kb, vb, do, lse_g, delta, None,
                                                            sm, False), flush)
    split = device_ms_by_name(torch, lambda: (flush.zero_(), fa.flash_grid_bwd_parts(
        q, kb, vb, do, lse_g, delta, None, sm, False)), ["bwd::dkdv_kernel", "bwd::dq_kernel"])
    plain_fwd_ms = time_ms(torch, lambda: _by_heads(torch, plain_fwd, q, kb, vb), flush, iters=3)
    plain_bwd_ms = time_ms(torch, lambda: _by_heads(torch, plain_bwd, q, kb, vb, do, lse_g,
                                                    delta), flush, iters=3)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(qr, kr, vr), flush)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib_out, (qr, kr, vr), do,
                                                         retain_graph=True), flush)
    bounds = grid_bounds("bfloat16", b, h, h, s, d, False, False, 4)
    lim_f, lim_b = fa.BF16_PARITY_TOL["fwd"], fa.BF16_PARITY_TOL["bwd"]
    line = {"case": "ring hop", "dtype": "bfloat16", "b": b, "h": h, "s": s, "d": d,
            "causal": False, "rope": False, "out_dtype": "float32",
            "stats": "the lse / delta of a two-block fold (diagonal causal + this block)",
            "plain_heads_at_a_time": RING_HOP_PLAIN_HEADS,
            "tolerance": f"bf16_parity_excess: out {lim_f}, gradients {lim_b}; lse 1e-4",
            "fwd_err": fwd_err, "bwd_err_dq_dk_dv": bwd_err, "control_fwd_err": ctl_fwd,
            "control_bwd_err_dq_dk_dv": ctl_bwd, "fwd_max_abs_err": fwd_abs,
            "lse_max_abs_err": lse_err, "bwd_max_abs_err_dq_dk_dv": abs_err, "routes": taken,
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "dkdv_ms": split["bwd::dkdv_kernel"],
            "dq_ms": split["bwd::dq_kernel"], "fwd_plain_ms": plain_fwd_ms,
            "bwd_plain_ms": plain_bwd_ms, "fwd_library_ms": lib_fwd, "bwd_library_ms": lib_bwd,
            **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
            **{f"{k}_bound_by": v[1] for k, v in bounds.items()}}
    log(json.dumps(line))
    check(finite, "ring hop: non-finite kernel output")
    check(fwd_err <= lim_f, f"ring hop: forward err {fwd_err} > {lim_f}")
    check(lse_err <= 1e-4, f"ring hop: lse err {lse_err} > 1e-4")
    check(ctl_fwd > lim_f, "ring hop: the dropped-tile control passes the forward check")
    for name, e, c in zip("qkv", bwd_err, ctl_bwd):
        check(e <= lim_b, f"ring hop: d{name} err {e} > {lim_b}")
        check(c > lim_b, f"ring hop: the dropped-tile control passes for d{name} ({c})")
    del q, ka, va, kb, vb, do, out, lse, grads, qr, kr, vr, lib_out, flush
    torch.cuda.empty_cache()
    RESULTS["ring_hop"] = line
    return line


# ---------------------------------------------------------------------------
# phase 3, continued: the fused norm kernels, parity and timing
# ---------------------------------------------------------------------------

NORM_CASES = [
    # (label, norm, dtype name, rows, H, timed)
    ("rms main", "rms", "bfloat16", 16384, 4096, True),
    ("ln main", "ln", "bfloat16", 16384, 2048, True),
    ("rms main fp32", "rms", "float32", 16384, 4096, True),
    ("ln main fp32", "ln", "float32", 16384, 2048, True),
    ("rms n1", "rms", "bfloat16", 1, 4096, False),
    ("ln n4", "ln", "bfloat16", 4, 2048, False),
    ("rms n1000", "rms", "bfloat16", 1000, 4096, False),
    ("ln n1000 fp32", "ln", "float32", 1000, 2048, False),
    ("rms h128", "rms", "bfloat16", 1000, 128, False),
    ("ln h128 fp32", "ln", "float32", 1000, 128, False),
    ("rms h5120", "rms", "bfloat16", 1000, 5120, False),
    ("ln h5120", "ln", "bfloat16", 1000, 5120, False),
    ("rms h7168 fp32", "rms", "float32", 1000, 7168, False),
    # Swin's widths (phase 24): (a)'s largest rows timed, stage 0's 128 x
    # 3136 x 128 and the last merge's 128 x 49 x 2048; the layers' and
    # merges' other widths, and swin-large's, at their rows for parity
    ("ln swin h128", "ln", "bfloat16", 128 * 3136, 128, True),
    ("ln swin h2048", "ln", "bfloat16", 128 * 49, 2048, True),
    ("ln swin h256", "ln", "bfloat16", 128 * 784, 256, False),
    ("ln swin h512", "ln", "bfloat16", 128 * 784, 512, False),
    ("ln swin h1024", "ln", "bfloat16", 128 * 196, 1024, False),
    ("ln swin h384", "ln", "bfloat16", 16 * 784, 384, False),
    ("ln swin h3072", "ln", "bfloat16", 16 * 49, 3072, False),
    # the fp16 instances at the training shapes (phase 15 (d)'s RMSNorm,
    # phase 25 (a)'s LayerNorm) and at Swin's stage-0 rows
    ("rms main fp16", "rms", "float16", 16384, 4096, True),
    ("ln main fp16", "ln", "float16", 16384, 2048, True),
    ("ln swin h128 fp16", "ln", "float16", 128 * 3136, 128, True),
]
# bf16 y and dx against the plain version, by fa.bf16_parity_excess: both
# round one fp32 value whose two computations differ only in the order of
# the row sum (~1e-7 relative), so they lie within one ulp and the excess is
# 0 but for fp32 noise; a row normalised with H + 128 reads 0.01 and more
NORM_BF16_TOL = 2 ** -10
# fp16 the same bound scaled to fp16's ulp (2^-3 of bf16's)
NORM_FP16_TOL = 2 ** -13
# dscale / dbias: the largest error over the rms of the vector (fp32 column
# sums over up to 16384 rows in another order); a strip of n/256 rows left
# out reads 0.05 and more
NORM_COLSUM_TOL = 1e-4
NORM_EPS = 1e-5


def norm_inputs(torch, dtype, n, h, seed):
    """Rows, an incoming gradient correlated with them (so that the
    backward's row-sum terms weigh as much as its direct term), and fp32
    scale and bias away from 1 and 0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x32 = torch.randn((n, h), generator=gen, device="cuda") * 1.5 + 0.3
    dy = (torch.randn((n, h), generator=gen, device="cuda") + 0.5 * x32).to(dtype)
    scale = 1.0 + 0.1 * torch.randn((h,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((h,), generator=gen, device="cuda")
    return x32.to(dtype), dy, scale, bias


def norm_bounds(norm, dtype, n, h):
    """Least times of the forward and the backward: inputs read once and
    outputs written once over 3.35 TB/s (forward: x, scale [, bias] -> y,
    rstd [, mu]; backward: x, dy, scale, rstd [, mu] -> dx, dscale [,
    dbias]), or the fp32 operations of the formulas (per element: forward 4
    RMSNorm / 7 LayerNorm, backward 10 / 13) over the 67 TFLOP/s of the CUDA
    cores, whichever is larger."""
    esz = 2 if dtype in ("bfloat16", "float16") else 4
    k = 2 if norm == "ln" else 1  # statistics per row, parameters per column
    nbytes = {"fwd": 2 * n * h * esz + k * h * 4 + k * n * 4,
              "bwd": 3 * n * h * esz + k * n * 4 + h * 4 + k * h * 4}
    ops = {"fwd": 7 if norm == "ln" else 4, "bwd": 13 if norm == "ln" else 10}
    out = {}
    for name in ("fwd", "bwd"):
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] * n * h / PEAK_FLOPS["torch.float32"] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def _norm_fns(fn, norm, scale, bias):
    """(forward, backward, plain forward, plain backward) of one norm, each
    forward returning (y, *statistics) and each backward taking (x,
    statistics, dy) and returning (dx, dscale [, dbias])."""
    if norm == "rms":
        return (lambda x: fn.rms_fwd(x, scale, NORM_EPS),
                lambda x, st, dy: fn.rms_bwd(x, scale, *st, dy),
                lambda x: fn.rms_fwd_plain(x, scale, NORM_EPS),
                lambda x, st, dy: fn.rms_bwd_plain(x, scale, *st, dy))
    return (lambda x: fn.ln_fwd(x, scale, bias, NORM_EPS),
            lambda x, st, dy: fn.ln_bwd(x, scale, *st, dy),
            lambda x: fn.ln_fwd_plain(x, scale, bias, NORM_EPS),
            lambda x, st, dy: fn.ln_bwd_plain(x, scale, *st, dy))


def _wrong_h_row(torch, norm, x, dy, scale, bias, stats, row):
    """Row ``row`` of y and dx as a kernel would write them that divided
    its row sums by H + 128: the control for the row reductions."""
    xr, dyr, g = x[row].float(), dy[row].float(), scale
    wrong = xr.numel() + 128
    if norm == "rms":
        r = stats[0][row]
        y = xr * torch.rsqrt((xr * xr).sum() / wrong + NORM_EPS) * g
        dyg = dyr * g
        dx = r * dyg - xr * (r * r * r) * ((dyg * xr).sum() / wrong)
        return y, dx
    mu, rstd = stats[0][row], stats[1][row]
    xc = xr - mu
    y = xc * torch.rsqrt((xc * xc).sum() / wrong + NORM_EPS) * g + bias
    xhat, dxhat = xc * rstd, dyr * g
    dx = rstd * (dxhat - dxhat.sum() / wrong - xhat * ((dxhat * xhat).sum() / wrong))
    return y, dx


def _vec_err(got, ref):
    """dscale / dbias: the largest error over the rms of the vector."""
    return ((got - ref).abs().max() / ref.square().mean().sqrt().clamp_min(1e-30)).item()


def _norm_counts(fn, norm):
    return (fn.rms_fwd.launches, fn.rms_bwd.launches) if norm == "rms" else (
        fn.ln_fwd.launches, fn.ln_bwd.launches)


def phase_norm(torch):
    """The four fused norm kernels against their plain versions on the
    card, with the wrong-H and left-out-strip controls, and their times
    beside the plain versions', the library calls' and the bounds."""
    import torch.nn.functional as F

    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.ops import fused_norm as fn

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lines = {}
    for i, (label, norm, dname, n, h, timed) in enumerate(NORM_CASES):
        t0 = time.perf_counter()
        dtype = getattr(torch, dname)
        x, dy, scale, bias = norm_inputs(torch, dtype, n, h, seed=50 + i)
        fwd, bwd, plain_fwd, plain_bwd = _norm_fns(fn, norm, scale, bias)
        before = _norm_counts(fn, norm)
        dtypes_before = fn.dtype_counts()
        y, *stats = fwd(x)
        dx, *dvecs = bwd(x, stats, dy)
        torch.cuda.synchronize()
        check(_norm_counts(fn, norm) == (before[0] + 1, before[1] + 1),
              f"{label}: a kernel did not launch")
        counted = {k: v[str(dtype)] - dtypes_before[k][str(dtype)]
                   for k, v in fn.dtype_counts().items()}
        check(counted == {k: int(k.startswith(norm)) for k in counted},
              f"{label}: launches counted as {dtype}: {counted}")
        ref_y, *ref_stats = plain_fwd(x)
        # the backward is held on the kernel's own statistics, as the path runs it
        ref_dx, *ref_dvecs = plain_bwd(x, stats, dy)
        fp32 = dtype == torch.float32
        excess, band = ((fa.bf16_parity_excess, NORM_BF16_TOL) if dtype == torch.bfloat16
                        else (fa.fp16_parity_excess, NORM_FP16_TOL))
        row_err = (lambda g, r, tol: ((g - r).abs().max().item(), tol)) if fp32 else (
            lambda g, r, tol: (excess(g, r), band))
        y_err, y_lim = row_err(y, ref_y, 1e-5)
        dx_err, dx_lim = row_err(dx, ref_dx, 1e-4)
        stat_err = max((a - b).abs().max().item() for a, b in zip(stats, ref_stats))
        vec_err = [_vec_err(a, b) for a, b in zip(dvecs, ref_dvecs)]
        # control 1: one row normalised with the wrong H
        row = n // 2
        wy, wdx = _wrong_h_row(torch, norm, x, dy, scale, bias, stats, row)
        ctl_y, ctl_dx = ref_y.clone(), ref_dx.clone()
        ctl_y[row], ctl_dx[row] = wy.to(dtype), wdx.to(dtype)
        ctl_y_err, ctl_dx_err = row_err(ctl_y, ref_y, 1e-5)[0], row_err(ctl_dx, ref_dx, 1e-4)[0]
        # control 2: the column sums with a strip of rows left out
        strip = max(1, n // 256)
        _, *strip_vecs = plain_bwd(x[:strip], [st[:strip] for st in stats], dy[:strip])
        ctl_vec_err = [_vec_err(r - sv, r) for r, sv in zip(ref_dvecs, strip_vecs)]
        finite = all(bool(torch.isfinite(t).all()) for t in (y, dx, *stats, *dvecs))
        line = {"case": label, "norm": norm, "dtype": dname, "rows": n, "hidden": h,
                "tolerance": ("fp32: max abs err, y/statistics 1e-5, dx 1e-4" if fp32 else
                              f"{_kind(dtype)}: |err| - 1 ulp over the row's rms "
                              f"({_kind(dtype)}_parity_excess) {y_lim}, statistics 1e-5") +
                             f"; dscale/dbias {NORM_COLSUM_TOL} of the vector's rms",
                "y_err": y_err, "dx_err": dx_err, "stat_max_abs_err": stat_err,
                "dscale_dbias_err": vec_err, "control_y_err": ctl_y_err,
                "control_dx_err": ctl_dx_err, "control_dscale_dbias_err": ctl_vec_err,
                "y_max_abs_err": (y.float() - ref_y.float()).abs().max().item(),
                "dx_max_abs_err": (dx.float() - ref_dx.float()).abs().max().item()}
        del ctl_y, ctl_dx
        if timed:
            # yardstick: F.rms_norm / F.layer_norm with the parameters in x's
            # dtype, and their autograd backward
            xl = x.detach().clone().requires_grad_(True)
            wl = scale.to(dtype).requires_grad_(True)
            bl = bias.to(dtype).requires_grad_(True)
            if norm == "rms":
                lib, lib_in = (lambda: F.rms_norm(xl, (h,), wl, NORM_EPS)), (xl, wl)
            else:
                lib, lib_in = (lambda: F.layer_norm(xl, (h,), wl, bl, NORM_EPS)), (xl, wl, bl)
            lib_out = lib()
            bounds = norm_bounds(norm, dname, n, h)
            line.update({
                "library_y_max_abs_err": (lib_out.float() - ref_y.float()).abs().max().item(),
                "fwd_ms": time_ms(torch, lambda: fwd(x), flush),
                "bwd_ms": time_ms(torch, lambda: bwd(x, stats, dy), flush),
                "fwd_plain_ms": time_ms(torch, lambda: plain_fwd(x), flush, iters=5),
                "bwd_plain_ms": time_ms(torch, lambda: plain_bwd(x, stats, dy), flush, iters=5),
                "fwd_library_ms": time_ms(torch, lib, flush),
                "bwd_library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, lib_in, dy, retain_graph=True), flush),
                **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
                **{f"{k}_bound_by": v[1] for k, v in bounds.items()}})
            del xl, wl, bl, lib_out
        line["seconds"] = time.perf_counter() - t0
        log(json.dumps(line))
        lines[label] = line
        check(finite, f"{label}: non-finite kernel output")
        check(y_err <= y_lim, f"{label}: y err {y_err} > {y_lim}")
        check(dx_err <= dx_lim, f"{label}: dx err {dx_err} > {dx_lim}")
        check(stat_err <= 1e-5, f"{label}: row statistics err {stat_err} > 1e-5")
        check(ctl_y_err > y_lim, f"{label}: the wrong-H control passes for y ({ctl_y_err})")
        check(ctl_dx_err > dx_lim, f"{label}: the wrong-H control passes for dx ({ctl_dx_err})")
        for name, e, c in zip(("dscale", "dbias"), vec_err, ctl_vec_err):
            check(e <= NORM_COLSUM_TOL, f"{label}: {name} err {e} > {NORM_COLSUM_TOL}")
            check(c > NORM_COLSUM_TOL, f"{label}: the left-out-strip control passes for {name}")
        del x, dy, y, dx, stats, dvecs, ref_y, ref_dx, ref_stats, ref_dvecs
        torch.cuda.empty_cache()
    lines.update(_norm_public_cases(torch, fa, fn))
    RESULTS["norm"] = lines
    return lines


def _norm_public_cases(torch, fa, fn):
    """The public functions over (..., H) through autograd, kernels against
    the plain versions swapped in: ``fused_add_rmsnorm`` under ``y.sum()``
    (an expanded, stride-0 incoming gradient) and ``fused_layernorm`` on a
    non-contiguous view."""
    gen = torch.Generator(device="cuda").manual_seed(90)
    out = {}

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def run(label, make, params, counters):
        res = {}
        for which in ("kernel", "plain"):
            leaves = [t.detach().clone().requires_grad_(True) for t in params]
            plain = {} if which == "kernel" else {
                k: getattr(fn, k + "_plain") for k in ("rms_fwd", "rms_bwd", "ln_fwd", "ln_bwd")}
            before = fn.launch_counts()
            with _patched(fn, **plain):
                y = make(*leaves)
                grads = torch.autograd.grad(y.sum(), leaves)
            torch.cuda.synchronize()
            res[which] = (y, grads, _delta(fn.launch_counts(), before))
        (y, grads, launched), (ref_y, ref_grads, ref_launched) = res["kernel"], res["plain"]
        want = {k: int(k in counters) for k in launched}
        check(launched == want, f"{label}: launches {launched}, expected {want}")
        check(not any(ref_launched.values()), f"{label}: the plain run launched a kernel")
        errs = {"y": fa.bf16_parity_excess(y, ref_y),
                "dx": fa.bf16_parity_excess(grads[0], ref_grads[0]),
                "dparams": max(_vec_err(a.float(), b.float())
                               for a, b in zip(grads[1:], ref_grads[1:]))}
        line = {"case": label, "shape": list(y.shape), **errs}
        log(json.dumps(line))
        check(errs["y"] <= NORM_BF16_TOL and errs["dx"] <= NORM_BF16_TOL,
              f"{label}: y / dx excess {errs} > {NORM_BF16_TOL}")
        check(errs["dparams"] <= NORM_COLSUM_TOL, f"{label}: parameter gradients {errs}")
        out[label] = line

    bf16 = torch.bfloat16
    x, res = rand(4, 250, 4096).to(bf16), rand(4, 250, 4096).to(bf16)
    run("fused_add_rmsnorm stride-0 dy", lambda x_, g_: fn.fused_add_rmsnorm(x_, res, g_)[0],
        (x, 1.0 + 0.1 * rand(4096)), ("rms_fwd", "rms_bwd"))
    xt = rand(250, 4, 2048).to(bf16)
    run("fused_layernorm transposed view",
        lambda x_, g_, b_: fn.fused_layernorm(x_.transpose(0, 1), g_, b_),
        (xt, 1.0 + 0.1 * rand(2048), 0.1 * rand(2048)), ("ln_fwd", "ln_bwd"))
    return out


# ---------------------------------------------------------------------------
# phase 4: full-width forward, card vs CPU
# ---------------------------------------------------------------------------


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# 4 (c): the fp16 forward's logits against the fp32 card run's, the largest
# difference over the fp32 logits' rms (every activation and weight rounded
# to 11 bits through two llama-7b layers; the paged kernel itself is held to
# one fp16 ulp in phase 2). An H100 read 0.0061.
FORWARD_FP16_TOL = 2 ** -6


def phase_forward(torch, fused=False):
    """Prefill + decode steps through ``forward_with_cache_paged``, card
    against CPU; ``fused``: 4 rows with ``fused_norm=True``, every norm of
    every call through the RMSNorm forward kernel. Without ``fused`` the
    same weights cast to fp16 run the same tokens on the card beside them
    (4 (c), the paged kernel's fp16 instance): finite logits within
    ``FORWARD_FP16_TOL`` of the fp32 card logits' rms."""
    import numpy as np

    from galvatron_tpu_torch.models import generation, modeling
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.ops import fused_norm as fn

    cfg = modeling.PRESETS["llama-7b"].replace(num_layers=2, dtype=torch.float32,
                                               fused_norm=fused)
    cfgs = {"cuda": cfg, "cpu": cfg}
    t0 = time.perf_counter()
    cpu_params = modeling.init_model_params(cfg, 0, "cpu")
    gpu_params = _to(cpu_params, "cuda")
    params = {"cpu": cpu_params, "cuda": gpu_params}
    if not fused:
        cfgs["cuda_fp16"] = cfg.replace(dtype=torch.float16)
        params["cuda_fp16"] = modeling.cast_params(_to(gpu_params, "cuda"), cfgs["cuda_fp16"])
    bs, mb, b, steps = 16, 8, (4 if fused else 2), (4 if fused else 8)
    nblocks = 1 + b * mb
    rng = np.random.RandomState(0)
    tables = (rng.permutation(nblocks - 1) + 1).reshape(b, mb).astype(np.int32)
    pools = {dev: generation.init_kv_cache(cfgs[dev], nblocks, bs, dev.split("_")[0])
             for dev in cfgs}
    tokens = rng.randint(0, cfg.vocab_size, (b, 24)).astype(np.int64)
    offsets = np.asarray([0, 5, 0, 11][:b], np.int32)
    before, norm_before = fa.paged_decode_attention.launches, fn.launch_counts()
    dtypes_before = dict(fa.paged_decode_attention.dtypes)
    max_diff, fp16_diff, fp16_s = 0.0, 0.0, 0.0
    with torch.inference_mode():
        for step in range(steps + 1):
            logits = {}
            for dev in cfgs:
                t1 = time.perf_counter()
                out, _ = generation.forward_with_cache_paged(
                    params[dev], torch.from_numpy(tokens).to(dev.split("_")[0]), cfgs[dev],
                    pools[dev], torch.from_numpy(tables).to(dev.split("_")[0]),
                    torch.from_numpy(offsets).to(dev.split("_")[0]))
                logits[dev] = out.float().cpu()
                fp16_s += (time.perf_counter() - t1) * (dev == "cuda_fp16")
                check(bool(torch.isfinite(logits[dev]).all()),
                      f"step {step}: non-finite logits on {dev}")
            diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
            max_diff = max(max_diff, diff)
            check(diff <= 1e-3, f"forward step {step}: card vs CPU logits differ by {diff}")
            if not fused:
                rms = logits["cuda"].square().mean().sqrt().item()
                fp16_diff = max(fp16_diff,
                                (logits["cuda_fp16"] - logits["cuda"]).abs().max().item() / rms)
            offsets = offsets + tokens.shape[1]
            tokens = logits["cuda"][:, -1].argmax(-1, keepdim=True).numpy().astype(np.int64)
    launches = fa.paged_decode_attention.launches - before
    by_dtype = {k: v - dtypes_before[k] for k, v in fa.paged_decode_attention.dtypes.items()}
    want = {k: cfg.num_layers * steps if k == "torch.float32" or (
        k == "torch.float16" and not fused) else 0 for k in by_dtype}
    check(by_dtype == want, f"forward: kernel launches by dtype {by_dtype}, expected {want}")
    norm_launches = _delta(fn.launch_counts(), norm_before)
    norm_calls = (2 * cfg.num_layers + 1) * (steps + 1) if fused else 0
    want = {k: (norm_calls if k == "rms_fwd" else 0) for k in norm_launches}
    check(norm_launches == want, f"forward: norm launches {norm_launches}, expected {want}")
    res = {"layers": cfg.num_layers, "hidden": cfg.hidden_size, "rows": b,
           "fused_norm": fused, "decode_steps": steps,
           "max_abs_logit_diff": max_diff, "tolerance": 1e-3, "launches": launches,
           "launches_by_dtype": by_dtype, "norm_launches": norm_launches,
           "seconds": time.perf_counter() - t0}
    if not fused:
        res.update({"fp16_logit_diff_over_rms": fp16_diff, "fp16_tolerance": FORWARD_FP16_TOL,
                    "fp16_seconds": fp16_s})
    log("phase 4 forward:", json.dumps(res))
    RESULTS["forward_fused" if fused else "forward"] = res
    check(fused or fp16_diff <= FORWARD_FP16_TOL,
          f"forward: fp16 logits {fp16_diff} of the rms from fp32's > {FORWARD_FP16_TOL}")
    del cpu_params, gpu_params, params, pools
    torch.cuda.empty_cache()
    return by_dtype["torch.float16"]


# ---------------------------------------------------------------------------
# phase 5: full-width train steps, card vs CPU
# ---------------------------------------------------------------------------

# the fp32 card-vs-CPU steps' depth: the CPU side sets the phase's time, and
# one layer runs every kernel and module a deeper model runs
PARITY_LAYERS = 1
# and its steps: two, which compare an updated step, keep the script inside
# its time limit
PARITY_STEPS = 2


def kernel_counts():
    """Every training kernel's launch count: the flash kernels and the
    fused norm kernels."""
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.ops import fused_norm as fn

    return {"flash_fwd": fa.flash_fwd.launches, "flash_bwd": fa.flash_bwd.launches,
            "flash_grid_fwd": fa.flash_grid_fwd.launches,
            "flash_grid_dkdv": fa.flash_grid_bwd_parts.dkv_launches,
            "flash_grid_dq": fa.flash_grid_bwd_parts.dq_launches, **fn.launch_counts()}


def route_counts():
    """The flash wrappers' calls by route (``fa.ROUTES``: ``tma`` or
    ``cuda_core``), keyed as :func:`kernel_counts` keys their launches."""
    from galvatron_tpu_torch.ops import flash_attention as fa

    return {name: dict(r) for name, r in (
        ("flash_fwd", fa.flash_fwd.routes), ("flash_bwd", fa.flash_bwd.routes),
        ("flash_grid_fwd", fa.flash_grid_fwd.routes),
        ("flash_grid_dkdv", fa.flash_grid_bwd_parts.dkv_routes),
        ("flash_grid_dq", fa.flash_grid_bwd_parts.dq_routes))}


def reset_kernel_counts():
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.ops import fused_norm as fn

    fa.flash_fwd.launches = fa.flash_bwd.launches = fa.flash_grid_fwd.launches = 0
    fa.flash_grid_bwd_parts.dkv_launches = fa.flash_grid_bwd_parts.dq_launches = 0
    for modes in (fa.flash_grid_fwd.modes, fa.flash_grid_bwd_parts.dkv_modes,
                  fa.flash_grid_bwd_parts.dq_modes):
        modes.clear()
    fn.reset_launch_counts()


def path_counts(model, layers, steps, fused):
    """The launch counts ``steps`` train steps of ``model`` at ``layers``
    layers must show (no per-layer recompute): layers x steps for each flash
    kernel of its family (blocked for llama, grid for gpt / opt), (2 x
    layers + 1) x steps for its family's norm kernels when ``fused``, and 0
    for every other kernel, so a launch of the wrong family fails."""
    mine = {"flash_fwd", "flash_bwd"} if model == "llama" else {
        "flash_grid_fwd", "flash_grid_dkdv", "flash_grid_dq"}
    norms = set()
    if fused:
        norms = {"rms_fwd", "rms_bwd"} if model == "llama" else {"ln_fwd", "ln_bwd"}
    return {k: layers * steps if k in mine else (2 * layers + 1) * steps if k in norms else 0
            for k in kernel_counts()}


def _delta(a, b):
    return {k: a[k] - b[k] for k in a}


def phase_train_parity(torch, model, fused=False):
    import numpy as np

    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    preset = TRAIN_PATHS[model][0]
    cfg = modeling.PRESETS[preset].replace(num_layers=PARITY_LAYERS, max_seq_len=512,
                                           attn_impl="flash", fused_norm=fused)
    steps, t0 = PARITY_STEPS, time.perf_counter()
    adam = AdamConfig(lr=1e-4, weight_decay=0.01, grad_clip=1.0)
    cpu_params = modeling.init_model_params(cfg, 0, "cpu")
    runs = {}
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size, (1, 513)).astype(np.int32) for _ in range(steps)]
    for dev in ("cuda", "cpu"):
        rt = build_runtime(cfg, adam=adam, global_batch_size=1, seq_len=512,
                           mixed_precision="fp32", device=dev)
        params = _to(cpu_params, dev) if dev == "cuda" else cpu_params
        state = rt.state_from(params)
        before = kernel_counts()
        losses = []
        for batch in batches:
            state, loss = rt.train_step(state, torch.from_numpy(batch))
            losses.append(float(loss))
        runs[dev] = (losses, _delta(kernel_counts(), before))
        del state, params, rt
        torch.cuda.empty_cache()
    (gpu_losses, gpu_launches), (cpu_losses, cpu_launches) = runs["cuda"], runs["cpu"]
    diff = max(abs(a - b) for a, b in zip(gpu_losses, cpu_losses))
    check(all(np.isfinite(gpu_losses)), f"{preset} train parity: non-finite losses {gpu_losses}")
    check(diff <= 1e-3, f"{preset} train parity: card vs CPU losses differ by {diff}")
    want = path_counts(model, cfg.num_layers, steps, fused)
    check(gpu_launches == want, f"{preset} train parity: launches {gpu_launches}, expected {want}")
    check(not any(cpu_launches.values()), f"{preset} train parity: the CPU run launched a kernel")
    res = {"model": preset, "layers": cfg.num_layers, "hidden": cfg.hidden_size, "seq": 512,
           "batch": 1, "dtype": "float32", "fused_norm": fused, "steps": steps,
           "card_losses": gpu_losses,
           "cpu_losses": cpu_losses, "max_abs_loss_diff": diff, "tolerance": 1e-3,
           "launches": gpu_launches, "seconds": time.perf_counter() - t0}
    log("phase 5 train parity:", json.dumps(res))
    RESULTS[f"train_parity_{model}" + ("_fused" if fused else "")] = res


def _strip_dropped(torch, plain_bwd):
    """A norm backward's plain version with the first n/16 rows left out of
    the column sums (dscale, dbias): the control of the fused-norm step."""

    def bwd(x2d, scale, *rest):
        dx, *vecs = plain_bwd(x2d, scale, *rest)
        k = max(1, x2d.shape[0] // 16)
        _, *strip = plain_bwd(x2d[:k], scale, *[t[:k] for t in rest])
        return (dx, *[v - sv for v, sv in zip(vecs, strip)])

    return bwd


def phase_train_bf16(torch, model, fused=False, act=None):
    """The preset's width at 2 layers (``act``: with another MLP activation), bf16 over fp32 masters, batch 2 at
    its sequence length: the loss and every parameter gradient of one
    forward + backward through the bf16 tensor-core flash kernels (blocked
    for llama, grid for GPT / OPT) and, with ``fused``, the fused norm
    kernels, against the same step with the wrappers swapped for their plain
    versions on the same card (every other op, cuBLAS's GEMMs included, is
    then the same), and against a control, which must fail: plain versions
    that drop one key tile or, with ``fused``, that leave a strip of rows
    out of the norms' dscale / dbias."""
    import numpy as np

    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.ops import fused_norm as fn

    preset, _, _, seq = TRAIN_PATHS[model]
    cfg = modeling.PRESETS[preset].replace(num_layers=2, attn_impl="flash", dtype=torch.bfloat16,
                                           fused_norm=fused)
    if act is not None:
        cfg = cfg.replace(act_fn=act)
    grad_tol = TRAIN_BF16_RELU_GRAD_TOL if cfg.act_fn == "relu" else TRAIN_BF16_GRAD_TOL
    t0 = time.perf_counter()
    params = modeling.init_model_params(cfg, 0, "cuda")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, seq + 1))).to("cuda")

    def step():
        loss = modeling.lm_loss(params, batch, cfg)
        loss.backward()
        grads = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return loss.item(), grads

    before = kernel_counts()
    loss, grads = step()
    launches = _delta(kernel_counts(), before)
    if model == "llama":
        plain = {"flash_fwd": fa.flash_fwd_blocked_plain, "flash_bwd": fa.flash_bwd_plain}
    else:
        plain = {"flash_grid_fwd": fa.flash_fwd_grid_plain,
                 "flash_grid_bwd_parts": fa.flash_grid_bwd_parts_plain}
    norm_plain, norm_ctl = {}, {}
    if fused:
        norm_plain = {k: getattr(fn, k + "_plain")
                      for k in ("rms_fwd", "rms_bwd", "ln_fwd", "ln_bwd")}
        norm_ctl = dict(norm_plain, rms_bwd=_strip_dropped(torch, fn.rms_bwd_plain),
                        ln_bwd=_strip_dropped(torch, fn.ln_bwd_plain))
    with _patched(fa, **plain), _patched(fn, **norm_plain):
        ref_loss, ref_grads = step()
    plain_launches = _delta(kernel_counts(), before)  # read with the wrappers back in place
    if fused:
        with _patched(fa, **plain), _patched(fn, **norm_ctl):
            ctl_loss, ctl_grads = step()
    else:
        # both families' plain versions take their causal mask from _causal_keep
        with _patched(fa, **plain, _causal_keep=_dropped_tile_keep(torch)):
            ctl_loss, ctl_grads = step()

    def worst(gs):
        errs = [((g - r).norm() / r.norm().clamp_min(1e-30)).item()
                for g, r in zip(gs, ref_grads)]
        return max(errs)

    grad_err, ctl_grad_err = worst(grads), worst(ctl_grads)
    res = {"model": preset, "act_fn": cfg.act_fn, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "seq": seq,
           "batch": 2, "dtype": "bfloat16", "fused_norm": fused, "loss": loss,
           "plain_loss": ref_loss,
           "control_loss": ctl_loss, "loss_abs_diff": abs(loss - ref_loss),
           "loss_tolerance": TRAIN_BF16_LOSS_TOL, "grad_rel_err": grad_err,
           "grad_tolerance": grad_tol, "control_grad_rel_err": ctl_grad_err,
           "launches": launches, "seconds": time.perf_counter() - t0}
    log("phase 5 bf16 train parity:", json.dumps(res))
    RESULTS[f"train_parity_bf16_{model}" + ("_fused" if fused else "")
            + (f"_{act}" if act else "")] = res
    want = path_counts(model, cfg.num_layers, 1, fused)
    check(launches == want, f"{preset} bf16 train parity: launches {launches}, expected {want}")
    check(plain_launches == launches,
          f"{preset} bf16 train parity: the plain step launched a kernel ({plain_launches})")
    check(all(np.isfinite([loss, *[g.sum().item() for g in grads]])),
          f"{preset} bf16 train parity: non-finite loss or gradient")
    check(abs(loss - ref_loss) <= TRAIN_BF16_LOSS_TOL,
          f"{preset} bf16 train parity: kernel vs plain losses differ by {abs(loss - ref_loss)}")
    check(grad_err <= grad_tol,
          f"{preset} bf16 train parity: gradient relative error {grad_err} > {grad_tol}")
    check(ctl_grad_err > grad_tol,
          f"{preset} bf16 train parity: the control passes ({ctl_grad_err})")
    del params, leaves, grads, ref_grads, ctl_grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the serving path, cli serve
# ---------------------------------------------------------------------------


def _http(url, body=None, timeout=600):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _text(rng, n):
    letters = "abcdefghijklmnopqrstuvwxyz     "
    return "".join(letters[i] for i in rng.randint(0, len(letters), n))


def _start_cli_serve(argv, what):
    """``cli.main(argv)`` (a ``serve`` command, ``--port`` included) in a
    thread of this process; returns (base URL, thread, return codes, errors)
    once /readyz is 200."""
    from galvatron_tpu_torch import cli

    port = argv[argv.index("--port") + 1]
    rc, err = [], []

    def serve():
        try:
            rc.append(cli.main(argv))
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            err.append(e)
            raise

    server = threading.Thread(target=serve, name="cli-serve", daemon=True)
    server.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 600
    while True:
        check(not err, f"{what}: cli serve died: {err[:1]}")
        try:
            if _http(base + "/readyz", timeout=10)[0] == 200:
                break
        except OSError:
            pass
        check(time.time() < deadline, f"{what}: cli serve never became ready")
        time.sleep(0.2)
    return base, server, rc, err


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _serve_prompts():
    """Phase 6's prompts: ~50 / 300 / 700 bytes and one sharing the 700's
    first 640 bytes."""
    import numpy as np

    rng = np.random.RandomState(0)
    p50, p300, p700 = _text(rng, 50), _text(rng, 300), _text(rng, 700)
    return [p50, p300, p700, p700[:640] + _text(rng, 20)]


def _drive_serve(torch, smi, argv, what, layers, backend, plain=False, before=None):
    """The serving path's drive (phases 6, 16 and 18): ``cli serve`` with
    ``argv`` in a thread; 4 concurrent greedy POST /api requests of phase
    6's prompts, 32 tokens each, then the 300-byte prompt again, which must
    repeat; /healthz must name ``backend``; POST /drain must report no leak.
    The paged kernel's count is set to 0 just before and read just after
    (and must stay 0 with ``plain``: the caller put the plain version in the
    kernel's place). ``before(base URL)`` runs once the server is ready,
    before the burst. Returns (result line, {prompt: tokens}, (params, cfg)
    of the engine)."""
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.serving import engine as engine_mod

    engines = []

    class _Seen(engine_mod.Engine):  # keeps the served params for the margin rule
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append((self.params, self.cfg))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    real, engine_mod.Engine = engine_mod.Engine, _Seen
    try:
        fa.paged_decode_attention.launches = 0  # the main path's count starts here
        t0 = time.perf_counter()
        base, server, rc, err = _start_cli_serve(argv, what)
    finally:
        engine_mod.Engine = real
    ready_s = time.perf_counter() - t0
    if before is not None:
        before(base)
    prompts = _serve_prompts()
    results = [None] * len(prompts)

    def post(i):
        results[i] = _http(base + "/api", {"prompts": [prompts[i]], "tokens_to_generate": 32,
                                           "temperature": 0.0})

    t1 = time.perf_counter()
    posters = [threading.Thread(target=post, args=(i,)) for i in range(len(prompts))]
    for p in posters:
        p.start()
    for p in posters:
        p.join(600)
    burst_s = time.perf_counter() - t1
    tok = ByteTokenizer()
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"{what}: request {i}: {r}")
        n = len(r[1]["tokens"][0]) - len(tok.encode(prompts[i]))
        check(n == 32, f"{what}: request {i}: {n} generated tokens, expected 32")
    code, again = _http(base + "/api", {"prompts": [prompts[1]], "tokens_to_generate": 32})
    check(code == 200 and again["tokens"] == results[1][1]["tokens"],
          f"{what}: the repeated prompt gave another completion")
    code, health = _http(base + "/healthz")
    check(code == 200, f"{what}: /healthz {code}")
    st = health["serving"]
    check(st["kv_backend"] == backend, f"{what}: /healthz kv_backend {st['kv_backend']}")
    code, drained = _http(base + "/drain", {})
    check(code == 200 and drained.get("leaked") is False, f"{what}: /drain: {drained}")
    server.join(120)
    check(not server.is_alive() and rc == [0], f"{what}: cli serve did not exit cleanly: "
          f"{rc} {err}")
    launches = fa.paged_decode_attention.launches  # read right after the main path
    want = layers * st["decode_steps"] if backend == "paged" and not plain else 0
    check(launches == want, f"{what}: {launches} paged_decode launches, expected {want} "
          f"({backend} backend, {layers} layers x {st['decode_steps']} decode steps)")
    dh = st["decode_step_hist"]
    res = {
        "card": smi, "backend": backend, "layers": health["model"]["num_layers"],
        "hidden": health["model"]["hidden_size"], "requests": len(prompts) + 1,
        "prompt_bytes": [len(p) for p in prompts],
        "ready_s": ready_s, "burst_s": burst_s,
        "ttft_p50_s": st["ttft_p50_s"], "ttft_p95_s": st["ttft_p95_s"],
        "decode_step_ms_mean": 1e3 * dh["sum"] / max(1, dh["count"]),
        "decode_steps": st["decode_steps"], "tokens_generated": st["tokens_generated"],
        "tokens_per_s": st["tokens_per_s"], "prefix_cache_hits": st.get("prefix_cache_hits"),
        "kernel_launches": launches, "leaked": drained["leaked"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        # decode is host-bound: threads an earlier phase left running would
        # move its times
        "host_threads": threading.active_count(),
    }
    tokens = {p: r[1]["tokens"][0] for p, r in zip(prompts, results)}
    return res, tokens, engines[0]


#: phase 6's greedy tokens per prompt, for phase 16's margin rule
SERVE_TOKENS: dict = {}


def phase_serve(torch, smi):
    argv = ["serve", "--model_size", "llama-7b", "--kv_num_blocks", "-1",
            "--num_slots", "4", "--prefill_chunk", "32", "--port", _free_port(),
            "--request_ttl_s", "600"]
    res, tokens, _ = _drive_serve(torch, smi, argv, "phase 6", SERVE_LAYERS, "paged")
    res = {"card": smi, "model": "llama-7b", **{k: v for k, v in res.items() if k != "card"}}
    SERVE_TOKENS["llama-7b"] = tokens
    log("phase 6 serve:", json.dumps(res))
    RESULTS["serve"] = res
    return res["kernel_launches"]


# ---------------------------------------------------------------------------
# phase 16: the slot backend, GPT serving, cli generate, the serialized path
# ---------------------------------------------------------------------------

#: two greedy runs of one model in bf16 through other code (the slot
#: backend's ``decode_attention`` against the paged kernel, other batch
#: shapes for cuBLAS) may part where two logits lie within a rounding of
#: each other: tokens must agree up to the first difference, and there the
#: two runs' tokens' logits (from a forward of the common prefix) must lie
#: within this share of the logits' rms
MARGIN_TOL = 2 ** -4
SLOT_GEN_PROMPTS = 2  # 16 (c): phase 6's first two prompts
SERIAL_LAYERS = 2  # 16 (d)


def _margin_rule(torch, params, cfg, prompt_ids, a, b, what):
    """Hold two greedy token lists (prompt + completion) of one model to
    each other by the margin rule; returns what was read."""
    from galvatron_tpu_torch.models import modeling

    check(a[:len(prompt_ids)] == b[:len(prompt_ids)] == prompt_ids, f"{what}: prompts differ")
    n = min(len(a), len(b))
    j = next((i for i in range(len(prompt_ids), n) if a[i] != b[i]), None)
    if j is None:
        check(len(a) == len(b), f"{what}: {len(a)} against {len(b)} tokens")
        return {"equal": True, "first_difference": None}
    with torch.inference_mode():
        ids = torch.tensor([a[:j]], device=params["embed"]["tok"].device)
        logits = modeling.forward(params, ids, cfg)[0, -1]
    logits = logits.float()
    rms = float(logits.pow(2).mean().sqrt())
    gap = abs(float(logits[a[j]] - logits[b[j]]))
    top2 = logits.topk(2).values
    out = {"equal": False, "first_difference": j - len(prompt_ids), "gap": gap,
           "top2_margin": float(top2[0] - top2[1]), "logit_rms": rms,
           "tolerance": MARGIN_TOL * rms}
    check(gap <= MARGIN_TOL * rms, f"{what}: tokens part at generated position "
          f"{j - len(prompt_ids)} with a logit gap {gap} > {MARGIN_TOL} x rms {rms}")
    return out


def _margins(torch, params, cfg, runs_a, runs_b, what):
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    return {f"{len(p)} bytes": _margin_rule(torch, params, cfg, tok.encode(p), runs_a[p],
                                            runs_b[p], f"{what}, {len(p)}-byte prompt")
            for p in runs_a}


def phase_slots(torch, smi):
    """16 (a)-(d): the default ``cli serve`` (slot backend) at llama-7b, 32
    layers; gpt-1.5b (48 layers) on the paged then the slot backend; ``cli
    generate`` at llama-7b; the serialized path at 2 layers."""
    import io

    from galvatron_tpu_torch import cli, server
    from galvatron_tpu_torch.models import generation, modeling
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer
    from galvatron_tpu_torch.ops import flash_attention as fa

    out = {}
    # (a) the default backend: cli serve with no --kv_num_blocks
    argv = ["serve", "--model_size", "llama-7b", "--num_slots", "4", "--prefill_chunk", "32",
            "--port", _free_port(), "--request_ttl_s", "600"]
    res_a, tok_a, (params, cfg) = _drive_serve(torch, smi, argv, "16 (a)", SERVE_LAYERS, "slot")
    if "llama-7b" in SERVE_TOKENS:
        res_a["against_phase6_paged"] = _margins(torch, params, cfg, SERVE_TOKENS["llama-7b"],
                                                 tok_a, "16 (a) slot against phase 6 paged")
    del params, cfg
    out["a_llama7b_slot"] = res_a
    log("phase 16 (a) serve llama-7b, slot backend:", json.dumps(res_a))
    # (b) gpt-1.5b, all 48 layers: paged, then slot
    gpt_layers = modeling.PRESETS["gpt-1.5b"].num_layers
    runs, toks = {}, {}
    for backend, extra in (("paged", ["--kv_num_blocks", "-1"]), ("slot", [])):
        argv = ["serve", "--model_size", "gpt-1.5b", "--num_slots", "4", "--prefill_chunk",
                "32", "--port", _free_port(), "--request_ttl_s", "600", *extra]
        # the slot run's weights stay for the margin rule; the paged run's go
        # before the slot run, so they are no part of its peak memory
        params = cfg = None
        runs[backend], toks[backend], (params, cfg) = _drive_serve(
            torch, smi, argv, f"16 (b) {backend}", gpt_layers, backend)
    out["b_gpt_paged_launches"] = runs["paged"]["kernel_launches"]
    res_b = {**runs, "slot_against_paged": _margins(torch, params, cfg, toks["paged"],
                                                    toks["slot"], "16 (b) slot against paged")}
    del params, cfg, runs
    out["b_gpt15b"] = res_b
    log("phase 16 (b) serve gpt-1.5b, paged and slot:", json.dumps(res_b))
    # (c) cli generate at llama-7b: greedy, two of phase 6's prompts, on
    # the weights (a) served (the cli draws seed 0 on the card either way)
    prompts = _serve_prompts()[:SLOT_GEN_PROMPTS]
    got = []
    real_np = generation.generate_np

    def spy(params, cfg, *a, **kw):
        got.append((params, cfg, real_np(params, cfg, *a, **kw)))
        return got[-1][2]

    fa.paged_decode_attention.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    generation.generate_np = spy
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["generate", "--model_size", "llama-7b", "--max_new_tokens", "32",
                           *sum((["--prompt", p] for p in prompts), [])])
    finally:
        generation.generate_np = real_np
    gen_s = time.perf_counter() - t0
    check(rc == 0, f"16 (c): cli generate returned {rc}")
    check(fa.paged_decode_attention.launches == 0, "16 (c): generate launched paged_decode")
    params, cfg, outs = got[0]
    lines = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    tok = ByteTokenizer()
    toks_c = dict(zip(prompts, outs))
    check([ln["prompt"] for ln in lines] == prompts, f"16 (c): JSON lines {lines}")
    check(all(ln["completion"] == tok.decode(toks_c[p][len(tok.encode(p)):])
              for ln, p in zip(lines, prompts)), "16 (c): completions are not generate_np's")
    check(all(len(toks_c[p]) - len(tok.encode(p)) == 32 for p in prompts),
          "16 (c): not 32 tokens a prompt")
    res_c = {"card": smi, "prompts": len(prompts), "seconds": gen_s,
             "against_16a_slot": _margins(torch, params, cfg, {p: tok_a[p] for p in prompts},
                                          toks_c, "16 (c) generate against 16 (a)")}
    del params, cfg, got
    gc.collect()
    torch.cuda.empty_cache()
    out["c_llama7b_generate"] = res_c
    log("phase 16 (c) cli generate llama-7b:", json.dumps(res_c))
    # (d) the serialized path (--num_slots 0) at 2 layers
    services = []

    class _Seen(server.GenerationService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            services.append(self)

    real_gs, server.GenerationService = server.GenerationService, _Seen
    try:
        argv = ["serve", "--model_size", "llama-7b", "--num_layers", str(SERIAL_LAYERS),
                "--num_slots", "0", "--port", _free_port()]
        base, srv, rc, err = _start_cli_serve(argv, "16 (d)")
    finally:
        server.GenerationService = real_gs
    prompt = _serve_prompts()[1]
    code, resp = _http(base + "/api", {"prompts": [prompt], "tokens_to_generate": 16})
    check(code == 200, f"16 (d): {code} {resp}")
    code, health = _http(base + "/healthz")
    check(code == 200 and "serving" not in health and health["gate"]["in_use"] == 0,
          f"16 (d): /healthz {health}")
    svc = services[0]
    want = generation.generate_np(svc.params, svc.cfg, [tok.encode(prompt)], max_new_tokens=16,
                                  eos_id=tok.eos_id, pad_id=tok.pad_id)
    code, drained = _http(base + "/drain", {})
    srv.join(120)
    check(not srv.is_alive() and rc == [0] and drained.get("leaked") is False,
          f"16 (d): cli serve did not drain cleanly: {rc} {err} {drained}")
    check(resp["tokens"] == want, "16 (d): the serialized path's tokens are not generate_np's")
    res_d = {"card": smi, "layers": SERIAL_LAYERS,
             "generated_tokens": len(want[0]) - len(tok.encode(prompt)),
             "equal_to_generate_np": True, "gate": health["gate"]}
    del svc, services
    out["d_serialized"] = res_d
    log("phase 16 (d) serve --num_slots 0:", json.dumps(res_d))
    beside = {k: {"phase6_paged_llama7b": RESULTS.get("serve", {}).get(k),
                  "16a_slot_llama7b": res_a[k], "16b_paged_gpt15b": res_b["paged"][k],
                  "16b_slot_gpt15b": res_b["slot"][k]}
              for k in ("ttft_p50_s", "ttft_p95_s", "decode_step_ms_mean", "tokens_per_s",
                        "max_memory_allocated_gb")}
    log("phase 16 beside phase 6:", json.dumps(beside))
    out["beside_phase6"] = beside
    RESULTS["slots"] = out
    return out["b_gpt_paged_launches"]


# ---------------------------------------------------------------------------
# phase 7: the training path, cli train
# ---------------------------------------------------------------------------


def _kernel_intervals(prof):
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _union_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((s, e) for _, s, e in intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _category(name: str) -> str:
    n = name.lower()
    # the TMA kernels (csrc/flash_fwd_common.cuh, csrc/flash_bwd_common.cuh)
    # serve both families, their pre-passes included: the grid's are the ones
    # with GRID (the second template argument) true
    m = re.search(r"(fwd|bwd)::(rope_k|main|prepass|dkdv|dq)_kernel<\d+, (true|false)", n)
    if m:
        grid = "flash_grid_" if m.group(3) == "true" else "flash_"
        return grid + m.group(1)
    if "fused_norm_fwd" in n:
        return "norm_fwd"
    if "fused_norm_bwd" in n or "fused_norm_colsum" in n:
        return "norm_bwd"
    if "flash_grid_fwd" in n:
        return "flash_grid_fwd"
    if "flash_grid_dkdv" in n or "flash_grid_dq" in n:
        return "flash_grid_bwd"
    if "flash_fwd" in n:
        return "flash_fwd"
    if "flash_dkdv" in n or "flash_dq" in n or "flash_delta" in n:
        return "flash_bwd"
    # cuBLAS on Hopper names its GEMMs nvjet_*; older builds gemm/cutlass/xmma
    if any(k in n for k in ("nvjet", "gemm", "cutlass", "cublas", "xmma", "gemv")):
        return "matmul"
    return "other"


def _train_argv(modeling, run):
    """The ``cli train`` flags of a main-path run."""
    _, model, _, iters = TRAIN_RUNS[run]
    preset, layers, _, _ = TRAIN_PATHS[model]
    argv = ["--model_size", preset, "--train_iters", str(iters)]
    if layers != modeling.PRESETS[preset].num_layers:  # depth cut (llama-7b: 4 of 32 layers)
        argv += ["--num_layers", str(layers)]
    return argv


def phase_train(torch, smi, tmpdir, run):
    """One main-path training run: ``cli train`` (``cli.main``) or, with
    the fused norms, ``trainer.train(ns, cfg=...)`` with the config the same
    flags give and ``fused_norm=True`` (the field has no flag)."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.utils.metrics import read_metrics

    phase, model, fused, iters = TRAIN_RUNS[run]
    preset, layers, bsz, seq = TRAIN_PATHS[model]
    path = os.path.join(tmpdir, f"train_metrics_{run}.jsonl")
    argv = _train_argv(modeling, run) + ["--metrics_path", path]
    gc.collect()  # an earlier phase's engine or state may still sit in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_kernel_counts()  # the main path's counts start here
    routes_before = route_counts()
    if fused:
        ns = initialize_galvatron("train", argv)
        out = trainer.train(ns, cfg=model_config_from_args(ns).replace(fused_norm=True))
        launches = kernel_counts()  # read right after the main path
        check(out["launches"] == launches, f"{run}: trainer.train reports {out['launches']}")
        del out  # the final state
    else:
        rc = cli.main(["train", *argv])
        launches = kernel_counts()  # read right after the main path
        check(rc == 0, f"cli train {preset} returned {rc}")
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    recs = [r for r in read_metrics(path) if r["event"] == "train_iter"]
    check(len(recs) == iters, f"{len(recs)} train_iter records, expected {iters}")
    losses = [r["loss"] for r in recs]
    check(all(isinstance(x, float) and x == x and abs(x) != float("inf") for x in losses),
          f"{run}: non-finite losses {losses}")
    want = path_counts(model, layers, iters, fused)  # --global_checkpoint 0: no recompute
    check(launches == want, f"{run}: launches {launches}, expected {want}")
    # every flash call of the path (bf16, head_dim 64 / 128) took the TMA route
    routes = {k: {r: n - routes_before[k][r] for r, n in v.items()}
              for k, v in route_counts().items()}
    check(all(r["tma"] == launches[k] and r["cuda_core"] == 0 for k, r in routes.items()),
          f"{run}: routes {routes}, launches {launches}")
    steady = recs[1:]
    mean = lambda key: sum(r[key] for r in steady) / len(steady)  # noqa: E731
    res = {"card": smi, "run": run, "model": preset, "layers": layers, "batch": bsz, "seq": seq,
           "dtype": "bfloat16", "fused_norm": fused, "iters": iters, "losses": losses,
           "iter_ms_mean_from_2": mean("iter_ms"), "iter_ms": [r["iter_ms"] for r in recs],
           "tokens_per_s": mean("tokens_per_s"), "tflops_per_device": mean("tflops_per_device"),
           "mfu": mean("mfu"), "max_memory_allocated_gb": peak_gb, "launches": launches,
           "tma_routes": {k: r["tma"] for k, r in routes.items()}, "seconds": seconds}
    log(f"phase {phase} train {run}:", json.dumps(res))
    RESULTS[f"train_{run}"] = res
    torch.cuda.empty_cache()
    return launches, res


def phase_train_profile(torch, run, hp=None):
    """torch.profiler over two steady steps of a main-path run's
    configuration (one unprofiled warm step first); with ``hp``, phase 11's
    strategy plan over that configuration."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    from galvatron_tpu_torch.core.dataloader import build_dataloader
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    phase, model, fused, _ = TRAIN_RUNS[run]
    preset, layers, bsz, seq = TRAIN_PATHS[model]
    cfg = modeling.PRESETS[preset].replace(num_layers=layers, attn_impl="flash",
                                           fused_norm=fused)
    adam = AdamConfig(lr=1e-4, weight_decay=0.01, grad_clip=1.0)
    if hp is None:
        rt = build_runtime(cfg, adam=adam, global_batch_size=bsz, seq_len=seq,
                           mixed_precision="bf16", device="cuda")
    else:
        phase, run = 11, "hybrid"
        rt = build_runtime(cfg, hp, adam, global_batch_size=bsz, seq_len=seq, device="cuda")
    state = rt.init_state(1234)
    loader = build_dataloader(rt.cfg, bsz, seq, seed=1234)
    state, loss = rt.train_step(state, torch.from_numpy(next(loader)))
    float(loss)
    steps, batches = 2, [torch.from_numpy(next(loader)) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        state, loss = rt.train_step(state, batch)
        float(loss)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    batches = [torch.from_numpy(next(loader)) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for batch in batches:
            state, loss = rt.train_step(state, batch)
            float(loss)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3 / steps
    kernels = _kernel_intervals(prof)
    check(kernels, "the profiler recorded no device kernel")
    busy_ms = _union_us(kernels) / 1e3 / steps
    by_name, by_cat = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for name, s, e in kernels:
        by_name[name][0] += (e - s) / 1e3 / steps
        by_name[name][1] += 1
        by_cat[_category(name)] += (e - s) / 1e3 / steps
    check(bool(by_cat.get("norm_fwd")) == fused and bool(by_cat.get("norm_bwd")) == fused,
          f"{run}: the profiler's norm kernel time is {dict(by_cat)}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    res = {"run": run, "model": preset, "layers": layers, "fused_norm": fused, "steps": steps,
           "wall_ms_per_step": wall_ms,
           "wall_ms_per_step_profiled": prof_wall_ms, "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_idle_share_profiled_wall": 1.0 - busy_ms / prof_wall_ms,
           "kernel_launches_per_step": len(kernels) / steps,
           "device_ms_by_category": dict(by_cat),
           "top_kernels_ms_per_step": [
               {"name": n[:90], "ms": v[0], "launches_per_step": v[1] / steps} for n, v in top]}
    log(f"phase {phase} train profile {run}:", json.dumps(res))
    RESULTS[f"train_profile_{run}"] = res
    del state, rt
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 11-12: per-layer hybrid parallelism (cli train with a strategy JSON)
# ---------------------------------------------------------------------------

HYBRID_ITERS = 10  # phase 11
HYBRID_STEPS = 2  # phase 12 (a); two keep the script inside its time limit
# phase 12 (b): its gloo steps are host-staged transport (~14 s each), so it
# runs two, which still compare an updated step with world size 1's
HYBRID_BF16_STEPS = 2
# phase 11's plan at world size 1: a recompute mode per layer
HYBRID_W1_CKPT = ("none", "full", "selective", "none")
# phase 12's plan on two ranks: every boundary changes the DP degree
# (tp, tp_consec, sp, dp_type, ckpt) per layer; vocab_tp 2
HYBRID_W2 = ((2, True, True, "ddp", "none"), (1, True, False, "zero3", "full"),
             (2, True, False, "ddp", "selective"), (1, True, False, "zero2", "none"))
HYBRID_W2_VOCAB_TP = 2
HYBRID_FP32_LAYERS = 2  # phase 12a: the plan's first two layers (SP + ddp, zero3 + full)
HYBRID_FP32_LOSS_TOL = 1e-3  # phase 5's
HYBRID_BF16_LOSS_RTOL = 2e-2
HYBRID_RANK_TIMEOUT_S = 420


def _hybrid_plan(path, layers, precision, world):
    """Write a strategy JSON: phase 11's recompute modes at world size 1, or
    the first ``layers`` layers of phase 12's two-rank plan."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy

    if world == 1:
        strategies = [LayerStrategy(ckpt=c) for c in HYBRID_W1_CKPT[:layers]]
        vocab_tp = 1
    else:
        strategies = [LayerStrategy(tp=t, tp_consec=c, sp=sp, dp_type=d, ckpt=k)
                      for t, c, sp, d, k in HYBRID_W2[:layers]]
        vocab_tp = HYBRID_W2_VOCAB_TP
    hp = HybridParallelConfig(layer_strategies=strategies, vocab_tp=vocab_tp,
                              mixed_precision=precision)
    hp.save(path)
    return hp


def _hybrid_argv(plan, layers, batch, seq, iters):
    return ["--model_size", "llama-7b", "--num_layers", str(layers), "--seq_length", str(seq),
            "--global_train_batch_size", str(batch), "--train_iters", str(iters),
            "--galvatron_config_path", plan]


def _flash_want(hp, steps):
    """flash_fwd / flash_bwd launches of ``steps`` steps of a llama plan: a
    forward per layer, one more for each layer recomputed whole or in its
    attention core; a backward per layer."""
    extra = sum(1 for s in hp.layer_strategies if s.ckpt in ("full", "selective"))
    return {"flash_fwd": (hp.num_layers + extra) * steps, "flash_bwd": hp.num_layers * steps}


def _flash_heads_want(hp, steps, heads=32):
    """Launches by local head count: heads / tp for each layer."""
    fwd, bwd = {}, {}
    for s in hp.layer_strategies:
        h = heads // s.tp
        fwd[h] = fwd.get(h, 0) + (2 if s.ckpt in ("full", "selective") else 1) * steps
        bwd[h] = bwd.get(h, 0) + steps
    return {"flash_fwd": fwd, "flash_bwd": bwd}


def phase_hybrid_world1(torch, smi, tmpdir):
    """Phase 11: ``cli train`` of llama-7b width at 4 layers through the
    strategy path at world size 1, a different recompute mode per layer."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.parallel import comm
    from galvatron_tpu_torch.utils.metrics import read_metrics

    _, layers, bsz, seq = TRAIN_PATHS["llama"]
    plan = os.path.join(tmpdir, "plan_world1.json")
    hp = _hybrid_plan(plan, layers, "bf16", 1)
    path = os.path.join(tmpdir, "train_metrics_hybrid.jsonl")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_counts()
    reset_kernel_counts()  # the main path's counts start here
    routes_before = route_counts()
    t0 = time.perf_counter()
    rc = cli.main(["train", *_hybrid_argv(plan, layers, bsz, seq, HYBRID_ITERS),
                   "--metrics_path", path])
    launches = kernel_counts()  # read right after the main path
    check(rc == 0, f"phase 11: cli train returned {rc}")
    recs = [r for r in read_metrics(path) if r["event"] == "train_iter"]
    check(len(recs) == HYBRID_ITERS, f"phase 11: {len(recs)} train_iter records")
    losses = [r["loss"] for r in recs]
    check(all(isinstance(x, float) and abs(x) != float("inf") and x == x for x in losses),
          f"phase 11: non-finite losses {losses}")
    want = dict(path_counts("llama", layers, HYBRID_ITERS, False), **_flash_want(hp, HYBRID_ITERS))
    check(launches == want, f"phase 11: launches {launches}, expected {want}")
    routes = {k: {r: n - routes_before[k][r] for r, n in v.items()}
              for k, v in route_counts().items()}
    check(all(r["tma"] == launches[k] and r["cuda_core"] == 0 for k, r in routes.items()),
          f"phase 11: routes {routes}")
    check(comm.issued == 0, f"phase 11: world size 1 issued {comm.issued} collectives")
    steady = recs[1:]
    res = {"card": smi, "model": "llama-7b", "layers": layers, "batch": bsz, "seq": seq,
           "dtype": "bfloat16", "ckpt": list(HYBRID_W1_CKPT), "iters": HYBRID_ITERS,
           "losses": losses, "iter_ms_mean_from_2": sum(r["iter_ms"] for r in steady) / len(steady),
           "iter_ms": [r["iter_ms"] for r in recs],
           "tokens_per_s": sum(r["tokens_per_s"] for r in steady) / len(steady),
           "mfu": sum(r["mfu"] for r in steady) / len(steady),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "collectives": comm.issued,
           "seconds": time.perf_counter() - t0}
    log("phase 11 hybrid world 1:", json.dumps(res))
    RESULTS["hybrid_world1"] = res
    phase_train_profile(torch, "llama", hp=hp)
    return res


def _rank_results(outdir, world):
    out = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _launch_ranks(argv, outdir, backend, local_ranks, extra=()):
    from galvatron_tpu_torch.parallel.launch import launch_local

    cmd = [sys.executable, os.path.abspath(__file__), "--rank-worker", outdir, *extra, "--",
           *argv, "--dist_backend", backend]
    ranks = launch_local(cmd, len(local_ranks), timeout_s=HYBRID_RANK_TIMEOUT_S,
                         local_ranks=local_ranks, cwd=os.path.dirname(os.path.abspath(__file__)))
    for r in ranks:
        tail = "\n".join(r.output.splitlines()[-12:])
        log(f"  rank {r.rank}: rc={r.returncode} killed={r.killed}\n{tail}")
    check(all(r.returncode == 0 and not r.killed for r in ranks),
          f"a rank failed or hit its {HYBRID_RANK_TIMEOUT_S} s limit")
    return _rank_results(outdir, len(local_ranks))


def _launch_rank_runs(argvs, outdir, backend, local_ranks, extra=()):
    """Several ``cli train`` runs one after another in ONE set of rank
    processes (each process and its CUDA context start once; the runs share
    the default process group): run j's records land in ``outdir/run<j>``
    (``--ref-params`` in ``extra`` holds the runs to world-size-1
    parameters, in run order). Returns each run's rank records."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    cmd = [sys.executable, os.path.abspath(__file__), "--rank-worker", outdir, *extra, "--"]
    for j, argv in enumerate(argvs):
        cmd += (["--then"] if j else []) + [*argv, "--dist_backend", backend]
        os.makedirs(os.path.join(outdir, f"run{j}"))
    ranks = launch_local(cmd, len(local_ranks), timeout_s=HYBRID_RANK_TIMEOUT_S,
                         local_ranks=local_ranks, cwd=os.path.dirname(os.path.abspath(__file__)))
    for r in ranks:
        tail = "\n".join(r.output.splitlines()[-12:])
        log(f"  rank {r.rank}: rc={r.returncode} killed={r.killed}\n{tail}")
    check(all(r.returncode == 0 and not r.killed for r in ranks),
          f"a rank failed or hit its {HYBRID_RANK_TIMEOUT_S} s limit")
    return [_rank_results(os.path.join(outdir, f"run{j}"), len(local_ranks))
            for j in range(len(argvs))]


def phase_hybrid_ranks(torch, smi, tmpdir, backend, local_ranks, world1):
    """Phase 12 (two ranks sharing card 0 over gloo) or 12b (two cards over
    NCCL): (a) fp32 parity of the plan's first two layers against the same
    layers' world-size-1 plan, (b) the whole bf16 plan at full width against
    phase 11's losses on the same weights and batches. (a) and then (b) run
    in ONE set of rank processes (``--then``)."""
    import numpy as np

    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron

    tag = "12" if backend == "gloo" else "12b"
    world = len(local_ranks)
    _, layers, bsz, seq = TRAIN_PATHS["llama"]
    res = {"card": smi, "backend": backend, "local_ranks": list(local_ranks)}
    t0 = time.perf_counter()
    # (a) fp32: world size 1 in this process, then the two ranks
    fl = HYBRID_FP32_LAYERS
    plan1 = os.path.join(tmpdir, f"plan_fp32_w1_{tag}.json")
    _hybrid_plan(plan1, fl, "fp32", 1)
    plan2 = os.path.join(tmpdir, f"plan_fp32_w2_{tag}.json")
    hp2 = _hybrid_plan(plan2, fl, "fp32", world)
    argv = _hybrid_argv(plan2, fl, 2, 512, HYBRID_STEPS)
    ref = trainer.train(initialize_galvatron("train", _hybrid_argv(plan1, fl, 2, 512,
                                                                   HYBRID_STEPS)))
    ref_path = os.path.join(tmpdir, f"ref_params_{tag}.pt")
    torch.save(_to(ref["state"]["params"], "cpu"), ref_path)
    ref_losses = ref["losses"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    plan = os.path.join(tmpdir, f"plan_bf16_w2_{tag}.json")
    hp = _hybrid_plan(plan, layers, "bf16", world)
    ranks, ranks_b = _launch_rank_runs(
        [argv, _hybrid_argv(plan, layers, bsz, seq, HYBRID_BF16_STEPS)],
        os.path.join(tmpdir, f"ranks_{tag}"), backend, local_ranks, ("--ref-params", ref_path))
    os.remove(ref_path)
    lr = 1e-4  # cli train's default
    band = 2 * HYBRID_STEPS * lr  # AdamW moves an element at most ~lr a step on each side
    diff = max(abs(a - b) for a, b in zip(ranks[0]["losses"], ref_losses))
    pdiff = max(r["param_max_abs_diff"] for r in ranks)
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks), "ranks report other losses")
    check(diff <= HYBRID_FP32_LOSS_TOL, f"phase {tag} (a): losses {ranks[0]['losses']} vs "
          f"world size 1 {ref_losses}")
    check(pdiff <= band, f"phase {tag} (a): parameters {pdiff} from world size 1 (band {band})")
    res["fp32"] = {"layers": fl, "batch": 2, "seq": 512, "steps": HYBRID_STEPS,
                   "plan": [list(x) for x in HYBRID_W2[:fl]], "losses": ranks[0]["losses"],
                   "world1_losses": ref_losses, "max_abs_loss_diff": diff,
                   "tolerance": HYBRID_FP32_LOSS_TOL, "param_max_abs_diff": pdiff,
                   "param_band": band, "host_staged": [r["host_staged"] for r in ranks]}
    log(f"phase {tag} (a) hybrid fp32:", json.dumps(res["fp32"]))
    # (b) bf16 at full width, the whole plan
    ranks = ranks_b
    w1 = world1["losses"][:HYBRID_BF16_STEPS]
    losses = ranks[0]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, w1))
    check(all(np.isfinite(losses)), f"phase {tag} (b): non-finite losses {losses}")
    check(rel <= HYBRID_BF16_LOSS_RTOL, f"phase {tag} (b): losses {losses} vs phase 11 {w1}")
    want = _flash_want(hp, HYBRID_BF16_STEPS)
    heads = _flash_heads_want(hp, HYBRID_BF16_STEPS)
    for r in ranks:
        # gloo stages every collective of a card tensor through the host; NCCL never
        check((r["host_staged"] > 0) == (backend == "gloo"),
              f"phase {tag} (b) rank {r['rank']}: {r['host_staged']} host-staged collectives")
        got = {k: r["launches"][k] for k in want}
        check(got == want, f"phase {tag} (b) rank {r['rank']}: launches {got}, expected {want}")
        check(all(r["routes"][k]["tma"] == want[k] and r["routes"][k]["cuda_core"] == 0
                  for k in want), f"phase {tag} (b) rank {r['rank']}: routes {r['routes']}")
        got_heads = {k: {int(h): n for h, n in v.items()} for k, v in r["heads"].items()}
        check(got_heads == heads,
              f"phase {tag} (b) rank {r['rank']}: launches by heads {got_heads}, expected {heads}")
    steady = lambda r: sum(r["iter_times"][1:]) / (len(r["iter_times"]) - 1)  # noqa: E731
    res["bf16"] = {"layers": layers, "batch": bsz, "seq": seq, "steps": HYBRID_BF16_STEPS,
                   "plan": [list(x) for x in HYBRID_W2], "vocab_tp": HYBRID_W2_VOCAB_TP,
                   "losses": losses, "phase11_losses": w1, "max_rel_loss_diff": rel,
                   "tolerance": HYBRID_BF16_LOSS_RTOL,
                   "launches": [{k: r["launches"][k] for k in want} for r in ranks],
                   "launches_by_heads": [r["heads"] for r in ranks],
                   "host_staged": [r["host_staged"] for r in ranks],
                   "iter_ms_mean_from_2": [steady(r) for r in ranks],
                   "max_memory_allocated_gb": [r["max_memory_allocated_gb"] for r in ranks],
                   "iter_ms_is": ("a gloo-loopback transport figure, not a parallelism result"
                                  if backend == "gloo" else "NCCL on two cards")}
    log(f"phase {tag} (b) hybrid bf16:", json.dumps(res["bf16"]))
    res["seconds"] = time.perf_counter() - t0
    res["seconds_are"] = "(a) and (b) in one set of rank processes, (a)'s world size 1 first"
    RESULTS[f"hybrid_ranks_{backend}"] = res
    return res


# ---------------------------------------------------------------------------
# phase 13: pipelines (cli train --pp_deg through a strategy JSON)
# ---------------------------------------------------------------------------

PIPE_STEPS = 2  # two keep the script inside its time limit
# (a) fp32 parity: pp=2 x tp=2 (SP), 1F1B, llama-7b width at 2 layers
PIPE_FP32 = dict(layers=2, batch=4, seq=512, chunks=2)
# (b) bf16 at phase 7's shape: chunks 8 under each schedule (pipeline_type, vpp)
PIPE_BF16_CHUNKS = 8
PIPE_SCHEDULES = (("gpipe", 1), ("pipedream_flush", 1), ("pipedream_flush", 2))
# (c) GPT-2 XL at all 48 layers, 1F1B, an uneven division
PIPE_GPT_DIVISION = (25, 23)
PIPE_GPT_CHUNKS = 4
# 13 (a)'s four ranks run at the same time as 13 (b) and (c)'s two: what
# each phase's times were read beside
PIPE_BESIDE = {"13 (a)": "read beside 13 (b) and (c)'s two-rank world on the same card",
               "13 (b)": "read beside 13 (a)'s four-rank world on the same card",
               "13 (c)": "read beside 13 (a)'s four-rank world on the same card"}


def _pipe_plan(path, layers, precision, pp=2, tp=1, chunks=1, ptype="pipedream_flush", vpp=1,
               division=None):
    """Write a uniform strategy JSON (SP whenever tp > 1)."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    hp = HybridParallelConfig.uniform(layers, pp=pp, vpp=vpp, tp=tp, sp=tp > 1, chunks=chunks,
                                      pipeline_type=ptype, mixed_precision=precision)
    if division:
        hp.pp_division = list(division)
    hp.save(path)
    return hp


def _schedule_name(ptype, vpp):
    return ("interleaved " if vpp > 1 else "") + ("1F1B" if ptype == "pipedream_flush" else "GPipe")


def _steady(r):
    return sum(r["iter_times"][1:]) / (len(r["iter_times"]) - 1)


def _check_stage_launches(tag, ranks, model, chunks, steps):
    """Each rank launched its family's flash kernels (stage layers x chunks)
    x steps times, every call on the TMA route, and nothing else."""
    for r in ranks:
        want = path_counts(model, len(r["stage_layers"]) * chunks, steps, False)
        check(r["launches"] == want,
              f"phase {tag} rank {r['rank']}: launches {r['launches']}, expected {want}")
        check(all(v["tma"] == r["launches"][k] and v["cuda_core"] == 0
                  for k, v in r["routes"].items()),
              f"phase {tag} rank {r['rank']}: routes {r['routes']}")


def _pipe_fp32_reference(torch, tmpdir):
    """Phase 13 (a)'s world-size-1 run in this process: its losses, and its
    parameters saved for the ranks to compare (the file's path)."""
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron

    c = PIPE_FP32
    plan1 = os.path.join(tmpdir, "pipe_fp32_w1.json")
    _pipe_plan(plan1, c["layers"], "fp32", pp=1, chunks=c["chunks"])
    ref = trainer.train(initialize_galvatron("train", _hybrid_argv(
        plan1, c["layers"], c["batch"], c["seq"], PIPE_STEPS)))
    ref_path = os.path.join(tmpdir, "pipe_ref_params.pt")
    torch.save(_to(ref["state"]["params"], "cpu"), ref_path)
    ref_losses = ref["losses"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return ref_losses, ref_path


def phase_pipeline_fp32(smi, tmpdir, ref_losses, ref_path):
    """Phase 13 (a): four ranks share card 0 over gloo, pp=2 x tp=2 (SP),
    1F1B, in fp32, against the same layers at world size 1
    (:func:`_pipe_fp32_reference`). ``main`` runs it in a thread beside 13
    (b) and (c): two worlds on the card at once."""
    c = PIPE_FP32
    plan4 = os.path.join(tmpdir, "pipe_fp32_w4.json")
    _pipe_plan(plan4, c["layers"], "fp32", pp=2, tp=2, chunks=c["chunks"])
    t0 = time.perf_counter()
    outdir = os.path.join(tmpdir, "pipe_fp32")
    os.makedirs(outdir)
    ranks = _launch_ranks(_hybrid_argv(plan4, c["layers"], c["batch"], c["seq"], PIPE_STEPS),
                          outdir, "gloo", (0, 0, 0, 0), ("--ref-params", ref_path))
    os.remove(ref_path)
    band = 2 * PIPE_STEPS * 1e-4  # AdamW's band at cli train's lr, as phase 12 (a)
    diff = max(abs(a - b) for a, b in zip(ranks[0]["losses"], ref_losses))
    pdiff = max(r["param_max_abs_diff"] for r in ranks)
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks), "13 (a): ranks report other losses")
    check(diff <= HYBRID_FP32_LOSS_TOL, f"phase 13 (a): losses {ranks[0]['losses']} vs world "
          f"size 1 {ref_losses}")
    check(pdiff <= band, f"phase 13 (a): parameters {pdiff} from world size 1 (band {band})")
    check(sorted(r["stage"] for r in ranks) == [0, 0, 1, 1], "phase 13 (a): stages")
    res = {"card": smi, "layers": c["layers"], "batch": c["batch"], "seq": c["seq"],
           "chunks": c["chunks"], "steps": PIPE_STEPS, "plan": "pp=2 x tp=2 (SP), 1F1B, fp32",
           "losses": ranks[0]["losses"], "world1_losses": ref_losses, "max_abs_loss_diff": diff,
           "tolerance": HYBRID_FP32_LOSS_TOL, "param_max_abs_diff": pdiff, "param_band": band,
           "p2p": [r["p2p"] for r in ranks],
           "seconds": time.perf_counter() - t0, "seconds_are": PIPE_BESIDE["13 (a)"]}
    log("phase 13 (a) pipeline fp32:", json.dumps(res))
    RESULTS["pipeline_fp32"] = res
    return res


def phase_pipeline_bf16(torch, smi, tmpdir, backend, local_ranks, world1, gpt_losses=None):
    """Phase 13 (b) (two ranks sharing card 0 over gloo) or 13b (two cards
    over NCCL): llama-7b width at phase 7's 4 layers and shape, pp=2, chunks
    8, under GPipe, 1F1B and interleaved 1F1B (vpp=2), against phase 11's
    losses; 1F1B's stage 0 must peak below GPipe's. With ``gpt_losses``
    (phase 8's), 13 (c) runs in the same rank processes after them. Over
    gloo it runs beside 13 (a) (``main``); its times say so."""
    import numpy as np

    tag = "13 (b)" if backend == "gloo" else "13b"
    _, layers, bsz, seq = TRAIN_PATHS["llama"]
    w1 = world1["losses"][:PIPE_STEPS]
    out = {"card": smi, "backend": backend, "local_ranks": list(local_ranks), "layers": layers,
           "batch": bsz, "seq": seq, "chunks": PIPE_BF16_CHUNKS, "steps": PIPE_STEPS,
           "phase11_losses": w1, "tolerance": HYBRID_BF16_LOSS_RTOL, "runs": {}}
    t0 = time.perf_counter()
    argvs = []
    for ptype, vpp in PIPE_SCHEDULES:
        plan = os.path.join(tmpdir, f"pipe_bf16_{ptype}_vpp{vpp}_{backend}.json")
        _pipe_plan(plan, layers, "bf16", chunks=PIPE_BF16_CHUNKS, ptype=ptype, vpp=vpp)
        argvs.append(_hybrid_argv(plan, layers, bsz, seq, PIPE_STEPS))
    if gpt_losses is not None:
        argvs.append(_pipe_gpt_argv(tmpdir))
    runs = _launch_rank_runs(argvs, os.path.join(tmpdir, f"pipe_bf16_{backend}"), backend,
                             local_ranks)
    if gpt_losses is not None:
        _check_pipeline_gpt(smi, runs.pop(), gpt_losses)
    for (ptype, vpp), ranks in zip(PIPE_SCHEDULES, runs):
        name = _schedule_name(ptype, vpp)
        losses = ranks[0]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, w1))
        check(all(np.isfinite(losses)), f"phase {tag} {name}: non-finite losses {losses}")
        check(rel <= HYBRID_BF16_LOSS_RTOL, f"phase {tag} {name}: losses {losses} vs phase 11 {w1}")
        _check_stage_launches(f"{tag} {name}", ranks, "llama", PIPE_BF16_CHUNKS, PIPE_STEPS)
        for r in ranks:
            check((r["host_staged"] > 0) == (backend == "gloo"),
                  f"phase {tag} {name} rank {r['rank']}: {r['host_staged']} host-staged messages")
        by_stage = sorted(ranks, key=lambda r: r["stage"])
        out["runs"][name] = {
            "losses": losses, "max_rel_loss_diff": rel,
            "stage_layers": [r["stage_layers"] for r in by_stage],
            "launches": [{k: v for k, v in r["launches"].items() if v} for r in by_stage],
            "p2p": [r["p2p"] for r in by_stage],
            "host_staged": [r["host_staged"] for r in by_stage],
            "iter_ms_mean_from_2": [_steady(r) for r in by_stage],
            "max_memory_allocated_gb": [r["max_memory_allocated_gb"] for r in by_stage]}
        log(f"phase {tag} pipeline bf16 {name}:", json.dumps(out["runs"][name]))
    mem = {n: out["runs"][n]["max_memory_allocated_gb"][0] for n in ("GPipe", "1F1B")}
    check(mem["1F1B"] < mem["GPipe"], f"phase {tag}: 1F1B's stage-0 peak {mem['1F1B']} GB is "
          f"not below GPipe's {mem['GPipe']} GB")
    out["stage0_peak_gb"] = mem
    out["iter_ms_is"] = ("a gloo-loopback transport figure, not a parallelism result, "
                         + PIPE_BESIDE["13 (b)"] if backend == "gloo" else "NCCL on two cards")
    out["seconds"] = time.perf_counter() - t0
    if backend == "gloo":
        out["seconds_are"] = (("with 13 (c) in the same rank processes, " if gpt_losses
                               is not None else "") + PIPE_BESIDE["13 (b)"])
    RESULTS[f"pipeline_bf16_{backend}"] = out
    return out


def _pipe_gpt_argv(tmpdir):
    """Phase 13 (c)'s flags: gpt-1.5b at all 48 layers, 1F1B over the
    division 25 / 23."""
    preset, layers, bsz, _ = TRAIN_PATHS["gpt"]
    plan = os.path.join(tmpdir, "pipe_gpt.json")
    _pipe_plan(plan, layers, "bf16", chunks=PIPE_GPT_CHUNKS, division=PIPE_GPT_DIVISION)
    return ["--model_size", preset, "--global_train_batch_size", str(bsz),
            "--train_iters", str(PIPE_STEPS), "--galvatron_config_path", plan]


def _check_pipeline_gpt(smi, ranks, gpt_losses):
    """Phase 13 (c): gpt-1.5b at all 48 layers, 1F1B over the division
    25 / 23, two ranks sharing card 0 over gloo: the grid kernels and the
    tied table across stages, against phase 8's losses."""
    import numpy as np

    preset, layers, bsz, seq = TRAIN_PATHS["gpt"]
    ref = gpt_losses[:PIPE_STEPS]
    losses = ranks[0]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    check(all(np.isfinite(losses)), f"phase 13 (c): non-finite losses {losses}")
    check(rel <= HYBRID_BF16_LOSS_RTOL, f"phase 13 (c): losses {losses} vs phase 8 {ref}")
    by_stage = sorted(ranks, key=lambda r: r["stage"])
    check([len(r["stage_layers"]) for r in by_stage] == list(PIPE_GPT_DIVISION),
          f"phase 13 (c): stage layers {[r['stage_layers'] for r in by_stage]}")
    _check_stage_launches("13 (c)", ranks, "gpt", PIPE_GPT_CHUNKS, PIPE_STEPS)
    res = {"card": smi, "model": preset, "layers": layers, "batch": bsz, "seq": seq,
           "division": list(PIPE_GPT_DIVISION), "chunks": PIPE_GPT_CHUNKS, "steps": PIPE_STEPS,
           "schedule": "1F1B", "losses": losses, "phase8_losses": ref, "max_rel_loss_diff": rel,
           "tolerance": HYBRID_BF16_LOSS_RTOL,
           "launches": [{k: v for k, v in r["launches"].items() if v} for r in by_stage],
           "p2p": [r["p2p"] for r in by_stage],
           "iter_ms_mean_from_2": [_steady(r) for r in by_stage],
           "max_memory_allocated_gb": [r["max_memory_allocated_gb"] for r in by_stage],
           "iter_ms_is": "a gloo-loopback transport figure, not a parallelism result, "
           + PIPE_BESIDE["13 (c)"]}
    log("phase 13 (c) pipeline gpt-1.5b:", json.dumps(res))
    RESULTS["pipeline_gpt"] = res
    return res


def _gpt_reference_losses(torch, tmpdir, train_res):
    """Phase 8's losses, or (when phase 8 did not run) the same ``cli
    train`` for the steps phase 13 (c) compares."""
    if "gpt" in train_res:
        return train_res["gpt"]["losses"]
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron

    preset, _, bsz, _ = TRAIN_PATHS["gpt"]
    out = trainer.train(initialize_galvatron("train", [
        "--model_size", preset, "--global_train_batch_size", str(bsz),
        "--train_iters", str(PIPE_STEPS)]))
    losses = out["losses"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return losses


# ---------------------------------------------------------------------------
# phase 14: profiling and search (cli profile → profile-hardware → search →
# check-plan → train)
# ---------------------------------------------------------------------------

SEARCH_PROFILE_BSZ = 8
SEARCH_TRAIN_LAYERS = 4  # phase 7's depth
# roomy; below phase 7's measured unrecomputed peak (~33 GB); below the cost
# model's own unrecomputed prediction (~26 GB), so the plan recomputes or
# splits the batch
SEARCH_BUDGETS_GB = (40.0, 28.0, 22.0)
SEARCH_FIDELITY_BAND = (0.67, 1.5)  # predicted / measured step, phase 7 beside it
SEARCH_ITERS = 10
SEARCH_FULL_DEPTH = ["--num_devices", "8", "--memory_constraint_gb", "32", "--settle_bsz", "16"]
REFERENCE_HW = "configs/hardware/reference_2x8_ib.json"


class _Tee:
    """Writes to stdout and keeps a copy (the cli modes report by printing)."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()

    def text(self):
        return "".join(self.parts)


def _cli(argv):
    """``cli.main(argv)`` in this process; returns (rc, what it printed)."""
    from galvatron_tpu_torch import cli

    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(list(argv))
    return rc, tee.text()


def _routes_since(before):
    return {k: {r: n - before[k][r] for r, n in v.items()} for k, v in route_counts().items()}


def _all_tma(launches, routes):
    return all(r["tma"] == launches[k] and r["cuda_core"] == 0 for k, r in routes.items())


def phase_search_profile(torch, smi, tmpdir, phase7_iter_ms):
    """14 (a): ``cli profile`` of llama-7b at full width with the adaptive
    layer counts, then the cost model's world-1 step at 4 layers from it
    against phase 7's measured iter_ms."""
    from galvatron_tpu_torch.core.strategy import LayerStrategy
    from galvatron_tpu_torch.search.cost_model import ProfiledHardware
    from galvatron_tpu_torch.search.search_engine import SearchEngine, SearchSpace
    from galvatron_tpu_torch.utils.config_utils import load_profiled_model

    prefix = os.path.join(tmpdir, "profile_llama-7b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()  # the main path's counts start here
    before = route_counts()
    t0 = time.perf_counter()
    rc, out = _cli(["profile", "--model_size", "llama-7b", "--profile_batch_size",
                    str(SEARCH_PROFILE_BSZ), "--output_prefix", prefix])
    launches = kernel_counts()  # read right after the main path
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(rc == 0, f"phase 14 (a): cli profile returned {rc}")
    counts = [tuple(map(int, m)) for m in re.findall(r"layer counts \((\d+), (\d+)\) on", out)]
    check(counts, "phase 14 (a): the profile printed no layer counts")
    l1, l2 = counts[-1]
    dropped = re.findall(r"out of memory at layer counts \((\d+), (\d+)\)", out)
    routes = _routes_since(before)
    # every completed layer count ran 2 warm-up + 4 timed steps and one
    # forward for the activation bytes; an attempt that ran out of memory
    # adds the launches it made before it failed
    done = l1 + l2
    check(launches["flash_fwd"] >= 7 * done and launches["flash_bwd"] >= 6 * done,
          f"phase 14 (a): launches {launches} below the completed runs' {7 * done} / {6 * done}")
    check(all(launches[k] == 0 for k in launches if k not in ("flash_fwd", "flash_bwd")),
          f"phase 14 (a): kernels of another path launched: {launches}")
    check(_all_tma(launches, routes), f"phase 14 (a): routes {routes}")
    costs = load_profiled_model(prefix + "_computation.json", prefix + "_memory.json")
    lt = costs.layer_types[0]
    check(lt.fwd_ms_per_sample > 0 and lt.activation_mb_per_sample[1] > 0,
          f"phase 14 (a): profile {lt}")
    # the cost model's world-1 step at phase 7's depth: the DP over the one
    # strategy phase 7 runs (tp 1, dp 1, pp 1, no recompute, chunks 1)
    hw = ProfiledHardware(allreduce_bw={}, p2p_bw={}, overlap_coe=1.1)
    space = SearchSpace(world_size=1, pp_choices=[1], allow_sp=False, allow_ckpt=False,
                        allow_zero2=False, allow_zero3=False, allow_strided=False)
    eng = SearchEngine(costs, hw, num_layers=SEARCH_TRAIN_LAYERS, space=space,
                       memory_budget_mb=80 * 1024.0, mixed_precision="bf16")
    table = eng.check_cost_model(SEARCH_PROFILE_BSZ, strategies=[LayerStrategy()])
    log(table)
    r = eng.evaluate(1, SEARCH_PROFILE_BSZ, 1, "gpipe")
    check(r is not None, "phase 14 (a): the cost model found no world-1 step")
    ratio = r.cost_ms / phase7_iter_ms
    lo, hi = SEARCH_FIDELITY_BAND
    res = {"card": smi, "layer_counts": [l1, l2], "dropped": [list(map(int, d)) for d in dropped],
           "fwd_ms_per_sample": lt.fwd_ms_per_sample,
           "activation_mb_per_sample_1": lt.activation_mb_per_sample[1],
           "other_fwd_ms_per_sample": costs.other_fwd_ms_per_sample,
           "vocab_slope_ms": costs.measured_vocab_slope_ms,
           "vocab_const_ms": costs.measured_vocab_const_ms, "launches": launches,
           "tma_routes": {k: v["tma"] for k, v in routes.items()},
           "predicted_step_ms_4_layers": r.cost_ms, "predicted_memory_mb_4_layers": r.memory_mb,
           "phase7_iter_ms": phase7_iter_ms, "predicted_over_measured": ratio,
           "band": list(SEARCH_FIDELITY_BAND), "max_memory_allocated_gb": peak_gb,
           "seconds": seconds}
    log("phase 14 (a) profile:", json.dumps(res))
    RESULTS["search_profile"] = res
    check(lo <= ratio <= hi, f"phase 14 (a): predicted {r.cost_ms:.1f} ms over phase 7's "
          f"{phase7_iter_ms:.1f} ms = {ratio:.3f}, outside {SEARCH_FIDELITY_BAND}")
    return prefix


def phase_search_hardware(tmpdir):
    """14 (b): ``cli profile-hardware`` on the one card: world 1 measures
    nothing and writes the reference's degenerate values."""
    path = os.path.join(tmpdir, "hardware_world1.json")
    rc, _ = _cli(["profile-hardware", "--hardware_output_path", path])
    check(rc == 0, f"phase 14 (b): cli profile-hardware returned {rc}")
    with open(path) as f:
        hw = json.load(f)
    want = {"allreduce": {}, "p2p": {}, "overlap_coe": 1.1, "dcn_keys": []}
    check(hw == want, f"phase 14 (b): world-1 hardware {hw}, expected {want}")
    log("phase 14 (b) profile-hardware, world 1:", json.dumps(hw))
    RESULTS["search_hardware_world1"] = hw
    return path


def phase_search_plans(torch, smi, tmpdir, prefix, hw_path):
    """14 (c): ``cli search`` at 4 layers on one device under each budget
    with ``--validate_top_k 2``, then ``cli check-plan --strict 1`` and
    ``cli train`` of the emitted plan."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.utils.metrics import read_metrics

    _, layers, bsz, seq = TRAIN_PATHS["llama"]
    out = []
    for budget in SEARCH_BUDGETS_GB:
        tag = f"{budget:g}gb"
        plan = os.path.join(tmpdir, f"plan_llama-7b_1dev_{tag}.json")
        gc.collect()
        torch.cuda.empty_cache()
        rc, text = _cli(["search", "--model_size", "llama-7b", "--num_layers", str(layers),
                         "--num_devices", "1", "--settle_bsz", str(bsz),
                         "--memory_constraint_gb", str(budget),
                         "--time_profile_path", prefix + "_computation.json",
                         "--memory_profile_path", prefix + "_memory.json",
                         "--hardware_profile_path", hw_path, "--validate_top_k", "2",
                         "--output_config_path", plan])
        check(rc == 0, f"phase 14 (c) {tag}: cli search returned {rc}")
        validated = [{"predicted_ms": float(a), "measured_ms": float(b)} for a, b in
                     re.findall(r"predicted ([\d.]+) ms, measured ([\d.]+) ms", text)]
        agree = re.findall(r"rank agreement: (\d+)/(\d+) positions \(best candidate ([^)]*)\)",
                           text)
        rc, text = _cli(["check-plan", plan, "--strict", "1"])
        check(rc == 0, f"phase 14 (c) {tag}: check-plan --strict 1 returned {rc}")
        with open(plan) as f:
            d = json.load(f)
        hp = HybridParallelConfig.load(plan)
        path = os.path.join(tmpdir, f"train_metrics_search_{tag}.jsonl")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()  # the main path's counts start here
        before = route_counts()
        rc, _ = _cli(["train", "--model_size", "llama-7b", "--num_layers", str(layers),
                      "--global_train_batch_size", str(bsz), "--train_iters", str(SEARCH_ITERS),
                      "--galvatron_config_path", plan, "--metrics_path", path])
        launches = kernel_counts()  # read right after the main path
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        check(rc == 0, f"phase 14 (c) {tag}: cli train returned {rc}")
        recs = [x for x in read_metrics(path) if x["event"] == "train_iter"]
        losses = [x["loss"] for x in recs]
        check(len(recs) == SEARCH_ITERS and all(
            isinstance(x, float) and x == x and abs(x) != float("inf") for x in losses),
            f"phase 14 (c) {tag}: losses {losses}")
        # each micro-batch runs every layer's kernels: a forward per layer
        # and one more per recomputed layer, a backward per layer
        want = dict(path_counts("llama", layers, SEARCH_ITERS, False),
                    **_flash_want(hp, SEARCH_ITERS * hp.chunks))
        check(launches == want, f"phase 14 (c) {tag}: launches {launches}, expected {want}")
        routes = _routes_since(before)
        check(_all_tma(launches, routes), f"phase 14 (c) {tag}: routes {routes}")
        steady = [x["iter_ms"] for x in recs[1:]]
        iter_ms = sum(steady) / len(steady)
        res = {"card": smi, "budget_gb": budget, "plan": {
                   k: d[k] for k in ("pp_deg", "tp_sizes_enc", "dp_types_enc", "checkpoint",
                                     "chunks", "vocab_tp", "embed_sdp") if k in d},
               "recomputed_layers": [i for i, s in enumerate(hp.layer_strategies) if s.ckpt],
               "search_cost_ms": d["search_cost_ms"], "iter_ms_mean_from_2": iter_ms,
               "predicted_over_measured_ms": d["search_cost_ms"] / iter_ms,
               "memory_mb_plan": d["memory_mb"], "max_memory_allocated_mb": peak_mb,
               "budget_mb": budget * 1024.0, "peak_within_budget": peak_mb <= budget * 1024.0,
               "validate_top_k": validated,
               "rank_agreement": [list(a) for a in agree], "losses": losses,
               "launches": {k: launches[k] for k in ("flash_fwd", "flash_bwd")}}
        log(f"phase 14 (c) search + train, {tag}:", json.dumps(res))
        out.append(res)
    RESULTS["search_plans"] = out
    return out


def phase_search_two_ranks(torch, smi, tmpdir):
    """14 (d): ``cli search`` for two devices at phase 12 (a)'s shape on
    the reference hardware file, the plan trained by two ranks sharing card
    0 over gloo against world size 1 in fp32."""
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy

    layers, bsz, seq = HYBRID_FP32_LAYERS, 2, 512
    plan2 = os.path.join(tmpdir, "plan_search_w2_fp32.json")
    rc, _ = _cli(["search", "--model_size", "llama-7b", "--num_layers", str(layers),
                  "--seq_length", str(seq), "--num_devices", "2", "--settle_bsz", str(bsz),
                  "--memory_constraint_gb", "40", "--mixed_precision", "fp32",
                  "--analytic_costs", "1", "--hardware_profile_path", REFERENCE_HW,
                  "--output_config_path", plan2])
    check(rc == 0, f"phase 14 (d): cli search returned {rc}")
    rc, _ = _cli(["check-plan", plan2, "--strict", "1"])
    check(rc == 0, f"phase 14 (d): check-plan --strict 1 returned {rc}")
    hp2 = HybridParallelConfig.load(plan2)
    check(hp2.mixed_precision == "fp32", f"phase 14 (d): plan precision {hp2.mixed_precision}")
    plan1 = os.path.join(tmpdir, "plan_search_w1_fp32.json")
    HybridParallelConfig(layer_strategies=[LayerStrategy()] * layers,
                         mixed_precision="fp32").save(plan1)
    gc.collect()
    torch.cuda.empty_cache()
    ref = trainer.train(initialize_galvatron("train", _hybrid_argv(plan1, layers, bsz, seq,
                                                                   HYBRID_STEPS)))
    ref_losses = ref["losses"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    outdir = os.path.join(tmpdir, "ranks_search_w2")
    os.makedirs(outdir)
    ranks = _launch_ranks(_hybrid_argv(plan2, layers, bsz, seq, HYBRID_STEPS), outdir, "gloo",
                          (0, 0))
    diff = max(abs(a - b) for a, b in zip(ranks[0]["losses"], ref_losses))
    res = {"card": smi, "plan": hp2.to_json_dict(), "losses": [r["losses"] for r in ranks],
           "world1_losses": ref_losses, "max_abs_loss_diff": diff,
           "tolerance": HYBRID_FP32_LOSS_TOL}
    log("phase 14 (d) searched plan on two ranks:", json.dumps(res))
    RESULTS["search_two_ranks"] = res
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks), "phase 14 (d): ranks differ")
    check(diff <= HYBRID_FP32_LOSS_TOL, f"phase 14 (d): losses {ranks[0]['losses']} vs "
          f"world size 1 {ref_losses}")


def phase_search_full_depth(smi, tmpdir, prefix):
    """14 (e): the full-depth llama-7b search for 8 devices on the 14 (a)
    profile and the reference hardware file, beside the analytic plan in
    configs/strategies; no device."""
    from galvatron_tpu_torch.search import native

    plan = os.path.join(tmpdir, "plan_llama-7b_8dev_32gb_profiled.json")
    rc, text = _cli(["search", "--model_size", "llama-7b", *SEARCH_FULL_DEPTH,
                     "--time_profile_path", prefix + "_computation.json",
                     "--memory_profile_path", prefix + "_memory.json",
                     "--hardware_profile_path", REFERENCE_HW, "--output_config_path", plan])
    check(rc == 0, f"phase 14 (e): cli search returned {rc}")
    rc, _ = _cli(["check-plan", plan, "--strict", "1"])
    check(rc == 0, f"phase 14 (e): check-plan --strict 1 returned {rc}")
    check(native.ROUTE == "native" and "dp route: native" in text,
          f"phase 14 (e): the DP ran on the {native.ROUTE} route ({native.BUILD_ERROR})")
    keys = ("pp_deg", "tp_sizes_enc", "tp_consecutive_flags", "dp_types_enc", "checkpoint",
            "sp_flags", "chunks", "pipeline_type", "vocab_tp", "embed_sdp", "global_bsz",
            "search_cost_ms", "memory_mb")
    with open(plan) as f:
        d = json.load(f)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "strategies",
                           "llama-7b_8dev_32gb.json")) as f:
        analytic = json.load(f)
    res = {"card": smi, "dp_route": native.ROUTE,
           "profiled": {k: d.get(k) for k in keys},
           "analytic_checked_in": {k: analytic.get(k) for k in keys}}
    log("phase 14 (e) full-depth search beside the analytic plan:", json.dumps(res))
    RESULTS["search_full_depth"] = res


def phase_search_nccl(smi, tmpdir):
    """14b: ``cli profile-hardware`` over NCCL on cards 0 and 1."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    path = os.path.join(tmpdir, "hardware_nccl_2.json")
    ranks = launch_local([sys.executable, "-m", "galvatron_tpu_torch.cli", "profile-hardware",
                          "--hardware_output_path", path, "--dist_backend", "nccl"], 2,
                         timeout_s=HYBRID_RANK_TIMEOUT_S, local_ranks=(0, 1),
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    for r in ranks:
        log(f"  rank {r.rank}: rc={r.returncode}\n" + "\n".join(r.output.splitlines()[-6:]))
    check(all(r.returncode == 0 and not r.killed for r in ranks),
          "phase 14b: a profile-hardware rank failed")
    with open(path) as f:
        hw = json.load(f)
    res = {"card": smi, "allreduce_2_1_GBps": hw["allreduce"].get("2_1"),
           "p2p_pp2_GBps": hw["p2p"].get("2"), "overlap_coe": hw["overlap_coe"], "json": hw}
    log("phase 14b profile-hardware, NCCL on two cards:", json.dumps(res))
    check(res["allreduce_2_1_GBps"] and res["p2p_pp2_GBps"] and hw["overlap_coe"] >= 1.0,
          f"phase 14b: {hw}")
    RESULTS["search_hardware_nccl"] = res


def phase_search(torch, smi, train_res):
    """Phase 14 (a)-(e); phase 7's iter_ms from this run, or from a run of
    phase 7 here when ``train`` is not among the phases."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_search_") as tmpdir:
        if "llama" not in train_res:
            _, train_res["llama"] = phase_train(torch, smi, tmpdir, "llama")
        prefix = phase_search_profile(torch, smi, tmpdir,
                                      train_res["llama"]["iter_ms_mean_from_2"])
        hw_path = phase_search_hardware(tmpdir)
        phase_search_plans(torch, smi, tmpdir, prefix, hw_path)
        phase_search_two_ranks(torch, smi, tmpdir)
        phase_search_full_depth(smi, tmpdir, prefix)
    log(f"phase 14 search: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: the training services (corpus, checkpoints, resume, serve --load,
# fp16, ramp-up)
# ---------------------------------------------------------------------------

SERVICES_LAYERS = 2
SERVICES_STEPS = 6
SERVICES_PROCESS_TIMEOUT_S = 420
# (b): the pp = 2 restore's first loss against the uninterrupted run's; (d):
# fp16 step 0 against bf16 step 0 (same weights and batch)
SERVICES_LAYOUT_RTOL = 1e-4
SERVICES_FP16_RTOL = 1e-2
# (a): a resumed loss against the uninterrupted run's (the TMA backward
# repeats bitwise, so equality is expected)
SERVICES_RESUME_RTOL = 1e-6


def _services_corpora(tmpdir, vocab):
    """Two corpora written with the port's ``write_indexed_dataset`` from
    seeded random documents of 500-4000 tokens, each with enough windows for
    6 batches of 8 x 2048 from that source alone, and the 0.7 / 0.3 mixture
    JSON over them."""
    import numpy as np

    from galvatron_tpu_torch.core.data import write_indexed_dataset

    need = SERVICES_STEPS * 8 * 2048 + 1
    sources = []
    for i, (name, weight) in enumerate((("web", 0.7), ("books", 0.3))):
        rng = np.random.RandomState(100 + i)
        docs, total = [], 0
        while total < need:
            docs.append(rng.randint(0, vocab, rng.randint(500, 4001)))
            total += len(docs[-1])
        prefix = os.path.join(tmpdir, name)
        write_indexed_dataset(prefix, docs, vocab)
        sources.append({"name": name, "prefix": prefix, "weight": weight, "tokens": total,
                        "docs": len(docs)})
    mix = os.path.join(tmpdir, "mixture.json")
    with open(mix, "w") as f:
        json.dump({"sources": [{k: s_[k] for k in ("name", "prefix", "weight")}
                               for s_ in sources]}, f)
    return mix, sources


def _services_argv(mix, iters, *extra):
    return ["--model_size", "llama-7b", "--num_layers", str(SERVICES_LAYERS),
            "--train_iters", str(iters), "--data_mixture", mix, "--prefetch_depth", "2",
            *extra]


def _train_process(argv, what):
    """``cli train`` in a process of its own (the card is shared with this
    one); its stdout, or a failed check with its tail."""
    cmd = [sys.executable, "-m", "galvatron_tpu_torch.cli", "train", *argv]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=SERVICES_PROCESS_TIMEOUT_S)
    tail = "\n".join((r.stdout + r.stderr).splitlines()[-15:])
    log(f"  {what}: rc={r.returncode} in {time.perf_counter() - t0:.1f} s\n{tail}")
    check(r.returncode == 0, f"{what}: cli train returned {r.returncode}")
    return r.stdout


def _train_losses(path, first_step=0):
    from galvatron_tpu_torch.utils.metrics import read_metrics

    recs = [r for r in read_metrics(path) if r["event"] == "train_iter"]
    check([r["step"] for r in recs] == list(range(first_step, first_step + len(recs))),
          f"{path}: train_iter steps {[r['step'] for r in recs]}")
    return [r["loss"] for r in recs], recs


def _step_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def phase_services_resume(torch, smi, tmpdir, mix):
    """15 (a): run A (6 steps, no save) in this process; run B: 3 steps
    with ``--save`` here, then a second process ``--load``s and trains to
    step 6; then one byte of the newest step is flipped and the next
    ``--load`` (a third run, in this process) must fall back to the older
    step."""
    from galvatron_tpu_torch.core import checkpoint as ckpt
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron
    from galvatron_tpu_torch.utils.metrics import read_metrics

    d = os.path.join(tmpdir, "ckpt")
    path_a = os.path.join(tmpdir, "a.jsonl")
    reset_kernel_counts()  # the main path's counts start here
    routes_before = route_counts()
    out_a = trainer.train(initialize_galvatron("train", _services_argv(
        mix, SERVICES_STEPS, "--metrics_path", path_a)))
    launches = kernel_counts()  # read right after the main path
    routes = {k: {r: n - routes_before[k][r] for r, n in v.items()}
              for k, v in route_counts().items()}
    want = path_counts("llama", SERVICES_LAYERS, SERVICES_STEPS, False)
    check(launches == want, f"15 (a): launches {launches}, expected {want}")
    check(all(r["tma"] == launches[k] for k, r in routes.items()), f"15 (a): routes {routes}")
    losses_a, _ = _train_losses(path_a)
    check(all(x == x and abs(x) != float("inf") for x in losses_a), f"15 (a): losses {losses_a}")
    pipe = [r for r in read_metrics(path_a) if r["event"] == "data_pipeline"]
    check(pipe and pipe[0]["samples_consumed"] == SERVICES_STEPS * 8, f"15 (a): {pipe}")
    del out_a
    gc.collect()
    torch.cuda.empty_cache()
    # B, first half: 3 steps and the interval save, in this process
    out_b1 = trainer.train(initialize_galvatron("train", _services_argv(
        mix, 3, "--save", d, "--save_interval", "3", "--keep_last_n", "1")))
    check(ckpt.committed_steps(d) == [3], f"15 (a): committed {ckpt.committed_steps(d)}")
    step_gb = _step_bytes(ckpt.step_path(d, 3)) / 1e9
    save_s = out_b1["save_s"][0]
    del out_b1
    gc.collect()
    torch.cuda.empty_cache()
    # B, second half: another process resumes, verifies the data cursor and
    # trains to step 6, saving it (two steps kept for the corruption case)
    path_b = os.path.join(tmpdir, "b.jsonl")
    out = _train_process(_services_argv(mix, SERVICES_STEPS, "--load", d, "--save", d,
                                        "--save_interval", "3", "--keep_last_n", "2",
                                        "--metrics_path", path_b), "15 (a) resume")
    restore_s = float(re.search(r"resumed from .* at step 3 \(([\d.]+) s\)", out).group(1))
    losses_b, _ = _train_losses(path_b, first_step=3)
    check(ckpt.committed_steps(d) == [3, 6], f"15 (a): committed {ckpt.committed_steps(d)}")
    meta = ckpt.read_manifest(ckpt.step_path(d, 6))["meta"]
    check(meta["data_state"]["position"] == SERVICES_STEPS * 8, f"15 (a): {meta['data_state']}")
    resume_abs = max(abs(a - b) for a, b in zip(losses_b, losses_a[3:]))
    resume_rel = max(_rel(a, b) for a, b in zip(losses_b, losses_a[3:]))
    # a flipped byte in one leaf of the newest step: the next --load falls back
    leaf = os.path.join(ckpt.step_path(d, 6), "params.layers.0.attn.wqkv.npy")
    with open(leaf, "r+b") as f:
        f.seek(os.path.getsize(leaf) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0x10]))
    path_c = os.path.join(tmpdir, "c.jsonl")
    out_c = trainer.train(initialize_galvatron("train", _services_argv(
        mix, 4, "--load", d, "--metrics_path", path_c)))
    del out_c
    gc.collect()
    torch.cuda.empty_cache()
    fallback = [r for r in read_metrics(path_c) if r["event"] == "ckpt_fallback"]
    losses_c, _ = _train_losses(path_c, first_step=3)
    check([r["step"] for r in fallback] == [6], f"15 (a): ckpt_fallback events {fallback}")
    check(ckpt.committed_steps(d) == [3], f"15 (a): committed {ckpt.committed_steps(d)}")
    check(_rel(losses_c[0], losses_a[3]) <= SERVICES_RESUME_RTOL,
          f"15 (a): the fallback's loss {losses_c[0]} against {losses_a[3]}")
    res = {"card": smi, "model": "llama-7b", "layers": SERVICES_LAYERS, "batch": 8, "seq": 2048,
           "losses_a": losses_a, "losses_resumed": losses_b, "resume_max_abs_diff": resume_abs,
           "resume_max_rel_diff": resume_rel, "resume_bitwise": resume_abs == 0.0,
           "step_gb": step_gb, "save_s": save_s, "save_gb_per_s": step_gb / save_s,
           "restore_s": restore_s, "restore_gb_per_s": step_gb / restore_s,
           "fallback_events": len(fallback), "fallback_loss": losses_c[0],
           "launches": launches}
    log("phase 15 (a) corpus, checkpoint, resume:", json.dumps(res))
    check(resume_rel <= SERVICES_RESUME_RTOL,
          f"15 (a): resumed losses {losses_b} against {losses_a[3:]}")
    RESULTS["services_resume"] = res
    return d, losses_a


def phase_services_layout(torch, smi, tmpdir, mix, d, losses_a):
    """15 (b): (a)'s step-3 checkpoint restored under pp = 2 by two ranks
    sharing the card over gloo, one step each: its loss against run A's
    step 3."""
    outdir = os.path.join(tmpdir, "layout")
    os.makedirs(outdir)
    t0 = time.perf_counter()
    ranks = _launch_ranks(_services_argv(mix, 4, "--load", d, "--pp_deg", "2"), outdir,
                          "gloo", (0, 0))
    res = {"card": smi, "pp": 2, "world": 2, "losses": [r["losses"] for r in ranks],
           "want": losses_a[3], "seconds": time.perf_counter() - t0,
           "seconds_are": "beside 15 (c) and (e) in this process",
           "rel_diff": max(_rel(r["losses"][0], losses_a[3]) for r in ranks),
           "launches": [r["launches"] for r in ranks]}
    log("phase 15 (b) restore at pp = 2:", json.dumps(res))
    check(all(len(r["losses"]) == 1 for r in ranks), "15 (b): one step a rank")
    check(res["rel_diff"] <= SERVICES_LAYOUT_RTOL,
          f"15 (b): loss {res['losses']} against run A's step 3 {losses_a[3]}")
    RESULTS["services_layout"] = res


def phase_services_serve(torch, smi, d):
    """15 (c): ``cli serve --load`` of (a)'s checkpoint on the paged backend
    answers 4 greedy requests; the first generated token of the prompt whose
    two best logits lie furthest apart equals the argmax of the restored
    model's training forward at its last position."""
    import numpy as np

    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core import checkpoint as ckpt
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer
    from galvatron_tpu_torch.ops import flash_attention as fa

    tok = ByteTokenizer()
    rng = np.random.RandomState(5)
    # 127 bytes + BOS: a tileable length for the training forward's kernels
    prompts = [_text(rng, 127) for _ in range(4)]
    cfg = modeling.PRESETS["llama-7b"].replace(num_layers=SERVICES_LAYERS, attn_impl="flash")
    raw, step = ckpt.restore_raw_checkpoint(d, prefix=ckpt.keystr(("params",)))
    params = modeling.cast_params(_to(raw["params"], torch.device("cuda")), cfg)
    with torch.no_grad():
        ids = torch.tensor([tok.encode(p) for p in prompts], device="cuda")
        logits = modeling.forward(params, ids, cfg)[:, -1].float()
    top2 = logits.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    pick = int(np.argmax(margins))
    want = int(logits[pick].argmax())
    del params, raw, logits
    torch.cuda.empty_cache()
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    argv = ["serve", "--model_size", "llama-7b", "--num_layers", str(SERVICES_LAYERS),
            "--load", d, "--kv_num_blocks", "-1", "--num_slots", "4", "--port", str(port),
            "--request_ttl_s", "600"]
    rc, err = [], []

    def serve():
        try:
            rc.append(cli.main(argv))
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            err.append(e)
            raise

    fa.paged_decode_attention.launches = 0  # the main path's count starts here
    server = threading.Thread(target=serve, name="cli-serve-load", daemon=True)
    server.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 600
    while True:
        check(not err, f"15 (c): cli serve died: {err[:1]}")
        try:
            if _http(base + "/readyz", timeout=10)[0] == 200:
                break
        except OSError:
            pass
        check(time.time() < deadline, "15 (c): cli serve never became ready")
        time.sleep(0.2)
    results = [None] * len(prompts)

    def post(i):
        results[i] = _http(base + "/api", {"prompts": [prompts[i]], "tokens_to_generate": 8,
                                           "temperature": 0.0})

    posters = [threading.Thread(target=post, args=(i,)) for i in range(len(prompts))]
    for p in posters:
        p.start()
    for p in posters:
        p.join(600)
    code, health = _http(base + "/healthz")
    decode_steps = health["serving"]["decode_steps"] if code == 200 else None
    code, drained = _http(base + "/drain", {})
    server.join(120)
    launches = fa.paged_decode_attention.launches  # read right after the main path
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"15 (c): request {i}: {r}")
    # the engine returns the prompt and what it generated; an EOS ends a
    # request without being appended
    generated = results[pick][1]["tokens"][0][len(tok.encode(prompts[pick])):]
    got = generated[0] if generated else tok.eos_id
    res = {"card": smi, "step": step, "requests": len(prompts), "margins": margins,
           "prompt": pick, "first_token": got, "forward_argmax": want,
           "decode_steps": decode_steps, "paged_decode_launches": launches,
           "leaked": drained.get("leaked")}
    log("phase 15 (c) serve --load:", json.dumps(res))
    check(not server.is_alive() and rc == [0], f"15 (c): cli serve did not exit cleanly: {rc}")
    check(drained.get("leaked") is False, f"15 (c): /drain {drained}")
    check(got == want, f"15 (c): greedy first token {got}, training forward's argmax {want}")
    check(launches == SERVICES_LAYERS * decode_steps,
          f"15 (c): {launches} paged_decode launches, expected {SERVICES_LAYERS} x {decode_steps}")
    RESULTS["services_serve"] = res


def phase_services_fp16(torch, smi, bf16_res):
    """15 (d): phase 9's configuration (phase 7's with ``fused_norm=True``)
    under ``--mixed_precision fp16``, 10 iterations: every loss finite, the
    blocked flash kernels 40 / 40 on the TMA route (their fp16 mainloop
    instances), the RMSNorm kernels 90 / 90 at fp16, step 0 against phase
    9's bf16 step 0."""
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.ops import fused_norm as fn

    _, layers, bsz, seq = TRAIN_PATHS["llama"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fp16_") as tmpdir:
        path = os.path.join(tmpdir, "m.jsonl")
        argv = _train_argv(modeling, "llama_fused") + ["--mixed_precision", "fp16",
                                                        "--metrics_path", path]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()  # the main path's counts start here
        routes_before = route_counts()
        dtypes_before = (dict(fa.flash_fwd.dtypes), dict(fa.flash_bwd.dtypes))
        ns = initialize_galvatron("train", argv)
        out = trainer.train(ns, cfg=model_config_from_args(ns).replace(fused_norm=True))
        launches = kernel_counts()  # read right after the main path
        norm_dtypes = fn.dtype_counts()
        routes = {k: {r: n - routes_before[k][r] for r, n in v.items()}
                  for k, v in route_counts().items()}
        fp16_calls = [w.dtypes["torch.float16"] - b["torch.float16"]
                      for w, b in zip((fa.flash_fwd, fa.flash_bwd), dtypes_before)]
        fp16_calls += [norm_dtypes[k]["torch.float16"] for k in ("rms_fwd", "rms_bwd")]
        losses, recs = _train_losses(path)
    steady = recs[1:]
    res = {"card": smi, "model": "llama-7b", "layers": layers, "batch": bsz, "seq": seq,
           "dtype": "float16", "fused_norm": True, "iters": TRAIN_ITERS, "losses": losses,
           "loss_scale": [r["loss_scale"] for r in recs], "skipped_steps": out["skipped_steps"],
           "iter_ms_mean_from_2": sum(r["iter_ms"] for r in steady) / len(steady),
           "iter_ms": [r["iter_ms"] for r in recs], "launches": launches,
           "routes": {k: routes[k] for k in ("flash_fwd", "flash_bwd")},
           "fp16_calls_flash_fwd_bwd_rms_fwd_bwd": fp16_calls,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    if bf16_res:
        res["bf16_step0_loss"] = bf16_res["losses"][0]
        res["step0_rel_diff"] = _rel(losses[0], bf16_res["losses"][0])
        res["bf16_iter_ms_mean_from_2"] = bf16_res["iter_ms_mean_from_2"]
    log("phase 15 (d) fp16 training:", json.dumps(res))
    del out
    check(len(losses) == TRAIN_ITERS and all(x == x and abs(x) != float("inf") for x in losses),
          f"15 (d): losses {losses}")
    want = path_counts("llama", layers, TRAIN_ITERS, True)
    check(launches == want, f"15 (d): launches {launches}, expected {want}")
    check(fp16_calls == [want[k] for k in ("flash_fwd", "flash_bwd", "rms_fwd", "rms_bwd")],
          f"15 (d): fp16 calls {fp16_calls}")
    check(all(routes[k]["tma"] == launches[k] for k in ("flash_fwd", "flash_bwd")),
          f"15 (d): routes {routes}")
    if bf16_res:
        check(res["step0_rel_diff"] <= SERVICES_FP16_RTOL,
              f"15 (d): step 0 loss {losses[0]} against bf16 {bf16_res['losses'][0]}")
    RESULTS["services_fp16"] = res
    return launches


def phase_services_rampup(torch, smi):
    """15 (e): ``--rampup_batch_size 4 4 32`` to a global batch of 16 at 2
    layers, 6 steps: the batch sizes ``BatchSizeRampup`` gives."""
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron
    from galvatron_tpu_torch.core.schedules import BatchSizeRampup

    ramp = BatchSizeRampup(start=4, increment=4, rampup_samples=32, target=16)
    want, consumed = [], 0
    for _ in range(SERVICES_STEPS):
        want.append(ramp(consumed))
        consumed += want[-1]
    reset_kernel_counts()  # the main path's counts start here
    out = trainer.train(initialize_galvatron("train", [
        "--model_size", "llama-7b", "--num_layers", str(SERVICES_LAYERS), "--train_iters",
        str(SERVICES_STEPS), "--global_train_batch_size", "16", "--rampup_batch_size", "4",
        "4", "32"]))
    launches = kernel_counts()  # read right after the main path
    res = {"card": smi, "batch_sizes": out["batch_sizes"], "want": want,
           "consumed_samples": out["consumed_samples"], "losses": out["losses"],
           "iter_ms": out["iter_times"],
           "iter_ms_is": "read while 15 (b)'s two rank processes may share the card",
           "launches": launches}
    del out
    log("phase 15 (e) ramp-up:", json.dumps(res))
    check(res["batch_sizes"] == want and res["consumed_samples"] == consumed,
          f"15 (e): batch sizes {res['batch_sizes']}, expected {want}")
    check(all(x == x and abs(x) != float("inf") for x in res["losses"]), "15 (e): losses")
    check(launches == path_counts("llama", SERVICES_LAYERS, SERVICES_STEPS, False),
          f"15 (e): launches {launches}")
    RESULTS["services_rampup"] = res


def phase_services(torch, smi, train_res):
    """Phase 15 (a)-(e); returns the fp16 path's launch counts."""
    from galvatron_tpu_torch.models import modeling

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_services_") as tmpdir:
        mix, sources = _services_corpora(tmpdir, modeling.PRESETS["llama-7b"].vocab_size)
        log("phase 15 corpora:", json.dumps(sources))
        d, losses_a = phase_services_resume(torch, smi, tmpdir, mix)
        gc.collect()
        torch.cuda.empty_cache()
        # (b)'s two ranks read the step-3 checkpoint beside (c) and (e) in
        # this process (their launches are counted in their own processes)
        with ThreadPoolExecutor(1) as pool:
            layout = pool.submit(phase_services_layout, torch, smi, tmpdir, mix, d, losses_a)
            phase_services_serve(torch, smi, d)
            gc.collect()
            torch.cuda.empty_cache()
            phase_services_rampup(torch, smi)
            layout.result()
    gc.collect()
    torch.cuda.empty_cache()
    launches = phase_services_fp16(torch, smi, train_res.get("llama_fused"))
    RESULTS["services_seconds"] = time.perf_counter() - t0
    log(f"phase 15 took {RESULTS['services_seconds']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 17: context parallelism (cli train with cp plans; ring and Ulysses)
# ---------------------------------------------------------------------------

CP_STEPS = 2  # 17 (a); two keep the script inside its time limit
# (b)'s steps: its gloo steps are host-staged transport (~21 s each), so it
# runs two, which still compare an updated step with world size 1's
CP_LONG_STEPS = 2
# (a) fp32 parity: llama-7b width, layer 0 cp 2 ring, layer 1 cp 2 a2a
CP_FP32 = dict(layers=2, batch=2, seq=1024)
# (b) bf16 long context: llama-7b width, 4 layers, 16384-token sequences; two
# of them, since a micro-batch must split over dp x cp (the plan checker's
# GTA009, the JAX package's rule)
CP_LONG = dict(layers=4, batch=2, seq=16384)
# (b)'s plan on two ranks: (cp, cp_impl, tp, sp, dp_type, ckpt) per layer; vocab_tp 2
CP_PLAN = ((2, "ring", 1, False, "ddp", "none"), (2, "ring", 1, False, "zero3", "full"),
           (2, "a2a", 1, False, "zero2", "none"), (1, "ring", 2, True, "ddp", "none"))
CP_VOCAB_TP = 2
# (c) the functions alone, on the two ranks, at (b)'s local batch
CP_FN_SHAPE = dict(b=2, h=32, s=4096, d=128)
# (a)'s limits, set between the sound run's readings and its control's (PERF.md,
# PR 14): a parameter band of one AdamW step at cli train's lr (1e-4), and a
# loss limit of ten fp32 ulps at 10.5; a run without the CP gradient sum
# crosses both (its steps go other ways from step 1)
CP_FP32_PARAM_BAND = 1e-4
CP_FP32_LOSS_TOL = 1e-5
#: the controls: the CP gradient sum left out (17 (a)), the ring hop from ring
#: position 0 left out (17 (c)), MoE routing over each rank's own tokens
#: (18 (a)), and every TP rank given the first n/tp ALiBi slopes (21 (c))
CP_CONTROLS = ("no_cp_reduce", "drop_past_hop", "local_routing", "first_slopes")


def _cp_control(name):
    """A with block under which the runtime is ``name``'s control (None:
    the runtime as it is)."""
    from galvatron_tpu_torch.parallel import hybrid, ring

    if name == "no_cp_reduce":
        return _patched(hybrid, _reduce_cp=lambda g, lp: g)
    if name == "drop_past_hop":
        return _patched(ring, _past=lambda owner, idx: 0 < owner < idx)
    if name == "local_routing":  # 18 (a): no MoE context, each rank routes its own tokens
        return _patched(hybrid, MoEContext=lambda *a, **k: None)
    if name == "first_slopes":  # 21 (c): every TP rank the slopes of heads 0..n/tp-1
        from galvatron_tpu_torch.models import modeling

        return _patched(modeling, alibi_local=lambda slopes, tp: slopes[:len(slopes) // tp.size])
    if name is None:
        return contextlib.nullcontext()
    raise ValueError(f"unknown control {name!r}")


def _cp_plan(path, rows, precision, vocab_tp=1):
    """A strategy JSON from (cp, cp_impl, tp, sp, dp_type, ckpt) rows."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy

    hp = HybridParallelConfig(
        layer_strategies=[LayerStrategy(cp=c, cp_impl=i, tp=t, sp=sp, dp_type=d, ckpt=k)
                          for c, i, t, sp, d, k in rows],
        vocab_tp=vocab_tp, mixed_precision=precision)
    hp.save(path)
    return hp


def _cp_argv(plan, layers, batch, seq, steps=CP_STEPS):
    return ["--model_size", "llama-7b", "--num_layers", str(layers), "--seq_length", str(seq),
            "--global_train_batch_size", str(batch), "--train_iters", str(steps),
            "--galvatron_config_path", plan]


def _cp_grid_want(hp, idx, world, batch, seq, steps, heads=32):
    """Grid flash launches of ``steps`` steps of a plan at ring position
    ``idx`` in a world of ``world`` ranks, keyed as the wrappers' ``modes``
    ("b,h,s,causal" or "b,h,s,unmasked", b the batch over the layer's dp): a
    ring layer launches its own block causal and each of its ``idx`` past
    blocks unmasked, at (heads / tp, seq / cp), forwards twice under full
    recompute, and as many dk/dv and dq; an a2a layer's core one of each,
    causal, at (heads / (tp cp), seq); a tp layer one of each, causal, at
    (heads / tp, seq) when the blocked route does not take its shape.
    Returns ({kernel: {key: n}}, blocked launches)."""
    from galvatron_tpu_torch.ops import flash_attention as fa

    want = {"flash_grid_fwd": {}, "flash_grid_dkdv": {}, "flash_grid_dq": {}}
    blocked = 0
    for s in hp.layer_strategies:
        redo = 2 if s.ckpt == "full" else 1
        b = batch // (world // (s.tp * s.cp))
        if s.cp > 1 and s.cp_impl == "ring":
            at = f"{b},{heads // s.tp},{seq // s.cp}"
            keys = {f"{at},causal": 1, f"{at},unmasked": idx}
        elif s.cp > 1:
            keys = {f"{b},{heads // (s.tp * s.cp)},{seq},causal": 1}
        elif fa.flash_qkv_supported(seq, 128, True, True):
            blocked += 1
            continue
        else:
            keys = {f"{b},{heads // s.tp},{seq},causal": 1}
        for key, n in keys.items():
            for k, m in (("flash_grid_fwd", redo * n), ("flash_grid_dkdv", n),
                         ("flash_grid_dq", n)):
                if m:
                    want[k][key] = want[k].get(key, 0) + m * steps
    return want, blocked


def phase_cp_fp32(torch, smi, tmpdir, then_argv):
    """17 (a): the two-layer cp plan on two ranks sharing the card over
    gloo, fp32, against the same layers at world size 1 in this process:
    losses within ``CP_FP32_LOSS_TOL`` (and phase 12's
    ``HYBRID_FP32_LOSS_TOL``), every rank's parameters within
    ``CP_FP32_PARAM_BAND``. The same run without the CP gradient sum, run
    beside it on the card, must fall out of both. ``then_argv``: the run
    the sound world's rank processes make after (a)'s (``--then``: (b)'s,
    so one pair of processes starts for both); its rank records are
    returned."""
    from concurrent.futures import ThreadPoolExecutor
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron

    a = CP_FP32
    plan1 = os.path.join(tmpdir, "cp_fp32_w1.json")
    _cp_plan(plan1, [(1, "ring", 1, False, "ddp", "none")] * a["layers"], "fp32")
    plan2 = os.path.join(tmpdir, "cp_fp32_w2.json")
    _cp_plan(plan2, [(2, "ring", 1, False, "ddp", "none"), (2, "a2a", 1, False, "ddp", "none")],
             "fp32")
    t0 = time.perf_counter()
    ref = trainer.train(initialize_galvatron("train", _cp_argv(plan1, a["layers"], a["batch"],
                                                                 a["seq"])))
    ref_path = os.path.join(tmpdir, "cp_ref_params.pt")
    torch.save(_to(ref["state"]["params"], "cpu"), ref_path)
    ref_losses = ref["losses"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    def run(control):
        """Two ranks of the plan (under ``control``) on card 0: (a)'s rank
        records, and ``then_argv``'s after them in the sound world."""
        outdir = os.path.join(tmpdir, f"cp_ranks_fp32_{control}")
        os.makedirs(outdir)
        extra = ("--ref-params", ref_path) + (("--control", control) if control else ())
        argv = _cp_argv(plan2, a["layers"], a["batch"], a["seq"])
        if control:
            return _launch_ranks(argv, outdir, "gloo", (0, 0), extra), None
        return _launch_rank_runs([argv, then_argv], outdir, "gloo", (0, 0), extra)

    def readings(rs):
        return (max(abs(x - y) for x, y in zip(rs[0]["losses"], ref_losses)),
                max(r["param_max_abs_diff"] for r in rs))

    # the sound run and its control, two worlds at once
    with ThreadPoolExecutor(2) as pool:
        (ranks, then_ranks), (crs, _) = pool.map(run, (None, "no_cp_reduce"))
    os.remove(ref_path)
    diff, pdiff = readings(ranks)
    cdiff, cpdiff = readings(crs)
    control = {"losses": crs[0]["losses"], "max_abs_loss_diff": cdiff,
               "param_max_abs_diff": cpdiff}
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks), "17 (a): ranks differ")
    check(diff <= min(CP_FP32_LOSS_TOL, HYBRID_FP32_LOSS_TOL),
          f"17 (a): losses {ranks[0]['losses']} vs world size 1 {ref_losses}")
    check(pdiff <= CP_FP32_PARAM_BAND,
          f"17 (a): parameters {pdiff} from world size 1 (band {CP_FP32_PARAM_BAND})")
    check(cpdiff > CP_FP32_PARAM_BAND and cdiff > CP_FP32_LOSS_TOL,
          f"17 (a): the control without the CP gradient sum passes a limit ({control})")
    res = {"card": smi, **a, "steps": CP_STEPS, "plan": "cp 2 ring, cp 2 a2a", "dtype": "float32",
           "losses": ranks[0]["losses"], "world1_losses": ref_losses, "max_abs_loss_diff": diff,
           "tolerance": CP_FP32_LOSS_TOL, "param_max_abs_diff": pdiff,
           "param_band": CP_FP32_PARAM_BAND, "control_no_cp_reduce": control,
           "host_staged": [r["host_staged"] for r in ranks], "p2p": [r["p2p"] for r in ranks],
           "seconds": time.perf_counter() - t0,
           "seconds_are": ("(a)'s world size 1, then (a) and (b) in one pair of rank "
                           "processes beside (a)'s control world and 17 (c)'s ranks")}
    log("phase 17 (a) cp fp32:", json.dumps(res))
    RESULTS["cp_fp32"] = res
    return then_ranks


def phase_cp_world1(torch, smi, tmpdir):
    """(b)'s reference: the same 4 layers at world size 1, in this process."""
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron

    b = CP_LONG
    plan = os.path.join(tmpdir, "cp_long_w1.json")
    _cp_plan(plan, [(1, "ring", 1, False, "ddp", "none")] * b["layers"], "bf16")
    torch.cuda.reset_peak_memory_stats()
    out = trainer.train(initialize_galvatron("train", _cp_argv(plan, b["layers"], b["batch"],
                                                                 b["seq"], CP_LONG_STEPS)))
    it = out["iter_times"]
    res = {"losses": out["losses"], "iter_ms_mean_from_2": sum(it[1:]) / (len(it) - 1),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 17 (b) world size 1:", json.dumps(res))
    RESULTS["cp_long_world1"] = res
    return res


def _cp_long_plan(tmpdir, backend):
    """(b)'s plan (written to ``tmpdir``) and its ``cli train`` flags."""
    b = CP_LONG
    plan = os.path.join(tmpdir, f"cp_long_{backend}.json")
    hp = _cp_plan(plan, CP_PLAN, "bf16", CP_VOCAB_TP)
    return hp, _cp_argv(plan, b["layers"], b["batch"], b["seq"], CP_LONG_STEPS)


def phase_cp_long(torch, smi, tmpdir, backend, local_ranks, world1, ranks=None):
    """17 (b) (two ranks sharing card 0 over gloo) or 17b (two cards over
    NCCL): the bf16 plan at llama-7b width on 16384-token sequences,
    against world size 1 on the same weights and batches; each rank's grid
    launches by shape, on the TMA route. ``ranks``: the rank records of a
    run made already (17 (b) after 17 (a) in one pair of processes), else
    its own two ranks are launched here."""
    import numpy as np

    tag = "17 (b)" if backend == "gloo" else "17b"
    b = CP_LONG
    hp, argv = _cp_long_plan(tmpdir, backend)
    t0 = time.perf_counter()
    if ranks is None:
        outdir = os.path.join(tmpdir, f"cp_ranks_long_{backend}")
        os.makedirs(outdir)
        ranks = _launch_ranks(argv, outdir, backend, local_ranks)
    w1 = world1["losses"]
    losses = ranks[0]["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses, w1))
    check(all(np.isfinite(losses)), f"{tag}: non-finite losses {losses}")
    check(all(r["losses"] == losses for r in ranks), f"{tag}: ranks report other losses")
    check(rel <= HYBRID_BF16_LOSS_RTOL, f"{tag}: losses {losses} vs world size 1 {w1}")
    for r in ranks:
        want, blocked = _cp_grid_want(hp, r["rank"], len(ranks), b["batch"], b["seq"],
                                      CP_LONG_STEPS)
        totals = {k: sum(v.values()) for k, v in want.items()}
        got = {k: r["launches"][k] for k in totals}
        check(got == totals and r["launches"]["flash_fwd"] == blocked * CP_LONG_STEPS
              and r["launches"]["flash_bwd"] == blocked * CP_LONG_STEPS,
              f"{tag} rank {r['rank']}: launches {r['launches']}, expected {totals}")
        check(all(r["routes"][k]["tma"] == totals[k] and r["routes"][k]["cuda_core"] == 0
                  for k in totals), f"{tag} rank {r['rank']}: routes {r['routes']}")
        check(r["shapes"] == want, f"{tag} rank {r['rank']}: launches by shape {r['shapes']}, "
              f"expected {want}")
        check((r["host_staged"] > 0) == (backend == "gloo"),
              f"{tag} rank {r['rank']}: {r['host_staged']} host-staged collectives")
    steady = lambda r: sum(r["iter_times"][1:]) / (len(r["iter_times"]) - 1)  # noqa: E731
    res = {"card": smi, "backend": backend, "local_ranks": list(local_ranks), **b,
           "steps": CP_LONG_STEPS, "plan": [list(x) for x in CP_PLAN], "vocab_tp": CP_VOCAB_TP,
           "losses": losses, "world1_losses": w1, "max_rel_loss_diff": rel,
           "tolerance": HYBRID_BF16_LOSS_RTOL,
           "launches": [{k: r["launches"][k] for k in ("flash_grid_fwd", "flash_grid_dkdv",
                                                       "flash_grid_dq", "flash_fwd")}
                        for r in ranks],
           "launches_by_shape": [r["shapes"] for r in ranks],
           "host_staged": [r["host_staged"] for r in ranks], "p2p": [r["p2p"] for r in ranks],
           "iter_ms_mean_from_2": [steady(r) for r in ranks],
           "world1_iter_ms_mean_from_2": world1["iter_ms_mean_from_2"],
           "max_memory_allocated_gb": [r["max_memory_allocated_gb"] for r in ranks],
           "world1_max_memory_allocated_gb": world1["max_memory_allocated_gb"],
           "iter_ms_is": ("host-staged over gloo: a transport figure, not a parallelism "
                          "result, read after (a) in its rank processes while 17 (c)'s ranks "
                          "and the end of (a)'s control world may share the card"
                          if backend == "gloo" else "NCCL on two cards"),
           "seconds": time.perf_counter() - t0}
    if backend == "gloo":
        res["seconds_are"] = "the checks only: the run is in 17 (a)'s seconds"
    log(f"phase {tag} cp long context:", json.dumps(res))
    RESULTS[f"cp_long_{backend}"] = res
    return res


def _causal_fp32(torch, q, k, v):
    """Causal softmax attention over the whole sequence in fp32: (B, S, n,
    d) in and out."""
    sc = torch.einsum("bqnd,bknd->bnqk", q, k) / (q.shape[-1] ** 0.5)
    s = q.shape[1]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", p, v)


def _cp_fn_inputs(torch):
    b, h, s, d = (CP_FN_SHAPE[k] for k in "bhsd")
    gen = torch.Generator(device="cuda").manual_seed(70)
    return [torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(4)]


def cp_worker(outdir) -> int:
    """One rank of 17 (c): its block of seeded q/k/v through
    ``ring_attention`` (and with one past hop left out, the control) and
    ``ulysses_attention`` (flash core), forward and backward; writes each
    output and gradient block."""
    import torch
    import torch.distributed as dist

    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import ring, ulysses
    from galvatron_tpu_torch.parallel.mesh import ProcessGroups, RankMesh

    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(dev)
    init_distributed(dev, "gloo", timeout_s=300)
    rank = dist.get_rank()
    axes = ("x0",)
    group = ProcessGroups(RankMesh(dist.get_world_size()), rank, [axes]).get(axes)
    q, k, v, do = _cp_fn_inputs(torch)
    n = q.shape[1] // group.size
    blk = slice(group.index * n, (group.index + 1) * n)
    cfg = ModelConfig(num_heads=q.shape[2], hidden_size=q.shape[2] * q.shape[3],
                      attn_impl="flash")
    runs = {"ring": (lambda *t: ring.ring_attention(*t, group), None),
            "ring_control": (lambda *t: ring.ring_attention(*t, group), "drop_past_hop"),
            "ulysses": (lambda *t: ulysses.ulysses_attention(*t, cfg, group), None)}
    for name, (fn, control) in runs.items():
        qb, kb, vb = (t[:, blk].detach().clone().requires_grad_(True) for t in (q, k, v))
        with _cp_control(control):
            out = fn(qb, kb, vb)
            out.backward(do[:, blk])
        torch.cuda.synchronize()
        torch.save({"out": out.detach().cpu(), "grads": [t.grad.cpu() for t in (qb, kb, vb)],
                    "index": group.index}, os.path.join(outdir, f"{name}.{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _cp_function_ranks(tmpdir):
    """17 (c)'s two rank processes (``--cp-worker``), which write their
    blocks under ``tmpdir/cp_functions``; returns that directory and the
    ranks' seconds."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    outdir = os.path.join(tmpdir, "cp_functions")
    os.makedirs(outdir)
    t0 = time.perf_counter()
    ranks = launch_local([sys.executable, os.path.abspath(__file__), "--cp-worker", outdir], 2,
                         timeout_s=HYBRID_RANK_TIMEOUT_S, local_ranks=(0, 0),
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    for r in ranks:
        log(f"  rank {r.rank}: rc={r.returncode} killed={r.killed}\n" +
            "\n".join(r.output.splitlines()[-8:]))
    check(all(r.returncode == 0 and not r.killed for r in ranks), "17 (c): a rank failed")
    return outdir, time.perf_counter() - t0


def phase_cp_functions(torch, smi, outdir, rank_seconds):
    """17 (c): ``ring_attention`` and ``ulysses_attention`` on the two
    ranks, forward and backward at (2, 32, 4096, 128) bf16, held to the grid
    plain versions over the whole sequence on one device (causal, the
    kernels' bf16 rounding points: what world size 1 computes) by
    ``bf16_parity_excess`` (2^-5 the output, 2^-4 the gradients); the ring
    without a past hop must read out of band. Each is also held to the fp32
    attention over the whole sequence: within the plain versions' own
    reading against it on the same inputs plus the band (a kernel within
    the band of the plain versions can be no farther from fp32). dq reads
    far past 2^-4 there for the plain versions too: in the first rows of the
    sequence, ds = p (dp - delta) cancels to nearly zero in fp32 but keeps
    the rounding of the bf16 output that delta is taken from. The ranks
    (:func:`_cp_function_ranks`) ran beside 17 (a) and (b); the reference and
    the checks run here, after them."""
    from galvatron_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    q, k, v, do = _cp_fn_inputs(torch)
    # the reference: the grid plain versions over the whole sequence, head-major
    hq, hk, hv, hdo = (t.transpose(1, 2) for t in (q, k, v, do))
    sm = 1.0 / q.shape[-1] ** 0.5
    ref_out, lse = fa.flash_fwd_grid_plain(hq, hk, hv, None, sm, True)
    delta = (hdo.float() * ref_out.float()).sum(-1, keepdim=True)
    ref = [t.transpose(1, 2) for t in (ref_out, *fa.flash_bwd_grid_plain(
        hq, hk, hv, hdo, lse, delta, None, sm, True))]
    del ref_out, lse, delta
    # the fp32 attention, and the plain versions' own reading against it
    f32_in = [t.float().requires_grad_(True) for t in (q, k, v)]
    f32_out = _causal_fp32(torch, *f32_in)
    f32 = [f32_out.detach(), *torch.autograd.grad(f32_out, f32_in, do.float())]
    del f32_in, f32_out
    lim_f, lim_b = fa.BF16_PARITY_TOL["fwd"], fa.BF16_PARITY_TOL["bwd"]
    lims = (lim_f, lim_b, lim_b, lim_b)
    plain_f32 = [fa.bf16_parity_excess(r, f) for r, f in zip(ref, f32)]
    res = {"card": smi, "shape": CP_FN_SHAPE, "dtype": "bfloat16", "cp": 2,
           "reference": "the grid plain versions over the whole sequence (causal, bf16)",
           "tolerance": f"bf16_parity_excess: out {lim_f}, gradients {lim_b}; against fp32, "
                        "the plain versions' own reading plus that band",
           "plain_fp32_out_dq_dk_dv_err": plain_f32}
    for name in ("ring", "ring_control", "ulysses"):
        parts = sorted((torch.load(os.path.join(outdir, f"{name}.{r}.pt")) for r in range(2)),
                       key=lambda p: p["index"])
        got = [torch.cat([p["out"] for p in parts], dim=1).cuda()] + [
            torch.cat([p["grads"][i] for p in parts], dim=1).cuda() for i in range(3)]
        errs = [fa.bf16_parity_excess(g, r) for g, r in zip(got, ref)]
        errs32 = [fa.bf16_parity_excess(g, f) for g, f in zip(got, f32)]
        res[name] = {"out_err": errs[0], "dq_dk_dv_err": errs[1:],
                     "fp32_reference_out_dq_dk_dv_err": errs32}
        inside = all(e <= lim for e, lim in zip(errs, lims))
        inside32 = all(e <= p + lim for e, p, lim in zip(errs32, plain_f32, lims))
        if name == "ring_control":
            check(not inside and not inside32,
                  f"17 (c): the ring without a past hop passes ({errs}, fp32 {errs32})")
        else:
            check(inside, f"17 (c): {name} out / dq / dk / dv err {errs}")
            check(inside32, f"17 (c): {name} against fp32 {errs32}, the plain versions "
                  f"{plain_f32}")
    res["seconds"] = time.perf_counter() - t0 + rank_seconds
    res["seconds_are"] = "the ranks' (beside 17 (a) and (b)) and the checks'"
    log("phase 17 (c) cp functions:", json.dumps(res))
    RESULTS["cp_functions"] = res


def phase_cp(torch, smi, run_gloo=True, run_nccl=False):
    """Phase 17 (gloo on card 0: (a), (b), (c)) and 17b (NCCL on cards 0
    and 1 where there are two). Returns (b)'s result."""
    res = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cp_") as tmpdir:
        gc.collect()
        torch.cuda.empty_cache()
        world1 = phase_cp_world1(torch, smi, tmpdir)
        if run_gloo:
            from concurrent.futures import ThreadPoolExecutor

            # (c)'s two small ranks start beside (a)'s worlds; (b) runs after
            # (a) in the sound world's rank processes (one start for both)
            with ThreadPoolExecutor(1) as pool:
                fn_ranks = pool.submit(_cp_function_ranks, tmpdir)
                long_ranks = phase_cp_fp32(torch, smi, tmpdir, _cp_long_plan(tmpdir, "gloo")[1])
                fn_dir, fn_seconds = fn_ranks.result()
            gc.collect()
            torch.cuda.empty_cache()
            res = phase_cp_long(torch, smi, tmpdir, "gloo", (0, 0), world1, long_ranks)
            phase_cp_functions(torch, smi, fn_dir, fn_seconds)
        if run_nccl and torch.cuda.device_count() >= 2:
            phase_cp_long(torch, smi, tmpdir, "nccl", (0, 1), world1)
        elif run_nccl:
            log(f"phase 17b, cp over nccl on two cards: absent ({torch.cuda.device_count()} card)")
            RESULTS["cp_long_nccl"] = "absent: one card"
    return res


# ---------------------------------------------------------------------------
# phase 18: mixture-of-experts and expert parallelism (cli train, serve,
# profile, search of a switch-MoE model)
# ---------------------------------------------------------------------------

MOE_EXPERTS = 8
# (b): llama-7b width, 8 experts, depth cut to 2 layers, batch 8 x 2048
MOE_LAYERS, MOE_ITERS, MOE_EP_STEPS = 2, 10, 2  # two ep steps: the script's time limit
MOE_BATCH, MOE_SEQ = 8, 2048
# (b)'s plan on two ranks: ep 2 over the two (DDP on the dense leaves)
MOE_EP = 2
MOE_SERVE_LAYERS = 4  # (c)
# (a) and (d): a narrower model of the same family (h 1024, 8 heads of 128)
MOE_SMALL = ("--hidden_size", "1024", "--num_heads", "8", "--ffn_dim", "2816")
MOE_FP32 = dict(layers=2, batch=4, seq=512)
# (a)'s limits: 17 (a)'s (ten fp32 ulps of a loss near 10.4; one AdamW step at
# cli train's lr); a run that routes each rank's own tokens crosses both
MOE_FP32_LOSS_TOL = 1e-5
MOE_FP32_PARAM_BAND = 1e-4
# (d)'s profile batch: at (a)'s batch 4 the step is launch-bound (the layer's
# step time barely moves with 4x the tokens), so no timing resolves the expert
# work and the fit straddles the search's threshold (ROADMAP §3);
# experiments/torch_moe_fit_spread.py on one H100: threshold 0.153 at batch
# 16, where 12 of 12 fits (the port's and the reference's) read 0.328-0.804
MOE_PROFILE_BATCH = 16
#: the profiler ranges of ``models/moe.py`` and the autograd nodes of the
#: MoE block's backward, by part of the step
MOE_PARTS = {"routing": ("moe.routing",), "dispatch": ("moe.dispatch", "_DispatchBackward"),
             "experts": ("moe.experts", "BmmBackward0", "SiluBackward0"),
             "combine": ("moe.combine", "_CollectBackward"),
             "all_to_all": ("moe.all_to_all", "_MoEMoveBackward")}


def _moe_model(seq, small=False, layers=MOE_LAYERS):
    """The MoE model's shape flags: llama-7b width (or ``MOE_SMALL``)."""
    return (["--model_size", "llama-7b", "--num_layers", str(layers), "--moe_experts",
             str(MOE_EXPERTS), "--seq_length", str(seq)] + (list(MOE_SMALL) if small else []))


def _moe_argv(plan, batch, seq, iters, small=False, layers=MOE_LAYERS):
    argv = _moe_model(seq, small, layers) + ["--global_train_batch_size", str(batch),
                                             "--train_iters", str(iters)]
    if plan:
        argv += ["--galvatron_config_path", plan]
    return argv


def _moe_plan(path, ep, precision, dp_type="ddp", layers=MOE_LAYERS):
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy

    hp = HybridParallelConfig(layer_strategies=[LayerStrategy(ep=ep, dp_type=dp_type)] * layers,
                              mixed_precision=precision)
    hp.save(path)
    return hp


def moe_time_split(prof, steps):
    """Per step, each MoE part's device ms (kernels under its forward range
    or its backward autograd nodes) and host ms (the ranges' and nodes' CPU
    time: a host-staged all-to-all shows there)."""
    out = {part: {"device_ms": 0.0, "host_ms": 0.0} for part in MOE_PARTS}
    for e in prof.events():
        name = e.name
        node = name.split("evaluate_function: ")[-1] if "evaluate_function: " in name else None
        for part, names in MOE_PARTS.items():
            if name in names[:1] or (node is not None and node in names[1:]):
                dev = getattr(e, "device_time_total", None)
                dev = e.cuda_time_total if dev is None else dev
                out[part]["device_ms"] += dev / 1e3 / steps
                out[part]["host_ms"] += e.cpu_time_total / 1e3 / steps
    return out


def phase_moe_fp32(torch, smi, tmpdir, plan2, then_argv):
    """18 (a): the plan 18 (d) searched (ep 2) on two ranks sharing the card
    over gloo, fp32, against world size 1 in this process: losses within
    ``MOE_FP32_LOSS_TOL``, every rank's parameters within
    ``MOE_FP32_PARAM_BAND``. Beside it on the card, the control: the two
    ranks at ep 1 (data parallel), each routing its own tokens, must fall out
    of both (EP needs every rank's routing, so the control drops EP).
    ``then_argv``: the run the sound world's rank processes make after
    (a)'s (``--then``: 18 (b)'s ep 2 run, so one pair of processes starts
    for both); its rank records are returned."""
    from concurrent.futures import ThreadPoolExecutor

    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    a = MOE_FP32
    plan1 = os.path.join(tmpdir, "moe_fp32_w1.json")
    _moe_plan(plan1, 1, "fp32", layers=a["layers"])
    plan_dp = os.path.join(tmpdir, "moe_fp32_w2_dp.json")
    _moe_plan(plan_dp, 1, "fp32", layers=a["layers"])
    hp = HybridParallelConfig.load(plan2)
    t0 = time.perf_counter()
    ref = trainer.train(initialize_galvatron("train", _moe_argv(
        plan1, a["batch"], a["seq"], MOE_EP_STEPS, small=True, layers=a["layers"])))
    ref_path = os.path.join(tmpdir, "moe_ref_params.pt")
    torch.save(_to(ref["state"]["params"], "cpu"), ref_path)
    ref_losses = ref["losses"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    def run(control):
        """(a)'s rank records (under ``control``), and ``then_argv``'s after
        them in the sound world."""
        outdir = os.path.join(tmpdir, f"moe_ranks_fp32_{control}")
        os.makedirs(outdir)
        extra = ("--ref-params", ref_path) + (("--control", control) if control else ())
        argv = _moe_argv(plan_dp if control else plan2, a["batch"], a["seq"], MOE_EP_STEPS,
                         small=True, layers=a["layers"])
        if control:
            return _launch_ranks(argv, outdir, "gloo", (0, 0), extra), None
        return _launch_rank_runs([argv, then_argv], outdir, "gloo", (0, 0), extra)

    def readings(rs):
        return (max(abs(x - y) for x, y in zip(rs[0]["losses"], ref_losses)),
                max(r["param_max_abs_diff"] for r in rs))

    with ThreadPoolExecutor(2) as pool:
        (ranks, then_ranks), (crs, _) = pool.map(run, (None, "local_routing"))
    os.remove(ref_path)
    diff, pdiff = readings(ranks)
    cdiff, cpdiff = readings(crs)
    control = {"losses": crs[0]["losses"], "max_abs_loss_diff": cdiff,
               "param_max_abs_diff": cpdiff}
    res = {"card": smi, **a, "hidden": 1024, "experts": MOE_EXPERTS, "steps": MOE_EP_STEPS,
           "plan": hp.to_json_dict(), "dtype": "float32", "losses": ranks[0]["losses"],
           "world1_losses": ref_losses, "max_abs_loss_diff": diff,
           "tolerance": MOE_FP32_LOSS_TOL, "param_max_abs_diff": pdiff,
           "param_band": MOE_FP32_PARAM_BAND, "control_local_routing_ep1": control,
           "moe_moves": [r["moe_moves"] for r in ranks],
           "host_staged": [r["host_staged"] for r in ranks], "seconds": time.perf_counter() - t0,
           "seconds_are": ("(a)'s world size 1, then (a) and 18 (b)'s ep 2 run in one pair "
                           "of rank processes beside (a)'s control world")}
    log("phase 18 (a) moe fp32, the searched plan:", json.dumps(res))
    RESULTS["moe_fp32"] = res
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks), "18 (a): ranks differ")
    check(diff <= MOE_FP32_LOSS_TOL,
          f"18 (a): losses {ranks[0]['losses']} vs world size 1 {ref_losses}")
    check(pdiff <= MOE_FP32_PARAM_BAND,
          f"18 (a): parameters {pdiff} from world size 1 (band {MOE_FP32_PARAM_BAND})")
    check(cdiff > MOE_FP32_LOSS_TOL and cpdiff > MOE_FP32_PARAM_BAND,
          f"18 (a): the per-rank routing control passes a limit ({control})")
    ep = max(s_.ep for s_ in hp.layer_strategies)
    want = _moe_moves_want(a["layers"], MOE_EP_STEPS, ep)
    check(all(r["moe_moves"] == want for r in ranks),
          f"18 (a): moves {[r['moe_moves'] for r in ranks]}, expected {want}")
    return then_ranks


def _moe_moves_want(layers, steps, ep, recomputed=0):
    """``comm.moe_moves`` of ``steps`` steps of a plan with ``layers`` MoE
    layers at ``ep`` (DP 2, no chunks): a logits gather a layer forward
    (``recomputed`` more), and at ep > 1 a dispatch and a combine each way."""
    fwd = (layers + recomputed) * steps
    moves = 0 if ep == 1 else fwd + layers * steps
    return {"logits": fwd, "dispatch": moves, "combine": moves}


def phase_moe_train(torch, smi, tmpdir):
    """18 (b)'s first part: ``cli train`` of the llama-7b-width MoE at world
    size 1 (10 iterations; a profile window splits its step). Returns its
    record, which :func:`phase_moe_ep2` completes."""
    from torch.profiler import ProfilerActivity, profile

    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core.dataloader import build_dataloader
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.parallel import comm
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    path = os.path.join(tmpdir, "moe_train.jsonl")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_counts()
    t0 = time.perf_counter()
    reset_kernel_counts()  # the main path's counts start here
    before = route_counts()
    rc = cli.main(["train", *_moe_argv(None, MOE_BATCH, MOE_SEQ, MOE_ITERS),
                   "--metrics_path", path])
    launches = kernel_counts()  # read right after the main path
    routes = _routes_since(before)
    check(rc == 0, f"18 (b): cli train returned {rc}")
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, recs = _train_losses(path)
    check(len(losses) == MOE_ITERS and all(x == x and abs(x) != float("inf") for x in losses),
          f"18 (b): losses {losses}")
    want = path_counts("llama", MOE_LAYERS, MOE_ITERS, False)
    check(launches == want, f"18 (b): launches {launches}, expected {want}")
    check(_all_tma(launches, routes), f"18 (b): routes {routes}")
    check(comm.issued == 0 and not any(comm.moe_moves.values()),
          f"18 (b): world size 1 moved {comm.moe_moves}")
    steady = recs[1:]
    mean = lambda key: sum(r[key] for r in steady) / len(steady)  # noqa: E731
    w1 = {"layers": MOE_LAYERS, "experts": MOE_EXPERTS, "batch": MOE_BATCH, "seq": MOE_SEQ,
          "dtype": "bfloat16", "iters": MOE_ITERS, "losses": losses,
          "iter_ms_mean_from_2": mean("iter_ms"), "tokens_per_s": mean("tokens_per_s"),
          "mfu": mean("mfu"), "max_memory_allocated_gb": peak_gb, "launches": launches,
          "tma_routes": {k: v["tma"] for k, v in routes.items()}, "seconds": seconds}
    log("phase 18 (b) moe train world size 1:", json.dumps(w1))
    # the profile window: 2 steady steps of the same configuration
    cfg = modeling.PRESETS["llama-7b"].replace(num_layers=MOE_LAYERS, moe_experts=MOE_EXPERTS,
                                               attn_impl="flash")
    rt = build_runtime(cfg, adam=AdamConfig(lr=1e-4, weight_decay=0.01, grad_clip=1.0),
                       global_batch_size=MOE_BATCH, seq_len=MOE_SEQ, mixed_precision="bf16",
                       device="cuda")
    state = rt.init_state(1234)
    loader = build_dataloader(rt.cfg, MOE_BATCH, MOE_SEQ, seed=1234)
    for _ in range(2):
        state, loss = rt.train_step(state, torch.from_numpy(next(loader)))
        float(loss)
    batches = [torch.from_numpy(next(loader)) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for batch in batches:
            state, loss = rt.train_step(state, batch)
            float(loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / 2
    kernels = _kernel_intervals(prof)
    check(kernels, "18 (b): the profiler recorded no device kernel")
    busy_ms = _union_us(kernels) / 1e3 / 2
    by_cat = {}
    for name, s, e in kernels:
        c = _category(name)
        by_cat[c] = by_cat.get(c, 0.0) + (e - s) / 1e3 / 2
    w1["profile"] = {"wall_ms_per_step_profiled": wall_ms, "device_busy_ms_per_step": busy_ms,
                     "device_idle_share": 1.0 - busy_ms / wall_ms,
                     "kernel_launches_per_step": len(kernels) / 2,
                     "device_ms_by_category": by_cat, "moe_parts": moe_time_split(prof, 2)}
    log("phase 18 (b) moe step profile:", json.dumps(w1["profile"]))
    del state, rt, prof
    gc.collect()
    torch.cuda.empty_cache()
    return w1


def _moe_ep2_argv(tmpdir):
    """18 (b)'s ep 2 run: the plan on two ranks, 2 steps, rank 0 profiled
    (``PROFILE_MOE``, a flag of this run alone)."""
    plan2 = os.path.join(tmpdir, "moe_ep2.json")
    _moe_plan(plan2, MOE_EP, "bf16")
    return [PROFILE_MOE, *_moe_argv(plan2, MOE_BATCH, MOE_SEQ, MOE_EP_STEPS)]


def phase_moe_ep2(torch, smi, w1, ranks):
    """18 (b)'s second part: the ep 2 plan's rank records (two ranks sharing
    the card over gloo, run in 18 (a)'s rank processes after (a)) against
    the world-size-1 run ``w1``."""
    t0 = time.perf_counter()
    losses, peak_gb = w1["losses"], w1["max_memory_allocated_gb"]
    rel = max(_rel(x, y) for x, y in zip(ranks[0]["losses"], losses))
    ep2 = {"plan": f"ep {MOE_EP}, ddp", "steps": MOE_EP_STEPS, "losses": ranks[0]["losses"],
           "max_rel_loss_diff_vs_world1": rel, "tolerance": HYBRID_BF16_LOSS_RTOL,
           "iter_ms_mean_from_2": [sum(r["iter_times"][1:]) / (len(r["iter_times"]) - 1)
                                   for r in ranks],
           "iter_ms_is": ("read after 18 (a) in its rank processes, while the end of (a)'s "
                          "control world may share the card; rank 0 profiled"),
           "max_memory_allocated_gb": [r["max_memory_allocated_gb"] for r in ranks],
           "launches": [r["launches"] for r in ranks], "moe_moves": [r["moe_moves"] for r in ranks],
           "collectives": [r["collectives"] for r in ranks],
           "host_staged": [r["host_staged"] for r in ranks],
           "rank0_moe_parts": ranks[0].get("moe_parts"), "seconds": time.perf_counter() - t0,
           "seconds_are": "the checks only: the run is in 18 (a)'s seconds"}
    res = {"card": smi, "world1": w1, "ep2_gloo": ep2}
    log("phase 18 (b) moe train ep 2, two ranks over gloo:", json.dumps(ep2))
    RESULTS["moe_train"] = res
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks), "18 (b): ranks differ")
    check(rel <= HYBRID_BF16_LOSS_RTOL, f"18 (b): ep 2 losses {ranks[0]['losses']} vs world "
          f"size 1 {losses[:MOE_EP_STEPS]}")
    check(all(g < peak_gb for g in ep2["max_memory_allocated_gb"]),
          f"18 (b): per-rank peak {ep2['max_memory_allocated_gb']} not below world size 1's "
          f"{peak_gb}")
    check(ranks[0].get("moe_parts") is not None and ranks[1].get("moe_parts") is None,
          "18 (b): the ep 2 run's rank 0, and only it, should be profiled")
    rank_want = path_counts("llama", MOE_LAYERS, MOE_EP_STEPS, False)
    check(all(r["launches"] == rank_want for r in ranks),
          f"18 (b): rank launches {ep2['launches']}, expected {rank_want}")
    want = _moe_moves_want(MOE_LAYERS, MOE_EP_STEPS, MOE_EP)
    check(all(r["moe_moves"] == want for r in ranks),
          f"18 (b): moves {ep2['moe_moves']}, expected {want}")


@contextlib.contextmanager
def _moe_decode_records(records):
    """For the length of a with block, every decode forward of the engine
    appends to ``records`` the one active row's router logits and choice
    at each layer and its next-token logits (requests sent one at a time:
    the row whose offset is not 0)."""
    import numpy as np

    from galvatron_tpu_torch.models import moe
    from galvatron_tpu_torch.serving import engine as engine_mod

    real_route, real_step = moe.route_top1, engine_mod.Engine._decode_step
    calls = []  # the router's calls of the decode forward being recorded

    def route(logits, capacity, **kw):
        r = real_route(logits, capacity, **kw)
        calls.append((logits.detach().float().cpu(), r.expert.cpu()))
        return r

    def step(self, tokens, offsets):
        calls.clear()
        out = real_step(self, tokens, offsets)
        row = int(np.nonzero(offsets)[0][0])
        records.append({"routes": [(lg[row], int(ex[row])) for lg, ex in calls],
                        "logits": out[row].copy()})
        return out

    with _patched(moe, route_top1=route), _patched(engine_mod.Engine, _decode_step=step):
        yield


def _moe_sequential(base, what):
    """Phase 6's prompts sent one at a time (so the engine's batches, and
    with them the MoE capacity drops, do not depend on timing), each with
    the records of its decode forwards; {prompt: (tokens, records)}."""
    out, records = {}, []
    with _moe_decode_records(records):
        for p in _serve_prompts():
            records.clear()
            code, r = _http(base + "/api", {"prompts": [p], "tokens_to_generate": 32,
                                            "temperature": 0.0})
            check(code == 200, f"{what}: {code} {r}")
            out[p] = (r["tokens"][0], list(records))
    return out


def _moe_margin_rule(n_prompt, a, b, what):
    """The margin rule for a switch-MoE model, whose hard routing turns a
    rounding difference into a different expert: two greedy runs of one
    prompt are equal up to their first difference, and the first
    discontinuity between the two, walking the decode forwards up to it,
    is a near-tie in the first run, within ``MARGIN_TOL`` of the rms of the
    logits it chose among: a router choice that differs (the two experts'
    router logits), or else the parted token (the two tokens' logits)."""
    (ta, ra), (tb, rb) = a, b
    check(ta[:n_prompt] == tb[:n_prompt], f"{what}: prompts differ")
    n = min(len(ta), len(tb))
    j = next((i for i in range(n_prompt, n) if ta[i] != tb[i]), None)
    if j is None:
        check(len(ta) == len(tb), f"{what}: {len(ta)} against {len(tb)} tokens")
        return {"equal": True, "first_difference": None}
    k = j - n_prompt  # generated token k comes from decode forward k - 1
    check(k >= 1, f"{what}: parted at the first generated token, which prefill gives")

    def near(logits, x, y, cause, **where):
        rms = float((logits.double() ** 2).mean() ** 0.5)
        gap = abs(float(logits[x]) - float(logits[y]))
        out = {"equal": False, "first_difference": k, "cause": cause, **where, "gap": gap,
               "rms": rms, "tolerance": MARGIN_TOL * rms}
        check(gap <= MARGIN_TOL * rms, f"{what}: parted at generated position {k} by a "
              f"{cause} gap of {gap} > {MARGIN_TOL} x rms {rms} ({where})")
        return out

    for step in range(k):
        for layer, ((la, ea), (_, eb)) in enumerate(zip(ra[step]["routes"],
                                                         rb[step]["routes"])):
            if ea != eb:
                return near(la, ea, eb, "router", decode_forward=step, layer=layer)
    import torch

    return near(torch.from_numpy(ra[k - 1]["logits"]), ta[j], tb[j], "token")


def phase_moe_serve(torch, smi):
    """18 (c): ``cli serve`` of the MoE model (llama-7b width, 8 experts, 4
    layers) on the paged backend: phase 6's prompts one at a time, then its
    concurrent drive; then a server with the paged kernel's plain version
    in its place, the same prompts one at a time, held to the kernel's by
    the MoE margin rule (:func:`_moe_margin_rule`)."""
    from galvatron_tpu_torch.models import generation
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer
    from galvatron_tpu_torch.ops import flash_attention as fa

    def argv():
        return ["serve", "--model_size", "llama-7b", "--num_layers", str(MOE_SERVE_LAYERS),
                "--moe_experts", str(MOE_EXPERTS), "--kv_num_blocks", "-1", "--num_slots", "4",
                "--prefill_chunk", "32", "--port", _free_port(), "--request_ttl_s", "600"]

    t0 = time.perf_counter()
    seq = {}
    res, _, _ = _drive_serve(torch, smi, argv(), "18 (c)", MOE_SERVE_LAYERS, "paged",
                             before=lambda base: seq.update(kernel=_moe_sequential(
                                 base, "18 (c)")))
    with _patched(generation, paged_decode_attention=fa.paged_decode_attention_plain):
        plain, _, _ = _drive_serve(torch, smi, argv(), "18 (c) plain", MOE_SERVE_LAYERS,
                                   "paged", plain=True,
                                   before=lambda base: seq.update(plain=_moe_sequential(
                                       base, "18 (c) plain")))
    tok = ByteTokenizer()
    against = {f"{len(p)} bytes": _moe_margin_rule(len(tok.encode(p)), seq["kernel"][p],
                                                   seq["plain"][p], f"18 (c) {len(p)} bytes")
               for p in seq["kernel"]}
    res = {"card": smi, "model": "llama-7b width, 8 experts", **{
        k: v for k, v in res.items() if k != "card"},
        "plain": {k: plain[k] for k in ("decode_step_ms_mean", "tokens_per_s", "ttft_p50_s")},
        "against_plain": against, "seconds": time.perf_counter() - t0}
    log("phase 18 (c) moe serve:", json.dumps(res))
    RESULTS["moe_serve"] = res
    return res["kernel_launches"]


def phase_moe_search(torch, smi, tmpdir):
    """18 (d): ``cli profile`` of (a)'s model, ``cli search --enable_ep 1``
    for two devices on that profile, and ``check-plan``; the plan must split
    the experts (ep > 1). Returns its path: (a) trains it."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.utils.config_utils import load_profiled_model

    a = MOE_FP32
    model = _moe_model(a["seq"], small=True, layers=a["layers"])
    t0 = time.perf_counter()
    prefix = os.path.join(tmpdir, "profile_moe")
    gc.collect()
    torch.cuda.empty_cache()
    rc, _ = _cli(["profile", *model, "--profile_batch_size", str(MOE_PROFILE_BATCH),
                  "--output_prefix", prefix])
    check(rc == 0, f"18 (d): cli profile returned {rc}")
    lt = load_profiled_model(prefix + "_computation.json",
                             prefix + "_memory.json").layer_types[0]
    check(0.0 < lt.moe_expert_param_fraction < 1.0 and lt.moe_a2a_mb_per_sample > 0,
          f"18 (d): profile {lt}")
    plan = os.path.join(tmpdir, "moe_searched.json")
    rc, _ = _cli(["search", *model, "--num_devices", "2", "--settle_bsz", str(a["batch"]),
                  "--memory_constraint_gb", "40", "--mixed_precision", "fp32", "--enable_ep",
                  "1", "--time_profile_path", prefix + "_computation.json",
                  "--memory_profile_path", prefix + "_memory.json",
                  "--hardware_profile_path", REFERENCE_HW, "--output_config_path", plan])
    check(rc == 0, f"18 (d): cli search returned {rc}")
    rc, _ = _cli(["check-plan", plan])
    check(rc == 0, f"18 (d): check-plan returned {rc}")
    hp = HybridParallelConfig.load(plan)
    res = {"card": smi, "profile": {"fwd_ms_per_sample": lt.fwd_ms_per_sample,
                                    "moe_expert_param_fraction": lt.moe_expert_param_fraction,
                                    "moe_expert_time_fraction": lt.moe_expert_time_fraction,
                                    "moe_a2a_mb_per_sample": lt.moe_a2a_mb_per_sample},
           "plan": hp.to_json_dict(), "seconds": time.perf_counter() - t0}
    log("phase 18 (d) moe profile, search:", json.dumps(res))
    RESULTS["moe_search"] = res
    check(any(s_.ep > 1 for s_ in hp.layer_strategies), f"18 (d): no ep in {hp.to_json_dict()}")
    return plan


def phase_moe(torch, smi):
    """Phase 18: (d), whose plan (a) trains; (b)'s world size 1; (a), whose
    pair of rank processes then makes (b)'s ep 2 run (one start for both);
    (b)'s ep 2 checks; (c). Returns (b)'s world-1 launches and (c)'s paged
    launches."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmpdir:
        gc.collect()
        torch.cuda.empty_cache()
        plan2 = phase_moe_search(torch, smi, tmpdir)
        w1 = phase_moe_train(torch, smi, tmpdir)
        ranks = phase_moe_fp32(torch, smi, tmpdir, plan2, _moe_ep2_argv(tmpdir))
        phase_moe_ep2(torch, smi, w1, ranks)
        gc.collect()
        torch.cuda.empty_cache()
        serve_launches = phase_moe_serve(torch, smi)
    return w1["launches"], serve_launches


# ---------------------------------------------------------------------------
# 19: packed sequences; 20: the TP / gradient overlap plan fields
# ---------------------------------------------------------------------------

PACKED = dict(layers=2, batch=8, seq=2048)  # llama-7b width
PACKED_STEPS = 6
# (b)'s corpus: document lengths uniform on [100, 1100] (mean 600), token ids
# Zipf-distributed over the first PACKED_DRAW ids, so the loss can fall in 6 steps
PACKED_DOC_LENGTHS = (100, 1101)
PACKED_DRAW = 4096
PACKED_DOCS = 240
# (a): the packed step against the unpacked one, same weights and batch:
# equal to the last bit expected; a launch that parts them is named and the
# step held to this relative difference instead
PACKED_RTOL = 1e-6
# the einsum attention's backward autograd nodes (its forward runs under the
# "packed.attention" profiler range)
PACKED_ATTN_NODES = ("BmmBackward0", "SoftmaxBackward0", "MaskedFillBackward0")
OVERLAP_STEPS = 2
# (a): fp32 at h 1024 (llama-0.3b width), 2 layers, batch 4 x 512
OVERLAP_FP32 = ("--model_size", "llama-0.3b", "--num_layers", "2", "--global_train_batch_size",
                "4", "--seq_length", "512", "--mixed_precision", "fp32")
OVERLAP_FP32_RTOL = 1e-6
# (b) / (c): bf16 at llama-7b width, 2 layers, batch 4 x 2048 (the model's
# flags, which search takes too, and the batch)
OVERLAP_BF16 = ("--model_size", "llama-7b", "--num_layers", "2", "--seq_length", "2048")
OVERLAP_BF16_BATCH = 4
OVERLAP_BF16_RTOL = 1e-4
# 20b: the searched plan over NCCL on two cards, on / off / on, this many steps each
OVERLAP_NCCL_STEPS = 6


def _packed_corpus(tmpdir, vocab):
    """(b)'s seeded corpus, written with the port's ``write_indexed_dataset``."""
    import numpy as np

    from galvatron_tpu_torch.core.data import write_indexed_dataset

    rng = np.random.RandomState(19)
    docs = [np.minimum(rng.zipf(1.2, rng.randint(*PACKED_DOC_LENGTHS)), PACKED_DRAW) - 1
            for _ in range(PACKED_DOCS)]
    prefix = os.path.join(tmpdir, "packed_corpus")
    write_indexed_dataset(prefix, docs, vocab)
    return prefix, [len(d) for d in docs]


def phase_packed_parity(torch, smi):
    """19 (a): one step of the packed runtime on trivially packed rows (one
    full-row document a row) against one step of the unpacked runtime on the
    same tokens, from the same weights: loss and updated parameters equal
    (or, where a launch parts them, named and within ``PACKED_RTOL``); then
    one profiled packed step: how much of it the einsum attention takes."""
    from torch.profiler import ProfilerActivity, profile

    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    a = PACKED
    cfg = modeling.PRESETS["llama-7b"].replace(num_layers=a["layers"], fused_norm=True,
                                               attn_impl="xla")
    g = torch.Generator(device="cuda").manual_seed(19)
    tokens = torch.randint(0, cfg.vocab_size, (a["batch"], a["seq"] + 1), generator=g,
                           device="cuda")
    packed = torch.cat([tokens, torch.ones_like(tokens)], dim=1)
    t0 = time.perf_counter()
    runs = {}
    for name, c, batch in (("unpacked", cfg, tokens),
                           ("packed", cfg.replace(pack_sequences=True), packed)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rt = build_runtime(c, global_batch_size=a["batch"], seq_len=a["seq"],
                           mixed_precision="bf16", device="cuda")
        state = rt.init_state(1234)
        reset_kernel_counts()
        state, loss = rt.train_step(state, batch)
        torch.cuda.synchronize()
        runs[name] = {"loss": float(loss), "launches": kernel_counts(),
                      "params": [p.detach().clone() for p in tree_leaves(state["params"])],
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name == "packed":
            real = modeling.attention

            def ranged(*args, **kw):
                with torch.profiler.record_function("packed.attention"):
                    return real(*args, **kw)

            state, _ = rt.train_step(state, batch)  # one more warm step
            torch.cuda.synchronize()
            modeling.attention = ranged
            try:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    state, _ = rt.train_step(state, batch)
                    torch.cuda.synchronize()
            finally:
                modeling.attention = real
            attn_us = 0.0
            for e in prof.events():
                node = e.name.split("evaluate_function: ")[-1]
                if e.name == "packed.attention" or (
                        "evaluate_function: " in e.name and node in PACKED_ATTN_NODES):
                    dev = getattr(e, "device_time_total", None)
                    attn_us += e.cuda_time_total if dev is None else dev
            busy_us = _union_us(_kernel_intervals(prof))
            runs[name]["profile"] = {"device_busy_ms": busy_us / 1e3,
                                     "attention_ms": attn_us / 1e3,
                                     "attention_share": attn_us / busy_us if busy_us else None}
        del state, rt
    u, p = runs["unpacked"], runs["packed"]
    parted = [i for i, (x, y) in enumerate(zip(u["params"], p["params"])) if not torch.equal(x, y)]
    worst = max((float(((x - y).abs().max() / y.abs().max().clamp_min(1e-30)))
                 for x, y in zip(u["params"], p["params"])), default=0.0)
    res = {"card": smi, **a, "dtype": "bfloat16", "fused_norm": True, "attn_impl": "xla",
           "loss_unpacked": u["loss"], "loss_packed": p["loss"],
           "bit_equal": u["loss"] == p["loss"] and not parted, "parted_leaves": parted,
           "param_max_rel_diff": worst, "launches": p["launches"],
           "launches_unpacked": u["launches"], "peak_gb": p["peak_gb"],
           "profile": p["profile"], "seconds": time.perf_counter() - t0}
    for r in runs.values():
        r.pop("params")
    log("phase 19 (a) packed against unpacked:", json.dumps(res))
    RESULTS["packed_parity"] = res
    want = path_counts("llama", a["layers"], 1, True)
    want.update(flash_fwd=0, flash_bwd=0)  # the einsum attention: no flash launch
    check(p["launches"] == want and u["launches"] == want,
          f"19 (a): launches {p['launches']} / {u['launches']}, expected {want}")
    if not res["bit_equal"]:
        # not equal to the last bit: the leaves that parted are named above
        check(_rel(p["loss"], u["loss"]) <= PACKED_RTOL and worst <= PACKED_RTOL,
              f"19 (a): packed {p['loss']} vs unpacked {u['loss']}, parameters {worst} "
              f"(leaves {parted})")


def phase_packed_train(torch, smi, tmpdir):
    """19 (b): ``cli train --pack_sequences 1`` on a seeded corpus (through
    ``trainer.train`` for ``fused_norm=True``), 6 steps: the loss falls;
    then the same first step with the segment mask dropped must give another
    loss. Returns the run's launches."""
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.models import modeling

    a = PACKED
    prefix, lengths = _packed_corpus(tmpdir, modeling.PRESETS["llama-7b"].vocab_size)
    path = os.path.join(tmpdir, "packed_metrics.jsonl")
    argv = ["--model_size", "llama-7b", "--num_layers", str(a["layers"]), "--train_iters",
            str(PACKED_STEPS), "--data_path", prefix, "--pack_sequences", "1",
            "--global_train_batch_size", str(a["batch"]), "--metrics_path", path]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ns = initialize_galvatron("train", argv)
    reset_kernel_counts()  # the main path's counts start here
    out = trainer.train(ns, cfg=model_config_from_args(ns).replace(fused_norm=True))
    launches = kernel_counts()  # read right after the main path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del out
    losses, recs = _train_losses(path)
    # the control: the same first step with the segment mask dropped
    real = modeling.attention_xla

    def unmasked(q, k, v, cfg, q_offset, seg_ids=None, bias=None):
        return real(q, k, v, cfg, q_offset, bias=bias)

    modeling.attention_xla = unmasked
    try:
        cpath = os.path.join(tmpdir, "packed_control.jsonl")
        cns = initialize_galvatron("train", [*argv[:4], "--train_iters", "1", *argv[6:-1],
                                             cpath])
        trainer.train(cns, cfg=model_config_from_args(cns).replace(fused_norm=True))
    finally:
        modeling.attention_xla = real
    control = _train_losses(cpath)[0]
    steady = recs[1:]
    mean = lambda key: sum(r[key] for r in steady) / len(steady)  # noqa: E731
    res = {"card": smi, **a, "steps": PACKED_STEPS, "docs": len(lengths),
           "doc_tokens_mean": sum(lengths) / len(lengths), "losses": losses,
           "control_first_loss": control[0], "iter_ms_mean_from_2": mean("iter_ms"),
           "iter_ms": [r["iter_ms"] for r in recs], "tokens_per_s": mean("tokens_per_s"),
           "tokens_per_s_raw": mean("tokens_per_s_raw"),
           "packing_efficiency": [r["packing_efficiency"] for r in recs],
           "mfu": mean("mfu"), "max_memory_allocated_gb": peak_gb, "launches": launches,
           "seconds": time.perf_counter() - t0}
    log("phase 19 (b) cli train --pack_sequences 1:", json.dumps(res))
    RESULTS["packed_train"] = res
    want = path_counts("llama", a["layers"], PACKED_STEPS, True)
    want.update(flash_fwd=0, flash_bwd=0)
    check(launches == want, f"19 (b): launches {launches}, expected {want}")
    check(all(0.0 < e < 1.0 for e in res["packing_efficiency"]),
          f"19 (b): packing efficiency {res['packing_efficiency']}")
    check(losses[-1] < losses[0], f"19 (b): the loss did not fall: {losses}")
    check(control[0] != losses[0],
          f"19 (b): dropping the segment mask left the first loss at {losses[0]}")
    return launches


def phase_packed(torch, smi):
    """Phase 19: (a), then (b); returns (b)'s launches."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_packed_") as tmpdir:
        phase_packed_parity(torch, smi)
        return phase_packed_train(torch, smi, tmpdir)


def _overlap_off(src, dst):
    """The plan ``src`` with every layer's tp_overlap off, at ``dst``."""
    with open(src) as f:
        plan = json.load(f)
    plan["tp_overlap_flags"] = ",".join("0" for _ in plan["tp_overlap_flags"].split(","))
    with open(dst, "w") as f:
        json.dump(plan, f)


def _overlap_plans(tmpdir):
    """20 (c)'s search: ``cli search --enable_tp_overlap 1`` for two devices
    at (b)'s shape (analytic costs) and ``check-plan``; the plan must run a
    tp 2 + SP overlap layer. Returns (the plan, its overlap-off twin, the
    plan's config)."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    plan = os.path.join(tmpdir, "overlap_searched.json")
    rc, _ = _cli(["search", *OVERLAP_BF16, "--num_devices", "2", "--settle_bsz",
                  str(OVERLAP_BF16_BATCH), "--memory_constraint_gb", "40", "--enable_tp_overlap",
                  "1", "--analytic_costs", "1", "--output_config_path", plan])
    check(rc == 0, f"20 (c): cli search returned {rc}")
    rc, _ = _cli(["check-plan", plan])
    check(rc == 0, f"20 (c): check-plan returned {rc}")
    hp = HybridParallelConfig.load(plan)
    check(any(s_.tp_overlap and s_.tp == 2 and s_.sp for s_ in hp.layer_strategies),
          f"20 (c): the searched plan runs no tp 2 + SP overlap layer: {hp.to_json_dict()}")
    plan_off = os.path.join(tmpdir, "overlap_searched_off.json")
    _overlap_off(plan, plan_off)
    return plan, plan_off, hp


def phase_overlap_nccl(torch, smi, tmpdir, plan, plan_off):
    """20b: the searched plan over NCCL on cards 0 and 1, on, off, on
    (``OVERLAP_NCCL_STEPS`` steps each, one pair of rank processes): losses
    within ``OVERLAP_BF16_RTOL`` of off, ring hops only when on; iter_ms of
    each (the overlap's worth: the hops run beside the GEMMs there)."""
    t0 = time.perf_counter()
    bf16 = [*OVERLAP_BF16, "--global_train_batch_size", str(OVERLAP_BF16_BATCH),
            "--train_iters", str(OVERLAP_NCCL_STEPS)]
    names = ("on", "off", "on_again")
    argvs = [[*bf16, "--galvatron_config_path", plan_off if n == "off" else plan]
             for n in names]
    outdir = os.path.join(tmpdir, "overlap_nccl_ranks")
    runs = dict(zip(names, _launch_rank_runs(argvs, outdir, "nccl", (0, 1))))
    steady = lambda r: sum(r["iter_times"][1:]) / len(r["iter_times"][1:])  # noqa: E731
    res = {"card": smi, "steps": OVERLAP_NCCL_STEPS, "cards": 2,
           "losses": {n: rs[0]["losses"] for n, rs in runs.items()},
           "iter_ms_from_2": {n: [steady(r) for r in rs] for n, rs in runs.items()},
           "hops": {n: [r["hops"] for r in rs] for n, rs in runs.items()},
           "peak_gb": {n: [r["max_memory_allocated_gb"] for r in rs] for n, rs in runs.items()},
           "seconds": time.perf_counter() - t0}
    log("phase 20b overlap over nccl on two cards:", json.dumps(res))
    RESULTS["overlap_nccl"] = res
    losses = res["losses"]
    check(max(_rel(x, y) for x, y in zip(losses["on"], losses["off"])) <= OVERLAP_BF16_RTOL,
          f"20b: tp_overlap {losses['on']} vs off {losses['off']}")
    check(all((h > 0) == (n != "off") for n in names for h in res["hops"][n]),
          f"20b: ring hops {res['hops']}")


def phase_overlap(torch, smi, run_gloo=True, run_nccl=False):
    """Phase 20 (gloo on card 0) and 20b (NCCL on cards 0 and 1): the
    search of :func:`_overlap_plans`, then one pair of rank processes
    sharing card 0 over gloo runs, one after another: (a) fp32 tp 2 + SP
    with ``--global_tp_overlap`` on and off (losses within
    ``OVERLAP_FP32_RTOL``), dp 2 zero2 with ``--grad_overlap`` on and off
    (losses equal to the last bit, every bucket issued by the backward);
    (b) / (c) the searched plan (tp 2 + SP + tp_overlap, bf16) and the same
    plan with tp_overlap off (losses within ``OVERLAP_BF16_RTOL``, each
    rank's blocked flash launches at 16 heads on the TMA route). Returns the
    searched plan's rank-0 launches (None without the gloo runs)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_overlap_") as tmpdir:
        t0 = time.perf_counter()
        plan, plan_off, hp = _overlap_plans(tmpdir)
        if run_nccl and torch.cuda.device_count() >= 2:
            phase_overlap_nccl(torch, smi, tmpdir, plan, plan_off)
        elif run_nccl:
            log(f"phase 20b, overlap over nccl on two cards: absent "
                f"({torch.cuda.device_count()} card)")
            RESULTS["overlap_nccl"] = "absent: one card"
        if not run_gloo:
            return None
        steps = ["--train_iters", str(OVERLAP_STEPS)]
        tp = ["--global_tp_deg", "2", "--sequence_parallel", "1"]
        z2 = ["--default_dp_type", "zero2"]
        bf16 = [*OVERLAP_BF16, "--global_train_batch_size", str(OVERLAP_BF16_BATCH), *steps]
        argvs = {"fp32_tp_overlap": [*OVERLAP_FP32, *steps, *tp, "--global_tp_overlap", "1"],
                 "fp32_tp": [*OVERLAP_FP32, *steps, *tp],
                 "fp32_zero2_grad_overlap": [*OVERLAP_FP32, *steps, *z2, "--grad_overlap", "1"],
                 "fp32_zero2": [*OVERLAP_FP32, *steps, *z2],
                 "bf16_searched": [*bf16, "--galvatron_config_path", plan],
                 "bf16_searched_off": [*bf16, "--galvatron_config_path", plan_off]}
        outdir = os.path.join(tmpdir, "overlap_ranks")
        runs = dict(zip(argvs, _launch_rank_runs(list(argvs.values()), outdir, "gloo", (0, 0))))
    losses = {n: rs[0]["losses"] for n, rs in runs.items()}
    worst = lambda a_, b_: max(_rel(x, y) for x, y in zip(losses[a_], losses[b_]))  # noqa: E731
    flash = {n: [r["launches"]["flash_fwd"] for r in rs] + [r["launches"]["flash_bwd"]
                                                            for r in rs]
             for n, rs in runs.items()}
    steady = lambda r: sum(r["iter_times"][1:]) / len(r["iter_times"][1:])  # noqa: E731
    res = {"card": smi, "steps": OVERLAP_STEPS, "plan": hp.to_json_dict(), "losses": losses,
           "fp32_tp_rel_diff": worst("fp32_tp_overlap", "fp32_tp"),
           "bf16_rel_diff": worst("bf16_searched", "bf16_searched_off"),
           "hops": {n: [r["hops"] for r in rs] for n, rs in runs.items()},
           "buckets": [r["stats"].get("buckets") for r in runs["fp32_zero2_grad_overlap"]],
           "iter_ms_from_2": {n: [steady(r) for r in rs] for n, rs in runs.items()},
           "flash_launches": flash, "heads": {n: rs[0]["heads"] for n, rs in runs.items()},
           "host_staged": {n: [r["host_staged"] for r in rs] for n, rs in runs.items()},
           "peak_gb": {n: [r["max_memory_allocated_gb"] for r in rs] for n, rs in runs.items()},
           "seconds": time.perf_counter() - t0}
    log("phase 20 overlap:", json.dumps(res))
    RESULTS["overlap"] = res
    for n, rs in runs.items():
        check(all(r["losses"] == rs[0]["losses"] for r in rs), f"20: {n}: the ranks differ")
    check(res["fp32_tp_rel_diff"] <= OVERLAP_FP32_RTOL,
          f"20 (a): tp_overlap {losses['fp32_tp_overlap']} vs off {losses['fp32_tp']}")
    check(losses["fp32_zero2_grad_overlap"] == losses["fp32_zero2"],
          f"20 (a): grad_overlap {losses['fp32_zero2_grad_overlap']} vs off "
          f"{losses['fp32_zero2']}")
    check(all(b_ == {"backward": 2, "after": 0} for b_ in res["buckets"]),
          f"20 (a): buckets {res['buckets']} (2 layers, each issued by the backward)")
    check(res["bf16_rel_diff"] <= OVERLAP_BF16_RTOL,
          f"20 (b): tp_overlap {losses['bf16_searched']} vs off {losses['bf16_searched_off']}")
    for n in argvs:
        on = n in ("fp32_tp_overlap", "bf16_searched")  # the runs with ring seams
        check(all((h > 0) == on for h in res["hops"][n]), f"20: {n}: ring hops {res['hops'][n]}")
    layers = int(OVERLAP_BF16[3])
    for n in ("bf16_searched", "bf16_searched_off"):
        for r in runs[n]:
            want = layers * OVERLAP_STEPS
            check(r["launches"]["flash_fwd"] == want and r["launches"]["flash_bwd"] == want
                  and r["heads"]["flash_fwd"] == {"16": want}
                  and r["routes"]["flash_fwd"]["tma"] == want
                  and r["routes"]["flash_bwd"]["tma"] == want,
                  f"20 (b): {n}: launches {r['launches']}, heads {r['heads']}, "
                  f"routes {r['routes']}")
    return runs["bf16_searched"][0]["launches"]


# ---------------------------------------------------------------------------
# phase 21: HF import / export and ALiBi (Baichuan)
# ---------------------------------------------------------------------------

#: (a) / (b): (preset, layers, batch, seq, train steps) of the round trips
HF_LLAMA = ("llama-7b", 2, 4, 2048, 2)
HF_GPT = ("gpt-1.5b", 2, 4, 1024, 2)
#: (c): baichuan-13b at full width, cut to 2 layers; its bf16 train steps
#: (batch x seq), the card-against-CPU batch, and the tp 2 run's batch and steps
BAICHUAN_LAYERS = 2
BAICHUAN_TRAIN = (4, 2048, 2)
BAICHUAN_CPU_BATCH = (2, 128)
BAICHUAN_TP = (1, 2048, 2)
#: fp32 logits of the same weights on the card and on the CPU (summation
#: order only: phase 4 holds 1e-3 at llama-7b width), and the loss
BAICHUAN_LOGIT_TOL = 1e-3
BAICHUAN_LOSS_RTOL = 1e-5
#: tp 2 over two gloo ranks against world size 1 (fp32), relative on the losses
BAICHUAN_TP_RTOL = 1e-5
#: .bin shards of the Baichuan directory (the published checkpoint is sharded)
BAICHUAN_SHARDS = 2
#: (d)'s depth: half of baichuan-13b's 40 layers, to keep the script inside its
#: time limit (the 40-layer serve read 56.0 / 63.7 ms a decode step)
BAICHUAN_SERVE_LAYERS = 20


def _rss_sampler():
    """(stop(), samples): this process's resident set size, sampled every
    10 ms on a thread from ``/proc/self/statm``, until ``stop()``."""
    page = os.sysconf("SC_PAGE_SIZE")
    samples, done = [], threading.Event()

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    def run():
        while not done.is_set():
            samples.append(rss())
            done.wait(0.01)

    samples.append(rss())
    t = threading.Thread(target=run, name="rss-sampler", daemon=True)
    t.start()

    def stop():
        done.set()
        t.join()
        samples.append(rss())
        return samples

    return stop, samples


def _safetensors_headers(d):
    """The phase's own read of an exported directory's safetensors headers
    (8-byte little-endian length, JSON): every tensor F32, the data
    offsets contiguous from 0 to the end of the file, the metadata
    ``format: pt``. Returns {name: (shape, bytes)} and the files' bytes."""
    import struct

    names = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
    check(names, f"no safetensors file under {d}")
    tensors, total = {}, 0
    for fn in names:
        path = os.path.join(d, fn)
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        size = os.path.getsize(path)
        total += size
        check(header.pop("__metadata__", {}).get("format") == "pt", f"{fn}: metadata")
        spans = sorted(tuple(v["data_offsets"]) for v in header.values())
        check(spans[0][0] == 0 and spans[-1][1] == size - 8 - n
              and all(a[1] == b[0] for a, b in zip(spans, spans[1:])),
              f"{fn}: data offsets do not tile the data section")
        for k, v in header.items():
            nbytes = v["data_offsets"][1] - v["data_offsets"][0]
            check(v["dtype"] == "F32" and nbytes == 4 * _prod(v["shape"]),
                  f"{fn}: {k}: {v}")
            tensors[k] = (tuple(v["shape"]), nbytes)
    return tensors, total


def _prod(shape):
    out = 1
    for d in shape:
        out *= d
    return out


#: the fields an imported config must carry over from the exported one
_SHAPE_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads", "kv_heads", "ffn",
                 "max_seq_len", "pos_embed", "norm_type", "act_fn", "tie_word_embeddings",
                 "use_bias", "norm_eps", "rope_theta")


def _same_shape(a, b, what):
    diff = {f: (getattr(a, f), getattr(b, f)) for f in _SHAPE_FIELDS
            if getattr(a, f) != getattr(b, f)}
    check(not diff, f"{what}: configs differ (got, want): {diff}")


def _bitwise(torch, a, b, what):
    """Two parameter trees equal to the last bit (CPU copies compared)."""
    from galvatron_tpu_torch.core.checkpoint import flatten

    fa_, fb = flatten(a), flatten(b)
    check(sorted(fa_) == sorted(fb), f"{what}: leaves differ: {sorted(set(fa_) ^ set(fb))}")
    bad = [k for k in fa_ if not torch.equal(fa_[k].detach().cpu(), fb[k].detach().cpu())]
    check(not bad, f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}")
    return len(fa_)


def _hf_round_trip(torch, smi, tmpdir, preset, layers, tag):
    """``cli export-hf`` of seed-0 weights (drawn on the card, as every cli
    mode draws them) at ``layers`` layers, the headers read back, then
    ``load_hf_checkpoint``: bitwise the exported parameters. Returns the
    directory and what was read."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.models.convert import load_hf_checkpoint

    d = os.path.join(tmpdir, f"hf_{tag}")
    cfg = modeling.PRESETS[preset].replace(num_layers=layers)
    t0 = time.perf_counter()
    rc = cli.main(["export-hf", "--model_size", preset, "--num_layers", str(layers),
                   "--output_dir", d])
    export_s = time.perf_counter() - t0
    check(rc == 0, f"21 ({tag}): cli export-hf returned {rc}")
    tensors, nbytes = _safetensors_headers(d)
    with open(os.path.join(d, "config.json")) as f:
        hf_cfg = json.load(f)
    t0 = time.perf_counter()
    params, got_cfg = load_hf_checkpoint(d)
    import_s = time.perf_counter() - t0
    want = modeling.init_model_params(cfg, 0, "cuda")
    n = _bitwise(torch, params, want, f"21 ({tag}) export → import")
    _same_shape(got_cfg, cfg, f"21 ({tag}) export → import")
    del params, want
    gc.collect()
    torch.cuda.empty_cache()
    return d, {"model": preset, "layers": layers, "model_type": hf_cfg["model_type"],
               "files": sorted(os.listdir(d)), "tensors": len(tensors), "bytes": nbytes,
               "export_s": export_s, "export_gb_per_s": nbytes / export_s / 1e9,
               "import_s": import_s, "import_gb_per_s": nbytes / import_s / 1e9,
               "bitwise_leaves": n}


def _train_hf(torch, tmpdir, d, batch, seq, steps, tag, precision="bf16"):
    """``cli train --load_hf d`` in this process; (records, launches, peak GB)."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.utils.metrics import read_metrics

    path = os.path.join(tmpdir, f"train_{tag}.jsonl")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()  # the main path's counts start here
    routes_before = route_counts()
    rc = cli.main(["train", "--load_hf", d, "--seq_length", str(seq), "--global_train_batch_size",
                   str(batch), "--train_iters", str(steps), "--mixed_precision", precision,
                   "--metrics_path", path])
    launches = kernel_counts()  # read right after the main path
    check(rc == 0, f"21 ({tag}): cli train --load_hf returned {rc}")
    routes = {k: {r: n - routes_before[k][r] for r, n in v.items()}
              for k, v in route_counts().items()}
    recs = [r for r in read_metrics(path) if r["event"] == "train_iter"]
    check(len(recs) == steps and all(r["loss"] == r["loss"] and abs(r["loss"]) < 1e9
                                     for r in recs), f"21 ({tag}): records {recs}")
    return recs, launches, routes, torch.cuda.max_memory_allocated() / 1e9


def _hf_serve_against_generate_np(torch, smi, d, layers):
    """21 (a): ``cli serve --load_hf d`` on the paged backend driven as phase
    6; every prompt's greedy tokens held to ``generate_np`` on the served
    weights (equal, or by the margin rule where bf16 runs through other
    code part)."""
    from galvatron_tpu_torch.models import generation
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer

    argv = ["serve", "--load_hf", d, "--kv_num_blocks", "-1", "--num_slots", "4",
            "--prefill_chunk", "32", "--port", _free_port(), "--request_ttl_s", "600"]
    res, tokens, (params, cfg) = _drive_serve(torch, smi, argv, "21 (a) serve", layers, "paged")
    tok = ByteTokenizer()
    want = {p: generation.generate_np(params, cfg, [tok.encode(p)], max_new_tokens=32,
                                      eos_id=tok.eos_id, pad_id=tok.pad_id)[0] for p in tokens}
    res["against_generate_np"] = _margins(torch, params, cfg, want, tokens,
                                          "21 (a) serve against generate_np")
    res["tokens_equal_generate_np"] = all(want[p] == tokens[p] for p in tokens)
    del params, cfg
    return res


def _baichuan_dir(torch, d, cfg, seed):
    """A Baichuan-1 (13B-style) checkpoint directory written as the
    published one is laid out: ``config.json`` with ``model_type``
    'baichuan' and ``model_max_length`` (ALiBi), the fused ``W_pack``
    [Q; K; V] rows, bf16 torch ``.bin`` shards and their index. The weights
    are ``init_model_params(cfg, seed)`` drawn on the card; returns their
    bf16 rounding as the tree the import must give, and the bytes written."""
    from galvatron_tpu_torch.models import modeling

    os.makedirs(d)
    p = modeling.init_model_params(cfg, seed, "cuda")
    h, nd, f = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.ffn

    def bf(t):
        return t.detach().to(torch.bfloat16).cpu().contiguous()

    sd = {"model.embed_tokens.weight": bf(p["embed"]["tok"]),
          "model.norm.weight": bf(p["final_norm"]["scale"]),
          "lm_head.weight": bf(p["head"]["w"].t())}
    for i, lp in enumerate(p["layers"]):
        pre = f"model.layers.{i}."
        w13 = lp["mlp"]["w13"]
        sd.update({pre + "self_attn.W_pack.weight": bf(lp["attn"]["wqkv"].reshape(h, 3 * nd).t()),
                   pre + "self_attn.o_proj.weight": bf(lp["attn"]["wo"].t()),
                   pre + "mlp.gate_proj.weight": bf(w13[:, :f].t()),
                   pre + "mlp.up_proj.weight": bf(w13[:, f:].t()),
                   pre + "mlp.down_proj.weight": bf(lp["mlp"]["w2"].t()),
                   pre + "input_layernorm.weight": bf(lp["attn_norm"]["scale"]),
                   pre + "post_attention_layernorm.weight": bf(lp["mlp_norm"]["scale"])})
    want = {"embed": {"tok": p["embed"]["tok"]}, "layers": p["layers"],
            "final_norm": p["final_norm"], "head": p["head"]}
    want = _bf16_tree(torch, want)
    del p
    names = sorted(sd)
    weight_map, nbytes = {}, 0
    for j in range(BAICHUAN_SHARDS):
        fn = f"pytorch_model-{j + 1:05d}-of-{BAICHUAN_SHARDS:05d}.bin"
        part = {k: sd[k] for k in names[j::BAICHUAN_SHARDS]}
        torch.save(part, os.path.join(d, fn))
        weight_map.update({k: fn for k in part})
        nbytes += os.path.getsize(os.path.join(d, fn))
    with open(os.path.join(d, "pytorch_model.bin.index.json"), "w") as fh:
        json.dump({"metadata": {"total_size": sum(t.numel() * 2 for t in sd.values())},
                   "weight_map": weight_map}, fh)
    with open(os.path.join(d, "config.json"), "w") as fh:
        json.dump({"model_type": "baichuan", "architectures": ["BaichuanForCausalLM"],
                   "vocab_size": cfg.vocab_size, "hidden_size": h,
                   "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                   "intermediate_size": f, "model_max_length": cfg.max_seq_len,
                   "rms_norm_eps": cfg.norm_eps, "tie_word_embeddings": False,
                   "hidden_act": "silu", "torch_dtype": "bfloat16"}, fh)
    return want, nbytes


def _bf16_tree(torch, tree):
    """Every leaf rounded to bf16 and widened back to fp32, on the CPU."""
    if isinstance(tree, dict):
        return {k: _bf16_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_tree(torch, v) for v in tree]
    return tree.detach().to(torch.bfloat16).float().cpu()


def phase_hf_baichuan(torch, smi, tmpdir):
    """21 (c): the Baichuan-13B import at full width (2 layers), the card
    against the CPU, bf16 training, and tp 2 over two gloo ranks against
    world size 1 with its control."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.models.convert import load_hf_checkpoint
    from galvatron_tpu_torch.utils.metrics import read_metrics

    out = {}
    cfg = modeling.PRESETS["baichuan-13b"].replace(num_layers=BAICHUAN_LAYERS)
    d = os.path.join(tmpdir, "baichuan13b")
    t0 = time.perf_counter()
    want, nbytes = _baichuan_dir(torch, d, cfg, seed=13)
    write_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    stop, _ = _rss_sampler()
    t0 = time.perf_counter()
    params, got_cfg = load_hf_checkpoint(d)
    import_s = time.perf_counter() - t0
    rss = stop()
    _same_shape(got_cfg, cfg, "21 (c) import")
    check(got_cfg.pos_embed == "alibi", f"21 (c): imported pos_embed {got_cfg.pos_embed}")
    n = _bitwise(torch, params, want, "21 (c) the .bin shards' bf16 weights, widened")
    del want
    out["import"] = {"layers": BAICHUAN_LAYERS, "files": sorted(os.listdir(d)),
                     "bin_bytes": nbytes, "write_s": write_s, "import_s": import_s,
                     "import_gb_per_s": nbytes / import_s / 1e9, "bitwise_leaves": n,
                     "host_rss_before_gb": rss[0] / 1e9, "host_rss_peak_gb": max(rss) / 1e9,
                     "host_rss_after_gb": rss[-1] / 1e9, "pos_embed": got_cfg.pos_embed}
    # fp32 logits of the same weights on the card and on the CPU
    b, s = BAICHUAN_CPU_BATCH
    f32 = got_cfg.replace(dtype=torch.float32, attn_impl="flash")  # ALiBi keeps the einsum
    batch = torch.from_numpy(np.random.RandomState(13).randint(
        0, cfg.vocab_size, (b, s + 1))).long()
    def loss(logits):
        nll, count = modeling.cross_entropy_sum(logits, batch[:, 1:])
        return float(nll / count)

    with torch.inference_mode():
        cpu_logits = modeling.forward(params, batch[:, :-1], f32)
        dev = _to(params, "cuda")
        reset_kernel_counts()
        card_logits = modeling.forward(dev, batch[:, :-1].cuda(), f32).cpu()
        check(not any(kernel_counts().values()),
              f"21 (c): attn_impl flash with ALiBi launched {kernel_counts()}")
        cpu_loss, card_loss = loss(cpu_logits), loss(card_logits)
    del dev, params
    err = float((card_logits - cpu_logits).abs().max())
    rms = float(cpu_logits.pow(2).mean().sqrt())
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(err <= BAICHUAN_LOGIT_TOL and loss_rel <= BAICHUAN_LOSS_RTOL,
          f"21 (c): card against CPU: logits {err}, loss {card_loss} vs {cpu_loss}")
    out["card_against_cpu"] = {"batch": [b, s], "dtype": "float32", "logits_max_abs_err": err,
                               "logits_rms": rms, "tolerance": BAICHUAN_LOGIT_TOL,
                               "loss_card": card_loss, "loss_cpu": cpu_loss,
                               "loss_rel_err": loss_rel, "loss_rtol": BAICHUAN_LOSS_RTOL}
    del cpu_logits, card_logits
    gc.collect()
    torch.cuda.empty_cache()
    # bf16 training from the directory
    tb, ts, steps = BAICHUAN_TRAIN
    recs, launches, routes, peak = _train_hf(torch, tmpdir, d, tb, ts, steps, "c")
    check(not any(launches.values()), f"21 (c): ALiBi launched flash kernels {launches}")
    out["train_bf16"] = {"batch": tb, "seq": ts, "steps": steps,
                         "losses": [r["loss"] for r in recs],
                         "iter_ms": [r["iter_ms"] for r in recs],
                         "iter_ms_mean_from_2": sum(r["iter_ms"] for r in recs[1:]) / (steps - 1),
                         "tokens_per_s": recs[-1]["tokens_per_s"], "max_memory_allocated_gb": peak,
                         "launches": launches}
    # tp 2 over two gloo ranks on the card against world size 1, fp32
    b2, s2, steps2 = BAICHUAN_TP
    argv = ["--load_hf", d, "--seq_length", str(s2), "--global_train_batch_size", str(b2),
            "--train_iters", str(steps2), "--mixed_precision", "fp32"]
    path = os.path.join(tmpdir, "train_c_world1.jsonl")
    from galvatron_tpu_torch import cli

    gc.collect()
    torch.cuda.empty_cache()
    check(cli.main(["train", *argv, "--metrics_path", path]) == 0, "21 (c): world 1 run")
    ref = [r["loss"] for r in read_metrics(path) if r["event"] == "train_iter"]
    gc.collect()
    torch.cuda.empty_cache()

    def run(control):
        outdir = os.path.join(tmpdir, f"baichuan_tp2_{control}")
        os.makedirs(outdir)
        extra = ("--control", control) if control else ()
        return _launch_ranks(argv + ["--global_tp_deg", "2", "--vocab_tp", "2"], outdir, "gloo",
                             (0, 0), extra)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # the sound run and its control, two worlds at once
        ranks, crs = pool.map(run, (None, "first_slopes"))
    tp_s = time.perf_counter() - t0
    rel = max(abs(x - y) / abs(y) for x, y in zip(ranks[0]["losses"], ref))
    crel = max(abs(x - y) / abs(y) for x, y in zip(crs[0]["losses"], ref))
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks), "21 (c): tp ranks differ")
    check(rel <= BAICHUAN_TP_RTOL, f"21 (c): tp 2 losses {ranks[0]['losses']} vs world 1 {ref}")
    check(crel > BAICHUAN_TP_RTOL,
          f"21 (c): the control (every rank the first n/tp slopes) passes: {crs[0]['losses']}")
    out["tp2_gloo"] = {"batch": b2, "seq": s2, "steps": steps2, "dtype": "float32",
                       "losses": ranks[0]["losses"], "world1_losses": ref,
                       "max_rel_loss_diff": rel, "rtol": BAICHUAN_TP_RTOL,
                       "control_first_slopes": {"losses": crs[0]["losses"],
                                                "max_rel_loss_diff": crel},
                       "host_staged": [r["host_staged"] for r in ranks],
                       "max_memory_allocated_gb": [r["max_memory_allocated_gb"] for r in ranks],
                       "seconds_both_worlds": tp_s}
    log("phase 21 (c) baichuan-13b import, 2 layers:", json.dumps({"card": smi, **out}))
    return out


def phase_hf_serve_13b(torch, smi):
    """21 (d): ``cli serve --model_size baichuan-13b`` (``BAICHUAN_SERVE_LAYERS``
    layers, bf16) on the slot backend, then the paged one: greedy tokens held across the
    backends (equal, or the margin rule), every paged decode step on the
    einsum route and no ``paged_decode`` launch."""
    from galvatron_tpu_torch.models import generation

    layers = BAICHUAN_SERVE_LAYERS
    runs, toks = {}, {}
    params = cfg = None
    for backend, extra in (("slot", []), ("paged", ["--kv_num_blocks", "-1"])):
        argv = ["serve", "--model_size", "baichuan-13b", "--num_layers", str(layers),
                "--num_slots", "4", "--prefill_chunk", "32", "--port", _free_port(),
                "--request_ttl_s", "600", *extra]
        params = cfg = None  # the slot run's weights go before the paged run loads its own
        gc.collect()
        generation.reset_decode_routes()
        # plain=True: ALiBi's decode never reaches the kernel (want 0 launches)
        runs[backend], toks[backend], (params, cfg) = _drive_serve(
            torch, smi, argv, f"21 (d) {backend}", layers, backend, plain=True)
        routes = dict(generation.decode_routes)  # read right after the main path
        runs[backend]["decode_routes"] = routes
        if backend == "paged":
            check(routes["paged_decode"] == 0
                  and routes["einsum"] == runs[backend]["decode_steps"] > 0,
                  f"21 (d): paged decode routes {routes}, "
                  f"{runs[backend]['decode_steps']} decode steps")
    res = {**runs, "tokens_equal": toks["slot"] == toks["paged"],
           "paged_against_slot": _margins(torch, params, cfg, toks["slot"], toks["paged"],
                                          "21 (d) paged against slot")}
    del params, cfg
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 21 (d) serve baichuan-13b, {layers} layers:", json.dumps(res))
    return res


def phase_hf(torch, smi):
    """Phase 21 (a)-(d); returns the launches of its main paths."""
    from galvatron_tpu_torch.ops import flash_attention as fa

    out, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hf_") as tmpdir:
        # (a) LLaMA round trip at llama-7b width, train, serve
        preset, layers, batch, seq, steps = HF_LLAMA
        t0 = time.perf_counter()
        d, rt = _hf_round_trip(torch, smi, tmpdir, preset, layers, "a")
        recs, tl, routes, peak = _train_hf(torch, tmpdir, d, batch, seq, steps, "a")
        want = path_counts("llama", layers, steps, False)
        check(tl == want and routes["flash_fwd"]["tma"] == want["flash_fwd"],
              f"21 (a): launches {tl}, expected {want}; routes {routes}")
        serve = _hf_serve_against_generate_np(torch, smi, d, layers)
        launches["a_train"], launches["a_paged_decode"] = tl, serve["kernel_launches"]
        check(serve["kernel_launches"] > 0, "21 (a): no paged_decode launch")
        out["a_llama"] = {"card": smi, "round_trip": rt, "train": {
            "batch": batch, "seq": seq, "losses": [r["loss"] for r in recs],
            "iter_ms": [r["iter_ms"] for r in recs], "max_memory_allocated_gb": peak,
            "launches": tl}, "serve": serve, "seconds": time.perf_counter() - t0}
        log("phase 21 (a) llama round trip:", json.dumps(out["a_llama"]))
        shutil.rmtree(d, ignore_errors=True)
        # (b) GPT-2 round trip at gpt-1.5b width, train on the grid kernels
        preset, layers, batch, seq, steps = HF_GPT
        t0 = time.perf_counter()
        d, rt = _hf_round_trip(torch, smi, tmpdir, preset, layers, "b")
        recs, tl, routes, peak = _train_hf(torch, tmpdir, d, batch, seq, steps, "b")
        want = path_counts("gpt", layers, steps, False)
        check(tl == want, f"21 (b): launches {tl}, expected {want}")
        launches["b_train"] = tl
        out["b_gpt"] = {"card": smi, "round_trip": rt, "train": {
            "batch": batch, "seq": seq, "losses": [r["loss"] for r in recs],
            "iter_ms": [r["iter_ms"] for r in recs], "max_memory_allocated_gb": peak,
            "launches": tl}, "seconds": time.perf_counter() - t0}
        log("phase 21 (b) gpt round trip:", json.dumps(out["b_gpt"]))
        shutil.rmtree(d, ignore_errors=True)
        # (c) Baichuan-13B import at full width
        t0 = time.perf_counter()
        out["c_baichuan13b"] = phase_hf_baichuan(torch, smi, tmpdir)
        out["c_baichuan13b"]["seconds"] = time.perf_counter() - t0
    # (d) baichuan-13b served at full depth on both backends
    t0 = time.perf_counter()
    fa.paged_decode_attention.launches = 0
    out["d_baichuan13b_serve"] = phase_hf_serve_13b(torch, smi)
    out["d_baichuan13b_serve"]["seconds"] = time.perf_counter() - t0
    launches["d_paged_decode"] = out["d_baichuan13b_serve"]["paged"]["kernel_launches"]
    RESULTS["hf"] = out
    RESULTS["hf_launches"] = launches
    return launches


# ---------------------------------------------------------------------------
# phase 22: the encoders (BERT masked-LM, ViT classification)
# ---------------------------------------------------------------------------

ENCODER_STEPS = 3
# (a) bert-large at full width and depth: (preset, batch, seq)
ENCODER_BERT = ("bert-large", 32, 512)
# (b) vit-large at full width and depth, fused norms: (preset, images)
ENCODER_VIT = ("vit-large", 64)
# (c) vit-huge at full width, 2 layers: head_dim 80, off the TMA route
ENCODER_HUGE = ("vit-huge", 2, 16)  # (preset, layers, bf16 images)
# card against CPU at fp32 ((a)'s 2-layer forward, (c)): the logits and
# the loss by phase 21 (c)'s bounds, each gradient tensor's largest
# difference over its largest CPU value
ENCODER_FP32 = dict(layers=2, batch=2)
ENCODER_LOGIT_TOL = 1e-3
ENCODER_LOSS_RTOL = 1e-5
ENCODER_GRAD_RTOL = 1e-3
# (d) the searched plan: bert-large at 4 layers, profiled at batch 8
ENCODER_SEARCH = dict(layers=4, batch=8, steps=2, budget_gb=40)
#: the reference's refusals of an encoder in serving and generation
ENCODER_REFUSALS = {
    "serve": "serving engine requires a decoder-only causal LM (same constraint as "
             "generation.generate)",
    "generate": "generation requires a decoder-only causal LM (encoder families train "
                "with objective='mlm'; enc-dec decode is not implemented)",
}
_GRID_KERNELS = ("flash_grid_fwd", "flash_grid_dkdv", "flash_grid_dq")


def _grid_modes():
    """The grid wrappers' launches by (batch, heads, sequence, mask)."""
    from galvatron_tpu_torch.ops import flash_attention as fa

    return {"flash_grid_fwd": dict(fa.flash_grid_fwd.modes),
            "flash_grid_dkdv": dict(fa.flash_grid_bwd_parts.dkv_modes),
            "flash_grid_dq": dict(fa.flash_grid_bwd_parts.dq_modes)}


def _encoder_train(torch, smi, tmpdir, tag, argv, fused, layers, mode, norms):
    """One main-path encoder run of ``ENCODER_STEPS`` steps: ``cli train``,
    or with the fused norms ``trainer.train`` with ``fused_norm=True`` (the
    field has no flag). Every grid kernel launched layers x steps times, all
    unmasked at ``mode`` ("b,h,s,unmasked") on the TMA route, the norm
    kernels ``norms`` (2 x layers + 1) x steps times, nothing else."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.utils.metrics import read_metrics

    path = os.path.join(tmpdir, f"train_metrics_{tag}.jsonl")
    argv = [*argv, "--train_iters", str(ENCODER_STEPS), "--metrics_path", path]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_kernel_counts()  # the main path's counts start here
    routes_before = route_counts()
    if fused:
        ns = initialize_galvatron("train", argv)
        del trainer.train(ns, cfg=model_config_from_args(ns).replace(fused_norm=True))["state"]
    else:
        check(cli.main(["train", *argv]) == 0, f"22 {tag}: cli train failed")
    launches, modes = kernel_counts(), _grid_modes()  # read right after the main path
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    recs = [r for r in read_metrics(path) if r["event"] == "train_iter"]
    losses = [r["loss"] for r in recs]
    check(len(recs) == ENCODER_STEPS and all(
        isinstance(x, float) and x == x and abs(x) != float("inf") for x in losses),
        f"22 {tag}: losses {losses}")
    n = layers * ENCODER_STEPS
    want = {k: n if k in _GRID_KERNELS else (2 * layers + 1) * ENCODER_STEPS if k in norms
            else 0 for k in launches}
    check(launches == want, f"22 {tag}: launches {launches}, expected {want}")
    check(all(m == {mode: n} for m in modes.values()),
          f"22 {tag}: grid launches by shape {modes}, expected {mode}: {n}")
    routes = _routes_since(routes_before)
    check(_all_tma(launches, routes), f"22 {tag}: routes {routes}")
    steady = recs[1:]
    mean = lambda key: sum(r[key] for r in steady) / len(steady)  # noqa: E731
    res = {"card": smi, "argv": argv[:-2], "fused_norm": fused, "steps": ENCODER_STEPS,
           "losses": losses, "iter_ms_mean_from_2": mean("iter_ms"),
           "iter_ms": [r["iter_ms"] for r in recs], "tokens_per_s": mean("tokens_per_s"),
           "mfu": mean("mfu"), "max_memory_allocated_gb": peak_gb,
           "launches": {k: v for k, v in launches.items() if v},
           "routes": {k: routes[k] for k in _GRID_KERNELS}, "grid_modes": modes,
           "seconds": seconds}
    log(f"phase 22 {tag}:", json.dumps(res))
    return launches, res


def _card_against_cpu(torch, cfg, batch, what, backward, phase="22",
                      tols=(ENCODER_LOGIT_TOL, ENCODER_LOSS_RTOL, ENCODER_GRAD_RTOL)):
    """The fp32 loss (and logits; with ``backward`` every gradient) of
    ``cfg`` on the card, its grid kernels on the CUDA-core route, against
    the CPU (their plain versions) from the same seed-0 weights; ``tols``
    the logits' (absolute), the loss's and the gradients' (relative)
    bounds."""
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling

    def run(dev):
        params = modeling.init_model_params(cfg, 0, "cpu")
        if dev != "cpu":
            params = _to(params, dev)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(backward)
        inputs, labels = modeling.split_batch(batch.to(dev), cfg)
        with torch.set_grad_enabled(backward):
            if cfg.enc_layers:
                e = cfg.enc_seq
                logits = modeling.forward_encdec(params, inputs[:, :e], inputs[:, e:], cfg)
            else:
                logits = (modeling.forward_vision if cfg.image_size else modeling.forward)(
                    params, inputs, cfg)
            s, n = modeling.cross_entropy_sum(logits, labels)
            loss = s / n
            if backward:
                loss.backward()
        # a leaf the loss does not reach (Swin's wo_b) has a zero gradient
        grads = [torch.zeros(p.shape) if p.grad is None else p.grad.cpu()
                 for p in leaves] if backward else []
        return logits.detach().cpu(), loss.item(), grads

    before, routes_before = kernel_counts(), route_counts()
    card = run("cuda")
    launches = _delta(kernel_counts(), before)
    routes = _routes_since(routes_before)
    cpu = run("cpu")
    logit_err = (card[0] - cpu[0]).abs().max().item()
    loss_rel = abs(card[1] - cpu[1]) / abs(cpu[1])
    grad_rel = max(((g - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
                   for g, c in zip(card[2], cpu[2])) if backward else None
    logit_tol, loss_tol, grad_tol = tols
    res = {"what": what, "layers": cfg.total_layers, "batch": int(batch.shape[0]),
           "loss_card": card[1], "loss_cpu": cpu[1], "loss_rel_err": loss_rel,
           "logits_max_abs_err": logit_err, "grad_max_rel_err": grad_rel,
           "bounds": {"logits_abs": logit_tol, "loss_rel": loss_tol,
                      "grad_rel": grad_tol if backward else None},
           "launches": {k: v for k, v in launches.items() if v},
           "routes": {k: routes[k] for k in _GRID_KERNELS}}
    log(f"phase {phase} {what}, card against CPU (fp32):", json.dumps(res))
    check(logit_err <= logit_tol, f"{phase} {what}: logits {logit_err} from the CPU's")
    check(loss_rel <= loss_tol, f"{phase} {what}: loss {card[1]} vs CPU {cpu[1]}")
    if backward:
        check(grad_rel <= grad_tol, f"{phase} {what}: gradients {grad_rel} from the CPU's")
    # every layer's self-attention; an encoder-decoder's cross-attention and
    # Swin's window attention are einsum
    want = {} if cfg.swin_depths else {"flash_grid_fwd": cfg.total_layers}
    if backward and not cfg.swin_depths:
        want.update(flash_grid_dkdv=cfg.total_layers, flash_grid_dq=cfg.total_layers)
    check(res["launches"] == want, f"{phase} {what}: launches {res['launches']}, expected {want}")
    check(all(routes[k]["cuda_core"] == want.get(k, 0) and routes[k]["tma"] == 0
              for k in _GRID_KERNELS), f"{phase} {what}: routes {routes} (fp32: CUDA cores)")
    return res


def phase_encoder(torch, smi):
    """Phase 22: BERT and ViT through the grid kernels unmasked (module
    docstring)."""
    import numpy as np

    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.utils.metrics import read_metrics

    out = {}
    rng = np.random.RandomState(22)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_encoder_") as tmpdir:
        # (a) bert-large, 24 layers, 32 x 512, bf16
        preset, bsz, seq = ENCODER_BERT
        layers = modeling.PRESETS[preset].num_layers
        heads = modeling.PRESETS[preset].num_heads
        launches, out["a_bert_large"] = _encoder_train(
            torch, smi, tmpdir, "(a) bert-large", ["--model_size", preset,
                                                   "--global_train_batch_size", str(bsz)],
            False, layers, f"{bsz},{heads},{seq},unmasked", ())
        cfg = modeling.PRESETS[preset].replace(num_layers=ENCODER_FP32["layers"],
                                               dtype=torch.float32, attn_impl="flash")
        batch = torch.from_numpy(rng.randint(0, cfg.vocab_size - 1,
                                             (ENCODER_FP32["batch"], seq + 1)))
        out["a_bert_large_fp32"] = _card_against_cpu(torch, cfg, batch, "(a) bert-large",
                                                     backward=False)
        # (b) vit-large, 24 layers, 64 images, bf16, fused norms
        preset, images = ENCODER_VIT
        vit = modeling.PRESETS[preset]
        _, out["b_vit_large"] = _encoder_train(
            torch, smi, tmpdir, "(b) vit-large", ["--model_size", preset,
                                                  "--global_train_batch_size", str(images)],
            True, vit.num_layers, f"{images},{vit.num_heads},{vit.n_patches},unmasked",
            ("ln_fwd", "ln_bwd"))
        # (c) vit-huge at 2 layers: fp32 card against CPU, then bf16 on the card
        preset, hl, images = ENCODER_HUGE
        cfg = modeling.PRESETS[preset].replace(num_layers=hl, dtype=torch.float32,
                                               attn_impl="flash")
        check(cfg.head_dim == 80, f"{preset}: head_dim {cfg.head_dim}")

        def pixels(n):
            return torch.from_numpy(np.concatenate(
                [rng.randint(0, 256, (n, cfg.sample_len)),
                 rng.randint(0, cfg.num_classes, (n, 1))], 1))

        out["c_vit_huge_fp32"] = _card_against_cpu(torch, cfg, pixels(ENCODER_FP32["batch"]),
                                                    "(c) vit-huge", backward=True)
        bcfg = cfg.replace(dtype=torch.bfloat16)
        params = modeling.init_model_params(bcfg, 0, "cuda")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        before, routes_before = kernel_counts(), route_counts()
        loss = modeling.lm_loss(params, pixels(images).cuda(), bcfg)
        loss.backward()
        routes = _routes_since(routes_before)
        got = _delta(kernel_counts(), before)
        out["c_vit_huge_bf16"] = {"images": images, "loss": float(loss), "routes": {
            k: routes[k] for k in _GRID_KERNELS}}
        log("phase 22 (c) vit-huge bf16 step:", json.dumps(out["c_vit_huge_bf16"]))
        check(np.isfinite(float(loss)), "22 (c): bf16 loss")
        check(all(got[k] == hl and routes[k] == {"cuda_core": hl, "tma": 0}
                  for k in _GRID_KERNELS), f"22 (c) bf16 at head_dim 80: {got}, {routes}")
        del params, loss
        # (d) bert-large at 4 layers: profiled, searched, checked and trained
        s = ENCODER_SEARCH
        prefix = os.path.join(tmpdir, "profile_bert-large")
        shape = ["--model_size", "bert-large", "--num_layers", str(s["layers"])]
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rc, text = _cli(["profile", *shape, "--profile_batch_size", str(s["batch"]),
                         "--output_prefix", prefix])
        check(rc == 0, f"22 (d): cli profile returned {rc}")
        plan = os.path.join(tmpdir, "plan_bert-large.json")
        rc, _ = _cli(["search", *shape, "--num_devices", "1", "--settle_bsz", str(s["batch"]),
                      "--memory_constraint_gb", str(s["budget_gb"]),
                      "--time_profile_path", prefix + "_computation.json",
                      "--memory_profile_path", prefix + "_memory.json",
                      "--output_config_path", plan])
        check(rc == 0, f"22 (d): cli search returned {rc}")
        rc, _ = _cli(["check-plan", plan, "--strict", "1"])
        check(rc == 0, f"22 (d): check-plan --strict 1 returned {rc}")
        hp = HybridParallelConfig.load(plan)
        path = os.path.join(tmpdir, "train_metrics_encoder_search.jsonl")
        gc.collect()
        torch.cuda.empty_cache()
        reset_kernel_counts()  # the main path's counts start here
        before = route_counts()
        rc, _ = _cli(["train", *shape, "--global_train_batch_size", str(s["batch"]),
                      "--train_iters", str(s["steps"]), "--galvatron_config_path", plan,
                      "--metrics_path", path])
        got = kernel_counts()
        check(rc == 0, f"22 (d): cli train of the searched plan returned {rc}")
        losses = [x["loss"] for x in read_metrics(path) if x["event"] == "train_iter"]
        check(len(losses) == s["steps"] and all(np.isfinite(losses)), f"22 (d): {losses}")
        extra = sum(1 for x in hp.layer_strategies if x.ckpt in ("full", "selective"))
        n = s["steps"] * hp.chunks
        want = {"flash_grid_fwd": (hp.num_layers + extra) * n,
                "flash_grid_dkdv": hp.num_layers * n, "flash_grid_dq": hp.num_layers * n}
        check({k: got[k] for k in want} == want, f"22 (d): launches {got}, expected {want}")
        check(_all_tma({k: got[k] for k in want}, {k: _routes_since(before)[k] for k in want}),
              f"22 (d): routes {_routes_since(before)}")
        with open(plan) as f:
            d = json.load(f)
        out["d_search"] = {"card": smi, "plan": {k: d[k] for k in (
            "pp_deg", "tp_sizes_enc", "dp_types_enc", "checkpoint", "chunks", "vocab_tp")
            if k in d}, "search_cost_ms": d.get("search_cost_ms"), "losses": losses,
            "launches": want, "seconds": time.perf_counter() - t0}
        log("phase 22 (d) bert-large profiled, searched, checked, trained:",
            json.dumps(out["d_search"]))
    # (e) the reference's refusals of an encoder in serving and generation
    for mode, msg in ENCODER_REFUSALS.items():
        try:
            rc = _cli([mode, "--model_size", "bert-base"])[0]
            said = None
        except ValueError as e:
            rc, said = None, str(e)
        check(said == msg, f"22 (e): cli {mode} of bert-base returned {rc}, said {said!r}")
    out["e_refusals"] = ENCODER_REFUSALS
    log("phase 22 (e) cli serve / generate of bert-base refused:", json.dumps(ENCODER_REFUSALS))
    RESULTS["encoder"] = out
    return launches


# ---------------------------------------------------------------------------
# phase 23: the T5 encoder-decoder
# ---------------------------------------------------------------------------

ENCDEC_STEPS = 3
# (a) t5-large at full width and depth (24 + 24 layers, 512 + 512 tokens)
ENCDEC_LARGE = ("t5-large", 16)  # (preset, batch)
# (b) / (c) card against CPU at fp32, 2 + 2 layers, 2 rows: logits (absolute),
# loss (relative) and each gradient tensor's largest difference over its
# largest CPU value
ENCDEC_FP32 = dict(layers=2, batch=2)
ENCDEC_TOLS = (1e-4, 1e-5, 1e-5)
# (c) t5-3b at 2 + 2 layers: 32 heads of 32 (off the TMA route), bf16 rows
ENCDEC_3B = ("t5-3b", 4)  # (preset, bf16 batch)
# (d) the coupled pipeline: t5-large width at 4 + 4 layers, fp32, two gloo
# ranks sharing the card, GPipe then 1F1B, against world size 1 here
ENCDEC_PIPE = dict(layers=4, batch=4, chunks=2, steps=2)
ENCDEC_PIPE_RTOL = 1e-5
# (e) profiled, searched, checked and trained: t5-large width at 4 + 4 layers
ENCDEC_SEARCH = dict(layers=4, batch=8, steps=2, budget_gb=40)
ENCDEC_CP_REFUSAL = "context parallelism is not supported for enc-dec models"


def _t5_shape(preset, layers):
    return ["--model_size", preset, "--num_layers", str(layers), "--enc_layers", str(layers)]


def phase_encdec(torch, smi):
    """Phase 23: T5 through the grid kernels, unmasked in the encoder and
    causal in the decoder (module docstring). Returns (a)'s grid launches
    by mask: {"unmasked": {kernel: n}, "causal": {kernel: n}}."""
    import numpy as np

    from galvatron_tpu_torch.core.optim import AdamConfig, tree_leaves
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.parallel.hybrid import build_runtime
    from galvatron_tpu_torch.utils.metrics import read_metrics

    out = {}
    rng = np.random.RandomState(23)

    def rows(cfg, n):
        return torch.from_numpy(rng.randint(0, cfg.vocab_size, (n, cfg.sample_len + 1)))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_encdec_") as tmpdir:
        # (a) t5-large, 24 + 24 layers, 16 x (512 + 512), bf16, cli train
        preset, bsz = ENCDEC_LARGE
        t5 = modeling.PRESETS[preset]
        E, D, h, s = t5.enc_layers, t5.num_layers, t5.num_heads, t5.max_seq_len
        path = os.path.join(tmpdir, "train_metrics_t5.jsonl")
        argv = ["--model_size", preset, "--global_train_batch_size", str(bsz),
                "--train_iters", str(ENCDEC_STEPS), "--metrics_path", path]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_kernel_counts()  # the main path's counts start here
        routes_before, paged_before = route_counts(), fa.paged_decode_attention.launches
        check(_cli(["train", *argv])[0] == 0, "23 (a): cli train failed")
        launches, modes = kernel_counts(), _grid_modes()  # read right after the main path
        paged = fa.paged_decode_attention.launches - paged_before
        seconds = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        recs = [r for r in read_metrics(path) if r["event"] == "train_iter"]
        losses = [r["loss"] for r in recs]
        check(len(recs) == ENCDEC_STEPS and all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"23 (a): losses {losses}")
        n = ENCDEC_STEPS
        by_mask = {m: {k: modes[k].get(f"{bsz},{h},{s},{m}", 0) for k in _GRID_KERNELS}
                   for m in ("unmasked", "causal")}
        want = {"unmasked": {k: E * n for k in _GRID_KERNELS},
                "causal": {k: D * n for k in _GRID_KERNELS}}
        check(by_mask == want, f"23 (a): grid launches by mask {by_mask}, expected {want}")
        # nothing else: no blocked kernel, no other shape (cross-attention is
        # einsum), no norm kernel, no paged decode
        check(launches == {k: (E + D) * n if k in _GRID_KERNELS else 0 for k in launches}
              and all(sum(m.values()) == (E + D) * n for m in modes.values()) and paged == 0,
              f"23 (a): launches {launches}, shapes {modes}, paged_decode {paged}")
        routes = _routes_since(routes_before)
        check(_all_tma(launches, routes), f"23 (a): routes {routes}")
        steady = recs[1:]
        iter_ms = sum(r["iter_ms"] for r in steady) / len(steady)
        out["a_t5_large"] = {
            "card": smi, "argv": argv[:-2], "steps": n, "losses": losses,
            "iter_ms_mean_from_2": iter_ms, "iter_ms": [r["iter_ms"] for r in recs],
            "decoder_tokens_per_s": bsz * s / (iter_ms / 1e3),
            "tokens_per_s_enc_plus_dec": sum(r["tokens_per_s"] for r in steady) / len(steady),
            "mfu": sum(r["mfu"] for r in steady) / len(steady),
            "max_memory_allocated_gb": peak_gb, "grid_launches_by_mask": by_mask,
            "routes": {k: routes[k] for k in _GRID_KERNELS}, "paged_decode": paged,
            "seconds": seconds}
        log("phase 23 (a) t5-large:", json.dumps(out["a_t5_large"]))
        # (b) t5-large width, 2 + 2 layers, fp32: card against CPU
        fp = ENCDEC_FP32
        cfg = t5.replace(num_layers=fp["layers"], enc_layers=fp["layers"], dtype=torch.float32,
                         attn_impl="flash")
        out["b_t5_large_fp32"] = _card_against_cpu(torch, cfg, rows(cfg, fp["batch"]),
                                                    "(b) t5-large", True, "23", ENCDEC_TOLS)
        # (c) t5-3b, 2 + 2 layers: head_dim 32 on the CUDA-core kernels
        preset3, b3 = ENCDEC_3B
        cfg = modeling.PRESETS[preset3].replace(num_layers=fp["layers"], enc_layers=fp["layers"],
                                                dtype=torch.float32, attn_impl="flash")
        check(cfg.head_dim == 32, f"{preset3}: head_dim {cfg.head_dim}")
        out["c_t5_3b_fp32"] = _card_against_cpu(torch, cfg, rows(cfg, fp["batch"]),
                                                 "(c) t5-3b", True, "23", ENCDEC_TOLS)
        bcfg = cfg.replace(dtype=torch.bfloat16)
        params = modeling.init_model_params(bcfg, 0, "cuda")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        before, routes_before = kernel_counts(), route_counts()
        loss = modeling.lm_loss(params, rows(bcfg, b3).cuda(), bcfg)
        loss.backward()
        got, routes = _delta(kernel_counts(), before), _routes_since(routes_before)
        layers3 = bcfg.total_layers
        out["c_t5_3b_bf16"] = {"batch": b3, "loss": float(loss), "launches": {
            k: got[k] for k in _GRID_KERNELS}, "routes": {k: routes[k] for k in _GRID_KERNELS}}
        log("phase 23 (c) t5-3b bf16 step:", json.dumps(out["c_t5_3b_bf16"]))
        check(np.isfinite(float(loss)), "23 (c): bf16 loss")
        check(all(got[k] == layers3 and routes[k] == {"cuda_core": layers3, "tma": 0}
                  for k in _GRID_KERNELS), f"23 (c) bf16 at head_dim 32: {got}, {routes}")
        del params, loss
        gc.collect()
        torch.cuda.empty_cache()
        out["e_search"] = _encdec_search(torch, smi, tmpdir)
    # (f) the reference's refusals: serving, generation, context parallelism
    for mode, msg in ENCODER_REFUSALS.items():
        try:
            rc = _cli([mode, "--model_size", "t5-base"])[0]
            said = None
        except ValueError as e:
            rc, said = None, str(e)
        check(said == msg, f"23 (f): cli {mode} of t5-base returned {rc}, said {said!r}")
    try:
        build_runtime(modeling.PRESETS["t5-base"], HybridParallelConfig.uniform(
            24, cp=2, mixed_precision="bf16"), AdamConfig(), global_batch_size=8, seq_len=512)
        said = None
    except ValueError as e:
        said = str(e)
    check(said == ENCDEC_CP_REFUSAL, f"23 (f): cp = 2 on t5-base said {said!r}")
    out["f_refusals"] = dict(ENCODER_REFUSALS, cp=ENCDEC_CP_REFUSAL)
    log("phase 23 (f) serve / generate / cp = 2 of t5-base refused:",
        json.dumps(out["f_refusals"]))
    RESULTS["encdec"] = out
    return by_mask


def _coupled_pipelines(torch, smi, phases):
    """The coupled-sections pipelines, 23 (d) (T5: t5-large width at 4 + 4
    layers) and 24 (c) (Swin: swin-base width at depths 2, 2, 2, 2), those
    of ``phases``: each model in fp32 at pp = 2 on two gloo ranks sharing
    the card, GPipe then 1F1B, every run in ONE pair of rank processes;
    each against world size 1 in this process (losses within its ``rtol``
    relative; the GPipe run's parameters within AdamW's band). Returns
    {phase: result}."""
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    e, w = ENCDEC_PIPE, SWIN_FP32["depths"]
    specs = [spec for spec in (
        ("encdec", "23 (d)", "t5-large width", _t5_shape("t5-large", e["layers"]),
         2 * e["layers"], e, ENCDEC_PIPE_RTOL, f"{e['layers']} + {e['layers']}"),
        ("swin", "24 (c)", "swin-base width", _swin_shape("swin-base", w), sum(w), SWIN_PIPE,
         SWIN_PIPE_RTOL, "+".join(map(str, w)))) if spec[0] in phases]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_coupled_") as tmpdir:
        t0 = time.perf_counter()
        argvs, refs, ref_losses = [], [], {}
        for phase, tag, _, shape, total, c, _, _ in specs:

            def argv(plan, shape=shape, c=c):
                return [*shape, "--global_train_batch_size", str(c["batch"]), "--train_iters",
                        str(c["steps"]), "--galvatron_config_path", plan]

            plan1 = os.path.join(tmpdir, f"{phase}_w1.json")
            HybridParallelConfig.uniform(total, chunks=c["chunks"],
                                         mixed_precision="fp32").save(plan1)
            ref = trainer.train(initialize_galvatron("train", argv(plan1)))
            refs.append(os.path.join(tmpdir, f"{phase}_ref_params.pt"))
            torch.save(_to(ref["state"]["params"], "cpu"), refs[-1])
            ref_losses[phase] = ref["losses"]
            del ref
            gc.collect()
            torch.cuda.empty_cache()
            for ptype in ("gpipe", "pipedream_flush"):
                plan = os.path.join(tmpdir, f"{phase}_pp2_{ptype}.json")
                HybridParallelConfig.uniform(total, pp=2, chunks=c["chunks"], pipeline_type=ptype,
                                             mixed_precision="fp32").save(plan)
                argvs.append(argv(plan))
            refs.append("")  # the 1F1B run is held to the losses only
        runs = _launch_rank_runs(argvs, os.path.join(tmpdir, "ranks"), "gloo", (0, 0),
                                 ("--ref-params", ",".join(refs)))
        seconds = time.perf_counter() - t0
    for i, (phase, tag, what, _, _, c, rtol, layers) in enumerate(specs):
        res = {"card": smi, "layers": layers, "batch": c["batch"], "chunks": c["chunks"],
               "steps": c["steps"], "world1_losses": ref_losses[phase], "rtol": rtol,
               "runs": {}, "rank_processes_shared_by": [s[0] for s in specs],
               "seconds": seconds}
        band = 2 * c["steps"] * 1e-4  # AdamW's band at cli train's lr, as phase 13 (a)
        for ptype, ranks in zip(("GPipe", "1F1B"), runs[2 * i:2 * i + 2]):
            losses = ranks[0]["losses"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses[phase]))
            check(all(r["losses"] == losses for r in ranks), f"{tag} {ptype}: ranks disagree")
            check(rel <= rtol, f"{tag} {ptype}: losses {losses} vs world size 1 "
                  f"{ref_losses[phase]}")
            check(sorted(r["stage"] for r in ranks) == [0, 1], f"{tag} {ptype}: stages")
            entry = {"losses": losses, "max_rel_loss_diff": rel,
                     "in_flight": [r["stats"].get("in_flight") for r in ranks],
                     "stage_layers": [r["stage_layers"] for r in ranks],
                     "iter_times": ranks[0]["iter_times"]}
            if "param_max_abs_diff" in ranks[0]:
                entry["param_max_abs_diff"] = max(r["param_max_abs_diff"] for r in ranks)
                check(entry["param_max_abs_diff"] <= band, f"{tag} {ptype}: parameters "
                      f"{entry['param_max_abs_diff']} from world size 1")
            res["runs"][ptype] = entry
        check("param_max_abs_diff" in res["runs"]["GPipe"], f"{tag}: no parameter check")
        log(f"phase {tag} {what} pp = 2:", json.dumps(res))
        out[phase] = res
    return out


def _encdec_search(torch, smi, tmpdir):
    """23 (e): ``cli profile`` (two layer types), ``cli search`` for one
    device under a budget, ``cli check-plan --strict 1`` and ``cli train``
    of the plan, t5-large width at 4 + 4 layers."""
    import numpy as np

    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.utils.metrics import read_metrics

    s = ENCDEC_SEARCH
    prefix = os.path.join(tmpdir, "profile_t5-large")
    shape = _t5_shape("t5-large", s["layers"])
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc, _ = _cli(["profile", *shape, "--profile_batch_size", str(s["batch"]),
                  "--output_prefix", prefix])
    check(rc == 0, f"23 (e): cli profile returned {rc}")
    with open(prefix + "_computation.json") as f:
        comp = json.load(f)
    plan = os.path.join(tmpdir, "plan_t5-large.json")
    rc, _ = _cli(["search", *shape, "--num_devices", "1", "--settle_bsz", str(s["batch"]),
                  "--memory_constraint_gb", str(s["budget_gb"]),
                  "--time_profile_path", prefix + "_computation.json",
                  "--memory_profile_path", prefix + "_memory.json",
                  "--output_config_path", plan])
    check(rc == 0, f"23 (e): cli search returned {rc}")
    rc, _ = _cli(["check-plan", plan, "--strict", "1"])
    check(rc == 0, f"23 (e): check-plan --strict 1 returned {rc}")
    hp = HybridParallelConfig.load(plan)
    path = os.path.join(tmpdir, "train_metrics_encdec_search.jsonl")
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()  # the main path's counts start here
    before = route_counts()
    rc, _ = _cli(["train", *shape, "--global_train_batch_size", str(s["batch"]),
                  "--train_iters", str(s["steps"]), "--galvatron_config_path", plan,
                  "--metrics_path", path])
    got = kernel_counts()
    check(rc == 0, f"23 (e): cli train of the searched plan returned {rc}")
    losses = [x["loss"] for x in read_metrics(path) if x["event"] == "train_iter"]
    check(len(losses) == s["steps"] and all(np.isfinite(losses)), f"23 (e): {losses}")
    extra = sum(1 for x in hp.layer_strategies if x.ckpt in ("full", "selective"))
    n = s["steps"] * hp.chunks
    want = {"flash_grid_fwd": (hp.num_layers + extra) * n,
            "flash_grid_dkdv": hp.num_layers * n, "flash_grid_dq": hp.num_layers * n}
    check({k: got[k] for k in want} == want, f"23 (e): launches {got}, expected {want}")
    check(_all_tma({k: got[k] for k in want}, {k: _routes_since(before)[k] for k in want}),
          f"23 (e): routes {_routes_since(before)}")
    with open(plan) as f:
        d = json.load(f)
    types = {"encoder": comp["layertype_0"], "decoder": comp[f"layertype_{s['layers']}"]}
    check(types["encoder"] != types["decoder"], f"23 (e): one layer type {types}")
    res = {"card": smi, "profile_fwd_ms_per_sample": types, "plan": {k: d[k] for k in (
            "pp_deg", "tp_sizes_enc", "dp_types_enc", "checkpoint", "chunks", "vocab_tp")
            if k in d}, "search_cost_ms": d.get("search_cost_ms"), "losses": losses,
        "launches": want, "seconds": time.perf_counter() - t0}
    log("phase 23 (e) t5-large width profiled, searched, checked, trained:", json.dumps(res))
    return res


SWIN_STEPS = 3
# (a) swin-base at full width and depth (2, 2, 18, 2 layers over 56 x 56
# patches), 224-pixel images, the Swin paper's per-GPU batch (1024 over 8)
SWIN_BASE = ("swin-base", 128)  # (preset, images)
# (b) card against CPU at fp32: swin-base and swin-large widths at depths
# (2, 2, 2, 2), 2 images, 23 (b)'s bounds; then one bf16 swin-large step
SWIN_FP32 = dict(depths=(2, 2, 2, 2), batch=2)
SWIN_LARGE_BF16 = 16  # images
# (c) the K-section pipeline: swin-base width at depths (2, 2, 2, 2), fp32
SWIN_PIPE = dict(batch=4, chunks=2, steps=2)
SWIN_PIPE_RTOL = 1e-5
# (d) profiled, searched, checked and trained at depths (2, 2, 2, 2)
SWIN_SEARCH = dict(batch=8, steps=2, budget_gb=40)


def _swin_shape(preset, depths):
    return ["--model_size", preset, "--num_layers", str(sum(depths)),
            "--swin_depths", ",".join(map(str, depths))]


def _swin_ln_widths(cfg):
    """The LayerNorm rows of one Swin forward by width, {H: norms}: two
    norms a layer at its stage's width, each patch merge's at 4C, the final
    norm at the last stage's width; the widths the kernels tile (H % 128 ==
    0, ``fused_norm._tiles``) and the ones that take the plain version."""
    from galvatron_tpu_torch.models import modeling

    widths = {}
    for i in range(cfg.num_layers):
        h = modeling.vision_layer_cfg(cfg, i).hidden_size
        widths[h] = widths.get(h, 0) + 2
    for k in range(len(cfg.swin_depths) - 1):
        h = 4 * modeling.swin_geometry(cfg, k)[2]
        widths[h] = widths.get(h, 0) + 1
    last = modeling.swin_geometry(cfg, len(cfg.swin_depths) - 1)[2]
    widths[last] = widths.get(last, 0) + 1
    return ({h: n for h, n in widths.items() if h % 128 == 0},
            {h: n for h, n in widths.items() if h % 128})


def phase_swin(torch, smi):
    """Phase 24: the Swin pyramid (module docstring). Returns (a)'s
    LayerNorm launches {"ln_fwd": n, "ln_bwd": n}."""
    import numpy as np

    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.ops import fused_norm as fn
    from galvatron_tpu_torch.utils.metrics import read_metrics

    out = {}
    rng = np.random.RandomState(24)

    def rows(cfg, n):
        return torch.from_numpy(np.concatenate(
            [rng.randint(0, 256, (n, cfg.sample_len)), rng.randint(0, cfg.num_classes, (n, 1))],
            1))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_swin_") as tmpdir:
        # (a) swin-base, all 24 layers, 128 images of 224², bf16, fused norms
        preset, bsz = SWIN_BASE
        path = os.path.join(tmpdir, "train_metrics_swin.jsonl")
        argv = ["--model_size", preset, "--global_train_batch_size", str(bsz),
                "--train_iters", str(SWIN_STEPS), "--metrics_path", path]
        ns = initialize_galvatron("train", argv)
        cfg = model_config_from_args(ns).replace(fused_norm=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_kernel_counts()  # the main path's counts start here
        paged_before = fa.paged_decode_attention.launches
        del trainer.train(ns, cfg=cfg)["state"]
        launches, widths = kernel_counts(), fn.width_counts()  # right after the main path
        paged = fa.paged_decode_attention.launches - paged_before
        seconds = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        recs = [r for r in read_metrics(path) if r["event"] == "train_iter"]
        losses = [r["loss"] for r in recs]
        check(len(recs) == SWIN_STEPS and all(np.isfinite(losses)), f"24 (a): losses {losses}")
        tiled, plain = _swin_ln_widths(cfg)
        check(not plain, f"24 (a): swin-base widths off the kernels' tiles {plain}")
        n = SWIN_STEPS
        want_w = {h: k * n for h, k in tiled.items()}
        per_step = sum(tiled.values())
        # nothing else: no flash kernel (window attention is einsum), no RMSNorm
        want = {k: per_step * n if k in ("ln_fwd", "ln_bwd") else 0 for k in launches}
        check(launches == want and paged == 0,
              f"24 (a): launches {launches}, expected {want}; paged_decode {paged}")
        check(widths["ln_fwd"] == want_w and widths["ln_bwd"] == want_w,
              f"24 (a): LayerNorm launches by H {widths}, expected {want_w} each")
        steady = recs[1:]
        iter_ms = sum(r["iter_ms"] for r in steady) / len(steady)
        out["a_swin_base"] = {
            "card": smi, "argv": argv[:-2], "fused_norm": True, "steps": n, "losses": losses,
            "iter_ms_mean_from_2": iter_ms, "iter_ms": [r["iter_ms"] for r in recs],
            "images_per_s": bsz / (iter_ms / 1e3),
            "mfu": sum(r["mfu"] for r in steady) / len(steady),
            "max_memory_allocated_gb": peak_gb, "ln_launches_per_step": per_step,
            "ln_launches_by_h": {k: {str(h): c for h, c in sorted(v.items())}
                                 for k, v in widths.items() if v},
            "other_launches": {k: v for k, v in launches.items()
                               if k not in ("ln_fwd", "ln_bwd")},
            "paged_decode": paged, "seconds": seconds}
        log("phase 24 (a) swin-base:", json.dumps(out["a_swin_base"]))
        # (b) swin-base and swin-large widths at depths (2, 2, 2, 2), fp32
        fp = SWIN_FP32
        for name in ("swin-base", "swin-large"):
            c = modeling.PRESETS[name].replace(num_layers=sum(fp["depths"]),
                                               swin_depths=fp["depths"], dtype=torch.float32)
            out[f"b_{name}_fp32"] = _card_against_cpu(torch, c, rows(c, fp["batch"]),
                                                       f"(b) {name}", True, "24", ENCDEC_TOLS)
        # one bf16 swin-large step, fused norms: H = 192 takes the plain
        # version by the shared gate, 384 and wider the kernels
        lcfg = modeling.PRESETS["swin-large"].replace(
            num_layers=sum(fp["depths"]), swin_depths=fp["depths"], fused_norm=True)
        params = modeling.init_model_params(lcfg, 0, "cuda")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        reset_kernel_counts()
        loss = modeling.lm_loss(params, rows(lcfg, SWIN_LARGE_BF16).cuda(), lcfg)
        loss.backward()
        got, gw = kernel_counts(), fn.width_counts()
        tiled, plain = _swin_ln_widths(lcfg)
        out["b_swin_large_bf16"] = {"images": SWIN_LARGE_BF16, "loss": loss.item(),
                                    "ln_launches_by_h": {k: {str(h): c for h, c in
                                                             sorted(v.items())}
                                                         for k, v in gw.items() if v},
                                    "plain_widths": {str(h): c for h, c in plain.items()}}
        log("phase 24 (b) swin-large bf16 step:", json.dumps(out["b_swin_large_bf16"]))
        check(np.isfinite(loss.item()), "24 (b): swin-large bf16 loss")
        check(list(plain) == [192] and gw["ln_fwd"] == tiled and gw["ln_bwd"] == tiled
              and got["ln_fwd"] == got["ln_bwd"] == sum(tiled.values()),
              f"24 (b): swin-large LayerNorm launches by H {gw}, expected {tiled} "
              f"(192 plain: {plain})")
        del params, loss
        gc.collect()
        torch.cuda.empty_cache()
        # (c), the K-section pipeline, runs with 23 (d) (:func:`_coupled_pipelines`)
        out["d_search"] = _swin_search(torch, smi, tmpdir)
    # (e) the reference's refusals: serving, generation
    for mode, msg in ENCODER_REFUSALS.items():
        try:
            rc = _cli([mode, "--model_size", "swin-base"])[0]
            said = None
        except ValueError as e:
            rc, said = None, str(e)
        check(said == msg, f"24 (e): cli {mode} of swin-base returned {rc}, said {said!r}")
    out["e_refusals"] = ENCODER_REFUSALS
    log("phase 24 (e) serve / generate of swin-base refused:", json.dumps(out["e_refusals"]))
    RESULTS["swin"] = out
    return {k: launches[k] for k in ("ln_fwd", "ln_bwd")}


def _swin_search(torch, smi, tmpdir):
    """24 (d): ``cli profile`` (one layer type a stage), ``cli search`` for
    one device under a budget, ``cli check-plan --strict 1`` and ``cli
    train`` of the plan, swin-base width at depths (2, 2, 2, 2)."""
    import numpy as np

    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.utils.metrics import read_metrics

    s = SWIN_SEARCH
    prefix = os.path.join(tmpdir, "profile_swin-base")
    shape = _swin_shape("swin-base", SWIN_FP32["depths"])
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc, _ = _cli(["profile", *shape, "--profile_batch_size", str(s["batch"]),
                  "--output_prefix", prefix])
    check(rc == 0, f"24 (d): cli profile returned {rc}")
    with open(prefix + "_computation.json") as f:
        comp = json.load(f)
    with open(prefix + "_memory.json") as f:
        mem = json.load(f)
    plan = os.path.join(tmpdir, "plan_swin-base.json")
    rc, _ = _cli(["search", *shape, "--num_devices", "1", "--settle_bsz", str(s["batch"]),
                  "--memory_constraint_gb", str(s["budget_gb"]),
                  "--time_profile_path", prefix + "_computation.json",
                  "--memory_profile_path", prefix + "_memory.json",
                  "--output_config_path", plan])
    check(rc == 0, f"24 (d): cli search returned {rc}")
    rc, _ = _cli(["check-plan", plan, *shape, "--strict", "1"])
    check(rc == 0, f"24 (d): check-plan --strict 1 returned {rc}")
    hp = HybridParallelConfig.load(plan)
    path = os.path.join(tmpdir, "train_metrics_swin_search.jsonl")
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()
    rc, _ = _cli(["train", *shape, "--global_train_batch_size", str(s["batch"]),
                  "--train_iters", str(s["steps"]), "--galvatron_config_path", plan,
                  "--metrics_path", path])
    got = kernel_counts()
    check(rc == 0, f"24 (d): cli train of the searched plan returned {rc}")
    losses = [x["loss"] for x in read_metrics(path) if x["event"] == "train_iter"]
    check(len(losses) == s["steps"] and all(np.isfinite(losses)), f"24 (d): {losses}")
    check(not any(got.values()), f"24 (d): a kernel launched without fused_norm: {got}")
    # one type a stage: a pair of layers each, their parameters at the stage's
    # width (the times are differences of noisy steps and may clamp alike)
    types = [comp[f"layertype_{i}"] for i in (0, 2, 4, 6)]
    params = [mem[f"layertype_{i}"]["parameter_mb"] for i in range(8)]
    check(params[0::2] == params[1::2] and len(set(params)) == 4
          and all(comp[f"layertype_{i}"] == comp[f"layertype_{i + 1}"] for i in (0, 2, 4, 6)),
          f"24 (d): not one layer type a stage: times {comp}, parameters {params}")
    with open(plan) as f:
        d = json.load(f)
    res = {"card": smi, "profile_fwd_ms_per_sample": types, "profile_parameter_mb": params[0::2],
           "plan": {k: d[k] for k in (
            "pp_deg", "tp_sizes_enc", "dp_types_enc", "checkpoint", "chunks", "vocab_tp")
            if k in d}, "search_cost_ms": d.get("search_cost_ms"), "chunks": hp.chunks,
           "losses": losses, "seconds": time.perf_counter() - t0}
    log("phase 24 (d) swin-base width profiled, searched, checked, trained:", json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 25: fp16 on the grid kernels' and the LayerNorm kernels' paths
# ---------------------------------------------------------------------------

# (a) opt-1.3b at full width, 4 of its 24 layers, fused norms: (preset,
# layers, iterations); the batch and sequence are the preset's (8 x 2048)
FP16_OPT = ("opt-1.3b", 4, 6)
# (b) bert-large at full width, 2 of its 24 layers: (preset, layers, batch,
# iterations); the sequence is the preset's 512
FP16_BERT = ("bert-large", 2, 32, 3)
# fp16 step 0 against the bf16 step 0 of the same weights and batch
# (phase 15 (d)'s bound)
FP16_STEP0_RTOL = 1e-2


def _fp16_train(torch, smi, tmpdir, tag, argv, fused, iters):
    """One fp16 run of ``argv`` (``cli train``, or ``trainer.train`` with
    ``fused_norm=True``), then one bf16 step of the same flags; returns
    (launches, launches by dtype and route, the record)."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.ops import fused_norm as fn

    def run(precision, n, path):
        flags = [*argv, "--train_iters", str(n), "--mixed_precision", precision,
                 "--metrics_path", path]
        if fused:
            ns = initialize_galvatron("train", flags)
            del trainer.train(ns, cfg=model_config_from_args(ns).replace(fused_norm=True))["state"]
        else:
            check(cli.main(["train", *flags]) == 0, f"25 {tag}: cli train failed")

    path = os.path.join(tmpdir, f"fp16_{tag}.jsonl")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_kernel_counts()  # the main path's counts start here
    routes_before = route_counts()
    grid_dtypes = (fa.flash_grid_fwd.dtypes, fa.flash_grid_bwd_parts.dkv_dtypes,
                   fa.flash_grid_bwd_parts.dq_dtypes)
    before = [d["torch.float16"] for d in grid_dtypes]
    run("fp16", iters, path)
    launches, modes = kernel_counts(), _grid_modes()  # read right after the main path
    fp16 = dict(zip(_GRID_KERNELS, (d["torch.float16"] - b for d, b in zip(grid_dtypes, before))))
    fp16.update({k: v["torch.float16"] for k, v in fn.dtype_counts().items()})
    routes = _routes_since(routes_before)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seconds = time.perf_counter() - t0
    losses, recs = _train_losses(path)
    bf16_path = os.path.join(tmpdir, f"bf16_{tag}.jsonl")
    run("bf16", 1, bf16_path)
    bf16_loss = _train_losses(bf16_path)[0][0]
    steady = recs[1:]
    res = {"card": smi, "argv": argv, "fused_norm": fused, "dtype": "float16", "iters": iters,
           "losses": losses, "loss_scale": [r["loss_scale"] for r in recs],
           "iter_ms_mean_from_2": sum(r["iter_ms"] for r in steady) / len(steady),
           "iter_ms": [r["iter_ms"] for r in recs], "max_memory_allocated_gb": peak_gb,
           "bf16_step0_loss": bf16_loss, "step0_rel_diff": _rel(losses[0], bf16_loss),
           "launches": {k: v for k, v in launches.items() if v}, "fp16_launches": fp16,
           "routes": {k: routes[k] for k in _GRID_KERNELS}, "grid_modes": modes,
           "seconds_fp16_run": seconds}
    log(f"phase 25 {tag}:", json.dumps(res))
    check(len(losses) == iters and all(x == x and abs(x) != float("inf") for x in losses),
          f"25 {tag}: losses {losses}")
    check(res["step0_rel_diff"] <= FP16_STEP0_RTOL,
          f"25 {tag}: fp16 step 0 loss {losses[0]} against bf16 {bf16_loss}")
    check(all(routes[k] == {"cuda_core": launches[k], "tma": 0} for k in _GRID_KERNELS),
          f"25 {tag}: routes {routes}")
    return launches, fp16, modes, res


def phase_fp16(torch, smi):
    """Phase 25: (a) opt-1.3b at full width, 4 layers, ``fused_norm=True``,
    fp16 at 8 x 2048 for ``FP16_OPT``'s iterations, then a bf16 step of the
    same model and batch: finite losses, step 0 within 1e-2 relative of the
    bf16 step 0, each grid kernel launched layers x iterations at fp16 on
    the CUDA-core route, the LayerNorm kernels (2 x layers + 1) x iterations
    at fp16, nothing else; (b) bert-large at full width, 2 layers, fp16, 32 x
    512 for 3 iterations: the grid kernels unmasked at fp16, layers x
    iterations each. Returns (a)'s launches and (b)'s."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fp16p_") as tmpdir:
        preset, layers, iters = FP16_OPT
        launches_a, fp16, _, out["a_opt"] = _fp16_train(
            torch, smi, tmpdir, "(a) opt", ["--model_size", preset, "--num_layers", str(layers)],
            True, iters)
        want = path_counts("opt", layers, iters, True)
        check(launches_a == want, f"25 (a): launches {launches_a}, expected {want}")
        check(fp16 == {k: want[k] for k in fp16}, f"25 (a): fp16 launches {fp16}, expected "
              f"{want}")
        preset, layers, bsz, iters = FP16_BERT
        launches_b, fp16, modes, out["b_bert"] = _fp16_train(
            torch, smi, tmpdir, "(b) bert", ["--model_size", preset, "--num_layers", str(layers),
                                             "--global_train_batch_size", str(bsz)],
            False, iters)
        n = layers * iters
        want = {k: n if k in _GRID_KERNELS else 0 for k in launches_b}
        check(launches_b == want, f"25 (b): launches {launches_b}, expected {want}")
        check(fp16 == {k: want[k] for k in fp16}, f"25 (b): fp16 launches {fp16}")
        mode = f"{bsz},16,512,unmasked"
        check(all(m == {mode: n} for m in modes.values()),
              f"25 (b): grid launches by shape {modes}, expected {mode}: {n}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 25 took {out['seconds']:.1f} s")
    RESULTS["fp16"] = out
    return launches_a, launches_b


def rank_worker(outdir, argv, ref_params=None, control=None) -> int:
    """One rank of phases 12-13, 17 and 18: ``cli train``'s own call
    (``trainer.train`` of the parsed flags), with the blocked flash
    wrappers' calls also counted by the head count they ran at, and the grid
    wrappers' launches by shape and mask (their ``modes``); writes
    ``rank<r>.json`` (and, with ``ref_params``, the largest difference of
    this rank's pieces from the world-size-1 parameters). ``control`` names
    one of ``CP_CONTROLS`` to train under; ``PROFILE_MOE`` among a run's
    flags profiles rank 0's run and splits its MoE time
    (:func:`moe_time_split`). Flags with ``--then`` between them are several
    runs, one after another in this process (:func:`_launch_rank_runs`);
    ``ref_params`` holds them in order (comma-separated: run j to the j-th,
    an empty entry to none)."""
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron
    from galvatron_tpu_torch.ops import flash_attention as fa

    heads = {"flash_fwd": {}, "flash_bwd": {}}
    for name in heads:
        orig = getattr(fa, name)

        def counted(q, *a, _orig=orig, _name=name, **kw):
            h = int(q.shape[1])
            heads[_name][h] = heads[_name].get(h, 0) + 1
            return _orig(q, *a, **kw)

        # the wrapper's body counts into the module-level name: carry its counters
        counted.__dict__.update(orig.__dict__)
        setattr(fa, name, counted)
    # the world-size-1 parameters run j is held to (comma-separated, in run
    # order; empty for a run held to none)
    refs = ref_params.split(",") if ref_params else []
    runs = [[]]  # the flags of each run, split at "--then"
    for a in argv:
        if a == "--then":
            runs.append([])
        else:
            runs[-1].append(a)
    if len(runs) > 1:
        # one default process group for every run: trainer.train then
        # neither creates nor destroys it
        ns = initialize_galvatron("train", [a for a in runs[0] if a != PROFILE_MOE])
        created = trainer.init_distributed(trainer.rank_device(ns.device), ns.dist_backend,
                                           ns.dist_timeout_s)
        try:
            for j, run in enumerate(runs):
                _rank_run(os.path.join(outdir, f"run{j}"), run, heads,
                          refs[j] if j < len(refs) and refs[j] else None, control)
        finally:
            if created:
                import torch.distributed as dist

                dist.destroy_process_group()
        return 0
    _rank_run(outdir, argv, heads, refs[0] if refs else None, control)
    return 0


#: a flag of one rank run (not of ``cli train``): profile its rank 0
PROFILE_MOE = "--profile-moe"


def _rank_run(outdir, argv, heads, ref_params=None, control=None):
    """One ``cli train`` run of :func:`rank_worker`; writes ``rank<r>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.ops import collective_matmul as cm
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.parallel import comm

    for counts in heads.values():
        counts.clear()
    cm.hops = 0
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    comm.reset_counts()
    before = route_counts()
    profile_moe = PROFILE_MOE in argv
    ns = initialize_galvatron("train", [a for a in argv if a != PROFILE_MOE])
    prof = None
    if profile_moe and int(os.environ.get("RANK", "0")) == 0:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with _cp_control(control), (prof if prof is not None else contextlib.nullcontext()):
        out = trainer.train(ns)
    rec = {"rank": out["rank"], "world": out["world"], "losses": out["losses"],
           "moe_moves": dict(comm.moe_moves), "collectives": comm.issued,
           "moe_parts": moe_time_split(prof, ns.train_iters) if prof is not None else None,
           "iter_times": out["iter_times"], "launches": kernel_counts(),
           "routes": {k: {r: n - before[k][r] for r, n in v.items()}
                      for k, v in route_counts().items()},
           "heads": heads, "host_staged": out["host_staged"], "p2p": out["p2p"],
           "shapes": {"flash_grid_fwd": dict(fa.flash_grid_fwd.modes),
                      "flash_grid_dkdv": dict(fa.flash_grid_bwd_parts.dkv_modes),
                      "flash_grid_dq": dict(fa.flash_grid_bwd_parts.dq_modes)},
           "stage": out["stage"], "stage_layers": out["stage_layers"],
           "hops": cm.hops, "stats": {k: v for k, v in out["stats"].items()
                                      if k in ("in_flight", "buckets")},
           "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                       if torch.cuda.is_available() else None)}
    if ref_params:
        cfg = model_config_from_args(ns)
        hp = HybridParallelConfig.load(ns.galvatron_config_path)
        ref = bridge.params_to_numpy(torch.load(ref_params, mmap=True))
        mine = bridge.params_to_numpy(out["state"]["params"])
        want = bridge.shard_params(ref, cfg, hp, out["rank"], out["world"])
        from galvatron_tpu_torch.core.optim import tree_leaves

        rec["param_max_abs_diff"] = max(float(abs(a - b).max())
                                        for a, b in zip(tree_leaves(mine), tree_leaves(want)))
    with open(os.path.join(outdir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(rec, f)


#: the phases by name, for ``--phases``; a full run takes them all
PHASES = ("kernels", "flash", "grid", "norm", "forward", "parity", "serve", "train", "hybrid",
          "pipeline", "nccl", "search", "services", "slots", "cp", "moe", "packed", "overlap",
          "hf", "encoder", "encdec", "swin", "fp16")


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run of galvatron_tpu_torch on one card")
    ap.add_argument("--out", default=None, help="also write every measurement here as JSON")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run while developing "
                    f"({', '.join(PHASES)}; the card and the build always run). Only a full "
                    "run prints the kernels line and the result line")
    ap.add_argument("--rank-worker", default=None, metavar="OUTDIR",
                    help="(phases 12-13) run as one rank: the flags after -- are cli train's")
    ap.add_argument("--ref-params", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--control", default=None,
                    choices=(CP_CONTROLS[0], CP_CONTROLS[2], CP_CONTROLS[3]),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cp-worker", default=None, metavar="OUTDIR",
                    help="(phase 17 (c)) run as one rank of the ring / Ulysses functions")
    ap.add_argument("train_argv", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker:
        argv = args.train_argv[1:] if args.train_argv[:1] == ["--"] else args.train_argv
        return rank_worker(args.rank_worker, argv, args.ref_params, args.control)
    if args.cp_worker:
        return cp_worker(args.cp_worker)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    import torch

    import galvatron_tpu_torch  # noqa: F401 — fails fast outside a checkout

    clock = {"start": time.perf_counter(), "last": time.perf_counter()}
    seconds = RESULTS.setdefault("phase_seconds", {})

    def mark(name):
        """The seconds since the last mark, under ``name``; with ``--out``
        everything measured so far is written after each phase, so a run
        that fails later keeps it."""
        now = time.perf_counter()
        seconds[name] = now - clock["last"]
        clock["last"] = now
        if args.out:
            _write_out(args.out, RESULTS)

    smi = phase_card(torch)
    phase_build()
    mark("0-1 card, build")
    lines, launches, train_res = {}, {}, {}
    if "kernels" in phases:
        lines["paged"] = phase_kernels(torch)
        mark("2 paged decode")
    if "flash" in phases:
        lines["flash"] = phase_flash(torch)
        mark("3 flash")
    if "grid" in phases:
        lines["grid"] = phase_grid(torch)
        lines["ring_hop"] = phase_ring_hop(torch)
        mark("3 grid")
    if "norm" in phases:
        lines["norm"] = phase_norm(torch)
        mark("3 norm")
    _DAM.clear()  # the timer's tensors are no part of a later phase's peak memory
    torch.cuda.empty_cache()
    if "forward" in phases:
        launches["paged_fp16"] = phase_forward(torch)
        phase_forward(torch, fused=True)
        mark("4 forward")
    if "parity" in phases:
        for model, fused in (("llama", False), ("gpt", False), ("llama", True), ("opt", True)):
            phase_train_parity(torch, model, fused)
            phase_train_bf16(torch, model, fused)
        # opt's ReLU sets the step above a looser limit: its gelu twin at the
        # same width is held to the others'
        phase_train_bf16(torch, "opt", True, act="gelu")
        mark("5 parity")
    if "serve" in phases:
        launches["paged"] = phase_serve(torch, smi)
        mark("6 serve")
    if "train" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
            for run in TRAIN_RUNS:
                launches[run], train_res[run] = phase_train(torch, smi, tmpdir, run)
                if run != "opt_plain":
                    phase_train_profile(torch, run)
        beside = {
            "llama-7b width, 4 layers": ("llama", "llama_fused"),
            "opt-1.3b, 24 layers": ("opt_plain", "opt_fused")}
        for what, (plain, fused) in beside.items():
            a, b = train_res[plain], train_res[fused]
            cmp_ = {"path": what, **{
                k: {"fused_norm_false": a[k], "fused_norm_true": b[k]} for k in
                ("iter_ms_mean_from_2", "tokens_per_s", "mfu", "max_memory_allocated_gb")}}
            log("fused_norm beside plain:", json.dumps(cmp_))
            RESULTS.setdefault("fused_beside_plain", []).append(cmp_)
        mark("7-10 train")
    if {"hybrid", "pipeline", "nccl"} & set(phases):  # 12b, 13 and 13b stand against phase 11
        from concurrent.futures import ThreadPoolExecutor

        with tempfile.TemporaryDirectory(prefix="chip_smoke_hybrid_") as tmpdir:
            world1 = phase_hybrid_world1(torch, smi, tmpdir)
            if "llama" in train_res:
                cmp_ = {"path": "llama-7b width, 4 layers, world size 1", **{
                    k: {"phase7_cli": train_res["llama"][k], "phase11_plan": world1[k]}
                    for k in ("iter_ms_mean_from_2", "tokens_per_s", "mfu",
                              "max_memory_allocated_gb")}}
                log("phase 11 beside phase 7:", json.dumps(cmp_))
                RESULTS["hybrid_beside_phase7"] = cmp_
            gc.collect()
            torch.cuda.empty_cache()
            if "hybrid" in phases:
                phase_hybrid_ranks(torch, smi, tmpdir, "gloo", (0, 0), world1)
            if "pipeline" in phases:
                gpt_losses = _gpt_reference_losses(torch, tmpdir, train_res)
                ref_losses, ref_path = _pipe_fp32_reference(torch, tmpdir)
                # 13 (a)'s four ranks in a thread, 13 (b) and (c)'s two here:
                # two worlds on the card at once, its used memory sampled
                with ThreadPoolExecutor(1) as pool, card_used_peak(torch) as peak:
                    fp32 = pool.submit(phase_pipeline_fp32, smi, tmpdir, ref_losses, ref_path)
                    phase_pipeline_bf16(torch, smi, tmpdir, "gloo", (0, 0), world1,
                                        gpt_losses=gpt_losses)
                    fp32.result()
                RESULTS["pipeline_worlds_card_used_peak_gb"] = peak["gb"]
                log("phase 13 (a) beside (b) and (c): the card's used memory peaked at "
                    f"{peak['gb']:.2f} GB")
            if "nccl" in phases and torch.cuda.device_count() >= 2:
                nccl12 = phase_hybrid_ranks(torch, smi, tmpdir, "nccl", (0, 1), world1)
                log("phase 12b nccl on two cards: run")
                nccl13 = phase_pipeline_bf16(torch, smi, tmpdir, "nccl", (0, 1), world1)
                cmp_ = {"phase11_world1_iter_ms": world1["iter_ms_mean_from_2"],
                        "phase12b_tp2_iter_ms": nccl12["bf16"]["iter_ms_mean_from_2"],
                        "phase13b_pp2_iter_ms": {n: r["iter_ms_mean_from_2"]
                                                 for n, r in nccl13["runs"].items()}}
                log("phase 13b beside phases 11 and 12b:", json.dumps(cmp_))
                RESULTS["pipeline_beside_nccl"] = cmp_
            elif "nccl" in phases:
                log(f"phases 12b and 13b, nccl on two cards: absent "
                    f"({torch.cuda.device_count()} card)")
                RESULTS["hybrid_ranks_nccl"] = RESULTS["pipeline_bf16_nccl"] = "absent: one card"
        mark("11-13 hybrid, pipelines")
    gc.collect()
    torch.cuda.empty_cache()
    if "search" in phases:
        phase_search(torch, smi, train_res)
        mark("14 search")
    if "nccl" in phases and torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmpdir:
            phase_search_nccl(smi, tmpdir)
    elif "nccl" in phases:
        log(f"phase 14b, profile-hardware over nccl on two cards: absent "
            f"({torch.cuda.device_count()} card)")
        RESULTS["search_hardware_nccl"] = "absent: one card"
    if "services" in phases:
        launches["services_fp16"] = phase_services(torch, smi, train_res)
        mark("15 services")
    if "slots" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["paged_gpt"] = phase_slots(torch, smi)
        mark("16 slots")
    if {"cp", "nccl"} & set(phases):
        cp_long = phase_cp(torch, smi, run_gloo="cp" in phases, run_nccl="nccl" in phases)
        mark("17 cp")
    if "moe" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["moe_train"], launches["moe_paged"] = phase_moe(torch, smi)
        RESULTS["moe_launches"] = {"train_world1": launches["moe_train"],
                                   "serve_paged_decode": launches["moe_paged"]}
        mark("18 moe")
    if "packed" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["packed"] = phase_packed(torch, smi)
        mark("19 packed")
    if {"overlap", "nccl"} & set(phases):
        gc.collect()
        torch.cuda.empty_cache()
        overlap = phase_overlap(torch, smi, run_gloo="overlap" in phases,
                                run_nccl="nccl" in phases)
        if overlap is not None:
            launches["overlap"] = overlap
        mark("20 overlap")
    if "hf" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["hf"] = phase_hf(torch, smi)
        mark("21 hf")
    if "encoder" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["encoder"] = phase_encoder(torch, smi)
        mark("22 encoder")
    if "encdec" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["encdec"] = phase_encdec(torch, smi)
        mark("23 encdec")
    if "swin" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["swin"] = phase_swin(torch, smi)
        mark("24 swin")
    if {"encdec", "swin"} & set(phases):
        gc.collect()
        torch.cuda.empty_cache()
        for phase, res in _coupled_pipelines(torch, smi, phases).items():
            RESULTS[phase]["d_pipeline" if phase == "encdec" else "c_pipeline"] = res
        mark("23 (d), 24 (c) coupled pipelines")
    if "fp16" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launches["fp16_opt"], launches["fp16_bert"] = phase_fp16(torch, smi)
        mark("25 fp16")
        fp16_seconds = {
            **{k: v["seconds"] for part in ("paged", "grid", "norm") if part in lines
               for k, v in lines[part].items() if "fp16" in k and "seconds" in v},
            "4 (c) fp16 forward": RESULTS.get("forward", {}).get("fp16_seconds", 0.0),
            "25 fp16": seconds["25 fp16"]}
        RESULTS["fp16_seconds"] = dict(fp16_seconds, total=sum(fp16_seconds.values()))
        log("fp16 cases and phase 25, seconds:", json.dumps(RESULTS["fp16_seconds"]))
    if {"packed", "overlap"} & set(phases):
        RESULTS["packed_overlap_launches"] = {k: launches[k] for k in ("packed", "overlap")
                                              if k in launches}
    RESULTS["total_seconds"] = time.perf_counter() - clock["start"]
    log("phase seconds:", json.dumps(seconds), f"total {RESULTS['total_seconds']:.1f} s")
    if set(phases) != set(PHASES):
        if args.out:
            _write_out(args.out, RESULTS)
        log(f"partial run ({','.join(phases)}): no kernels line, no result line")
        return 0
    paged_line = lines["paged"]["paged_decode main"]
    paged16 = lines["paged"]["paged_decode main fp16"]
    opt16 = lines["grid"]["grid opt fp16"]
    gpt_paged_line = lines["paged"]["paged_decode gpt"]
    grid_line, norm_lines = lines["grid"]["grid gpt"], lines["norm"]
    enc_line = lines["grid"]["grid encoder s512 d64"]
    t5_lines = {"unmasked": lines["grid"]["grid t5 s512 d64"],
                "causal": lines["grid"]["grid t5 causal s512 d64"]}
    flash_line, fp16_line = lines["flash"]["flash main"], lines["flash"]["flash main fp16"]
    src = "galvatron_tpu_torch/ops/csrc/"
    replaces = "galvatron_tpu/ops/flash_attention.py:"

    def grid_entry(name, source, line_no, count, err, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces + line_no, "launches": launches["gpt"][count],
                "max_abs_err": err, "ms": grid_line[ms], "plain_ms": grid_line[plain],
                "bound_ms": grid_line[bound + "_bound_ms"],
                "bound_by": grid_line[bound + "_bound_by"], "library_ms": grid_line[library]}

    def norm_entry(name, line_no, case, run, which, count=None):
        """A norm kernel at a timed shape (bf16 or fp16): ``which`` is fwd
        or bwd; the backward's time is its two launches (row pass and column
        sums); ``count`` the kernel's name in ``launches[run]`` when it is
        not ``name``."""
        line = norm_lines[case]
        err = line["y_max_abs_err"] if which == "fwd" else line["dx_max_abs_err"]
        return {"name": name, "route": "cuda", "source": src + "fused_norm.cu",
                "replaces": "galvatron_tpu/ops/fused_norm.py:" + line_no,
                "launches": launches[run][count or name], "max_abs_err": err,
                "ms": line[which + "_ms"], "plain_ms": line[which + "_plain_ms"],
                "bound_ms": line[which + "_bound_ms"], "bound_by": line[which + "_bound_by"],
                "library_ms": line[which + "_library_ms"]}

    dq_err, dk_err, dv_err = grid_line["bwd_max_abs_err_dq_dk_dv"]
    ring_line = lines["ring_hop"]
    # the ring hops' launches on 17 (b)'s path, both ranks: the past hops
    # (unmasked), whose shape phase 3's ring-hop case times
    hop = f"{RING_HOP['b']},{RING_HOP['h']},{RING_HOP['s']},unmasked"
    ring_launches = {k: sum(r[k].get(hop, 0) for r in cp_long["launches_by_shape"])
                     for k in ("flash_grid_fwd", "flash_grid_dkdv", "flash_grid_dq")}
    check(all(ring_launches.values()), f"no past-hop launch at {hop} in 17 (b): {ring_launches}")
    rq_err, rk_err, rv_err = ring_line["bwd_max_abs_err_dq_dk_dv"]

    def ring_entry(name, source, line_no, count, err, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces + line_no, "launches": ring_launches[count],
                "max_abs_err": err, "ms": ring_line[ms], "plain_ms": ring_line[plain],
                "bound_ms": ring_line[bound + "_bound_ms"],
                "bound_by": ring_line[bound + "_bound_by"], "library_ms": ring_line[library]}

    kernels = {"kernels": [
        {"name": "paged_decode", "route": "cuda", "source": src + "paged_decode.cu",
         "replaces": replaces + "1152",
         "launches": launches["paged"], "max_abs_err": paged_line["max_abs_err"],
         "ms": paged_line["kernel_ms"], "plain_ms": paged_line["plain_ms"],
         "bound_ms": paged_line["bound_ms"], "bound_by": paged_line["bound_by"],
         "library_ms": paged_line["library_ms"]},
        # the same kernel's head_dim-64 instance at gpt-1.5b's decode shape,
        # with its launches on phase 16 (b)'s paged serving path
        {"name": "paged_decode_d64", "route": "cuda", "source": src + "paged_decode.cu",
         "replaces": replaces + "1152",
         "launches": launches["paged_gpt"], "max_abs_err": gpt_paged_line["max_abs_err"],
         "ms": gpt_paged_line["kernel_ms"], "plain_ms": gpt_paged_line["plain_ms"],
         "bound_ms": gpt_paged_line["bound_ms"], "bound_by": gpt_paged_line["bound_by"],
         "library_ms": gpt_paged_line["library_ms"]},
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": replaces + "272",
         "launches": launches["llama"]["flash_fwd"], "max_abs_err": flash_line["fwd_max_abs_err"],
         "ms": flash_line["fwd_ms"], "plain_ms": flash_line["fwd_plain_ms"],
         "bound_ms": flash_line["fwd_bound_ms"], "bound_by": flash_line["fwd_bound_by"],
         "library_ms": flash_line["fwd_library_ms"]},
        {"name": "flash_bwd", "route": "cuda", "source": src + "flash_bwd.cu",
         "replaces": replaces + "514",
         "launches": launches["llama"]["flash_bwd"], "max_abs_err": flash_line["bwd_max_abs_err"],
         "ms": flash_line["bwd_ms"], "plain_ms": flash_line["bwd_plain_ms"],
         "bound_ms": flash_line["bwd_bound_ms"], "bound_by": flash_line["bwd_bound_by"],
         "library_ms": flash_line["bwd_library_ms"]},
        # the fp16 instances of the blocked kernels (the TMA route), with their
        # launches on phase 15 (d)'s fp16 training path
        {"name": "flash_fwd_fp16", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": replaces + "272", "launches": launches["services_fp16"]["flash_fwd"],
         "max_abs_err": fp16_line["fwd_max_abs_err"], "ms": fp16_line["fwd_ms"],
         "plain_ms": fp16_line["fwd_plain_ms"], "bound_ms": fp16_line["fwd_bound_ms"],
         "bound_by": fp16_line["fwd_bound_by"], "library_ms": fp16_line["fwd_library_ms"]},
        {"name": "flash_bwd_fp16", "route": "cuda", "source": src + "flash_bwd.cu",
         "replaces": replaces + "514", "launches": launches["services_fp16"]["flash_bwd"],
         "max_abs_err": fp16_line["bwd_max_abs_err"], "ms": fp16_line["bwd_ms"],
         "plain_ms": fp16_line["bwd_plain_ms"], "bound_ms": fp16_line["bwd_bound_ms"],
         "bound_by": fp16_line["bwd_bound_by"], "library_ms": fp16_line["bwd_library_ms"]},
        # the plain and library times of the two backward kernels are those
        # of the whole backward (the plain version and SDPA compute dq, dk
        # and dv in one call); each kernel's own time and bound are its own
        grid_entry("flash_grid_fwd", "flash_grid_fwd.cu", "123", "flash_grid_fwd",
                   grid_line["fwd_max_abs_err"], "fwd_ms", "fwd_plain_ms", "fwd",
                   "fwd_library_ms"),
        grid_entry("flash_grid_dkdv", "flash_grid_bwd.cu", "724", "flash_grid_dkdv",
                   max(dk_err, dv_err), "dkdv_ms", "bwd_plain_ms", "dkdv", "bwd_library_ms"),
        grid_entry("flash_grid_dq", "flash_grid_bwd.cu", "792", "flash_grid_dq", dq_err,
                   "dq_ms", "bwd_plain_ms", "dq", "bwd_library_ms"),
        # the same three kernels in the ring-hop mode (phase 3's ring-hop
        # case: unmasked, fp32 out; the backward on a fold's global lse /
        # delta), with their launches on phase 17 (b)'s context-parallel path
        ring_entry("flash_grid_fwd_ring_hop", "flash_grid_fwd.cu", "123", "flash_grid_fwd",
                   ring_line["fwd_max_abs_err"], "fwd_ms", "fwd_plain_ms", "fwd",
                   "fwd_library_ms"),
        ring_entry("flash_grid_dkdv_ring_hop", "flash_grid_bwd.cu", "724", "flash_grid_dkdv",
                   max(rk_err, rv_err), "dkdv_ms", "bwd_plain_ms", "dkdv", "bwd_library_ms"),
        ring_entry("flash_grid_dq_ring_hop", "flash_grid_bwd.cu", "792", "flash_grid_dq", rq_err,
                   "dq_ms", "bwd_plain_ms", "dq", "bwd_library_ms"),
        # the same three kernels unmasked with bf16 output, an encoder's
        # attention (phase 3's "grid encoder s512 d64" case: 22 (a)'s
        # bert-large shape, batch and stacked view), with their launches on
        # phase 22 (a)'s bert-large path
        *[{"name": name, "route": "cuda", "source": src + source, "replaces": replaces + line_no,
           "launches": launches["encoder"][count], "max_abs_err": err, "ms": enc_line[ms],
           "plain_ms": enc_line[plain], "bound_ms": enc_line[bound + "_bound_ms"],
           "bound_by": enc_line[bound + "_bound_by"], "library_ms": enc_line[library]}
          for name, source, line_no, count, err, ms, plain, bound, library in (
              ("flash_grid_fwd_encoder", "flash_grid_fwd.cu", "123", "flash_grid_fwd",
               enc_line["fwd_max_abs_err"], "fwd_ms", "fwd_plain_ms", "fwd", "fwd_library_ms"),
              ("flash_grid_dkdv_encoder", "flash_grid_bwd.cu", "724", "flash_grid_dkdv",
               max(enc_line["bwd_max_abs_err_dq_dk_dv"][1:]), "dkdv_ms", "bwd_plain_ms",
               "dkdv", "bwd_library_ms"),
              ("flash_grid_dq_encoder", "flash_grid_bwd.cu", "792", "flash_grid_dq",
               enc_line["bwd_max_abs_err_dq_dk_dv"][0], "dq_ms", "bwd_plain_ms", "dq",
               "bwd_library_ms"))],
        # the same three kernels on T5's path (phase 3's "grid t5" cases:
        # 23 (a)'s t5-large shape and batch in the stacked view), the
        # encoder's unmasked and the decoder's causal, with their launches
        # by mask on phase 23 (a)'s path
        *[{"name": name + suffix, "route": "cuda", "source": src + source,
           "replaces": replaces + line_no, "launches": launches["encdec"][mask][name],
           "max_abs_err": err(t5_lines[mask]), "ms": t5_lines[mask][ms],
           "plain_ms": t5_lines[mask][plain], "bound_ms": t5_lines[mask][bound + "_bound_ms"],
           "bound_by": t5_lines[mask][bound + "_bound_by"],
           "library_ms": t5_lines[mask][library]}
          for mask, suffix in (("unmasked", "_encdec"), ("causal", "_encdec_causal"))
          for name, source, line_no, err, ms, plain, bound, library in (
              ("flash_grid_fwd", "flash_grid_fwd.cu", "123", lambda x: x["fwd_max_abs_err"],
               "fwd_ms", "fwd_plain_ms", "fwd", "fwd_library_ms"),
              ("flash_grid_dkdv", "flash_grid_bwd.cu", "724",
               lambda x: max(x["bwd_max_abs_err_dq_dk_dv"][1:]), "dkdv_ms", "bwd_plain_ms",
               "dkdv", "bwd_library_ms"),
              ("flash_grid_dq", "flash_grid_bwd.cu", "792",
               lambda x: x["bwd_max_abs_err_dq_dk_dv"][0], "dq_ms", "bwd_plain_ms", "dq",
               "bwd_library_ms"))],
        # the fp16 instances (the CUDA-core route): the grid kernels at phase
        # 25 (a)'s opt-1.3b shape (phase 3's "grid opt fp16" case) with their
        # launches on that path, ...
        *[{"name": name + "_fp16", "route": "cuda", "source": src + source,
           "replaces": replaces + line_no, "launches": launches["fp16_opt"][name],
           "max_abs_err": err, "ms": opt16[ms], "plain_ms": opt16[plain],
           "bound_ms": opt16[bound + "_bound_ms"], "bound_by": opt16[bound + "_bound_by"],
           "library_ms": opt16[library]}
          for name, source, line_no, err, ms, plain, bound, library in (
              ("flash_grid_fwd", "flash_grid_fwd.cu", "123", opt16["fwd_max_abs_err"],
               "fwd_ms", "fwd_plain_ms", "fwd", "fwd_library_ms"),
              ("flash_grid_dkdv", "flash_grid_bwd.cu", "724",
               max(opt16["bwd_max_abs_err_dq_dk_dv"][1:]), "dkdv_ms", "bwd_plain_ms", "dkdv",
               "bwd_library_ms"),
              ("flash_grid_dq", "flash_grid_bwd.cu", "792", opt16["bwd_max_abs_err_dq_dk_dv"][0],
               "dq_ms", "bwd_plain_ms", "dq", "bwd_library_ms"))],
        # ... the norm kernels at the training shapes with their launches on
        # phase 15 (d)'s (RMSNorm) and phase 25 (a)'s (LayerNorm) paths, ...
        norm_entry("rms_fwd_fp16", "64", "rms main fp16", "services_fp16", "fwd", "rms_fwd"),
        norm_entry("rms_bwd_fp16", "72", "rms main fp16", "services_fp16", "bwd", "rms_bwd"),
        norm_entry("ln_fwd_fp16", "190", "ln main fp16", "fp16_opt", "fwd", "ln_fwd"),
        norm_entry("ln_bwd_fp16", "202", "ln main fp16", "fp16_opt", "bwd", "ln_bwd"),
        # ... and paged_decode at the serving shape (phase 2's "paged_decode
        # main fp16") with its launches on phase 4 (c)'s fp16 decode path
        {"name": "paged_decode_fp16", "route": "cuda", "source": src + "paged_decode.cu",
         "replaces": replaces + "1152", "launches": launches["paged_fp16"],
         "max_abs_err": paged16["max_abs_err"], "ms": paged16["kernel_ms"],
         "plain_ms": paged16["plain_ms"], "bound_ms": paged16["bound_ms"],
         "bound_by": paged16["bound_by"], "library_ms": paged16["library_ms"]},
        norm_entry("rms_fwd", "64", "rms main", "llama_fused", "fwd"),
        norm_entry("rms_bwd", "72", "rms main", "llama_fused", "bwd"),
        norm_entry("ln_fwd", "190", "ln main", "opt_fused", "fwd"),
        norm_entry("ln_bwd", "202", "ln main", "opt_fused", "bwd"),
        # the LayerNorm kernels at Swin's widest rows (phase 3's "ln swin
        # h128" case: 24 (a)'s stage-0 rows), with their launches at every
        # width on phase 24 (a)'s path
        norm_entry("ln_fwd_swin", "190", "ln swin h128", "swin", "fwd", "ln_fwd"),
        norm_entry("ln_bwd_swin", "202", "ln swin h128", "swin", "bwd", "ln_bwd"),
    ]}
    if args.out:
        _write_out(args.out, dict(RESULTS, **kernels))
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _write_out(path, results):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
