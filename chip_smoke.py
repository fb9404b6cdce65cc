"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                  # the smoke, phases 1-22
    python3 chip_smoke.py --persist-ab 10  # offline serving, old persist
                                           # against the scatter's
    python3 chip_smoke.py --split-sweep    # the attention kernels' split
                                           # plans, timed at other aims
    python3 chip_smoke.py --kernels grouped_gemm,mla_decode
                                           # build and run phase 3's cases
                                           # of the named kernels only
    python3 chip_smoke.py --sim            # phase 12 alone
    python3 chip_smoke.py --train-mla      # phase 21 alone
    python3 chip_smoke.py --train-ssm      # phase 22 alone

Drives ``repro_torch`` (never the JAX package) on the card:

1. environment: torch version, the card's name and power limit, TF32 off;
2. builds the eleven CUDA sources of ``build.SOURCES`` (the build line
   prints their count) from src/repro_torch/kernels/csrc with nvcc for
   sm_90a, one nvcc process per source, all at once (the causal conv and
   its backward are Triton, compiled at their first launch);
3. holds each kernel against its plain PyTorch version at the main
   paths' shapes plus other shapes (gather and scatter bit-exact, at the
   installs' and the persists' shapes, one page, short chunks, bf16 and
   f32 pools through permuted tables, the first and last layer;
   attention within 2e-2 in bf16 and 2e-5 in f32, at the edges of its
   tiles, splits, pages and masks; every kernel bit-identical over two
   calls; flash also at the chunked prefill's 256-token slices; flash
   and paged also at gemma2-2b's head dim 256 with its 4096-token
   window and softcap 50, in bf16 and f32, with q scaled so the outputs
   are O(1) and, in bf16, faults planted in the plain version (a window
   64 keys short, q's columns shifted) shown to fail the tolerance); at
   ds27b's shapes, the grouped GEMM (at every M the ds27b phase runs:
   each append's token copies and the 8-slot decode's, both projections,
   group sizes from the router, plus a planted skew, all rows in one
   group in each regime and M < 16; a group boundary moved by one row
   must fail), the absorbed MLA decode (8 slots, lengths at the tiles',
   splits' and cache's edges, all short, one at the cache's end; the
   scale 1/sqrt(576) must fail), flash at q/k 192 and v 128 (V's last 64
   columns dropped must fail) and gather and scatter of 1152-byte rows;
   it times the kernel, the plain version and one PyTorch call
   computing the same function, with CUDA events (also with a clean L2,
   and split into their kernels under torch.profiler): the median of 25
   calls for each kernel's main case and ds27b's backward cases, of 3
   for the others, which are not profiled; times the main
   gather and its indexing alternately, beside an empty kernel; then the
   round-1 persist (16 FullBlocks) the old way (layer-major bytes, a
   host slice per block) against the scatter's block-major pool, host
   time and D2H device time; at mamba2-1.3b's shapes the SSD chunk scan
   (the mamba2 phase's appends of 4000, 301 and 501 tokens, 4096 and
   100 tokens, 4 sequences, f32; bf16 held to SSD_BF16_TOL, from the
   split TF32 products' measured error; the carried state dropped, the
   cumulative sum shifted by a row and plain TF32 must fail; the round-1
   append's three kernels' parts),
   the decode step, the token's conv folded into the recurrence, every
   tail in place (8 slots, one slot's state and tails all zeros in bf16
   and f32, one slot, f32, three consecutive steps, and 3 slots of 5
   heads of (32, 16) over three steps in bf16 and f32; the decay applied
   after the update, the conv's taps reversed and, over three steps, B's
   old tail kept must fail; one decode layer of mamba2-1.3b and of
   zamba2-2.7b launches the step once and copies no tail) and the
   prefill conv (4352 channels: appends, s =
   1 over 8 slots, 2 tokens, f32; against F.conv1d too); flash and paged
   at nemotron-4-15b's group of 6 (dh 128) and minicpm-2b's 36 heads of
   64 in bf16 and f32, and the grouped GEMM at granite-moe-3b-a800m's 40
   experts, top-8, in both regimes (a moved group boundary must fail); at
   zamba2-2.7b's shapes flash at head dim 80 (the zamba2 phase's appends
   of 4000, 301 and 501 rows over its 5120-token cache, 272 rows over
   4600 keys; bf16 and f32; q's columns shifted must fail), paged at
   head dim 80 (8 slots at 4000-4848 keys, the edges of a page and of
   the cache; bf16 and f32), the SSD scan at N 64 over 80 heads (the
   phase's appends, f32; plain TF32 must fail), the decode step at 80
   heads and N 64 (also over three steps) and the conv over 5248
   channels; at the last three models' shapes flash at llama4's g 5
   (its round-2 append and 4096-row prefill), llava's g 7 (the round-2
   append and the 2880-patch append) and hubert's bidirectional (80, 80)
   over 8 clips of 1500 frames, paged over 8 slots at g 5 and g 7, each
   in bf16 and f32, and the grouped GEMM at llama4's 128 experts, top-1
   (the 4096-token prefill, a 400-token append and the 8-slot decode,
   both projections, and f32), planted faults failing; and flash's
   backward (``flash_attention_bwd``, the training path's gradient)
   against the plain backward (autograd of the plain forward) within
   TOLS of each gradient's largest |value|, bit-identical over two
   calls, at qwen's training microbatch (4 x 1023, 16 x 64, causal), GQA
   g 4 at dh 128, hubert's bidirectional (80, 80) over 2 clips of 1500,
   gemma2's dh 256 with a 256-token window and softcap 50, s 1 and 77,
   f32, and a case built so the bf16 rounding of P shows in dV; planted
   faults (the softcap's derivative dropped, the last key tile skipped,
   P left unrounded in dV, D dropped) must fail, SDPA's backward is timed
   beside it, and the kernel's two launches apart; the forward's log-sum-exp
   (what the backward reads) is held against the plain one at qwen's
   microbatch (one split) and gemma2's case (split keys: the combine
   writes it), in bf16 and f32, and the forward is timed with and
   without it; flash's backward also at granite's training microbatch
   (2 x 1023, 24 over 8 x 64: g 3) and at ds27b's MLA widths, q/k 192
   and v 128 over 32 heads (its training microbatch, 1 x 1023, the lse
   checked; s 77, where dK's rope columns left at zero and the scale
   taken from v's width must fail; f32 at s 256), SDPA's backward named
   by the backend PyTorch picks; and the grouped GEMM's backward
   (``grouped_gemm_bwd``, MoE training's gradient: dX and dW) against
   the plain backward and against autograd of the plain forward within
   TOLS, bit-identical over two calls, at granite's training microbatch
   (M 16,368 copies, gate/up and down; gate/up in f32), ds27b's
   4096-token append, llama4's 4096-token prefill (on phase 3's own
   weight stack) and the tile walk's edges (empty groups, all rows in
   one group, rows past the groups, M < E, groups past M, M 0); a group
   boundary moved by one row must fail; dX and dW timed apart beside
   ``torch._grouped_mm``; flash's backward also at zamba2's shared block
   (2 x 1023, 32 x 80, causal); the SSD scan's backward
   (``ssd_chunk_scan_bwd``) against autograd of the masked plain forward
   within SSD_BWD_TOLS (BF16_GRAD_TOL for bf16 gradients) of each
   gradient's largest |value|, bit-identical
   over two calls, at mamba2-1.3b's training microbatch (2 x 1023, 64
   heads, N 128, chunks of 256), zamba2-2.7b's (80 heads, N 64), 77 rows,
   301 rows from a carried state with a cotangent on the final state
   (dh0 checked) and f32 at 1000 rows (the reverse pass dropped, da
   taken without the reverse cumulative sum, and dCB and the carried
   contractions over one head must fail; the kernel's head groups equal
   ``ssd_scan.bwd_plan``'s, its scratch in MB printed), and the conv's
   backward (``causal_conv_bwd``) within TOLS
   at the two models' microbatches (4352 and 5248 channels), 2 rows with
   a cotangent on the new tail (dx's taps left unreversed and dw without
   the tail's rows must fail) and f32, beside the backward of
   ``F.conv1d`` + SiLU;
4. serves 6 agents x 3 rounds of full-width qwen1.5-0.5b (bf16, random
   weights from a seed) offline through the port's ServingSystem,
   asserting that every round finished, both read sides were used and
   all four kernels launched (the scatter once per persist); then the
   blocking arm must give identical tokens, and a third run under
   torch.profiler says where the time goes;
5. serves 3 agents x 4 rounds online (Poisson arrivals, think gaps on
   the modelled clock) at full width and depth, with a DRAM tier on
   each node and the think-time prefetcher, asserting that every
   round finished, all four kernels launched (the scatter once per
   persist), the tiers hit, prefetched and evicted, and the blocking arm
   gave identical tokens;
6. the online SLO layer at full width and depth: 2 batch and 2
   interactive agents arriving together behind an admission gate, with
   256-token prefill slices and class order, the online phase's DRAM
   tier and prefetcher, asserting that rounds were deferred (and, under
   a second setting, rejected), every admitted round finished, slices
   ran (the PREFILL_CHUNKED sub-state), flash launched once per layer of
   every ``append_step``, all four kernels launched, and an interactive
   round that arrived after a batch round reached its first token first;
7. chaos at full width and depth: phase 5's workload on 2 PEs + 2 DEs
   with split reads, in four arms: (a) fault-free and traced (the trace
   audit, the TTFT attribution against ``stats()``, the loading plans'
   bytes against the read ledgers), (b) untraced (equal tokens and
   ``stats()``), (c) a slow storage NIC and stragglers with hedged reads,
   (d) a DE dies while it decodes a round and its rounds restart from the
   persisted KV on the survivor (gather and flash run again, persists
   land once); (c) and (d) give (a)'s tokens, store writes and trie
   blocks (see :func:`chaos_phase`);
8. elastic roles and the compute network at full width and depth on 2
   PEs + 2 DEs with split reads and phase 5's tier: (e) a prefill-heavy
   wave then a decode-heavy wave with elastic role flips on: a DE
   becomes a PE and PEs become DEs mid-run, the flipped-in engines
   prefill and decode, a DE that leaves frees its decode state on the
   card, every engine ends ACTIVE and no tier pin is left; (f) the same
   with elastic off gives (e)'s tokens; (g) and (h) phase 5's workload
   with model collectives on the compute network under the weighted-VL
   and the FIFO arbiter: equal tokens, FIFO stalls the collectives
   longer (see :func:`elastic_phase`);
9. f32 token identity at full width: ServingSystem against the port's
   cache-free reference (full forward, then decode), unchunked and with
   the first round's prefill cut into slices;
10. gemma2-2b at full width and depth (26 layers, head dim 256, local
   layers with a 4096-token window between global ones, softcaps 50 and
   30; bf16, random weights from a seed): 4 agents x 3 rounds whose
   contexts pass the window (4624 to 5168 tokens), offline on 1 PE + 1
   DE, asserting that every round finished, all four kernels launched
   (the scatter once per persist), flash and paged ran with the window
   on sequences longer than it, and the blocking arm gave identical
   tokens; then f32 token identity with the cache-free reference on a
   4160-token first round, unchunked and in 1024-token prefill slices
   (see :func:`gemma2_phase`); a third pipelined run under
   torch.profiler says where its time goes;
11. ds27b (the paper's own model: MoE with 72 experts, top-6, over MLA
   attention) at full width and depth (30 layers, bf16, random weights
   from a seed): 4 agents x 3 rounds (4096, 384 and 512 tokens, 16
   generated each; contexts to 5040 of a 6144-token cache) offline on 1
   PE + 1 DE, asserting that every round finished, FullBlock rows are
   1152 bytes, every launch count equals its prediction from the
   packer's items, the installs, the persists, the decode steps and the
   layer kinds (gather, scatter, flash, the grouped GEMM and the
   absorbed decode launched; paged never), and the blocking arm gave
   identical tokens; a third run under torch.profiler; then f32 token
   identity at full width and depth 4 with the cache-free reference,
   unchunked and in 1024-token slices (see :func:`moe_phase`);
12. the event simulator (``repro_torch.sim``), on the host in modelled
   time: (a) DS 660B at 2P4D on 192 Table 2 trajectories of 64K in the
   basic, dualpath and oracle modes, side by side in three processes
   started with phase 3 (every agent finishes, dualpath's modelled
   ``jct_max`` under 0.95 x basic's, oracle within 1.02 x dualpath,
   mean TPOT within 15 %); (b) benchmarks/microbench_sim.py's
   saturated-link workload under ``Sim``, ``VectorSim`` and ``VectorSim``
   with its settle on the card, all three ``results()`` equal; (c) a
   traced dualpath run at 48 agents whose trace passes ``audit_sim`` and
   whose rounds' charges equal their loading plans to the byte; no
   kernel launches in it.  It prints real host seconds and events per
   host second, the modelled figures labelled so, and a ``sim`` JSON line
   (see :func:`sim_phase`);
13. mamba2-1.3b (SSM, attention-free: the state-blob path) at full
   width and depth (48 layers, bf16, random weights from a seed): 4
   agents x 3 rounds (4000, 300 and 500 tokens, 16 generated each)
   offline on 1 PE + 1 DE, asserting that every round finished, rounds 2
   and 3 read their session's state blob (8 reads of the raw state's
   ~102 MB, none split across the read sides), the launches equal their
   prediction (the SSD scan and the prefill conv per layer of each
   append, the decode step per layer of each decode step; no attention
   kernel), and the blocking arm gave identical tokens; a
   third run under torch.profiler, one blob's D2H and H2D alone, then
   f32 token identity at depth 4 with the cache-free reference,
   unchunked and in 1024-token slices (see :func:`blob_phase`);
14. granite-moe-3b-a800m, minicpm-2b and nemotron-4-15b at full width
   and depth, one after another (each model's weights freed before the
   next): 2 agents x (2048, 16), (256, 16) offline on 1 PE + 1 DE,
   asserting that every round finished, gather, scatter, flash, paged
   (and granite's grouped GEMM) launched as predicted, and the blocking
   arm gave identical tokens (see :func:`registrations_phase`);
15. zamba2-2.7b (hybrid: 54 Mamba2 layers and one shared attention block
   of 32 x 80 heads after every 6th, 9 applications, each with its own
   K/V; the state-blob path) at full width and depth (bf16, random
   weights from a seed): 4 agents x 3 rounds (4000, 300 and 500 tokens,
   16 generated each; contexts to 4848 of a 5120-token cache) offline on
   1 PE + 1 DE, asserting that every round finished, rounds 2 and 3 read
   their session's blob (8 reads of 544,338,432 bytes: the Mamba2 states
   and the shared K/V at the cache length, from the config; none split),
   the launches equal their prediction (the SSM kernels per layer, flash
   and paged per shared application; nothing else) at the appends phase
   3 held flash at, and the blocking arm gave identical tokens; a third
   run under torch.profiler, one blob's D2H and H2D alone, then f32 token
   identity at depth 12 (two shared applications) with the cache-free
   reference, unchunked and in 1024-token slices (see
   :func:`blob_phase`);
16. llama4-maverick-400b-a17b (MoE of period 2: a dense layer, then an
   MoE layer of 128 experts, top-1, and a shared expert, over GQA 40 x 8
   of 128) at full width and depth 2 (37.1 GB of bf16 weights: one MoE
   layer's experts alone are 32.2 GB): ds27b's rounds, agents and cache,
   asserting what phase 11 asserts (paged in place of the MLA decode) and
   that the grouped GEMM ran in both regimes; a profiled run; f32 token
   identity at depth 2 with the routed experts cut to 32 (see
   :func:`llama4_phase`);
17. llava-next-34b (the VLM connector) at full width and depth 48 of 60:
   (a) served offline by token ids at the registrations' rounds, with
   phase 14's checks, and profiled; (b) the VLM path on one slot: 2880
   patch embeddings appended, a 256-token text append, 16 greedy decode
   steps, every logit finite, flash once per layer of each append and
   paged once per layer of each step; (c) f32 at depth 4: the patch
   append in 1024-row slices equals the unchunked forward (see
   :func:`llava_phase`);
18. hubert-xlarge (the encoder) at full width and depth: a bf16 forward
   over 8 clips x 1500 frames, finite, flash launched once per layer and
   bidirectional, nothing else, timed and profiled; f32 at depth 2 on
   the card equal to the port's CPU forward within TOLS[f32] of the
   largest logit; moving the last frame moves the first frame's logits (see
   :func:`hubert_phase`);
19. training and checkpoints on qwen1.5-0.5b at published widths: (a) f32
   at depth 2, the card's gradients and 3 AdamW steps against the port's
   CPU path; (b) bf16 at full depth, 6 steps of 8 x 1024 tokens in 2
   microbatches with full remat (``make_train_step`` -> ``loss_fn`` ->
   ``forward`` through flash and its hand-written backward -> AdamW):
   finite, falling losses and every launch count equal to its
   prediction, host seconds per step, trained tokens per real second,
   peak memory and a profiled step; (c) ``FaultTolerantRunner`` at depth
   2 with the vocabulary cut to 8192 tokens, crashing after step 3 and
   resumed from step 2: losses and final parameters equal an
   uninterrupted run's bit for bit (see :func:`train_phase`; every (c)
   of phases 19-22 cuts the vocabulary so);
20. MoE training on granite-moe-3b-a800m at published widths, phase 19's
   three parts through the same functions: (a) f32 at depth 2, every
   token of the first batch routed to the same experts on the card and
   on the CPU, then the gradients and 3 AdamW steps against the CPU; (b)
   bf16 at full depth (32 layers, 3.3 B parameters), 5 steps of 8 x 1024
   tokens in granite's 4 microbatches with full remat, through flash,
   the grouped GEMM and their hand-written backwards, every launch count
   equal to its prediction; (c) crash and resume at depth 2, bit for
   bit;
21. MLA training on ds27b (MoE over MLA) at published widths, the same
   three parts: (a) f32 at depth 2 with the routed experts cut to 8 and
   the vocabulary to 8192, every routed token equal on the card and the
   CPU, then the gradients
   and 2 AdamW steps against the CPU; (b) bf16 cut to depth 4 (a dense
   layer, then 3 MoE layers of 72 experts, top-6; 3.50 B parameters), 5
   steps of 8 x 1024 tokens in ds27b's 8 microbatches with full remat at
   lr 1e-3,
   through flash at q/k 192, v 128, its hand-written backward at those
   widths, the grouped GEMM and its backward, every launch count equal
   to its prediction; (c) crash after step 3 and resume at depth 2 with
   8 experts, run to step 4, bit for bit (see :func:`train_mla_phase`);
22. SSM and hybrid training at published widths, through the SSD scan's
   and the conv's hand-written backwards: (a) f32, the card against the
   CPU, mamba2-1.3b at depth 2 and zamba2-2.7b at depth 6, 2 rows of 300
   tokens (a 256-row chunk and a 43-row one), 2 AdamW steps; (b)
   mamba2-1.3b at full depth (48 layers, 1.34 B parameters) in bf16, 5
   steps of 8 x 1024 tokens in its 4 microbatches with full remat,
   every gradient finite and every launch count equal to its prediction;
   (c) crash and resume at depth 2, bit for bit; (d) zamba2 at depth 6
   in bf16, 3 steps, its shared block through flash at (80, 80) and
   flash's backward (see :func:`train_ssm_phase`);
23. prints the ``kernels`` JSON line, then the contract line
   ``{"ok": true, "device": {...}}`` last.

Any failed check raises, so the script exits non-zero and prints no
result.  Without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

# cuBLAS is reproducible run to run only with a fixed workspace config,
# and torch.use_deterministic_algorithms (phase 19 (c)) refuses its
# GEMMs unless one is named before the first of them
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12,     # f32 outside the tensor cores
              "tf32": 495e12}           # dense tensor-core TF32
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the SSD scan with bf16 inputs: its output is f32 and its products are
# split TF32, whose error against the plain version was 1.9e-5 to 6.1e-5
# on an H100 (the PR 23 runs); plain TF32 (the low parts dropped) errs by
# ~1.7e-2 to 2.3e-2 at mamba2's widths, which TOLS[bf16] would pass
SSD_BF16_TOL = 2e-4
AGENT_ROUNDS = ((1024, 32), (128, 32), (128, 32))
# online: (append, gen, think seconds before the round).  The tier holds
# 18 FullBlocks per node: more than one round-1 context (16 blocks), less
# than the round-3 context it is warmed with (21), so warm-up evicts and
# the prefetcher stages blocks back; a 0.5 s think gap (the mean arrival
# gap) lets an agent's prefix survive until its next round, so rounds
# hit.  Spread arrivals decode about one agent at a time, and a decode
# step costs host time per layer, so the agent count sets the phase's
# real time: 3 agents keep it near one offline run per arm
ONLINE_ROUNDS = ((1024, 32, 0.0), (128, 32, 0.5), (128, 32, 0.5),
                 (128, 32, 0.5))
ONLINE_AGENTS = 3
ONLINE_TIER_BLOCKS = 18
# the SLO phase: two batch agents arrive at t = 0 and two interactive ones
# just after, before the first prefill slice ends, so the first rounds
# queue behind each other at the gate and in the PE fifo.  Arrivals are in
# units of the modelled time one queued first round adds to the gate's
# estimate (1.7 ms of the modelled clock at full width)
SLO_ROUNDS = ((1024, 32, 0.0), (128, 32, 0.5), (128, 32, 0.5))
SLO_CLASSES = ("batch", "batch", "interactive", "interactive")
SLO_ARRIVALS = (0.0, 0.0, 0.01, 0.02)
SLO_CHUNK = 256
# the elastic phase (modelled seconds): 12 prefill-heavy agents (a
# 1536-token append, 1 token, then a 64-token round on the hit) arrive 4
# ms apart, longer than one's prefill takes two PEs (~3 ms), so prefill
# work is queued at every observation and the controller flips a DE to a
# PE; 20 ms after the last, 8 decode-heavy agents (2 rounds of 64 tokens
# in, 48 out) arrive together and the controller flips PEs to DEs, which
# take the second rounds.  The controller observes every 2 ms
ELASTIC_WAVE1 = dict(n=12, rounds=((1536, 1, 0.0), (64, 1, 0.0)),
                     gap_s=0.004)
ELASTIC_WAVE2 = dict(n=8, rounds=((64, 48, 0.0), (64, 48, 0.0)),
                     after_s=0.02)
ELASTIC = dict(reconfig_interval_s=0.002, reconfig_patience=2,
               reconfig_idle_floor_s=1e-4)
# the gemma2 phase: full-width gemma2-2b, 4 agents at t = 0.  Round-1
# contexts reach 4624 tokens and round-3 ones 5168, past the 4096-token
# window of the local layers, so the window masks in the appends and in
# decode; rounds 2-3 hit the whole previous context
GEMMA2_ROUNDS = ((4608, 16), (256, 16), (256, 16))
GEMMA2_AGENTS = 4
GEMMA2_MAX_SEQ = 6144
# its f32 identity: a 4160-token first round, past the window, unchunked
# and in 1024-token prefill slices
GEMMA2_IDENTITY = dict(rounds=((4160, 4), (64, 4), (64, 4)), max_seq=4416,
                       chunk=1024)
# the ds27b phase: full-width, full-depth ds27b (MoE + MLA), 4 agents at
# t = 0 on 1 PE + 1 DE.  A first round of 4096 tokens, then appends of
# 384 and 512; contexts reach 5040 tokens of a 6144-token cache; rounds
# 2-3 hit the whole previous context
DS27B_ROUNDS = ((4096, 16), (384, 16), (512, 16))
# the phase's PE appends, as (rows, kv_len) of each ``append_step`` and
# so of each flash call.  Round 1: the packer's 300 ms modelled quota
# at full width takes three 4096-token prefills and the fourth's first
# 2399 rows in one step, its last 1697 rows in the next; rounds 2-3:
# the new tokens plus the context past its last full 64-token block (16
# and 32 tokens).  Phase 3 holds flash at each, and phase 11 asserts
# they are the appends it ran
DS27B_APPENDS = ((4096, 4096), (2399, 2399), (1697, 4096), (400, 4496),
                 (544, 5024))
DS27B_AGENTS = 4
DS27B_MAX_SEQ = 6144
# its f32 identity at full width and depth 4 (1 dense + 3 MoE layers,
# 14.0 GB of f32 weights): a 2112-token first round, unchunked and in
# 1024-token prefill slices
DS27B_IDENTITY = dict(depth=4, rounds=((2112, 4), (64, 4), (64, 4)),
                      max_seq=2368, chunk=1024)
# the mamba2 phase: full-width, full-depth mamba2-1.3b, 4 agents at t = 0
# on 1 PE + 1 DE.  Rounds 2-3 continue from the previous round's state
# blob, so they append the new tokens plus the last generated one (301
# and 501 tokens); the state is constant-size, the cache length only a
# scheduler budget
MAMBA2_ROUNDS = ((4000, 16), (300, 16), (500, 16))
MAMBA2_AGENTS = 4
MAMBA2_MAX_SEQ = 6144
# its f32 identity at full width and depth 4, unchunked and in 1024-token
# prefill slices
MAMBA2_IDENTITY = dict(depth=4, rounds=((2112, 4), (64, 4), (64, 4)),
                       max_seq=2368, chunk=1024)
# the zamba2 phase: full-width, full-depth zamba2-2.7b (54 Mamba2 layers,
# the shared attention block after every 6th), mamba2's rounds and agents
# so the two SSM phases compare, a 5120-token cache.  Rounds 2-3 continue
# from the previous round's blob (the Mamba2 states and the shared
# block's K/V at max_seq), appending 301 and 501 tokens; contexts reach
# 4848
ZAMBA2_MAX_SEQ = 5120
# the phase's appends as (rows, kv_len) of each ``append_step``, and so of
# each flash call: round 1's 4000-token prefills, then rounds 2-3 (the
# blob holds 4015 and 4331 tokens: the last generated token is appended
# with the new ones).  Phase 3 holds flash at each; the phase asserts
# they are the appends it ran
ZAMBA2_APPENDS = ((4000, 4000), (301, 4316), (501, 4832))
# its f32 identity at full width and depth 12 (two shared applications),
# unchunked and in 1024-token prefill slices
ZAMBA2_IDENTITY = dict(depth=12, rounds=((2112, 4), (64, 4), (64, 4)),
                       max_seq=2368, chunk=1024)
# the registrations phase: granite-moe-3b-a800m, minicpm-2b and
# nemotron-4-15b at full width and depth, one after another, 2 agents x
# (2048, 16), (256, 16) on 1 PE + 1 DE
REG_ARCHS = ("granite-moe-3b-a800m", "minicpm-2b", "nemotron-4-15b")
REG_ROUNDS = ((2048, 16), (256, 16))
REG_AGENTS = 2
REG_MAX_SEQ = 2560
# the last three models (phases 16-18).  llama4-maverick-400b-a17b at
# published width and depth 2 (one dense layer, then one MoE layer of 128
# experts of d_ff 8192, top-1, and a shared expert: 37.1 GB of bf16
# weights; one MoE layer's routed experts alone are 32.2 GB, so depth 4
# would need ~69.5 GB of weights plus init_params' f32 draw of one
# expert stack, 21.5 GB), served with ds27b's rounds, agents and cache so
# the two MoE runs compare
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_DEPTH = 2
# its appends (rows, kv_len): at depth 2 the packer's quota takes the
# four 4096-token prefills in one step, unsplit; rounds 2-3 as ds27b's.
# Phase 3 holds flash at each; phase 16 asserts they are the appends it
# ran
LLAMA4_APPENDS = ((4096, 4096), (400, 4496), (544, 5024))
# its f32 identity at depth 2 with the routed experts cut to 32 (25.9 GB
# of f32 weights: 128 experts in f32 do not fit)
LLAMA4_IDENTITY = dict(depth=2, n_experts=32,
                       rounds=((2112, 4), (64, 4), (64, 4)), max_seq=2368,
                       chunk=1024)
# llava-next-34b at published width and depth 48 of 60 (55.5 GB of bf16
# weights; 60 layers are 68.9 GB before any cache): (a) the
# registrations' rounds by token ids; (b) the VLM path on one slot: the
# patch embeddings of LLaVA-NeXT's five 576-patch anyres tiles, a text
# append by token ids, greedy decode steps; (c) f32 identity at depth 4
# of the patch append in 1024-row slices against the unchunked forward
LLAVA = "llava-next-34b"
LLAVA_DEPTH = 48
LLAVA_PATCHES = 2880
LLAVA_TEXT = 256
LLAVA_STEPS = 16
# the VLM path's one-slot cache: its tokens rounded up to whole 64-token
# pages (3200 of 3152)
LLAVA_VLM_MAX_SEQ = -(-(LLAVA_PATCHES + LLAVA_TEXT + LLAVA_STEPS) // 64) * 64
LLAVA_IDENTITY = dict(depth=4, chunk=1024)
# hubert-xlarge at published width and depth (48 layers, 1.9 GB): 8
# clips of 30 s at its 50 Hz frame rate; f32 at depth 2 on the card
# against the port's CPU forward (plain versions) on one clip
HUBERT = "hubert-xlarge"
HUBERT_CLIPS, HUBERT_FRAMES = 8, 1500
HUBERT_IDENTITY = dict(depth=2)
# the training phase (19): qwen1.5-0.5b at published widths.  (a) f32 at
# depth 2, the card against the port's CPU path from one init: 2 rows of
# 129 tokens in 2 microbatches, 3 AdamW steps; (b) bf16 at full depth, the
# slice's path: 8 rows of 1024 tokens (1023 inputs each) in qwen's 2
# microbatches (microbatches_train_4k), full remat, 6 steps; (c) crash and
# resume at depth 2 in bf16, a checkpoint every 2 steps, a crash after
# step 3, resumed from step 2 and run to 5, with the vocabulary cut to
# TRAIN_CUT_VOCAB tokens (phases 19-22: the embedding, and the untied
# head, were most of a depth-2 checkpoint's bytes, and of its save and
# restore seconds; what (c) shows, a bitwise resume, is the same at any
# vocabulary)
TRAIN_IDENTITY = dict(depth=2, batch=2, seq=129, micro=2, steps=3)
TRAIN_CUT_VOCAB = 8192
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 1024, 2, 6
TRAIN_LR = 3e-4
TRAIN_RESUME = dict(depth=2, batch=4, seq=129, micro=2, every=2, crash=3,
                    steps=5, vocab=TRAIN_CUT_VOCAB)
# MoE training (phase 20): granite-moe-3b-a800m at published widths, the
# same three parts: (a) f32 at depth 2 against the CPU, 3 AdamW steps;
# (b) bf16 at full depth, 8 rows of 1024 tokens in granite's 4
# microbatches (microbatches_train_4k), full remat, TRAIN_MOE_STEPS steps;
# (c) crash and resume at depth 2 in bf16
TRAIN_MOE_BATCH, TRAIN_MOE_STEPS = 8, 5
# MLA training (phase 21): ds27b at published widths, the same three
# parts.  (b) bf16 cut to TRAIN_MLA_DEPTH layers (one dense, then MoE
# layers: 3.50 B parameters at 4, ~16 bytes each with the f32 sums and
# moments, on top of what phases 1-20 leave allocated), all 72 experts
# and the full vocabulary, 8 rows of 1024 tokens in ds27b's 8
# microbatches (microbatches_train_4k: one 1023-input row, 6,138 routed
# copies each), full remat, TRAIN_MLA_STEPS steps at TRAIN_MLA_LR; (a) f32
# and (c) bf16 at depth 2 with the routed experts cut to
# TRAIN_MLA_EXPERTS, as phase 16's identity cuts llama4's: at 72 a
# depth-2 checkpoint is ~17 GB and the CPU side of (a) ~34 GB.  Even so
# (a)'s CPU steps and (c)'s 9.4 GB checkpoints (the untied 129,280-token
# embedding and head are 70 % of them) cost ~120 s, so (a) takes 2 steps
# and (c) runs to step 4 (three saves and a restore).  ds27b's head is
# untied, so its loss starts near ln(vocab) (~12.26, not phases 19's and
# 20's hundreds); at TRAIN_LR it rose over five steps on the card, at
# 1e-3 it falls by the fifth (PERF.md, section 6)
TRAIN_MLA_BATCH, TRAIN_MLA_STEPS, TRAIN_MLA_DEPTH = 8, 5, 4
TRAIN_MLA_LR = 1e-3
TRAIN_MLA_EXPERTS = 8
# (a) also cuts the untied vocabulary to TRAIN_CUT_VOCAB tokens, as (c)
# does (the embedding and head were ~70 % of (c)'s checkpoints and of
# (a)'s CPU work); (b) keeps all 129,280
TRAIN_MLA_IDENTITY = dict(TRAIN_IDENTITY, steps=2,
                          n_experts=TRAIN_MLA_EXPERTS, vocab=TRAIN_CUT_VOCAB)
TRAIN_MLA_RESUME = dict(TRAIN_RESUME, steps=4, n_experts=TRAIN_MLA_EXPERTS)
# SSM and hybrid training (phase 22): (a) f32 at published widths, the
# card against the CPU from one init: mamba2-1.3b at depth 2 and
# zamba2-2.7b at depth 6 (its least depth with a shared-block
# application), 2 rows of 300 tokens (299 inputs: a 256-row chunk and a
# 43-row one) in 2 microbatches, 2 AdamW steps; (b) mamba2-1.3b at full
# depth in bf16, 8 rows of 1024 tokens in its 4 microbatches
# (microbatches_train_4k), full remat, TRAIN_SSM_STEPS steps at
# TRAIN_LR, every gradient finite; (c) crash and resume of mamba2 at
# depth 2 in bf16; (d) zamba2 at depth 6 in bf16, TRAIN_HYBRID_STEPS
# steps of (b)'s batch in its 4 microbatches
TRAIN_SSM_IDENTITY = dict(depth=2, batch=2, seq=300, micro=2, steps=2)
TRAIN_SSM_BATCH, TRAIN_SSM_STEPS = 8, 5
TRAIN_HYBRID_DEPTH, TRAIN_HYBRID_STEPS = 6, 3
# the event simulator (phase 12): (a) the reference's I/O-bound point,
# DS 660B at 2P4D on Table 2's 64K trajectories; (b)
# benchmarks/microbench_sim.py's saturated-link workload; (c) a traced
# dualpath run
SIM_IO_AGENTS = 192
SIM_IO_MAX_LEN = 65536
SIM_IO_MODES = ("basic", "dualpath", "oracle")
SIM_MICRO = dict(nodes=10, agents=60, window_s=4.0, horizon_s=12.0,
                 bw_per_node=1e9, bg_load=0.8, bg_chunk=64e6, max_len=8192)
SIM_TRACED_AGENTS = 48
# profiler rows of the port's kernels, by wrapper: kernel-name prefixes
KERNEL_ROWS = {"flash_attention": ("flash_",), "paged_attention": ("paged_",),
               "kv_layer_gather": ("gather_kernel",),
               "kv_layer_scatter": ("scatter_kernel",),
               "grouped_gemm_bwd": ("gg_bwd_",),
               "grouped_gemm": ("gg_",), "mla_decode": ("mla_",),
               "ssd_chunk_scan_bwd": ("ssd_bwd_",),
               "ssd_chunk_scan": ("ssd_",),
               "ssm_step": ("ssm_step_kernel",),
               "causal_conv_bwd": ("_conv_bwd_",),
               "causal_conv": ("_conv_kernel",),
               "flash_attention_bwd": ("bwd_",)}


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


# calls timed (after warm-up calls) for a median, and profiled for a
# kernel's parts; phase 3 times each kernel's main case with these counts
# and most other cases with QUICK_TIMING's, unprofiled
# (:func:`quick_timing`), which keeps the whole smoke inside its time
# limit
TIMING = dict(reps=25, warmup=3, parts=20)
QUICK_TIMING = dict(reps=3, warmup=1, parts=0)
# host seconds spent in time_ms and kernel_parts, for the phase-3 report
TIMING_S = [0.0]


@contextlib.contextmanager
def quick_timing():
    """Time with QUICK_TIMING's counts while entered."""
    saved = dict(TIMING)
    TIMING.update(QUICK_TIMING)
    try:
        yield
    finally:
        TIMING.update(saved)


def main_first(case):
    """``case`` (a phase-3 case maker) whose first call, a kernel's main
    case, is timed with TIMING's counts and every later call under
    :func:`quick_timing`."""
    made = []

    def timed(*args, **kw):
        made.append(1)
        if len(made) == 1:
            return case(*args, **kw)
        with quick_timing():
            return case(*args, **kw)
    return timed


def time_ms(fn, reps: int | None = None, warmup: int | None = None,
            clean_l2: bool = False) -> float:
    """Median device time of one call, CUDA events around each call
    (``reps`` calls after ``warmup``; TIMING's counts by default).
    Before every timed call the 50 MB L2 is flushed (the main path finds
    its inputs cold) and the stream is kept busy for about a millisecond
    (``torch.cuda._sleep``), so the host has enqueued the whole call
    before the start event fires: the time is device time, without the
    host's launch overhead.  The flush writes 64 MB (the default),
    which leaves L2 full of dirty lines that the call's own reads must
    evict and write back; with ``clean_l2`` it reads 64 MB instead, so
    the call finds L2 cold but clean, as a decode step finds it after the
    previous layer's reads."""
    t0 = time.perf_counter()
    reps = reps or TIMING["reps"]
    warmup = TIMING["warmup"] if warmup is None else warmup
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if clean_l2:
            flush.max()
        else:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    TIMING_S[0] += time.perf_counter() - t0
    return float(np.median(times))


def short_name(key: str) -> str:
    """A profiler kernel name without namespace, template and signature."""
    return key.removeprefix("void ").replace("(anonymous namespace)::",
                                             "").split("<")[0].split("(")[0]


def device_times(prof) -> dict:
    """{kernel or copy name: (device ns, launches)} over a finished
    torch.profiler run's device events, read from its raw trace.
    ``key_averages()`` gives the same sums but first builds a Python
    event, with its tree of children, for every event of the trace (~2 a
    launch): tens of seconds after a serving run or a train step."""
    from torch.autograd import DeviceType
    out, names = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_hidden_event():
            continue
        raw = e.name()
        name = names.get(raw)
        if name is None:
            # key_averages' names are demangled, one-letter names kept
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 \
                else raw
        ns, n = out.get(name, (0, 0))
        out[name] = (ns + e.duration_ns(), n + 1)
    return out


def kernel_parts(fn, reps: int | None = None) -> dict:
    """Device ms per call of each kernel that ``fn`` launches (split and
    combine kernels apart), under torch.profiler, warm: back-to-back
    calls (TIMING's count by default), so inputs that fit in L2 stay
    there; none (an empty dict) under :func:`quick_timing`."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    reps = reps or TIMING["parts"]
    if not reps:
        return {}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {short_name(k): ns / 1e6 / reps
             for k, (ns, _) in device_times(prof).items()}
    TIMING_S[0] += time.perf_counter() - t0
    return parts


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS.get(dtype, PEAK_FLOPS[torch.float32])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, tol: float):
    """max |got - want|, and whether every element is within
    tol + tol * |want| (test_kernels.py's atol = rtol = tol)."""
    d = (got.float() - want.float()).abs()
    ok = bool((d <= tol + tol * want.float().abs()).all())
    return float(d.max()), ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _device_bytes(shape, dtype, gen):
    """Random finite values of ``dtype`` made on the card from ``gen``."""
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, dtype=dtype, device="cuda",
                             generator=gen)
    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def _copy_times(call, plain, library, nbytes):
    """The copy kernels' timings: dirty and clean L2, the kernels under
    torch.profiler, the plain version, the library call (dirty and clean
    L2), the bound."""
    b_ms, b_by = bound(nbytes, 0, torch.uint8)
    return dict(ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
                parts_ms=kernel_parts(call), plain_ms=time_ms(plain),
                library_ms=time_ms(library),
                library_ms_clean_l2=time_ms(library, clean_l2=True),
                bound_ms=b_ms, bound_by=b_by)


def _pool_and_table(rng, gen, *, n, n_pool, n_layers, pt, feat, dtype):
    """A random (n_pool, n_layers, pt, feat) pool and an int32 table of n
    distinct pages: an arange when the pool has n pages, else a
    permutation."""
    pool = _device_bytes((n_pool, n_layers, pt, feat), dtype, gen)
    ids = np.arange(n) if n_pool == n else rng.permutation(n_pool)[:n]
    return pool, torch.from_numpy(ids.astype(np.int32)).cuda()


def _gather_case(rng, gen, *, n, n_layers, layer, pt=64, feat,
                 dtype=torch.uint8, n_pool=None):
    from repro_torch.kernels import kv_layer_gather, ref
    pool, table = _pool_and_table(rng, gen, n=n, n_pool=n_pool or n,
                                  n_layers=n_layers, pt=pt, feat=feat,
                                  dtype=dtype)
    shapes = dict(pool=list(pool.shape), table=[n], layer=layer,
                  dtype=str(dtype).replace("torch.", ""))
    call = lambda: kv_layer_gather(pool, table, layer=layer)
    got = _deterministic(call)
    if not torch.equal(got, ref.kv_layer_gather_ref(pool, table,
                                                    layer=layer)):
        raise AssertionError(f"kv_layer_gather is not bit-exact at {shapes}")
    tl = table.long()
    return dict(shapes=shapes, max_abs_err=0.0, **_copy_times(
        call, lambda: ref.kv_layer_gather_ref(pool, table, layer=layer),
        lambda: pool[tl, layer], 2 * got.numel() * got.element_size()))


def gather_cases(cfg, rng):
    """The install's gathers: the round-2 install (1056 context tokens ->
    16 full 64-token pages of (layers, 64, row_bytes) uint8 FullBlocks)
    first, the round-3 install (19 pages), then the edges: one page, a
    slab of two chunks with a short last one (4-token pages of 10252-
    byte rows), bf16 and f32 pools of 48 pages through a permuted table,
    the first and the last layer."""
    from repro_torch.engines.kvio import kv_row_bytes
    gen = torch.Generator(device="cuda").manual_seed(1)
    L, row = cfg.n_layers, kv_row_bytes(cfg)
    case = main_first(lambda **kw: _gather_case(rng, gen, **{**dict(
        n=16, n_layers=L, layer=L // 2, feat=row), **kw}))
    return [case(), case(n=19), case(n=1, layer=0),
            case(pt=4, feat=10252, layer=L - 1),
            case(n_pool=48, feat=row // 2, dtype=torch.bfloat16, layer=0),
            case(n_pool=48, feat=row // 4, dtype=torch.float32,
                 layer=L - 1)]


def gather_against_indexing(cfg, rounds: int = 10) -> dict:
    """The round-2 install's gather (16 pages, one layer) and the
    indexing that computes the same, ``pool[tl, layer]``, each timed by
    ``time_ms`` with the writing and the clean flush, alternately for
    ``rounds`` rounds (the order reversed every other round), beside an
    empty kernel: the harness's floor.  Returns {name: {"dirty": [ms per
    round], "clean": [...]}}."""
    from repro_torch.engines.kvio import kv_row_bytes
    from repro_torch.kernels import kv_layer_gather
    gen = torch.Generator(device="cuda").manual_seed(4)
    L, row = cfg.n_layers, kv_row_bytes(cfg)
    pool = _device_bytes((16, L, 64, row), torch.uint8, gen)
    table = torch.arange(16, dtype=torch.int32, device="cuda")
    tl = table.long()
    calls = {"gather": lambda: kv_layer_gather(pool, table, layer=L // 2),
             "indexing": lambda: pool[tl, L // 2],
             "empty kernel": lambda: torch.cuda._sleep(0)}
    out = {k: {"dirty": [], "clean": []} for k in calls}
    for r in range(rounds):
        for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            out[k]["dirty"].append(time_ms(calls[k]))
            out[k]["clean"].append(time_ms(calls[k], clean_l2=True))
    return out


def _scatter_case(rng, gen, *, n, n_layers, layer, pt=64, feat,
                  dtype=torch.uint8, n_pool=None):
    """``layer`` an int (stream (n, pt, feat)) or a range (stream
    (len, n, pt, feat)); the kernel writes the pool in place, equal to
    the plain version, and a second call on a copy of the first's input
    gives the same bytes."""
    from repro_torch.kernels import kv_layer_scatter, ref
    pool, table = _pool_and_table(rng, gen, n=n, n_pool=n_pool or n,
                                  n_layers=n_layers, pt=pt, feat=feat,
                                  dtype=dtype)
    multi = isinstance(layer, range)
    stream = _device_bytes(((len(layer),) if multi else ()) + (n, pt, feat),
                           dtype, gen)
    shapes = dict(pool=list(pool.shape), table=[n],
                  layer=[layer.start, layer.stop] if multi else layer,
                  dtype=str(dtype).replace("torch.", ""))
    base = pool.clone()
    want = ref.kv_layer_scatter_ref(base.clone(), table, stream, layer=layer)
    call = lambda: kv_layer_scatter(pool, table, stream, layer=layer)
    if call() is not pool or not torch.equal(pool, want):
        raise AssertionError(f"kv_layer_scatter is not bit-exact in place "
                             f"at {shapes}")
    if not torch.equal(kv_layer_scatter(base, table, stream, layer=layer),
                       pool):
        raise AssertionError(f"two calls gave different bits at {shapes}")
    del base, want
    tl = table.long()
    if multi:
        dst, src = pool[:, layer.start:layer.stop], stream.transpose(0, 1)
    else:
        dst, src = pool[:, layer], stream
    return dict(shapes=shapes, max_abs_err=0.0, **_copy_times(
        call, lambda: ref.kv_layer_scatter_ref(pool, table, stream,
                                               layer=layer),
        lambda: dst.index_copy_(0, tl, src),
        2 * stream.numel() * stream.element_size()))


def scatter_cases(cfg, rng):
    """The persist's scatters: one layer of the round-1 persist (16 new
    64-token FullBlocks of (layers, 64, row_bytes) uint8) first, then the
    whole persists of rounds 1, 2 and 3 (16, 3 and 2 blocks, every layer
    in one launch, as ``kvio.serialize_blocks`` calls it), then the
    edges: one page, 4-token pages of 10252-byte rows (two chunks, the
    last short) over layers 3 .. L - 1, bf16 and f32 pools of 48 pages through a permuted table, the
    first and the last layer."""
    from repro_torch.engines.kvio import kv_row_bytes
    gen = torch.Generator(device="cuda").manual_seed(2)
    L, row = cfg.n_layers, kv_row_bytes(cfg)
    case = main_first(lambda **kw: _scatter_case(rng, gen, **{**dict(
        n=16, n_layers=L, layer=L // 2, feat=row), **kw}))
    return [case(), case(layer=range(L)), case(n=3, layer=range(L)),
            case(n=2, layer=range(L)), case(n=1, layer=0),
            case(pt=4, feat=10252, layer=range(3, L)),
            case(n_pool=48, feat=row // 2, dtype=torch.bfloat16,
                 layer=L - 1),
            case(n_pool=48, feat=row // 4, dtype=torch.float32,
                 layer=range(L))]


def split_sweep(cfg, reps=2):
    """The attention kernels' split plans at other aims than the
    wrappers' constants, at the main path's shapes: paged
    (BLOCKS_PER_SM, KEY_UNIT) and flash SPLIT_BLOCKS_PER_SM (0: never
    split).  Each setting is timed (dirty and clean L2) ``reps`` times,
    in forward then reverse order.  Returns printable lines."""
    import importlib
    from repro_torch.kernels import build, flash_attention, paged_attention
    pm = importlib.import_module("repro_torch.kernels.paged_attention")
    fm = importlib.import_module("repro_torch.kernels.flash_attention")
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to("cuda", torch.bfloat16)
    h, dh, n_sm = cfg.n_heads, cfg.head_dim, build.sm_count(0)
    lengths = [int(x) for x in rng.integers(1300, 1377, 8)]
    lines, keep = [], (pm.BLOCKS_PER_SM, pm.KEY_UNIT, fm.SPLIT_BLOCKS_PER_SM)
    try:
        for hkv in (cfg.n_kv_heads, h // 4):
            b, S, g = 8, 2048, h // hkv
            q, kc, vc = f(b, hkv, g, dh), f(b, S, hkv, dh), f(b, S, hkv, dh)
            kp, vp = (x.view(b * S // 64, 64, hkv, dh) for x in (kc, vc))
            table = torch.arange(b * S // 64, dtype=torch.int32,
                                 device="cuda").view(b, S // 64)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            call = lambda: paged_attention(q, kp, vp, table, lens)
            aims = [(2, 128), (4, 128), (8, 128), (16, 64), (8, 256)]
            for order in range(reps):
                for bps, unit in aims if order % 2 == 0 else aims[::-1]:
                    pm.BLOCKS_PER_SM, pm.KEY_UNIT = bps, unit
                    lines.append(
                        f"paged g={g} blocks/SM {bps} unit {unit} plan "
                        f"{pm.plan(b, hkv, 64, S // 64, n_sm)}: "
                        f"{time_ms(call):.4f} ms, clean L2 "
                        f"{time_ms(call, clean_l2=True):.4f} ms")
            pm.BLOCKS_PER_SM, pm.KEY_UNIT = keep[:2]
        for sq, hkv, kl in ((128, cfg.n_kv_heads, 1184),
                            (1024, cfg.n_kv_heads, 1024), (128, h // 4, 1184)):
            q = f(1, sq, h, dh).transpose(1, 2)
            k, v = (f(1, 2048, hkv, dh).transpose(1, 2) for _ in range(2))
            lens = torch.tensor([kl], dtype=torch.int32, device="cuda")
            call = lambda: flash_attention(q, k, v, kv_lens=lens)
            aims = [0, 1, 2, 4]
            for order in range(reps):
                for aim in aims if order % 2 == 0 else aims[::-1]:
                    fm.SPLIT_BLOCKS_PER_SM = aim
                    lines.append(
                        f"flash sq={sq} g={h // hkv} blocks/SM {aim} plan "
                        f"{fm.plan(1, h, hkv, sq, 2048, n_sm)}: "
                        f"{time_ms(call):.4f} ms, clean L2 "
                        f"{time_ms(call, clean_l2=True):.4f} ms")
    finally:
        pm.BLOCKS_PER_SM, pm.KEY_UNIT, fm.SPLIT_BLOCKS_PER_SM = keep
    return lines


def persist_blocks_old(cfg, state, slot, b0, b1, bt):
    """The DE's persist before the scatter: the layer-major bytes of
    FullBlocks ``b0 .. b1-1`` in one host copy, then a contiguous host
    copy of each block's strided slice."""
    from repro_torch.engines import kvio
    kv = kvio.serialize_kv(cfg, state, slot, b0 * bt, b1 * bt)
    return [np.ascontiguousarray(kv[:, i * bt:(i + 1) * bt])
            for i in range(b1 - b0)]


def persist_ab(cfg, reps=8):
    """The round-1 persist (16 new FullBlocks of one slot of an 8-slot,
    2048-token bf16 decode state) two ways, in alternation: ``old`` is
    :func:`persist_blocks_old`, ``new`` is ``serialize_blocks`` (scatter
    into a block-major pool, one copy).  Every rep's blocks stay alive,
    as the store keeps them.  Returns {way: (median host ms per persist,
    D2H device ms per persist under torch.profiler)}; raises if the two
    ways' blocks differ."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engines import kvio
    from repro_torch.models import init_decode_state
    n, bt, slot = 16, 64, 3
    state = init_decode_state(cfg, 8, 2048, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for t in state["kv"].values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda",
                            dtype=t.dtype))
    ways = {"old": persist_blocks_old, "new": kvio.serialize_blocks}
    a, b = (fn(cfg, state, slot, 0, n, bt) for fn in ways.values())
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("serialize_blocks differs from serialize_kv")
    kept, host = [], {w: [] for w in ways}
    torch.cuda.synchronize()
    for _ in range(reps):
        for w, fn in ways.items():
            t0 = time.perf_counter()
            kept.append(fn(cfg, state, slot, 0, n, bt))
            host[w].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for w, fn in ways.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                kept.append(fn(cfg, state, slot, 0, n, bt))
        d2h = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "DtoH" in e.key)
        out[w] = (float(np.median(host[w])), d2h / 1e3 / reps)
    return out


def persist_serving_ab(cfg, pairs=10):
    """Phase 4's offline serving (pipelined) with the DE persisting the
    old way and the scatter way, in one process, pairs alternating which
    way runs first, after one unmeasured pair.  Returns {way: [real wall
    s, ...]}.  Run with ``python3 chip_smoke.py --persist-ab [pairs]``."""
    from repro_torch.engines import kvio
    from repro_torch.models import init_params
    from repro_torch.sim.traces import Round, Trajectory
    params = init_params(cfg, seed=0, device="cuda")
    ways = {"old": persist_blocks_old, "new": kvio.serialize_blocks}
    walls = {w: [] for w in ways}
    try:
        for i in range(pairs + 1):
            for w in (("old", "new") if i % 2 else ("new", "old")):
                kvio.serialize_blocks = ways[w]
                trajs = [Trajectory(a, [Round(*r) for r in AGENT_ROUNDS])
                         for a in range(6)]
                _, _, wall = serve(cfg, params, trajs, "cuda", n_pe=1,
                                   n_de=1, mode="dualpath", block_tokens=64,
                                   max_seq=2048, de_slots=8)
                if i:
                    walls[w].append(wall)
    finally:
        kvio.serialize_blocks = ways["new"]
    return walls


def _deterministic(call):
    """Run ``call`` twice: the outputs must be equal bit for bit (the
    split kernels merge partials in a fixed order, with no atomics)."""
    a, b = call(), call()
    if not torch.equal(a, b):
        raise AssertionError("two calls gave different bits")
    return a


def normal(rng, shape, dtype) -> torch.Tensor:
    """N(0, 1) draws of ``shape`` on the card in ``dtype``: from a numpy
    Generator on the host, or from a CUDA ``torch.Generator`` on the card
    (for large tensors: no host draw, no copy)."""
    if isinstance(rng, torch.Generator):
        return torch.randn(shape, generator=rng, device="cuda").to(dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype)


def _planted(name, want, tol, faults: dict, check=max_err) -> dict:
    """Each fault, emulated in the plain version, must fail the check
    the kernel passes (``check(out, want, tol)`` -> (err, ok);
    :func:`max_err` unless given): the case's inputs let the tolerance see
    a fault of that size.  Returns each fault's max |err|."""
    errs = {}
    for label, out in faults.items():
        err, ok = check(out, want, tol)
        if ok:
            raise AssertionError(f"{name}: the planted fault '{label}' is "
                                 f"within the tolerance (err {err})")
        errs[label] = err
    return errs


def _flash_case(rng, *, hq, hkv, dh, sq, kv_lens, S, dtype, causal=True,
                softcap=0.0, window=0, q_std=1.0, planted=False,
                parts=False, dv=None):
    """The PE's append at the main path's layout: q (b, sq, hq, dh) and a
    padded (b, S, hkv, dh) cache, passed as (b, h, s, dh) views, with
    per-row ``kv_lens``; ``dv`` (default ``dh``) is V's width.  The
    yardstick is SDPA with the same mask; it has no softcap, so a case
    with one times it without.  ``q_std`` scales q, and so the scores'
    spread; with ``planted``, a window 64 keys short and Q's columns taken
    from the next 16-wide k-step must fail the tolerance
    (:func:`_planted`), and with ``dv`` < ``dh`` V's last 64 columns
    dropped must too."""
    from repro_torch.kernels import flash_attention, ref
    f = lambda *s: normal(rng, s, dtype)
    b, dv = len(kv_lens), dv or dh
    q = (f(b, sq, hq, dh) * q_std).transpose(1, 2)
    k = f(b, S, hkv, dh).transpose(1, 2)
    v = f(b, S, hkv, dv).transpose(1, 2)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, softcap=softcap, window=window, kv_lens=lens)
    shapes = dict(q=[b, hq, sq, dh], kv=[b, hkv, S, dh],
                  **({} if dv == dh else dict(v=[b, hkv, S, dv])),
                  kv_len=kv_lens[0] if b == 1 else list(kv_lens),
                  dtype=str(dtype).replace("torch.", ""))
    shapes.update({n: x for n, x in (("causal", causal), ("softcap", softcap),
                                     ("window", window))
                   if x != dict(causal=True, softcap=0.0, window=0)[n]})
    call = lambda: flash_attention(q, k, v, **kw)
    got = _deterministic(call)
    want = ref.flash_attention_ref(q, k, v, **kw)
    err, ok = max_err(got, want, TOLS[dtype])
    if not ok:
        raise AssertionError(f"flash_attention off by {err} at {shapes}")
    faults = None
    if planted:
        faults = {"Q from the next k-step": ref.flash_attention_ref(
            q.roll(-16, -1), k, v, **kw)}
        if window:
            faults["window 64 short"] = ref.flash_attention_ref(
                q, k, v, **{**kw, "window": window - 64})
        if dv < dh:
            faults["V's last 64 columns dropped"] = ref.flash_attention_ref(
                q, k, torch.cat([v[..., :-64], torch.zeros_like(
                    v[..., -64:])], -1), **kw)
        faults = _planted("flash_attention", want, TOLS[dtype], faults)
    # the valid (query, key) pairs; the yardstick is SDPA with this mask
    # over the same keys (it has no softcap)
    ln = lens.long()
    pos = (ln - sq)[:, None] + torch.arange(sq, device="cuda")
    cols = torch.arange(S, device="cuda")
    valid = (cols[None, None, :] < ln[:, None, None]).expand(b, sq, S)
    if causal:
        valid = valid & (cols <= pos[:, :, None])
    if window > 0:
        valid = valid & (pos[:, :, None] - cols < window)
    g = hq // hkv
    ke, ve = (x.repeat_interleave(g, dim=1) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    isz = q.element_size()
    keys = int(valid.any(dim=1).sum())     # keys some query needs
    b_ms, b_by = bound(b * sq * hq * (dh + dv) * isz +
                       keys * hkv * (dh + dv) * isz,
                       2 * (dh + dv) * hq * int(valid.sum()), dtype)
    return dict(
        shapes=shapes, max_abs_err=err, planted_err=faults,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        parts_ms=kernel_parts(call) if parts else None,
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
        library_ms=time_ms(lambda: sdpa(q, ke, ve, attn_mask=valid[:, None])),
        bound_ms=b_ms, bound_by=b_by)


def flash_cases(cfg, rng):
    h, kvh, dh, bf = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, torch.bfloat16
    case = main_first(lambda **kw: _flash_case(rng, **{**dict(
        hq=h, hkv=kvh, dh=dh, sq=128, kv_lens=[1184], S=2048, dtype=bf),
        **kw}))
    return [
        case(parts=True),                # round 2 append: 128 new tokens
                                         # over a 1056-token prefix
        case(sq=1024, kv_lens=[1024], parts=True),   # round 1 prefill
        case(hkv=h // 4, parts=True),    # GQA g = 4
        case(dtype=torch.float32),
        # edges of the tiles, the splits and the masks
        case(kv_lens=[1184, 700]),       # b = 2, unequal kv_lens
        case(sq=1),
        case(sq=77),                     # not a multiple of a row tile
        case(window=48, softcap=30.0),   # a window starting inside a tile
        case(causal=False),
        case(hkv=h // 8),                # g = 8
        case(hkv=h // 16),               # g = 16
        case(dh=128),
        case(dh=32),
        case(hkv=h // 4, kv_lens=[1184, 700], window=48, softcap=30.0,
             dtype=torch.float32),
        # the SLO phase's chunked prefill: a 1024-token append in
        # SLO_CHUNK-token slices over a prefix growing by one slice a
        # time; the last slice is timed as the main chunk shape
        case(sq=SLO_CHUNK, kv_lens=[1024], parts=True),
        *(case(sq=SLO_CHUNK, kv_lens=[n]) for n in (256, 512, 768)),
    ]


def _paged_case(rng, *, hq, hkv, dh, S, lengths, dtype, pt=64,
                softcap=0.0, window=0, q_std=1.0, planted=False,
                parts=False):
    """The DE's decode at the main path's layout: the padded (b, S, hkv,
    dh) cache viewed as ``pt``-token pages with an arange block table.
    The yardstick is SDPA with the same (length and window) mask and no
    softcap; the bound counts the K/V inside each window.  ``q_std`` and
    ``planted`` as for :func:`_flash_case` (the window's fault where
    there is a window); the other planted fault is each lane reading the
    next lane's 16 bytes of q."""
    from repro_torch.kernels import paged_attention, ref
    f = lambda *s: normal(rng, s, dtype)
    b, g = len(lengths), hq // hkv
    q = f(b, hkv, g, dh) * q_std
    kc, vc = f(b, S, hkv, dh), f(b, S, hkv, dh)
    kp, vp = (x.view(b * S // pt, pt, hkv, dh) for x in (kc, vc))
    table = torch.arange(b * S // pt, dtype=torch.int32,
                         device="cuda").view(b, S // pt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    shapes = dict(q=[b, hkv, g, dh], pool=list(kp.shape),
                  lengths=list(lengths),
                  dtype=str(dtype).replace("torch.", ""))
    shapes.update({n: x for n, x in (("softcap", softcap),
                                     ("window", window)) if x})
    kw = dict(softcap=softcap, window=window)
    call = lambda: paged_attention(q, kp, vp, table, lens, **kw)
    got = _deterministic(call)
    want = ref.paged_attention_ref(q, kp, vp, table, lens, **kw)
    err, ok = max_err(got, want, TOLS[dtype])
    if not ok:
        raise AssertionError(f"paged_attention off by {err} at {shapes}")
    e = 16 // q.element_size()
    faults = None
    if planted:
        faults = {"q from the next lane": ref.paged_attention_ref(
            q.roll(-e, -1), kp, vp, table, lens, **kw)}
        if window:
            faults["window 64 short"] = ref.paged_attention_ref(
                q, kp, vp, table, lens, softcap=softcap, window=window - 64)
        faults = _planted("paged_attention", want, TOLS[dtype], faults)
    qs = q.reshape(b, hq, 1, dh)
    ke, ve = (x.transpose(1, 2).repeat_interleave(g, dim=1)
              for x in (kc, vc))
    cols, ln = torch.arange(S, device="cuda")[None, :], lens[:, None].long()
    mask = cols < ln
    if window > 0:
        mask = mask & (ln - 1 - cols < window)
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    isz = q.element_size()
    tot = int(sum(min(n, window) if window > 0 else n for n in lengths))
    b_ms, b_by = bound(2 * b * hq * dh * isz + 2 * tot * hkv * dh * isz,
                       4 * dh * hq * tot, dtype)
    return dict(
        shapes=shapes, max_abs_err=err, planted_err=faults,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        parts_ms=kernel_parts(call) if parts else None,
        plain_ms=time_ms(lambda: ref.paged_attention_ref(q, kp, vp, table,
                                                         lens, **kw)),
        library_ms=time_ms(lambda: sdpa(qs, ke, ve, attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by)


def paged_cases(cfg, rng):
    h, kvh, dh, bf = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, torch.bfloat16
    # 8 slots mid-round-3: contexts of 1300..1376 tokens
    lengths = [int(x) for x in rng.integers(1300, 1377, 8)]
    edges = [1, 63, 64, 65, 2048]
    case = main_first(lambda **kw: _paged_case(rng, **{**dict(
        hq=h, hkv=kvh, dh=dh, S=2048, lengths=lengths, dtype=bf), **kw}))
    return [
        case(parts=True),
        case(hkv=h // 4, parts=True),    # GQA g = 4
        case(dtype=torch.float32),
        # edges of the splits and the pages
        case(lengths=edges),
        case(S=268, pt=4, lengths=[1, 100, 267, 268]),   # the f32 identity
                                                         # phase's pages
        case(hkv=h // 8),                # g = 8
        case(hkv=h // 16),               # g = 16
        case(dh=128),
        case(hkv=h // 8, lengths=edges, dtype=torch.float32),
        case(dh=128, S=268, pt=4, lengths=[1, 100, 267, 268],
             dtype=torch.float32),
    ]


# q's scale in the gemma2 and ds27b attention cases: scores of standard
# deviation about 3 make the softmax over thousands of keys peaked, as a
# trained model's is, so the outputs are O(1).  At 1, the softmax is
# nearly flat, the outputs about 0.026, and the bf16 tolerance as large
# as what it compares.
Q_STD = 3.0


def gemma2_flash_cases(cfg, rng):
    """Flash at gemma2-2b's shapes, window and softcap: the round-2 append
    of the gemma2 phase (256 queries over kv_len 4880 of a 6144 cache),
    a 1024-row prefill chunk whose queries cross the window's edge
    (positions 3584-4607), and the append in f32.  The bf16 cases check
    that planted faults fail the tolerance."""
    case = lambda **kw: _flash_case(rng, **{**dict(
        hq=cfg.n_heads, hkv=cfg.n_kv_heads, dh=cfg.head_dim, sq=256,
        kv_lens=[4880], S=GEMMA2_MAX_SEQ, dtype=torch.bfloat16,
        window=cfg.local_window, softcap=cfg.attn_logit_softcap,
        q_std=Q_STD), **kw})
    return [case(parts=True, planted=True),
            case(sq=1024, kv_lens=[4608], parts=True, planted=True),
            case(dtype=torch.float32)]


def gemma2_paged_cases(cfg, rng):
    """Paged at gemma2-2b's shapes, window and softcap: 8 slots with
    contexts of 4600-4900 tokens (the window masks their oldest keys),
    contexts up to the window (it masks nothing), the edges of the
    window and the cache, and the main case in f32.  The main case
    checks that planted faults fail the tolerance."""
    lengths = [int(x) for x in rng.integers(4600, 4901, 8)]
    case = lambda **kw: _paged_case(rng, **{**dict(
        hq=cfg.n_heads, hkv=cfg.n_kv_heads, dh=cfg.head_dim,
        S=GEMMA2_MAX_SEQ, lengths=lengths, dtype=torch.bfloat16,
        window=cfg.local_window, softcap=cfg.attn_logit_softcap,
        q_std=Q_STD), **kw})
    w = cfg.local_window
    return [case(parts=True, planted=True),
            case(lengths=[int(x) for x in rng.integers(3000, w, 7)] + [w]),
            case(lengths=[1, 64, w - 1, w, w + 1, w + 65,
                          GEMMA2_MAX_SEQ - 1, GEMMA2_MAX_SEQ]),
            case(dtype=torch.float32)]


# ---------------------------------------------------------------------------
# phase 3 at ds27b's shapes: grouped GEMM, absorbed MLA decode, flash at
# q/k 192 and v 128, gather and scatter of 1152-byte rows
# ---------------------------------------------------------------------------

def router_group_sizes(cfg, tokens: int, gen) -> torch.Tensor:
    """Group sizes (E,) int32 on the card from the port's router
    (``models.moe.route`` and ``_sort_by_expert``) on random tokens, with
    a router of the schema's init std."""
    from repro_torch.models import moe
    d, m = cfg.d_model, cfg.moe
    p = {"router": (torch.randn((d, m.n_experts), generator=gen,
                                device="cuda") / d ** 0.5).bfloat16()}
    x = torch.randn((tokens, d), generator=gen,
                    device="cuda").bfloat16()
    _, idx = moe.route(p, cfg, x)
    return moe._sort_by_expert(idx, tokens, m.top_k, m.n_experts)[3]


def skewed(sizes: torch.Tensor) -> torch.Tensor:
    """The planted skew: ``sizes`` with group 0 empty and group 1 holding
    a quarter of the rows, the rest shared as before, the sum kept."""
    n = sizes.cpu().numpy().astype(np.int64)
    m, quarter = int(n.sum()), int(n.sum()) // 4
    rest = n.copy()
    rest[:2] = 0
    rest = rest * (m - quarter) // max(int(rest.sum()), 1)
    rest[2 + int(np.argmax(rest[2:]))] += m - quarter - int(rest.sum())
    rest[1] = quarter
    return torch.from_numpy(rest.astype(np.int32)).cuda()


def _moved_boundary(sizes: torch.Tensor) -> torch.Tensor:
    """The planted fault: the last row of the first non-empty group moved
    into the next non-empty group."""
    n = sizes.cpu().numpy().copy()
    e0 = int(np.flatnonzero(n)[0])
    e1 = int(np.flatnonzero(n[e0 + 1:])[0]) + e0 + 1
    n[e0] -= 1
    n[e1] += 1
    return torch.from_numpy(n).cuda()


def _grouped_mm_library(x, w, sizes):
    """One PyTorch call computing the grouped GEMM, and its name:
    ``torch._grouped_mm`` on the row-major (E, K, N) ``w`` where this
    torch has it, for bf16 only; else None (the per-expert cuBLAS loop is
    the plain version).  It must agree with the plain version."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or x.dtype != torch.bfloat16:
        return None, None
    from repro_torch.kernels import ref
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    call = lambda: fn(x, w, offs=offs)
    err, ok = max_err(call(), ref.grouped_gemm_ref(x, w, sizes),
                      TOLS[x.dtype])
    assert ok, f"torch._grouped_mm off by {err}: no yardstick"
    return call, "torch._grouped_mm"


def expert_weights(gen, e: int, k: int, n: int, dtype) -> torch.Tensor:
    """w (E, K, N) of the schema's std 1/sqrt(K) drawn on the card one
    expert at a time, so a stack of 10.7 GB (llama4's 128 experts of
    5120 x 8192 in bf16) needs no f32 copy of itself."""
    w = torch.empty((e, k, n), dtype=dtype, device="cuda")
    for i in range(e):
        w[i] = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    return w


def _gg_case(gen, *, sizes, k, n, dtype=torch.bfloat16, planted=False,
             label="", w=None):
    """``grouped_gemm`` on x (M, K) ~ N(0, 1) and w (E, K, N) of the
    schema's std 1/sqrt(K) (drawn here, or ``w`` given), M = sum(sizes):
    held against the per-group plain version, bit-identical over two
    calls; with ``planted``, a group boundary moved by one row must fail
    the tolerance.  The bound reads each used expert's weights once."""
    import importlib
    from repro_torch.kernels import grouped_gemm, ref
    gg = importlib.import_module("repro_torch.kernels.grouped_gemm")
    e, m = sizes.shape[0], int(sizes.sum())
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    if w is None:
        w = (torch.randn((e, k, n), generator=gen, device="cuda") /
             k ** 0.5).to(dtype)
    assert w.shape == (e, k, n) and w.dtype == dtype, (w.shape, w.dtype)
    used = int((sizes > 0).sum())
    shapes = dict(x=[m, k], w=[e, k, n], groups_used=used,
                  largest_group=int(sizes.max()),
                  dtype=str(dtype).replace("torch.", ""),
                  **({"regime": gg.regime(m, e, k, n)}
                     if dtype == torch.bfloat16 else {}),
                  **({"case": label} if label else {}))
    call = lambda: grouped_gemm(x, w, sizes)
    got = _deterministic(call)
    want = ref.grouped_gemm_ref(x, w, sizes)
    err, ok = max_err(got, want, TOLS[dtype])
    if not ok:
        raise AssertionError(f"grouped_gemm off by {err} at {shapes}")
    faults = _planted("grouped_gemm", want, TOLS[dtype], {
        "a group boundary moved by one row": ref.grouped_gemm_ref(
            x, w, _moved_boundary(sizes))}) if planted else None
    lib, lib_name = _grouped_mm_library(x, w, sizes)
    isz = x.element_size()
    b_ms, b_by = bound((m * k + used * k * n + m * n) * isz, 2 * m * k * n,
                       dtype)
    return dict(
        shapes=shapes, max_abs_err=err, planted_err=faults,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        plain_ms=time_ms(lambda: ref.grouped_gemm_ref(x, w, sizes)),
        library_ms=None if lib is None else time_ms(lib),
        library_name=lib_name or "none (the per-expert loop is the plain "
                                 "version)",
        bound_ms=b_ms, bound_by=b_by)


def one_group(m: int, e: int, group: int = 5) -> torch.Tensor:
    """Group sizes with all ``m`` rows in one group."""
    sizes = torch.zeros(e, dtype=torch.int32, device="cuda")
    sizes[group] = m
    return sizes


def grouped_gemm_cases(cfg, rng):
    """ds27b's expert projections at every M the ds27b phase runs, gate/up
    (K 2560 -> N 1536) and down (1536 -> 2560), with group sizes from the
    port's router on random tokens: the copies of each append of
    ``DS27B_APPENDS`` (M = 6 x 4096, 2399, 1697, 400 and 544 tokens: the
    append regime) and of an 8-slot decode (M = 48, most of the 72 groups
    empty: the decode regime); the 4096-token append again with a planted
    skew (an empty group, a group of a quarter of the rows); all rows in
    one group in each regime; M < 16; an f32 case.  The 4096-token
    append's gate case is the main case."""
    import importlib
    gg = importlib.import_module("repro_torch.kernels.grouped_gemm")
    gen = torch.Generator(device="cuda").manual_seed(5)
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    copies = cfg.moe.top_k
    decode = router_group_sizes(cfg, 8, gen)
    appends = {rows: router_group_sizes(cfg, rows, gen)
               for rows, _ in DS27B_APPENDS}
    case = main_first(lambda **kw: _gg_case(gen, **{**dict(k=d, n=f),
                                                    **kw}))
    cases = [case(sizes=appends[4096], planted=True,
                  label="append 4096, gate/up"),
             case(sizes=appends[4096], k=f, n=d, label="append 4096, down")]
    for rows, _ in DS27B_APPENDS[1:]:
        cases += [case(sizes=appends[rows], label=f"append {rows}, gate/up"),
                  case(sizes=appends[rows], k=f, n=d,
                       label=f"append {rows}, down")]
    cases += [
        case(sizes=decode, planted=True, label="decode, gate/up"),
        case(sizes=decode, k=f, n=d, label="decode, down"),
        case(sizes=skewed(appends[4096]), planted=True,
             label="append 4096, skew"),
        case(sizes=one_group(8 * copies, e), label="decode, one group"),
        case(sizes=one_group(400 * copies, e), label="append 400, one group"),
        case(sizes=router_group_sizes(cfg, 2, gen), planted=True,
             label="2 tokens (M 12)"),
        case(sizes=router_group_sizes(cfg, 256, gen), dtype=torch.float32,
             label="256 tokens, f32")]
    regimes = {c["shapes"].get("regime") for c in cases}
    assert regimes >= set(gg.REGIMES), f"regimes held: {regimes}"
    return cases


def _mla_case(rng, *, lengths, S, dtype=torch.bfloat16, q_std=Q_STD,
              planted=False, parts=False):
    """``mla_decode`` at ds27b's widths (32 heads, r 512, rd 64) over a
    padded (b, S) latent cache with unit-variance rows, as the kv norm
    makes them, against the plain version; with ``planted``, the scale
    1/sqrt(r + rd) in place of 1/sqrt(nope + rope) must fail the
    tolerance.  The yardstick is SDPA over the latent rows as one shared
    key-value head (keys c || krope, values c) with the length mask."""
    import math
    from repro_torch.kernels import mla_decode, ref
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
    b, h, r, rd = len(lengths), 32, 512, 64
    q_lat, q_rope = f(b, h, r) * q_std, f(b, h, rd) * q_std
    c, krope = f(b, S, r), f(b, S, rd)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(192)
    shapes = dict(q_lat=[b, h, r], c=[b, S, r], lengths=list(lengths),
                  dtype=str(dtype).replace("torch.", ""))
    call = lambda: mla_decode(q_lat, q_rope, c, krope, lens, scale=scale)
    got = _deterministic(call)
    want = ref.mla_decode_ref(q_lat, q_rope, c, krope, lens, scale=scale)
    err, ok = max_err(got, want, TOLS[dtype])
    if not ok:
        raise AssertionError(f"mla_decode off by {err} at {shapes}")
    faults = _planted("mla_decode", want, TOLS[dtype], {
        "scale 1/sqrt(576)": ref.mla_decode_ref(
            q_lat, q_rope, c, krope, lens, scale=1.0 / math.sqrt(r + rd))}) \
        if planted else None
    qs = torch.cat([q_lat, q_rope], -1)[:, :, None]     # (b, h, 1, 576)
    ks = torch.cat([c, krope], -1)[:, None]             # (b, 1, S, 576)
    mask = (torch.arange(S, device="cuda")[None, :] <
            lens[:, None].long())[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(qs, ks.expand(b, h, S, r + rd),
                       c[:, None].expand(b, h, S, r), attn_mask=mask,
                       scale=scale)
    try:                        # a yardstick only: null where SDPA refuses
        lib()
        torch.cuda.synchronize()
    except RuntimeError:
        lib = None
    isz = c.element_size()
    tot = int(sum(min(n, S) for n in lengths))
    b_ms, b_by = bound(tot * (r + rd) * isz + b * h * (2 * r + rd) * isz,
                       2 * tot * h * (2 * r + rd), dtype)
    return dict(
        shapes=shapes, max_abs_err=err, planted_err=faults,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        parts_ms=kernel_parts(call) if parts else None,
        plain_ms=time_ms(lambda: ref.mla_decode_ref(
            q_lat, q_rope, c, krope, lens, scale=scale)),
        library_ms=None if lib is None else time_ms(lib), bound_ms=b_ms,
        bound_by=b_by)


def mla_decode_cases(cfg, rng):
    """The DE's absorbed decode over ds27b's 8 slots: contexts of the
    ds27b phase's third round (4600-5040 tokens) first, then the edges
    of the tiles, the splits and the cache (1, 63, 64, 65, 4095, 4096,
    5000, 6144), every length at most 64 (all but a row's first split
    exit at once), one row at the cache's end and seven short ones (one
    row's splits merge while the others' have exited), and the main case
    in f32."""
    lengths = [int(x) for x in rng.integers(4600, 5041, 8)]
    case = main_first(lambda **kw: _mla_case(rng, **{**dict(
        lengths=lengths, S=DS27B_MAX_SEQ), **kw}))
    return [case(planted=True, parts=True),
            case(lengths=[1, 63, 64, 65, 4095, 4096, 5000, DS27B_MAX_SEQ],
                 planted=True),
            case(lengths=[int(x) for x in rng.integers(1, 65, 8)],
                 planted=True),
            case(lengths=[DS27B_MAX_SEQ] +
                 [int(x) for x in rng.integers(1, 200, 7)], planted=True),
            case(dtype=torch.float32)]


def mla_flash_cases(cfg, rng):
    """Flash at ds27b's MLA append widths (32 heads, q/k 192, v 128) at
    each of the ds27b phase's appends (``DS27B_APPENDS``; the port
    expands K/V up to the longest row, so the cache the kernel sees is
    kv_len long), a 1024-row slice at the end of a chunked 4096-token
    prefill, and the 2399-row round-1 slice in f32.  Every bf16 case
    checks that planted faults (Q's columns shifted, V's last 64 columns
    dropped) fail the tolerance."""
    m = cfg.mla
    case = lambda sq, kv, **kw: _flash_case(rng, **{**dict(
        hq=cfg.n_heads, hkv=cfg.n_heads, dh=m.nope_head_dim + m.rope_head_dim,
        dv=m.v_head_dim, sq=sq, kv_lens=[kv], S=kv, dtype=torch.bfloat16,
        q_std=Q_STD, planted=True), **kw})
    return [*(case(sq, kv, parts=True) for sq, kv in DS27B_APPENDS),
            case(1024, 4096),
            case(*DS27B_APPENDS[1], dtype=torch.float32, planted=False)]


def ds27b_copy_cases(cfg, rng):
    """Gather and scatter of ds27b's 1152-byte MLA rows (30 layers): the
    round-2 install's gather of one layer (64 pages) and the round-1
    persist's scatter of every layer (64 blocks), then a 7-page gather
    and a 7-block persist (round 2), all bit-exact."""
    from repro_torch.engines.kvio import kv_row_bytes
    g_gen = torch.Generator(device="cuda").manual_seed(6)
    L, row = cfg.n_layers, kv_row_bytes(cfg)
    assert row == 1152, row
    gather = [_gather_case(rng, g_gen, n=n, n_layers=L, layer=L // 2,
                           feat=row) for n in (64, 7)]
    scatter = [_scatter_case(rng, g_gen, n=n, n_layers=L, layer=range(L),
                             feat=row) for n in (64, 7)]
    return gather, scatter


# ---------------------------------------------------------------------------
# phase 3 at mamba2-1.3b's shapes: the SSD scan, the recurrent step and the
# causal conv
# ---------------------------------------------------------------------------


def _ssm_inputs(gen, cfg, b, s, dtype):
    """One Mamba2 layer's inputs to its device work at ``cfg``'s widths,
    laid out as the model hands them over: x, B and C as views into one
    (b, s, d_inner + 2N) conv output ~ N(0, 1) in ``dtype``; dt =
    softplus(N(0, 1) + dt_bias) f32 with dt_bias drawn as the schema
    draws it; A = -U[1, 16] and D ~ 1 + N(0, 0.1), f32."""
    import math
    d_inner, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    H, P = d_inner // cfg.ssm.head_dim, cfg.ssm.head_dim
    dev = "cuda"
    xbc = torch.randn((b, s, d_inner + 2 * n), generator=gen,
                      device=dev).to(dtype)
    x = xbc[..., :d_inner].view(b, s, H, P)
    B, C = xbc[..., d_inner:d_inner + n], xbc[..., d_inner + n:]
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((H,), generator=gen, device=dev)
    dt_bias = torch.log(torch.expm1(torch.exp(lo + u * (hi - lo))))
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, H), generator=gen, device=dev) + dt_bias)
    A = -(1.0 + 15.0 * torch.rand((H,), generator=gen, device=dev))
    D = 1.0 + 0.1 * torch.randn((H,), generator=gen, device=dev)
    return x, B, C, dt, A, D


def _twice(call):
    """Run ``call`` twice from the same inputs: every output bit-equal."""
    a, b = call(), call()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("two calls gave different bits")
    return a


def _ssd_case(gen, cfg, *, b, s, dtype=torch.bfloat16, h0=False,
              planted=False, label="", parts=False):
    """``ssd_chunk_scan`` on one layer's inputs (:func:`_ssm_inputs`), the
    config's chunk, zeros or a random carried state: y and the final
    state against the plain version, bit-identical over two calls, within
    TOLS[f32] for f32 inputs and SSD_BF16_TOL for bf16 ones; with
    ``planted``, the carried state dropped and the cumulative sum shifted
    by one row must fail the tolerance, and with bf16 inputs the plain
    version in plain TF32 too (the split's low parts dropped).  The bound
    reads x, B, C, dt and h0 once and writes y and the state once; its
    operations count C.B^T once per chunk (shared by the heads) and, per
    head, the weighted x, the carried state's term and the state update,
    over the rows this call's chunks hold.  f32 inputs run them as f32
    FMAs: the f32 peak.  bf16 inputs run them as the kernel issues them,
    TF32 MMAs at the TF32 peak, C.B^T one a product and the others two
    (an f32 operand in two parts); ``bound_ms_f32_peak`` keeps the f32
    peak's figure beside it.  With ``parts``, each of the call's kernels'
    device time too (warm, :func:`kernel_parts`)."""
    from repro_torch.kernels import ref, ssd_chunk_scan
    x, B, C, dt, A, D = _ssm_inputs(gen, cfg, b, s, dtype)
    H, P, N = x.shape[2], x.shape[3], B.shape[2]
    state = torch.randn((b, H, P, N), generator=gen, device="cuda") \
        if h0 else None
    chunk = cfg.ssm.chunk_size
    shapes = dict(b=b, s=s, H=H, P=P, N=N, chunk=min(chunk, s),
                  h0=bool(h0), dtype=str(dtype).replace("torch.", ""),
                  **({"case": label} if label else {}))
    call = lambda: ssd_chunk_scan(x, B, C, dt, A, D, state, chunk)
    y, h = _twice(call)
    want_y, want_h = ref.ssd_chunk_scan_ref(x, B, C, dt, A, D, state, chunk)
    bf16 = dtype == torch.bfloat16
    tol = SSD_BF16_TOL if bf16 else TOLS[torch.float32]
    err_y, ok_y = max_err(y, want_y, tol)
    err_h, ok_h = max_err(h, want_h, tol)
    if not (ok_y and ok_h):
        raise AssertionError(
            f"ssd_chunk_scan off by {err_y} (y, max |y| "
            f"{float(want_y.abs().max())}), {err_h} (state, max |h| "
            f"{float(want_h.abs().max())}) at {shapes}")
    plant = lambda **kw: ref._ssd_scan(x, B, C, dt, A, D, state, chunk,
                                       **kw)[0]
    faults = _planted("ssd_chunk_scan", want_y, tol, {
        "carried state dropped": plant(carry=False),
        "cumsum shifted by one row": plant(shift=1),
        **({"plain TF32 (low parts dropped)": plant(tf32=True)}
           if bf16 else {})}) if planted else None
    L = min(chunk, s)
    lens = [min(L, s - c0) for c0 in range(0, s, L)]
    tri = sum(t * (t + 1) // 2 for t in lens)
    fma_cb, fma_heads = b * N * tri, b * H * (P * tri + 2 * s * P * N)
    isz = x.element_size()
    states = (2 if h0 else 1) * b * H * P * N * 4
    nbytes = b * s * (H * P + 2 * N) * isz + b * s * H * 4 + \
        b * s * H * P * 4 + states
    f32_ms, f32_by = bound(nbytes, 2 * (fma_cb + fma_heads), torch.float32)
    b_ms, b_by = bound(nbytes, 2 * (fma_cb + 2 * fma_heads), "tf32") \
        if bf16 else (f32_ms, f32_by)
    return dict(
        shapes=shapes, max_abs_err=max(err_y, err_h), planted_err=faults,
        tol=tol,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        parts_ms=kernel_parts(call) if parts else None,
        plain_ms=time_ms(lambda: ref.ssd_chunk_scan_ref(
            x, B, C, dt, A, D, state, chunk)),
        library_ms=None,
        library_name="none (no single PyTorch call computes the scan)",
        bound_ms=b_ms, bound_by=b_by, bound_ms_f32_peak=f32_ms)


def ssd_cases(cfg):
    """The SSD scan at mamba2-1.3b's widths (64 heads of 64, N 128, chunks
    of 256): the mamba2 phase's appends (round 1's 4000 tokens, from
    zeros; rounds 2-3's 301 and 501 tokens from a carried state: the new
    tokens plus the last generated one), 4096 tokens (16 whole chunks),
    100 tokens (one chunk shorter than 256), 4 sequences of 300 from
    carried states, and f32.  The first case is the main one and checks
    the planted faults, as do the continuation and the 4 sequences; the
    main case reads its kernels' parts."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    case = main_first(lambda **kw: _ssd_case(gen, cfg, **{
        **dict(b=1, s=4000), **kw}))
    return [case(planted=True, label="round-1 append", parts=True),
            case(s=301, h0=True, planted=True, label="round-2 append"),
            case(s=501, h0=True, label="round-3 append"),
            case(s=4096),
            case(s=100),
            case(b=4, s=300, h0=True, planted=True),
            case(s=1000, h0=True, dtype=torch.float32)]


def _ssm_step_case(gen, cfg, *, b, dtype=torch.bfloat16, zero_slot=None,
                   planted=False, steps=1, label=""):
    """``ssm_step`` over ``b`` slots of one layer's decode, ``steps``
    consecutive steps from one state: each step's pre-conv x, B and C
    (:func:`_ssm_inputs`), conv weights of the schema's std 1/sqrt(cw),
    random tails and a random f32 state, slot ``zero_slot``'s state and
    tails all zeros.  Each step's y, the final state and all three tails
    after each step (every one in place) against the plain version,
    bit-identical over two runs from the same state, the tails
    bit-exact: a later step convolves the tails the kernel left, so
    three steps show that the kernel's arrival counters come back to 0
    and its last block per slot writes B's and C's rows.  The plain
    version sums the token's conv in f32 and rounds it once, as the
    kernel does (``f32_conv``; the CPU path keeps the reference's bf16
    order, and the CPU tests hold both against the reference): that
    order rounds each product and partial sum, so its conv outputs sit a
    few bf16 steps from the kernel's, and y, a sum of 128 products of
    them, moved by 0.143 against it on an H100, past TOLS[bf16] where y
    is near 0.  Summed alike, the conv outputs agree in bf16 too, so y
    and the state are held to TOLS[f32] in both dtypes, as the step alone
    was (a conv output rounded the other way would fail it).  With
    ``planted``, the decay applied after the update and the conv's taps
    reversed must fail the tolerance, and over several steps B's tail
    left as it was (the tail write lost) too.  The bound reads and
    writes the state once, reads the token, the weights, dt and the
    tails and writes y and the tails; the operations are the
    recurrence's and the conv's (C.B^T once for the slots, not per
    head).  The times are of one step; beside them, PyTorch's in-place
    ``mul_`` of a state of the same shape (one tuned elementwise kernel
    that reads and writes it once, and nothing else: the least this
    timing gives any kernel that streams the state)."""
    from repro_torch.kernels import ref, ssm_step
    xs, Bs, Cs, dts, A, D = _ssm_inputs(gen, cfg, b, steps, dtype)
    tokens = [(xs[:, i], Bs[:, i], Cs[:, i], dts[:, i].contiguous())
              for i in range(steps)]
    H, P, N = xs.shape[2], xs.shape[3], Bs.shape[2]
    cw = cfg.ssm.conv_width
    dev = "cuda"
    weights = tuple((torch.randn((cw, c), generator=gen, device=dev) /
                     cw ** 0.5).to(dtype) for c in (H * P, N, N))
    tails = tuple(torch.randn((b, cw - 1, c), generator=gen,
                              device=dev).to(dtype) for c in (H * P, N, N))
    h = torch.randn((b, H, P, N), generator=gen, device=dev)
    if zero_slot is not None:
        for t in (h, *tails):
            t[zero_slot] = 0
    shapes = dict(b=b, H=H, P=P, N=N, cw=cw,
                  dtype=str(dtype).replace("torch.", ""),
                  **({} if zero_slot is None else {"zero_slot": zero_slot}),
                  **({} if steps == 1 else {"steps": steps}),
                  **({"case": label} if label else {}))

    def run(fn=ssm_step, ws=weights, keep_B=False, **kw):
        """``steps`` steps from copies of the state and tails: (each
        step's y, the final state, each tail after each step), stacked
        over steps; ``keep_B`` puts B's old tail back after each step."""
        hk, tk = h.clone(), tuple(t.clone() for t in tails)
        ys, seen = [], []
        for x, B, C, dt in tokens:
            old_B = tk[1].clone()
            ys.append(fn(hk, x, B, C, *ws, *tk, dt, A, D, **kw))
            if keep_B:
                tk[1].copy_(old_B)
            seen.append(tuple(t.clone() for t in tk))
        return (torch.stack(ys), hk,
                *(torch.stack(ts) for ts in zip(*seen)))

    got = _twice(run)
    plain = functools.partial(run, ref.ssm_conv_step_ref, f32_conv=True)
    want = plain()
    tol = TOLS[torch.float32]
    err_y, ok_y = max_err(got[0], want[0], tol)
    err_h, ok_h = max_err(got[1], want[1], tol)
    tails_ok = all(torch.equal(g, w) for g, w in zip(got[2:], want[2:]))
    if not (ok_y and ok_h and tails_ok):
        raise AssertionError(f"ssm_step off by {err_y} (y), {err_h} (state) "
                             f"at {shapes}; tails equal: {tails_ok}")
    faults = None
    if planted:
        faults = {"decay after the update": plain(decay_after=True)[0],
                  "conv taps reversed": plain(ws=tuple(
                      w.flip(0) for w in weights))[0]}
        if steps > 1:
            kept = plain(keep_B=True)
            assert not torch.equal(kept[3], want[3])
            faults["old B tail kept"] = kept[0]
        faults = _planted("ssm_step", want[0], tol, faults)
    x, B, C, dt = tokens[0]
    work, work_t = h.clone(), tuple(t.clone() for t in tails)
    work_p, work_pt = h.clone(), tuple(t.clone() for t in tails)
    call = lambda: ssm_step(work, x, B, C, *weights, *work_t, dt, A, D)
    isz = x.element_size()
    ch = H * P + 2 * N
    b_ms, b_by = bound(2 * b * H * P * N * 4 + b * ch * isz + cw * ch * isz
                       + 2 * b * (cw - 1) * ch * isz + b * H * 4 +
                       b * H * P * 4,
                       6 * b * H * P * N + (2 * cw + 4) * b * ch,
                       torch.float32)
    return dict(
        shapes=shapes, max_abs_err=max(err_y, err_h), planted_err=faults,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        plain_ms=time_ms(lambda: ref.ssm_conv_step_ref(
            work_p, x, B, C, *weights, *work_pt, dt, A, D)),
        state_rmw_ms=time_ms(lambda: work_p.mul_(1.0)),
        library_ms=None,
        library_name="none (no single PyTorch call computes the step)",
        bound_ms=b_ms, bound_by=b_by)


def ssm_config_at(cfg, heads, head_dim, d_state):
    """``cfg`` cut to ``heads`` SSD heads of ``head_dim`` at N ``d_state``
    (expand 2): widths the step's walk must mask or take in several
    float4s a lane."""
    return dataclasses.replace(
        cfg, d_model=heads * head_dim // 2, ssm=dataclasses.replace(
            cfg.ssm, d_state=d_state, head_dim=head_dim, expand=2))


def ssm_step_cases(cfg):
    """The decode step (the token's conv, then the recurrence) over the
    DE's 8 slots at mamba2-1.3b's widths (the main case, with the planted
    faults), slot 3's state and tails all zeros (a slot just admitted
    from a fresh prefill starts from a real state, an idle one stays
    zero) in bf16 and f32, one slot, f32, three consecutive steps from
    one state (the lost tail write planted), and other widths over
    consecutive steps: 5 heads of 32 at N 16 over 3 slots in bf16 and f32
    (4 lanes a row, 32 of a pass's 64 rows), 3 heads of 24 at N 132 (a
    lane takes 2 float4s of a row, 31 of 32 lanes idle for the second),
    and the largest N and P the wrapper takes: 2 heads of 64 at N 1024
    in f32 (49 KB of shared memory, past the 48 KB a launch gets without
    opting in) and bf16, and 2 heads of 1024 at N 1024 in f32 (68 KB)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    case = main_first(lambda c=cfg, **kw: _ssm_step_case(
        gen, c, **{**dict(b=8), **kw}))
    odd = ssm_config_at(cfg, 5, 32, 16)
    n132 = ssm_config_at(cfg, 3, 24, 132)
    wide = ssm_config_at(cfg, 2, 64, 1024)
    widest = ssm_config_at(cfg, 2, 1024, 1024)
    f32 = torch.float32
    return [case(planted=True), case(zero_slot=3, planted=True), case(b=1),
            case(dtype=f32),
            case(zero_slot=3, dtype=f32, planted=True),
            case(steps=3, planted=True, label="three steps"),
            case(odd, b=3, steps=3, planted=True, label="odd widths"),
            case(odd, b=3, steps=3, dtype=f32, label="odd widths"),
            case(n132, b=2, steps=2, planted=True, label="N 132"),
            case(wide, b=3, steps=3, dtype=f32, planted=True,
                 label="N 1024"),
            case(wide, b=3, steps=2, label="N 1024"),
            case(widest, b=1, steps=2, dtype=f32, label="P 1024, N 1024")]


def _conv_case(gen, *, b, s, c, cw, dtype=torch.bfloat16, label=""):
    """``causal_conv`` on x (b, s, c) ~ N(0, 1), weights of the schema's
    std 1/sqrt(cw) and a random tail: the output against the plain
    version (the reference's bf16 order), the new tail bit-exact, both
    bit-identical over two calls.  The library call is ``F.conv1d``
    (groups = c) over tail ‖ x laid out as it wants, then SiLU."""
    from repro_torch.kernels import causal_conv, ref
    F = torch.nn.functional
    x = torch.randn((b, s, c), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((cw, c), generator=gen, device="cuda") /
         cw ** 0.5).to(dtype)
    tail = torch.randn((b, cw - 1, c), generator=gen,
                       device="cuda").to(dtype)
    shapes = dict(x=[b, s, c], cw=cw, dtype=str(dtype).replace("torch.", ""),
                  **({"case": label} if label else {}))
    call = lambda: causal_conv(x, w, tail)
    out, new_tail = _twice(call)
    want, want_tail = ref.causal_conv_ref(x, w, tail)
    # f32: four products and a SiLU, summed in the same order as the
    # plain version; bf16: one rounding against the reference's five
    tol = 1e-5 if dtype == torch.float32 else TOLS[dtype]
    err, ok = max_err(out, want, tol)
    if not ok or not torch.equal(new_tail, want_tail):
        raise AssertionError(f"causal_conv off by {err} at {shapes} (tail "
                             f"equal: {torch.equal(new_tail, want_tail)})")
    xp = torch.cat([tail, x], dim=1).transpose(1, 2).contiguous()
    wt = w.t().contiguous().view(c, 1, cw)
    lib = lambda: F.silu(F.conv1d(xp, wt, groups=c))
    lib_err, lib_ok = max_err(lib().transpose(1, 2), want, tol)
    assert lib_ok, f"F.conv1d off by {lib_err}: no yardstick"
    isz = x.element_size()
    b_ms, b_by = bound((2 * b * s * c + 2 * b * (cw - 1) * c + cw * c) * isz,
                       (2 * cw + 4) * b * s * c, torch.float32)
    return dict(
        shapes=shapes, max_abs_err=err, planted_err=None,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        plain_ms=time_ms(lambda: ref.causal_conv_ref(x, w, tail)),
        library_ms=time_ms(lib), library_name="F.conv1d + F.silu",
        bound_ms=b_ms, bound_by=b_by)


def conv_cases(cfg):
    """The causal conv over mamba2-1.3b's 4352 channels (x, B and C
    concatenated), width 4: the round-1 append (4000 tokens, the main
    case), the 301-token append, the 8-slot decode step (s = 1, the
    tails carried), 2 tokens (fewer than the tail), and f32."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    c = cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.d_state
    case = main_first(lambda **kw: _conv_case(gen, **{**dict(
        b=1, s=4000, c=c, cw=cfg.ssm.conv_width), **kw}))
    return [case(label="round-1 append"), case(s=301, label="append"),
            case(b=8, s=1, label="decode"), case(s=2),
            case(s=301, dtype=torch.float32)]


# ---------------------------------------------------------------------------
# phase 3, the SSM backwards: the SSD scan's and the conv's gradients, the
# SSM and hybrid training path's (phase 22)
# ---------------------------------------------------------------------------


# each gradient of the SSD scan's backward held within this share of its
# own largest |value| (:func:`ssd_grads_err`): the f32 ones (ddt, dA, dh0,
# and every one with f32 inputs) by the inputs' dtype, the bf16 ones (dx,
# dB, dC, dD with bf16 inputs) within BF16_GRAD_TOL.  On an H100 the f32
# gradients of bf16 inputs (split TF32 products) erred by up to 1.2e-5;
# the bf16 ones by 4.9e-3, one bf16 step at their largest values (2^-8 to
# 2^-7 of it), where the kernel's f32 sum and the plain version's round
# to neighbouring bf16 values
SSD_BWD_TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-4}
BF16_GRAD_TOL = 1e-2


def ssd_grads_err(got, want, tol: float):
    """:func:`grads_err` with each bf16 gradient held to BF16_GRAD_TOL and
    each f32 one to ``tol``: (max |err|, all within)."""
    errs, ok = [], True
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        lim = BF16_GRAD_TOL if w.dtype == torch.bfloat16 else tol
        ok &= err <= lim * float(w.float().abs().max())
        errs.append(err)
    return max(errs), ok


def _nonnull(grads) -> tuple:
    return tuple(g for g in grads if g is not None)


def ssd_bwd_plain(x, B, C, dt, A, D, h0, chunk: int, dy, dh=None, *,
                  carry: bool = True, da_cumsum: bool = True,
                  dbc_heads: int | None = None, head_group: int | None = None,
                  tile: int = 64):
    """``ref.ssd_chunk_scan_bwd_ref`` computed as the card's backward
    (``csrc/ssd_scan_bwd.cu``) splits it, in f32, to plant faults in
    (tests/test_torch_ssm_training.py holds it against autograd).  Per
    chunk (``a = dt·A``, ``cs`` its cumulative sum, f64 rounded once;
    ``e_ij = exp(cs_i - cs_j)`` for j <= i; ``u = dt·x``; ``h_in`` the
    state entering the chunk, from the forward's split; ``g`` the
    cotangent of the state leaving it):
    (1) ``Q_c = Σ_i e^{cs_i} dy_i ⊗ C_i``, then the reverse pass over the
    chunks, ``g_{c-1} = e^{cs_end} g_c + Q_c`` from ``g = dh``, the last
    ``g`` being dh0; (2) per chunk and head, with ``M_ij = e_ij (dy_i ·
    u_j)``, ``du_j = Σ_{i>=j} (C_i·B_j) e_ij dy_i + e^{cs_end - cs_j} g
    B_j``, dx = dt·du + D·dy, ``ddt = x · du``; (3) ``dCB = Σ_h M``, the
    cotangent of C·Bᵀ, summed as the chunk kernel sums it (each group of
    ``head_group`` heads in index order, then the groups in order;
    ``ssd_scan.bwd_plan`` by default), then ``dB_j = Σ_i dCB_ij C_i +
    Σ_{h,p} e^{cs_end - cs_j} u_j g`` and ``dC_i = Σ_j dCB_ij B_j +
    Σ_{h,p} e^{cs_i} dy_i h_in``, the carried terms one contraction over
    H·P; (4) ``dcs`` from the quadratic term (``W = (C·B) ∘ M`` per head:
    its row sums taken a column tile of ``tile`` rows at a time, summed
    in tile order, less its column sums), the carried state's (``e^{cs_i}
    C_i · dy_i h_in``, per head) and the state update's (``v_j =
    e^{cs_end - cs_j} u_j · g B_j``: ``-v_j`` on row j, their sum and
    ``e^{cs_end} <g, h_in>`` on the last row), then ``da_k = Σ_{i>=k}
    dcs_i`` (f64), ``ddt += da·A``, ``dA = Σ da·dt``, ``dD = Σ dy·x``.
    ``carry=False`` drops the reverse pass (each chunk gets a zero ``g``,
    the last one ``dh``), ``da_cumsum=False`` takes ``da = dcs``,
    ``dbc_heads`` keeps only that many heads in dCB and in the carried
    contractions: the faults the card's check must see fail.  Returns
    (dx, dB, dC, ddt, dA, dD, dh0) as ``ref.ssd_chunk_scan_bwd_ref``
    does."""
    from repro_torch.kernels.ssd_scan import bwd_plan
    b, s, H, P = x.shape
    N = B.shape[-1]
    L = min(chunk, s)
    hpg = bwd_plan(b, s, H, L)[0] if head_group is None else head_group
    heads = H if dbc_heads is None else dbc_heads
    xf, Bf, Cf, dtf = x.float(), B.float(), C.float(), dt.float()
    dyf, Af, Df = dy.float(), A.float(), D.float()
    spans = [(r0, min(s, r0 + L)) for r0 in range(0, s, L)]
    cs = [torch.cumsum((dtf[:, r0:r1] * Af).double(), dim=1).float()
          for r0, r1 in spans]
    # the forward's states entering each chunk
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    h_in = []
    for (r0, r1), c in zip(spans, cs):
        h_in.append(h)
        w = torch.exp(c[:, -1:, :] - c) * dtf[:, r0:r1]
        h = h * torch.exp(c[:, -1, :])[:, :, None, None] + torch.einsum(
            "blh,bln,blhp->bhpn", w, Bf[:, r0:r1], xf[:, r0:r1])
    # (1) the reverse pass
    g = torch.zeros_like(h) if dh is None else dh.float()
    g_out = [None] * len(spans)
    for k in reversed(range(len(spans))):
        r0, r1 = spans[k]
        g_out[k] = g if carry or k == len(spans) - 1 else torch.zeros_like(g)
        q = torch.einsum("bih,bihp,bin->bhpn", torch.exp(cs[k]),
                         dyf[:, r0:r1], Cf[:, r0:r1])
        g = g_out[k] * torch.exp(cs[k][:, -1, :])[:, :, None, None] + q
    dh0 = None if h0 is None else g
    # (2) - (4), chunk by chunk
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dB = torch.empty((b, s, N), dtype=torch.float32, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros_like(Af)
    for (r0, r1), c, hc, gc in zip(spans, cs, h_in, g_out):
        n = r1 - r0
        xc, dyc, Bc, Cc = xf[:, r0:r1], dyf[:, r0:r1], Bf[:, r0:r1], \
            Cf[:, r0:r1]
        dtc = dtf[:, r0:r1]
        u = dtc[..., None] * xc
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        e = torch.exp(torch.where(causal, c[:, :, None, :] - c[:, None, :, :],
                                  float("-inf")))               # (b,i,j,H)
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)[..., None]
        M = e * torch.einsum("bihp,bjhp->bijh", dyc, u)
        W = cb * M
        ed = torch.exp(c[:, -1:, :] - c)                          # (b,n,H)
        gB = torch.einsum("bhpn,bjn->bjhp", gc, Bc)
        du = torch.einsum("bijh,bihp->bjhp", cb * e, dyc) + ed[..., None] * gB
        dx[:, r0:r1] = dtc[..., None] * du + Df[:, None] * dyc
        ddt[:, r0:r1] = (xc * du).sum(-1)
        v = ed * (u * gB).sum(-1)
        # (3) dCB, each group's heads in order, then the groups in order
        dcb = torch.zeros((b, n, n), dtype=torch.float32, device=x.device)
        for g0 in range(0, heads, hpg):
            part = M[..., g0]
            for hh in range(g0 + 1, min(g0 + hpg, heads)):
                part = part + M[..., hh]
            dcb = dcb + part
        ue = (ed[..., None] * u)[:, :, :heads].reshape(b, n, heads * P)
        ye = (torch.exp(c)[..., None] * dyc)[:, :, :heads].reshape(
            b, n, heads * P)
        dB[:, r0:r1] = torch.einsum("bij,bin->bjn", dcb, Cc) + \
            ue @ gc[:, :heads].reshape(b, heads * P, N)
        dC[:, r0:r1] = torch.einsum("bij,bjn->bin", dcb, Bc) + \
            ye @ hc[:, :heads].reshape(b, heads * P, N)
        # (4) dcs: W's row sums a column tile at a time, in tile order
        rows = torch.zeros_like(c)
        for j0 in range(0, n, tile):
            rows = rows + W[:, :, j0:j0 + tile].sum(2)
        dyh = torch.einsum("bihp,bhpn->bihn", dyc, hc)
        dcs = rows - W.sum(1) + torch.exp(c) * torch.einsum(
            "bihn,bin->bih", dyh, Cc) - v
        dcs[:, -1] += v.sum(1) + torch.exp(c[:, -1]) * torch.einsum(
            "bhpn,bhpn->bh", gc, hc)
        da = dcs.double().flip(1).cumsum(1).flip(1).float() if da_cumsum \
            else dcs
        ddt[:, r0:r1] += da * Af
        dA += (da * dtc).sum((0, 1))
    dD = (dyf * xf).sum((0, 1, 3))
    return (dx.to(x.dtype), dB.to(B.dtype), dC.to(C.dtype), ddt,
            dA.to(A.dtype), dD.to(D.dtype), dh0)


def ssd_bwd_fmas(b, s, H, P, N, L) -> dict:
    """The SSD backward's multiply-adds over this call's rows, with t =
    l (l + 1) / 2 pairs j <= i in a chunk of l rows.  The gradient's own
    (the least): b H (4 s P N + 2 t P) + b 2 t N (Q, g·B, u·g, dy·h_in;
    M and G·dy, once per head; dCB·C and dCB·B, once: B and C carry no
    head index).  As the kernels issue them: every product over whole
    64-row tiles and tile pairs; on the bf16 path each on ``wgmma`` from
    bf16 parts (an f32 operand in two, lo·lo dropped: two products for
    an f32 operand against a bf16 one, three for two f32 operands).
    Beside them the counts of the earlier per-head dB/dC design (M·C
    and M·B once per head, M again for each 64 columns of N, every
    product as split TF32).  Returns a dict of these counts."""
    lens = [min(L, s - c0) for c0 in range(0, s, L)]
    tri = sum(n * (n + 1) // 2 for n in lens)
    tiles = sum(-(-n // 64) for n in lens)
    pairs = sum(-(-n // 64) * (-(-n // 64) + 1) // 2 for n in lens)
    nh = N // 64
    own = b * H * (4 * s * P * N + 2 * tri * P) + b * 2 * tri * N
    rows = 64 * tiles                    # rows as the tiles cover them
    tile2 = 64 * 64 * pairs              # products of 64 x 64 tile pairs
    # Q; g·B; M and G·dy; x·g and dy·h_in; dCB·C and dCB·B
    q, gb, m, gdy = H * P * N * rows, H * N * P * rows, H * P * tile2, \
        H * P * tile2
    xg, yh, dcb = H * P * N * rows, H * P * N * rows, 2 * N * tile2
    issued = b * (q + gb + m + gdy + xg + yh + dcb)
    wgmma = b * (2 * q + 2 * gb + 2 * m + 3 * gdy + 2 * xg + 3 * yh +
                 2 * dcb)
    pr32 = b * H * (4 * s * P * N + tri * P * (1 + 2 * nh) + 2 * tri * N)
    pr32_mma = b * H * (9 * s * P * N + 3 * tri * P + 4 * nh * tri * P +
                        4 * tri * N)
    return dict(own=own, issued=issued, wgmma=wgmma, pr32_issued=pr32,
                pr32_mma=pr32_mma)


def _ssd_bwd_case(gen, cfg, *, b, s, dtype=torch.bfloat16, h0=False,
                  planted=False, label=""):
    """``ssd_chunk_scan_bwd`` on one layer's inputs (:func:`_ssm_inputs`,
    x, B and C as views into the conv's output, as training hands them
    over) at the config's chunk, dy ~ N(0, 1) f32, with the forward's
    scratch kept as ``_SSDChunkScan`` keeps it; with ``h0`` a random
    carried state and a random cotangent of the final state (dh0 is
    checked).  Every gradient against ``ref.ssd_chunk_scan_bwd_ref``
    (autograd of the masked plain forward) within SSD_BWD_TOLS (f32
    gradients) or BF16_GRAD_TOL (bf16 ones) of its own largest |value|
    (:func:`ssd_grads_err`), bit-identical over two calls;
    with ``planted`` the faults of :func:`ssd_bwd_plain` --
    the reverse pass dropped (when there are two chunks or more), da
    taken as dcs without the reverse cumulative sum, dCB and the carried
    contractions over one head -- must fail it.  The kernel's head groups
    (``ssd_scan.bwd_plan``'s, which the CPU mirror follows too) and its
    scratch in MB are reported.  The bound is the gradient's least
    multiply-adds (:func:`ssd_bwd_fmas`: dCB once, no split copies) at
    the TF32 peak for bf16 inputs, the rate their products run at, and
    at the f32 peak for f32 ones; ``bound_ms_f32_peak``, the FMAs as the
    kernels issue them and as the earlier per-head dB/dC design issued them
    are printed beside it.  No PyTorch call computes the gradient."""
    from repro_torch.kernels import ref, ssd_chunk_scan_bwd
    from repro_torch.kernels.ssd_scan import _bwd_fn, _forward, bwd_plan
    x, B, C, dt, A, D = _ssm_inputs(gen, cfg, b, s, dtype)
    H, P, N = x.shape[2], x.shape[3], B.shape[2]
    dev = "cuda"
    state = torch.randn((b, H, P, N), generator=gen, device=dev) \
        if h0 else None
    dh = torch.randn((b, H, P, N), generator=gen, device=dev) \
        if h0 else None
    dy = torch.randn((b, s, H, P), generator=gen, device=dev)
    chunk = cfg.ssm.chunk_size
    L = min(chunk, s)
    shapes = dict(x=[b, s, H, P], N=N, chunk=L, h0=bool(h0),
                  dtype=str(dtype).replace("torch.", ""),
                  **({"case": label} if label else {}))
    _, _, saved = _forward(x, B, C, dt, A, D, state, chunk)
    hpg = bwd_plan(b, s, H, L)[0]
    workspace_mb = _bwd_fn()[1](N, b, s, H, L, hpg) * 4 / 1e6
    call = lambda: _nonnull(ssd_chunk_scan_bwd(x, B, C, dt, A, D, state,
                                               chunk, dy, dh, saved=saved))
    got = _twice(call)
    want = _nonnull(ref.ssd_chunk_scan_bwd_ref(x, B, C, dt, A, D, state,
                                               chunk, dy, dh))
    tol = SSD_BWD_TOLS[dtype]
    err, ok = ssd_grads_err(got, want, tol)
    rel = {nm: float((g.float() - w.float()).abs().max() /
                     w.float().abs().max())
           for nm, g, w in zip(("dx", "dB", "dC", "ddt", "dA", "dD", "dh0"),
                               got, want)}
    if not ok:
        raise AssertionError(f"ssd_chunk_scan_bwd off at {shapes}: each "
                             f"gradient's error over its largest |value| "
                             f"{rel}")
    faults = None
    if planted:
        plant = lambda **kw: _nonnull(ssd_bwd_plain(
            x, B, C, dt, A, D, state, chunk, dy, dh, **kw))
        faults = _planted("ssd_chunk_scan_bwd", want, tol, {
            **({"the reverse pass dropped": plant(carry=False)}
               if s > L else {}),
            "da taken as dcs (no reverse cumulative sum)":
                plant(da_cumsum=False),
            "dCB and the carried contractions over one head":
                plant(dbc_heads=1)},
            check=ssd_grads_err)
    fmas = ssd_bwd_fmas(b, s, H, P, N, L)
    fma = fmas["own"]
    isz, nc = x.element_size(), -(-s // L)
    lt = -(-L // 64) * 64
    states = (3 if h0 else 1) * b * H * P * N * 4
    nbytes = 2 * b * s * (H * P + 2 * N) * isz + 2 * b * s * H * 4 + \
        b * s * H * P * 4 + states + b * nc * (lt * lt + H * lt) * 4 + \
        b * nc * H * P * N * 4
    f32_ms, f32_by = bound(nbytes, 2 * fma, torch.float32)
    b_ms, b_by = bound(nbytes, 2 * fma, "tf32") \
        if dtype == torch.bfloat16 else (f32_ms, f32_by)
    return dict(
        shapes=shapes, max_abs_err=err, rel_err=max(rel.values()),
        rel_err_by_grad=rel, planted_err=faults, tol=tol,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        parts_ms=kernel_parts(call),
        plain_ms=time_ms(lambda: ref.ssd_chunk_scan_bwd_ref(
            x, B, C, dt, A, D, state, chunk, dy, dh)),
        library_ms=None,
        library_name="none (no PyTorch call computes the scan's gradient)",
        fmas=fma, fmas_issued=fmas["issued"],
        wgmma_fmas_issued=fmas["wgmma"] if dtype == torch.bfloat16
        else None,
        fmas_pr32=fmas["pr32_issued"],
        mma_fmas_pr32=fmas["pr32_mma"] if dtype == torch.bfloat16 else None,
        heads_per_group=hpg, workspace_mb=workspace_mb,
        bound_ms=b_ms, bound_by=b_by, bound_ms_f32_peak=f32_ms)


def ssd_bwd_cases(cfg_m2, cfg_z2):
    """The SSD scan's backward: mamba2-1.3b's training microbatch (2 rows
    of 1023 inputs: chunks of 256, the last 255 rows; 64 heads of 64, N
    128; the main case, with the planted faults), zamba2-2.7b's (80 heads,
    N 64), 77 rows (under one chunk), 301 rows from a carried state with
    a cotangent on the final state (the append's form, dh0 checked, the
    planted faults), and f32 at 1000 rows.  The main case is timed with
    TIMING's counts, the others with QUICK_TIMING's."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    mb = TRAIN_SSM_BATCH // cfg_m2.microbatches_train_4k
    case = main_first(lambda c=cfg_m2, **kw: _ssd_bwd_case(
        gen, c, **{**dict(b=mb, s=TRAIN_SEQ - 1), **kw}))
    return [case(planted=True, label="mamba2 training microbatch"),
            case(cfg_z2, label="zamba2 training microbatch"),
            case(b=2, s=77),
            case(b=1, s=301, h0=True, planted=True, label="append"),
            case(b=1, s=1000, dtype=torch.float32)]


def conv_bwd_plain(x, w, tail, dout, dnew_tail=None, *, taps_reversed=True,
                   tail_in_dw=True):
    """The conv's gradient in closed form, f32 (the forward summed as the
    kernel sums it), to plant faults in: without ``taps_reversed`` dx
    takes the taps in the forward's order, without ``tail_in_dw`` dw
    leaves out the tail's rows.  Returns (dx, dw, dtail) in f32."""
    cw, s = w.shape[0], x.shape[1]
    xp, wf = torch.cat([tail, x], dim=1).float(), w.float()
    pre = xp[:, :s] * wf[0]
    for i in range(1, cw):
        pre = pre + xp[:, i:i + s] * wf[i]
    sg = torch.sigmoid(pre)
    dp = dout.float() * sg * (1 + pre * (1 - sg))
    dxp = torch.zeros_like(xp)
    for i in range(cw):
        dxp[:, i:i + s] += dp * wf[i if taps_reversed else cw - 1 - i]
    if dnew_tail is not None:
        dxp[:, s:] += dnew_tail.float()
    xw = xp.clone()
    if not tail_in_dw:
        xw[:, :cw - 1] = 0
    dw = torch.stack([(dp * xw[:, i:i + s]).sum((0, 1)) for i in range(cw)])
    return dxp[:, cw - 1:], dw, dxp[:, :cw - 1]


def _conv_bwd_case(gen, *, b, s, c, cw, dtype=torch.bfloat16, dnew=False,
                   planted=False, label=""):
    """``causal_conv_bwd`` on x (b, s, c) ~ N(0, 1), weights of the schema's
    std 1/sqrt(cw), a random tail, dout ~ N(0, 1) and, with ``dnew``, a
    cotangent of the new tail: dx, dw and dtail against
    ``ref.causal_conv_bwd_ref(..., f32_sum=True)`` (autograd of the plain
    forward summed as the kernel sums it) within TOLS of each one's
    largest |value|, bit-identical over two calls; with ``planted``, dx's
    taps left unreversed and dw without the tail's rows
    (:func:`conv_bwd_plain`) must fail.  The library call is the backward
    of ``F.conv1d`` (groups = c) + SiLU over tail ‖ x laid out as it
    wants, its graph kept; the bound is bytes (x, dout, dx, the tails, w
    and dw once)."""
    from repro_torch.kernels import causal_conv_bwd, ref
    F = torch.nn.functional
    dev = "cuda"
    x = torch.randn((b, s, c), generator=gen, device=dev).to(dtype)
    w = (torch.randn((cw, c), generator=gen, device=dev) /
         cw ** 0.5).to(dtype)
    tail = torch.randn((b, cw - 1, c), generator=gen, device=dev).to(dtype)
    dout = torch.randn((b, s, c), generator=gen, device=dev).to(dtype)
    dnt = torch.randn((b, cw - 1, c), generator=gen, device=dev).to(dtype) \
        if dnew else None
    shapes = dict(x=[b, s, c], cw=cw, dtype=str(dtype).replace("torch.", ""),
                  dnew_tail=bool(dnew), **({"case": label} if label else {}))
    call = lambda: causal_conv_bwd(x, w, tail, dout, dnt)
    got = _twice(call)
    want = ref.causal_conv_bwd_ref(x, w, tail, dout, dnt, f32_sum=True)
    tol = TOLS[dtype]
    err, ok = grads_err(got, want, tol)
    rel = {nm: float((g.float() - w_.float()).abs().max() /
                     w_.float().abs().max())
           for nm, g, w_ in zip(("dx", "dw", "dtail"), got, want)}
    if not ok:
        raise AssertionError(f"causal_conv_bwd off at {shapes}: each "
                             f"gradient's error over its largest |value| "
                             f"{rel}")
    faults = _planted("causal_conv_bwd", want, tol, {
        "dx's taps not reversed": conv_bwd_plain(
            x, w, tail, dout, dnt, taps_reversed=False),
        "dw without the tail's rows": conv_bwd_plain(
            x, w, tail, dout, dnt, tail_in_dw=False)},
        check=grads_err) if planted else None
    xp = torch.cat([tail, x], dim=1).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    wt = w.t().contiguous().view(c, 1, cw).requires_grad_(True)
    with torch.enable_grad():
        lib_out = F.silu(F.conv1d(xp, wt, groups=c))
    dout_t = dout.transpose(1, 2).contiguous()
    lib = lambda: torch.autograd.grad(lib_out, (xp, wt), dout_t,
                                      retain_graph=True)
    isz = x.element_size()
    b_ms, b_by = bound((3 * b * s * c + (3 if dnew else 2) * b * (cw - 1) * c
                        + 2 * cw * c) * isz, (4 * cw + 10) * b * s * c,
                       torch.float32)
    return dict(
        shapes=shapes, max_abs_err=err, rel_err=max(rel.values()),
        rel_err_by_grad=rel, planted_err=faults, tol=tol,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        parts_ms=kernel_parts(call),
        plain_ms=time_ms(lambda: ref.causal_conv_bwd_ref(
            x, w, tail, dout, dnt, f32_sum=True)),
        library_ms=time_ms(lib),
        library_name="backward of F.conv1d (groups = c) + F.silu",
        bound_ms=b_ms, bound_by=b_by)


def conv_bwd_cases(cfg_m2, cfg_z2):
    """The conv's backward over mamba2-1.3b's 4352 channels (x, B and C
    concatenated) at its training microbatch, 2 x 1023 (the main case,
    with the planted faults), zamba2-2.7b's 5248, 2 rows (under cw - 1:
    rows of the tail reach the new tail) with a cotangent of the new
    tail (the planted faults), and f32.  The main case is timed with
    TIMING's counts, the others with QUICK_TIMING's."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    width = lambda c: c.ssm.expand * c.d_model + 2 * c.ssm.d_state
    mb = TRAIN_SSM_BATCH // cfg_m2.microbatches_train_4k
    case = main_first(lambda **kw: _conv_bwd_case(gen, **{**dict(
        b=mb, s=TRAIN_SEQ - 1, c=width(cfg_m2),
        cw=cfg_m2.ssm.conv_width), **kw}))
    return [case(planted=True, label="mamba2 training microbatch"),
            case(c=width(cfg_z2), label="zamba2 training microbatch"),
            case(s=2, dnew=True, planted=True),
            case(dtype=torch.float32)]


# ---------------------------------------------------------------------------
# phase 3 at the registrations' shapes: flash and paged at nemotron-4-15b's
# group of 6 (48 heads over 8 x 128) and minicpm-2b's 36 heads of 64 (g 1),
# the grouped GEMM at granite-moe-3b-a800m's 40 experts, top-8
# ---------------------------------------------------------------------------


def registration_attention_cases(rng):
    """Flash and paged at nemotron's and minicpm's heads, at the
    registrations phase's shapes (round 2's 272-token append over a
    2320-token context, the 2048-token prefill; 8 decode slots at
    2300-2336 tokens of a 2560-token cache), bf16 and f32; nemotron's bf16 append checks
    the planted faults."""
    from repro_torch.configs import get_config
    flash, paged = [], []
    lengths = [int(x) for x in rng.integers(2300, 2337, 8)]
    for arch in ("nemotron-4-15b", "minicpm-2b"):
        cfg = get_config(arch)
        heads = dict(hq=cfg.n_heads, hkv=cfg.n_kv_heads, dh=cfg.head_dim)
        fcase = lambda **kw: _flash_case(rng, **{**heads, **dict(
            sq=272, kv_lens=[2320], S=REG_MAX_SEQ, dtype=torch.bfloat16,
            q_std=Q_STD), **kw})
        pcase = lambda **kw: _paged_case(rng, **{**heads, **dict(
            S=REG_MAX_SEQ, lengths=lengths, dtype=torch.bfloat16,
            q_std=Q_STD), **kw})
        flash += [fcase(planted=arch == "nemotron-4-15b"),
                  fcase(sq=2048, kv_lens=[2048]),
                  fcase(dtype=torch.float32)]
        paged += [pcase(planted=arch == "nemotron-4-15b"),
                  pcase(dtype=torch.float32)]
    return flash, paged


def granite_gemm_cases():
    """granite-moe-3b-a800m's expert projections (40 experts, top-8, K
    1536 -> N 512 gate/up and 512 -> 1536 down), group sizes from the
    router: the 2048-token prefill's 16384 copies (append regime), a
    round-2 append (272 tokens), the 8-slot decode (M 64: decode
    regime), the first and the decode's gate/up checking that a moved
    group boundary fails, and f32."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-3b-a800m")
    gen = torch.Generator(device="cuda").manual_seed(10)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    sizes = {t: router_group_sizes(cfg, t, gen) for t in (2048, 272, 8)}
    case = lambda t, **kw: _gg_case(gen, sizes=sizes[t], **{**dict(
        k=d, n=f), **kw})
    return [case(2048, planted=True, label="granite append 2048, gate/up"),
            case(2048, k=f, n=d, label="granite append 2048, down"),
            case(272, label="granite append 272, gate/up"),
            case(8, planted=True, label="granite decode, gate/up"),
            case(8, k=f, n=d, label="granite decode, down"),
            case(272, dtype=torch.float32, label="granite 272, f32")]


# ---------------------------------------------------------------------------
# phase 3 at zamba2-2.7b's shapes: flash and paged at head dim 80 (MHA 32
# x 80), the SSD scan at N 64 over 80 heads, the step and the conv
# ---------------------------------------------------------------------------


def zamba2_attention_cases(cfg, rng):
    """Flash and paged at zamba2's shared block (32 heads of 80, g 1) and
    its 5120-token cache.  Flash at the zamba2 phase's appends
    (``ZAMBA2_APPENDS``: round 1's 4000-row prefill, rounds 2-3's 301 and
    501 rows), a 272-row append over 4600 keys, and the prefill and the
    272-row append in f32; paged over 8 slots at the phase's decode
    contexts (4000-4848), at the edges of a page and of the cache, bf16
    and f32.  The main bf16 cases check that planted faults (q's columns
    shifted by a k-step or a lane) fail the tolerance.  The lengths come
    from ``rng``; q, K and V (up to 8 x 5120 x 32 x 80 values each) are
    drawn on the card."""
    heads = dict(hq=cfg.n_heads, hkv=cfg.n_kv_heads, dh=cfg.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(80)
    fcase = lambda sq, kv, **kw: _flash_case(gen, **{**heads, **dict(
        sq=sq, kv_lens=[kv], S=ZAMBA2_MAX_SEQ, dtype=torch.bfloat16,
        q_std=Q_STD), **kw})
    flash = [fcase(*ZAMBA2_APPENDS[0], planted=True, parts=True),
             *(fcase(*a) for a in ZAMBA2_APPENDS[1:]),
             fcase(272, 4600, planted=True),
             fcase(*ZAMBA2_APPENDS[0], dtype=torch.float32),
             fcase(272, 4600, dtype=torch.float32)]
    lengths = [int(x) for x in rng.integers(4000, 4849, 8)]
    edges = [1, 63, 64, 65, 4095, 4097, 5119, 5120]
    pcase = lambda **kw: _paged_case(gen, **{**heads, **dict(
        S=ZAMBA2_MAX_SEQ, lengths=lengths, dtype=torch.bfloat16,
        q_std=Q_STD), **kw})
    paged = [pcase(planted=True, parts=True), pcase(lengths=edges),
             pcase(dtype=torch.float32),
             pcase(lengths=edges, dtype=torch.float32)]
    return flash, paged


def zamba2_ssm_cases(cfg, names=None):
    """The SSD scan at zamba2's widths (80 heads of 64, N 64, chunks of
    256): the zamba2 phase's appends (4000 rows from zeros, 301 and 501
    from a carried state; bf16 held to SSD_BF16_TOL, the planted faults,
    plain TF32 among them, failing it) and f32; the decode step over 8
    slots (one slot zero, planted faults), f32 and three consecutive
    steps (the lost tail write planted); the prefill conv over
    5248 channels (x, B and C concatenated): the appends and f32.  With
    ``names``, only those kernels' cases."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    scan = lambda **kw: _ssd_case(gen, cfg, **{**dict(b=1, s=4000), **kw})
    step = lambda **kw: _ssm_step_case(gen, cfg, **{**dict(b=8), **kw})
    c = cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.d_state
    conv = lambda **kw: _conv_case(gen, **{**dict(
        b=1, s=4000, c=c, cw=cfg.ssm.conv_width), **kw})
    cases = dict(
        ssd_chunk_scan=lambda: [
            scan(planted=True, label="zamba2 round-1 append", parts=True),
            scan(s=301, h0=True, planted=True, label="zamba2 round-2 append"),
            scan(s=501, h0=True, planted=True, label="zamba2 round-3 append"),
            scan(s=1000, h0=True, dtype=torch.float32, label="zamba2 f32")],
        ssm_step=lambda: [step(planted=True), step(zero_slot=3, planted=True),
                          step(dtype=torch.float32),
                          step(steps=3, planted=True,
                               label="zamba2 three steps")],
        causal_conv=lambda: [conv(label="zamba2 round-1 append"),
                             conv(s=301, label="zamba2 append"),
                             conv(s=301, dtype=torch.float32)])
    return {k: make() for k, make in cases.items()
            if names is None or k in names}


# ---------------------------------------------------------------------------
# phase 3 at the last three models' shapes: flash at llama4's g 5, llava's
# g 7 and hubert's bidirectional (80, 80); paged at g 5 and g 7; the
# grouped GEMM at llama4's 128 experts, top-1
# ---------------------------------------------------------------------------


def last_three_attention_cases(rng):
    """Flash at llama4's 40 heads over 8 of 128 (g 5: its round-2 append
    of the llama4 phase, 400 rows over 4496 keys of 6144, and its
    4096-row prefill), llava's 56 over 8 (g 7: the registrations' round-2
    append, 272 rows over 2320 keys of 2560, and the VLM path's
    2880-patch append) and hubert's 16 of 80, bidirectional, over 8 clips
    of 1500 frames; each in f32 too.  Paged over 8 slots at g 5 (the
    llama4 phase's decode contexts, 4112-5040 of 6144) and g 7 (llava's,
    2300-2336 of 2560), bf16 and f32.  Each model's first bf16 case of
    each kernel checks that the planted faults fail.  q, K and V are drawn
    on the card; the lengths come from ``rng``."""
    from repro_torch.configs import get_config
    l4, lv, hb = (get_config(a) for a in (LLAMA4, LLAVA, HUBERT))
    gen = torch.Generator(device="cuda").manual_seed(26)
    bf, f32 = torch.bfloat16, torch.float32
    heads = lambda c: dict(hq=c.n_heads, hkv=c.n_kv_heads, dh=c.head_dim)
    fcase = lambda c, sq, kv, S, **kw: _flash_case(gen, **{**heads(c), **dict(
        sq=sq, kv_lens=kv if isinstance(kv, list) else [kv], S=S,
        dtype=bf, q_std=Q_STD), **kw})
    clips = [HUBERT_FRAMES] * HUBERT_CLIPS
    flash = [fcase(l4, *LLAMA4_APPENDS[1], DS27B_MAX_SEQ, planted=True,
                   parts=True),
             fcase(l4, *LLAMA4_APPENDS[0], DS27B_MAX_SEQ, parts=True),
             fcase(l4, *LLAMA4_APPENDS[1], DS27B_MAX_SEQ, dtype=f32),
             fcase(lv, 272, 2320, REG_MAX_SEQ, planted=True),
             fcase(lv, LLAVA_PATCHES, LLAVA_PATCHES, LLAVA_VLM_MAX_SEQ),
             fcase(lv, 272, 2320, REG_MAX_SEQ, dtype=f32),
             fcase(hb, HUBERT_FRAMES, clips, HUBERT_FRAMES, causal=False,
                   planted=True, parts=True),
             fcase(hb, HUBERT_FRAMES, clips, HUBERT_FRAMES, causal=False,
                   dtype=f32)]
    pcase = lambda c, S, lengths, **kw: _paged_case(gen, **{**heads(c), **dict(
        S=S, lengths=lengths, dtype=bf, q_std=Q_STD), **kw})
    l4_lens = [int(x) for x in rng.integers(4112, 5041, 8)]
    lv_lens = [int(x) for x in rng.integers(2300, 2337, 8)]
    paged = [pcase(l4, DS27B_MAX_SEQ, l4_lens, planted=True, parts=True),
             pcase(l4, DS27B_MAX_SEQ, l4_lens, dtype=f32),
             pcase(lv, REG_MAX_SEQ, lv_lens, planted=True),
             pcase(lv, REG_MAX_SEQ, lv_lens, dtype=f32)]
    return flash, paged


def llama4_gemm_cases(fwd=True, bwd=False) -> tuple:
    """llama4's expert projections (128 experts, top-1, K 5120 -> N 8192
    gate/up and 8192 -> 5120 down), group sizes from the router: the
    4096-token prefill (4096 copies, ~32 rows a group: the append
    regime), a 400-token append and the 8-slot decode (M <= 8 E: the
    decode regime), each projection's first case of each regime checking
    that a moved group boundary fails, and the 400-token gate/up in f32.
    Each 10.7 GB weight stack (21.5 GB in f32) is built once for its
    cases and freed before the next.  Returns (the forward's cases, with
    ``fwd``; the backward's, with ``bwd``: the prefill's gate/up on the
    same stack, :func:`_gg_bwd_case`)."""
    import importlib
    from repro_torch.configs import get_config
    gg = importlib.import_module("repro_torch.kernels.grouped_gemm")
    cfg = get_config(LLAMA4)
    gen = torch.Generator(device="cuda").manual_seed(27)
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    sizes = {t: router_group_sizes(cfg, t, gen) for t in (4096, 400, 8)}
    cases, bwd_cases = [], []
    for k, n, proj in ((d, f, "gate/up"), (f, d, "down")):
        if not fwd and proj == "down":
            break
        w = expert_weights(gen, e, k, n, torch.bfloat16)
        if fwd:
            cases += [_gg_case(gen, sizes=sizes[t], k=k, n=n, w=w,
                               planted=t != 400,
                               label=f"llama4 {what}, {proj}")
                      for t, what in ((4096, "prefill 4096"),
                                      (400, "append 400"), (8, "decode"))]
        if bwd and proj == "gate/up":
            bwd_cases.append(_gg_bwd_case(
                gen, sizes=sizes[4096], k=k, n=n, w=w,
                label="llama4 prefill 4096, gate/up"))
        del w
        torch.cuda.empty_cache()
    if not fwd:
        return cases, bwd_cases
    w = expert_weights(gen, e, d, f, torch.float32)
    cases.append(_gg_case(gen, sizes=sizes[400], k=d, n=f, w=w,
                          dtype=torch.float32,
                          label="llama4 append 400, gate/up, f32"))
    del w
    torch.cuda.empty_cache()
    regimes = {c["shapes"].get("regime") for c in cases}
    assert regimes >= set(gg.REGIMES), f"llama4 regimes held: {regimes}"
    return cases, bwd_cases


# ---------------------------------------------------------------------------
# phase 3, the grouped GEMM's backward: MoE training's gradient (phase 20),
# at granite's training microbatch, ds27b's append, llama4's prefill and
# the tile walk's edges
# ---------------------------------------------------------------------------

# granite's training microbatch in phase 20 (b): rows of 1024 tokens,
# 1023 inputs each, TRAIN_MOE_BATCH / micro rows a microbatch
GRANITE = "granite-moe-3b-a800m"
# the edges of tests/test_torch_moe.py's WALK_SIZES: (group sizes, M)
GG_BWD_EDGES = {
    "empty groups at both ends": ([0, 0, 12, 6, 12, 0, 0, 0], 30),
    "all rows in one group": ([0, 0, 300, 0], 300),
    "rows past the groups": ([4, 4, 4, 4, 4, 4, 0, 0], 30),
    "M < E": ([1, 0, 0, 2, 0, 0, 0, 0, 1, 0], 4),
    "groups past M": ([20, 20, 20], 33),
    "M = 0": ([0, 0, 0], 0),
}


def pair_err(got, want, tol: float):
    """:func:`max_err` over the gradients (dx, dw) that ``want`` holds
    (None and empty ones skipped), a block of leading rows at a time (so
    a 10.7 GB dw needs no f32 copy of itself): the largest error, and
    whether every element of each is within tol + tol * |want|."""
    errs = []
    for g, w in zip(got, want):
        if w is None or not w.numel():
            continue
        step = max(1, (1 << 27) // max(1, w[0].numel()))
        errs += [max_err(g[i:i + step], w[i:i + step], tol)
                 for i in range(0, w.shape[0], step)]
    return max((e for e, _ in errs), default=0.0), all(ok for _, ok in errs)


def _grouped_mm_bwd_library(x, w, sizes, dy, want):
    """One pair of PyTorch calls computing the backward, and its name:
    ``torch._grouped_mm`` for dX (dy against w's transposed view) and for
    dW (x's transposed view against dy, the groups along the reduction),
    where this torch has it, for bf16, and every row is in a group; else
    (None, why not).  It must agree with the plain backward, or it is no
    yardstick."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or x.dtype != torch.bfloat16 or \
            int(sizes.sum()) != x.shape[0]:
        return None, "none (bf16 with every row in a group only)"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    call = lambda: (fn(dy, w.transpose(1, 2), offs=offs),
                    fn(x.t(), dy, offs=offs))
    try:
        got = call()
    except (RuntimeError, ValueError) as e:
        return None, f"none (torch._grouped_mm refused: {str(e)[:100]})"
    err, ok = pair_err(got, want, TOLS[x.dtype])
    if not ok:
        return None, f"none (torch._grouped_mm off by {err:.3g})"
    return call, "torch._grouped_mm, dX and dW"


def _gg_bwd_case(gen, *, sizes, k, n, dtype=torch.bfloat16, planted=False,
                 label="", w=None, m=None):
    """``grouped_gemm_bwd`` on x (M, K) and dy (M, N) ~ N(0, 1) and w (E,
    K, N) of the schema's std 1/sqrt(K) (drawn here, or ``w`` given), M =
    sum(sizes) unless given: held against the plain backward and against
    ``torch.autograd`` of the plain forward within TOLS
    (:func:`pair_err`), bit-identical over two calls; with ``planted``, a
    group boundary moved by one row must fail.  Timed whole, dX alone
    and dW alone, with their bounds: 2 x routed rows x K x N operations
    each; dX's bytes dy's routed rows, the used experts' w and dx, dW's
    x's and dy's routed rows and the E x K x N dw."""
    from repro_torch.kernels import grouped_gemm_bwd, ref
    e = sizes.shape[0]
    m = int(sizes.sum()) if m is None else m
    routed = min(int(sizes.clamp_min(0).sum()), m)
    x = normal(gen, (m, k), dtype)
    dy = normal(gen, (m, n), dtype)
    if w is None:
        w = (torch.randn((e, k, n), generator=gen, device="cuda") /
             k ** 0.5).to(dtype)
    assert w.shape == (e, k, n) and w.dtype == dtype, (w.shape, w.dtype)
    used = int((sizes > 0).sum())
    shapes = dict(x=[m, k], w=[e, k, n], dy=[m, n], groups_used=used,
                  largest_group=int(sizes.max()),
                  dtype=str(dtype).replace("torch.", ""),
                  **({"case": label} if label else {}))
    call = lambda: grouped_gemm_bwd(x, w, sizes, dy)
    got, again = call(), call()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"grouped_gemm_bwd: two calls gave different "
                             f"bits at {shapes}")
    del again
    want = ref.grouped_gemm_bwd_ref(x, w, sizes, dy)
    err, ok = pair_err(got, want, TOLS[dtype])
    if not ok:
        raise AssertionError(f"grouped_gemm_bwd off by {err} at {shapes}")
    faults = _planted("grouped_gemm_bwd", want, TOLS[dtype], {
        "a group boundary moved by one row": ref.grouped_gemm_bwd_ref(
            x, w, _moved_boundary(sizes), dy)},
        check=pair_err) if planted else None
    lib, lib_name = _grouped_mm_bwd_library(x, w, sizes, dy, want)
    del want
    xl, wl = (t.detach().requires_grad_(True) for t in (x, w))
    with torch.enable_grad():
        y = ref.grouped_gemm_ref(xl, wl, sizes)
        # no row in a group: y is zeros that depend on nothing
        auto = torch.autograd.grad(y, (xl, wl), dy) if y.requires_grad \
            else (torch.zeros_like(x), torch.zeros_like(w))
    del y
    auto_err, ok = pair_err(got, auto, TOLS[dtype])
    if not ok:
        raise AssertionError(f"grouped_gemm_bwd off by {auto_err} against "
                             f"autograd of the plain forward at {shapes}")
    del auto, xl, wl, got
    torch.cuda.empty_cache()
    isz = x.element_size()
    flops = 2 * routed * k * n
    dx_bytes = (routed * n + used * k * n + m * k) * isz
    dw_bytes = (routed * k + routed * n + e * k * n) * isz
    b_ms, b_by = bound(dx_bytes + dw_bytes - routed * n * isz, 2 * flops,
                       dtype)
    dx_call = lambda: grouped_gemm_bwd(x, w, sizes, dy, need_dw=False)
    dw_call = lambda: grouped_gemm_bwd(x, w, sizes, dy, need_dx=False)
    out = dict(shapes=shapes, max_abs_err=err, autograd_err=auto_err,
               planted_err=faults, ms=time_ms(call),
               ms_clean_l2=time_ms(call, clean_l2=True))
    for part, fn, nbytes in (("dx", dx_call, dx_bytes),
                             ("dw", dw_call, dw_bytes)):
        p_ms, p_by = bound(nbytes, flops, dtype)
        out[part] = dict(ms=time_ms(fn), ms_clean_l2=time_ms(
            fn, clean_l2=True), bound_ms=p_ms, bound_by=p_by)
    out.update(
        plain_ms=time_ms(lambda: ref.grouped_gemm_bwd_ref(x, w, sizes, dy)),
        library_ms=None if lib is None else time_ms(lib),
        library_name=lib_name, bound_ms=b_ms, bound_by=b_by)
    return out


def grouped_gemm_bwd_cases() -> list:
    """The grouped GEMM's backward: granite's training microbatch (2 x
    1023 tokens, top-8 of 40: M 16,368; gate/up K 1536 -> N 512, and down
    512 -> 1536; sizes from the router; a moved group boundary must fail)
    and the gate/up in f32, ds27b's 4096-token append (x (24576, 2560), w
    (72, 2560, 1536)), the same widths with every group's size 64 q + r
    (r in 1..63, a moved boundary failing), so each of dW's units ends
    on a slice that reaches into the next group and the kernel's tail
    mask runs at full width, and the tile walk's edges at granite's
    gate/up widths (:data:`GG_BWD_EDGES`).  llama4's case comes with
    :func:`llama4_gemm_cases`, on its stack.  granite's gate/up and
    ds27b's two cases are timed with TIMING's counts, the others with
    QUICK_TIMING's."""
    from repro_torch.configs import get_config
    gr, ds = get_config(GRANITE), get_config("ds27b")
    gen = torch.Generator(device="cuda").manual_seed(29)
    d, f = gr.d_model, gr.moe.d_ff_expert
    tr = router_group_sizes(gr, TRAIN_MOE_BATCH // gr.microbatches_train_4k
                            * (TRAIN_SEQ - 1), gen)
    case = lambda **kw: _gg_bwd_case(gen, **kw)
    cases = [case(sizes=tr, k=d, n=f, planted=True,
                  label="granite training 2 x 1023, gate/up")]
    with quick_timing():
        cases += [case(sizes=tr, k=f, n=d, planted=True,
                       label="granite training 2 x 1023, down"),
                  case(sizes=tr, k=d, n=f, dtype=torch.float32,
                       label="granite training 2 x 1023, gate/up, f32")]
    cases += [case(sizes=router_group_sizes(ds, 4096, gen),
                  k=ds.d_model, n=ds.moe.d_ff_expert,
                  label="ds27b append 4096, gate/up")]
    rng = np.random.default_rng(30)
    e = ds.moe.n_experts
    mid = 64 * rng.integers(2, 8, e) + rng.integers(1, 64, e)
    cases.append(case(sizes=torch.tensor(mid, dtype=torch.int32,
                                         device="cuda"),
                      k=ds.d_model, n=ds.moe.d_ff_expert, planted=True,
                      label="ds27b widths, every group boundary mid-slice"))
    with quick_timing():
        for label, (sizes, m) in GG_BWD_EDGES.items():
            cases.append(case(sizes=torch.tensor(sizes, dtype=torch.int32,
                                                 device="cuda"), m=m, k=d,
                              n=f, label=label))
    return cases


# ---------------------------------------------------------------------------
# phase 3, flash's backward: the training path's gradient (phase 19), at
# qwen's training microbatch, GQA, hubert's bidirectional (80, 80),
# gemma2's dh 256 with a window and softcap, the short edges and f32
# ---------------------------------------------------------------------------

# q's scale in the softcapped backward case: scores of standard deviation
# ~8 put the largest ones where the softcap's derivative 1 - tanh^2(s /
# 50) is far from 1, so dropping it must fail the tolerance
BWD_Q_STD = 8.0
# the forward's log-sum-exp against the plain one (atol = rtol): f32
# scores of the same inputs summed in other orders, and exp2 / log2 in
# the kernel against exp / log
LSE_TOL = 1e-4


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """The valid (query, key) pairs of one head of full-sequence attention
    over ``s`` tokens."""
    total = 0
    for i in range(s):
        lo = max(0, i - window + 1) if window > 0 else 0
        total += (i if causal else s - 1) - lo + 1
    return total


def grads_err(got, want, tol: float):
    """max |got - want| over (dq, dk, dv), and whether each output is
    within ``tol`` of its own largest |value|, or, for an output that is
    zero in exact arithmetic (dq and dk over one token: P = 1, so dS =
    dP - D = 0), of the largest |value| of the three: its rounding
    residue is judged on the scale of the computation."""
    errs = [float((g.float() - w.float()).abs().max()) for g, w in
            zip(got, want)]
    tops = [float(w.float().abs().max()) for w in want]
    ok = all(e <= tol * (top or max(tops)) for e, top in zip(errs, tops))
    return max(errs), ok


def bwd_plain(q, k, v, do, *, causal=True, softcap=0.0, window=0,
              cap_grad=True, skip_from=None, round_p=True, use_d=True,
              dk_zero_from=None, scale_width=None):
    """flash's gradient in closed form (f32 products, P rounded to the V
    dtype for dV as the forward rounds it), to plant faults in: without
    ``cap_grad`` the softcap's derivative is dropped, with ``skip_from``
    the keys from there on leave dK, dV and dQ, without ``round_p`` dV
    takes P unrounded, without ``use_d`` dS = P dP (D = sum(dO * o)
    dropped), with ``dk_zero_from`` dK's columns from there on stay zero
    (MLA's rope columns left out), with ``scale_width`` the scale is
    1/sqrt(that width) (v's, not q's and k's)."""
    b, hq, s, dh = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    g = hq // hkv
    scale = 1 / np.sqrt(scale_width or dh)
    qf = q.float().reshape(b, hkv, g, s, dh)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, hkv, g, s, dv)
    raw = torch.einsum("bngqd,bnkd->bngqk", qf, kf) * scale
    t = torch.tanh(raw / softcap) if softcap else None
    sc = softcap * t if softcap else raw
    rows = torch.arange(s, device=q.device)
    ok = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        ok &= rows[None, :] <= rows[:, None]
    if window > 0:
        ok &= rows[:, None] - rows[None, :] < window
    p = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1)
    o = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), vf)
    dsum = (dof * o.to(q.dtype).float()).sum(-1, keepdim=True)
    keep = torch.ones(s, device=q.device)
    if skip_from is not None:
        keep[skip_from:] = 0
    pv = (p.to(v.dtype).float() if round_p else p) * keep
    dvg = torch.einsum("bngqk,bngqd->bnkd", pv, dof)
    ds = p * (torch.einsum("bngqd,bnkd->bngqk", dof, vf)
              - (dsum if use_d else 0)) * keep
    if softcap and cap_grad:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bngqk,bnkd->bngqd", ds, kf) * scale
    dk = torch.einsum("bngqk,bngqd->bnkd", ds, qf) * scale
    if dk_zero_from is not None:
        dk[..., dk_zero_from:] = 0
    return (dq.reshape(b, hq, s, dh).to(q.dtype), dk.to(k.dtype),
            dvg.to(v.dtype))


def rounded_p_inputs(b=1, h=4, s=1024, dh=64, device="cuda"):
    """bf16 inputs on which dV shows whether P was rounded to bf16: q = 0,
    so row i's P is 1/(i + 1) over its i + 1 causal keys, and v = 0, so dq
    and dk are exactly 0.  Consecutive rows are paired and given dO rows
    of +-(i + 1) (the same in every column and head), signed so that
    within a pair the unrounded P.dO nearly cancels while the rounding
    errors of P add: the bf16 dV is then mostly those rounding errors.
    Rows whose 1/(i + 1) lies within 1e-5 of a bf16 rounding midpoint get
    dO = 0 (an f32 recompute could round them the other way)."""
    i = torch.arange(s, dtype=torch.float64)
    p = (1.0 / (i + 1)).float()
    bits = p.view(torch.int32)
    lo = (bits & ~0xFFFF).view(torch.float32).double()
    hi = ((bits & ~0xFFFF) + 0x10000).view(torch.float32).double()
    safe = ((p.double() - (lo + hi) / 2).abs() / p.double() > 1e-5)
    delta = (p.to(torch.bfloat16).double() - p.double()) * (i + 1)
    sign = torch.zeros(s, dtype=torch.float64)
    rows = [int(r) for r in torch.nonzero(safe).flatten()]
    for a, c in zip(rows[0::2], rows[1::2]):
        sign[a] = 1.0 if delta[a] > delta[c] else -1.0
        sign[c] = -sign[a]
    do = (sign * (i + 1)).float()[None, :, None, None].expand(
        b, s, h, dh).contiguous().to(device, torch.bfloat16)
    z = torch.zeros((b, s, h, dh), dtype=torch.bfloat16, device=device)
    k = torch.randn((b, s, h, dh), generator=torch.Generator(
        device=device).manual_seed(29), device=device).to(torch.bfloat16)
    return tuple(x.transpose(1, 2) for x in (z, k, z.clone(), do))


def forward_with_lse_row(q, k, v, kw, fwd_lse) -> dict:
    """The forward that autograd runs (o and each row's lse, ``fwd_lse``)
    timed with a clean L2, beside the plain forward with its lse, one
    PyTorch call computing both (``_scaled_dot_product_flash_attention``,
    which returns the log-sum-exp, K and V repeated to the query heads;
    None where this torch lacks it or the mask has a window or softcap)
    and the bound: q, k, v and o read or written once and the lse
    written, against 4 x dh operations per valid (query, key) pair."""
    from repro_torch.kernels import ref
    b, hq, s, dh = q.shape
    g = hq // k.shape[1]
    sdpa = getattr(torch.ops.aten, "_scaled_dot_product_flash_attention",
                   None)
    library = None
    if sdpa is not None and not kw["window"] and not kw["softcap"]:
        kl, vl = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        library = lambda: sdpa(q, kl, vl, 0.0, kw["causal"])
    isz = q.element_size()
    pairs = attention_pairs(s, kw["causal"], kw["window"]) * b * hq
    b_ms, b_by = bound(2 * (q.numel() + k.numel()) * isz + 4 * b * hq * s,
                       4 * dh * pairs, q.dtype)
    return dict(ms_clean_l2=time_ms(fwd_lse, clean_l2=True),
                plain_ms=time_ms(lambda: ref.flash_attention_ref(
                    q, k, v, **kw, return_lse=True)),
                library_ms=None if library is None else time_ms(library),
                library_name="_scaled_dot_product_flash_attention (o and "
                             "lse)" if library else None,
                bound_ms=b_ms, bound_by=b_by)


def _bwd_case(gen, *, b, hq, hkv, dh, s, dv=None, dtype=torch.bfloat16,
              causal=True, softcap=0.0, window=0, q_std=1.0, planted=(),
              parts=False, inputs=None, label="", lse_check=False,
              fwd_ab=False):
    """flash's backward at the training path's layout: q, k (dh wide), v
    and dO (``dv`` wide, dh by default) made (b, s, h, width) and passed as
    (b, h, s, width) views, o and lse from the forward kernel.  Held
    against the plain backward (autograd of the plain forward) within TOLS
    of each output's largest |value| (``rel_err``: the largest error over
    that value, which in bf16 includes dS's rounding to bf16) and
    bit-identical over two calls; each label in ``planted`` is a fault of
    :func:`bwd_plain` that must fail that check.  With ``lse_check`` the
    forward's lse is held against the plain lse within LSE_TOL, in this
    dtype and in the other of bf16 and f32, and the case says whether the
    forward's plan split its keys (then the combine wrote the lse).  With
    ``fwd_ab`` the forward is timed with and without its lse, and with it
    beside its plain version, a library call and its bound
    (:func:`forward_with_lse_row`).  Timed beside the plain backward and
    SDPA's backward (causal or not, no window and no softcap, K and V
    repeated to the query heads; at dv != dh the backend PyTorch picks is
    named, with the kernels it launches), with the bound of its five
    products' flops over the valid pairs (the recomputed scores included:
    S, dK and dQ of 2 dh flops, dP and dV of 2 dv) or its bytes (q, k, v, o
    and dO read, dq, dk and dv written)."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ref
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.flash_attention import plan
    dv = dv or dh
    if inputs is None:
        f = lambda h, w: normal(gen, (b, s, h, w), dtype)
        q = (f(hq, dh) * q_std).transpose(1, 2)
        k, v, do = (f(h, w).transpose(1, 2)
                    for h, w in ((hkv, dh), (hkv, dv), (hq, dv)))
    else:
        q, k, v, do = inputs
    kw = dict(causal=causal, softcap=softcap, window=window)
    shapes = dict(q=[b, hq, s, dh], kv=[b, hkv, s, dh],
                  dtype=str(dtype).replace("torch.", ""))
    if dv != dh:
        shapes["v"] = [b, hkv, s, dv]
    shapes.update({n: x for n, x in kw.items()
                   if x != dict(causal=True, softcap=0.0, window=0)[n]})
    if label:
        shapes["case"] = label
    o, lse = flash_attention(q, k, v, **kw, return_lse=True)
    lse_errs = None
    if lse_check:
        lse_errs = {}
        for dt in (dtype, torch.float32 if dtype == torch.bfloat16
                   else torch.bfloat16):
            xs = [x.to(dt) for x in (q, k, v)]
            _, got_l = (o, lse) if dt == dtype else flash_attention(
                *xs, **kw, return_lse=True)
            _, want_l = ref.flash_attention_ref(*xs, **kw, return_lse=True)
            err_l, ok_l = max_err(got_l, want_l, LSE_TOL)
            if not ok_l:
                raise AssertionError(f"flash_attention's lse off by {err_l} "
                                     f"in {dt} at {shapes}")
            lse_errs[str(dt).replace("torch.", "")] = err_l
        shapes["fwd_split"] = plan(
            b, hq, hkv, s, s, sm_count(q.get_device()),
            dtype == torch.bfloat16)[0]
    fwd_ms = fwd_lse_row = None
    if fwd_ab:
        fwd = lambda: flash_attention(q, k, v, **kw)
        fwd_lse = lambda: flash_attention(q, k, v, **kw, return_lse=True)
        fwd_ms = {}
        for name in ("without lse", "with lse", "with lse ", "without lse "):
            fwd_ms.setdefault(name.strip(), []).append(
                time_ms(fwd_lse if name.startswith("with ") else fwd))
        fwd_lse_row = forward_with_lse_row(q, k, v, kw, fwd_lse)
    call = lambda: flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    got, again = call(), call()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd: two calls gave "
                             f"different bits at {shapes}")
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    err, ok = grads_err(got, want, TOLS[dtype])
    if not ok:
        raise AssertionError(f"flash_attention_bwd off by {err} at {shapes}")
    rel = max(float((g.float() - w.float()).abs().max())
              / (float(w.float().abs().max()) or 1.0)
              for g, w in zip(got, want))
    faults = None
    if planted:
        emulate = {"softcap's derivative dropped": dict(cap_grad=False),
                   "the last key tile skipped": dict(
                       skip_from=(s - 1) // 64 * 64),
                   "P left unrounded in dV": dict(round_p=False),
                   "D dropped": dict(use_d=False),
                   "dK's rope columns 128-191 left at zero": dict(
                       dk_zero_from=128),
                   "the scale taken from v's width": dict(scale_width=dv)}
        faults = _planted("flash_attention_bwd", want, TOLS[dtype],
                          {f: bwd_plain(q, k, v, do, **kw, **emulate[f])
                           for f in planted}, check=grads_err)
    del got, again, want
    g = hq // hkv
    ql, kl, vl = (x.detach().requires_grad_(True) for x in
                  (q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)))
    out = torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, is_causal=causal)
    library = lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                          retain_graph=True)
    backend = None if dv == dh else sdpa_backend(ql, kl, vl, causal,
                                                 library)
    pairs = attention_pairs(s, causal, window) * b * hq
    b_ms, b_by = bound(2 * (b * hq + b * hkv) * s * (dh + dv)
                       * q.element_size(), 2 * (3 * dh + 2 * dv) * pairs,
                       dtype)
    return dict(
        shapes=shapes, max_abs_err=err, rel_err=rel, planted_err=faults,
        lse_err=lse_errs, fwd_ms=fwd_ms, fwd_lse=fwd_lse_row,
        ms=time_ms(call), ms_clean_l2=time_ms(call, clean_l2=True),
        parts_ms=kernel_parts(call) if parts else None,
        plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, do,
                                                             **kw)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
        **({} if backend is None else dict(
            library_name=f"SDPA backward, {backend}")))


def sdpa_backend(q, k, v, causal: bool, fn) -> str:
    """The backend SDPA's dispatch picks for q, k and v
    (``torch._fused_sdp_choice``: flash, efficient, cudnn or math), with
    the kernels ``fn`` (its backward) launches under torch.profiler."""
    from torch.nn.attention import SDPBackend
    kinds = {int(getattr(SDPBackend, n)): n.lower().removesuffix("_attention")
             for n in dir(SDPBackend) if n.isupper()}
    kind = kinds.get(int(torch._fused_sdp_choice(q, k, v, None, 0.0,
                                                 causal)), "unknown")
    names = sorted(kernel_parts(fn, reps=5))
    return (f"{kind} backend ("
            f"{', '.join(names) or 'no kernel seen by the profiler'})")


def flash_bwd_cases():
    """flash's backward: qwen's training microbatch (4 rows of 1023
    inputs, 16 x 64, causal; phase 19's shape), GQA g 4 at dh 128 over
    1000 tokens, hubert's bidirectional 16 x 80 over 2 clips of 1500
    frames, gemma2's dh 256 (8 over 4 heads) with a 256-token window and
    softcap 50 over 1024 tokens (q scaled by ``BWD_Q_STD``; the softcap's
    derivative dropped and the last 64-key tile skipped must fail), s 1
    and s 77 (D dropped must fail), f32 at dh 64, and
    :func:`rounded_p_inputs` (P left unrounded in dV must fail), and
    granite's training microbatch (2 x 1023, 24 over 8 x 64: g 3),
    zamba2's shared block at its training microbatch (2 x 1023, 32 x 80,
    causal: hubert's (80, 80) case is bidirectional); then
    ds27b's MLA widths, q/k 192 and v 128 over 32 heads (g 1): its
    training microbatch (one row of 1023 inputs, phase 21's shape), s 77
    (dK's rope columns left at zero and the scale taken from v's width
    must fail) and f32 at s 256.  The forward's lse is held against the
    plain one at qwen's microbatch (one split), gemma2's case (split
    keys) and ds27b's microbatch, in bf16 and f32, and the forward is
    timed with and without it at qwen's microbatch.  qwen's microbatch
    and ds27b's cases are timed with TIMING's counts (the first with its
    parts), every other case with QUICK_TIMING's."""
    from repro_torch.configs import get_config
    qw, hb, g2, gr, ds, z2 = (get_config(a) for a in (
        "qwen1.5-0.5b", HUBERT, "gemma2-2b", GRANITE, "ds27b",
        "zamba2-2.7b"))
    gen = torch.Generator(device="cuda").manual_seed(28)
    heads = lambda c: dict(hq=c.n_heads, hkv=c.n_kv_heads, dh=c.head_dim,
                           dv=c.mla.v_head_dim if c.mla else None)
    case = lambda c, **kw: _bwd_case(gen, **{**heads(c), **kw})
    main = case(qw, b=TRAIN_BATCH // TRAIN_MICRO, s=TRAIN_SEQ - 1,
                parts=True, lse_check=True, fwd_ab=True)
    with quick_timing():
        older = [
            case(qw, b=2, hkv=qw.n_heads // 4, dh=128, s=1000),
            case(hb, b=2, s=HUBERT_FRAMES, causal=False),
            case(g2, b=1, s=1024, window=256, softcap=50.0,
                 q_std=BWD_Q_STD, planted=("softcap's derivative dropped",
                                           "the last key tile skipped"),
                 lse_check=True),
            case(qw, b=2, s=1),
            case(qw, b=2, s=77, planted=("D dropped",)),
            case(qw, b=2, s=256, dtype=torch.float32),
            _bwd_case(gen, b=1, hq=4, hkv=4, dh=64, s=1024,
                      inputs=rounded_p_inputs(), planted=(
                          "P left unrounded in dV",), label="rounded P"),
            case(gr, b=TRAIN_MOE_BATCH // gr.microbatches_train_4k,
                 s=TRAIN_SEQ - 1, label="granite g 3"),
            case(z2, b=TRAIN_SSM_BATCH // z2.microbatches_train_4k,
                 s=TRAIN_SEQ - 1, label="zamba2's shared block")]
    return [main] + older + [
        case(ds, b=TRAIN_MLA_BATCH // ds.microbatches_train_4k,
             s=TRAIN_SEQ - 1, parts=True, lse_check=True, label="ds27b"),
        case(ds, b=1, s=77, planted=("dK's rope columns 128-191 left at "
                                     "zero", "the scale taken from v's "
                                     "width"), label="ds27b"),
        case(ds, b=1, s=256, dtype=torch.float32, label="ds27b"),
    ]


# the wrappers and their sources (None: Triton, compiled at first launch)
KERNEL_SOURCES = {"kv_layer_gather": "kv_gather",
                  "kv_layer_scatter": "kv_scatter",
                  "flash_attention": "flash_attention",
                  "paged_attention": "paged_attention",
                  "grouped_gemm": "grouped_gemm", "mla_decode": "mla_decode",
                  "ssd_chunk_scan": "ssd_scan", "ssm_step": "ssm_step",
                  "causal_conv": None,
                  "flash_attention_bwd": "flash_attention_bwd",
                  "grouped_gemm_bwd": "grouped_gemm_bwd",
                  "ssd_chunk_scan_bwd": "ssd_scan_bwd",
                  "causal_conv_bwd": None}


def kernel_cases(names=None) -> dict:
    """Phase 3's cases, by kernel, in the smoke's order (``[0]`` is each
    kernel's main case): qwen1.5-0.5b's shapes, then gemma2-2b's (head
    dim 256, window 4096, softcap 50), then ds27b's (MLA's flash widths,
    its 1152-byte rows, and the two kernels only its path runs), then
    mamba2-1.3b's SSM kernels, the registrations' heads and experts,
    zamba2-2.7b's (head dim 80, N 64), and llama4's, llava's and hubert's
    (flash and paged at g 5 and g 7, flash bidirectional at head dim 80,
    the grouped GEMM at 128 experts, top-1).  Each kernel's main case
    is timed with TIMING's counts, and so are the two backwards' cases
    (the training path's gradients, with few cases); every other case
    with QUICK_TIMING's, unprofiled (:func:`main_first`,
    :func:`quick_timing`).  With
    ``names``, only those kernels' cases (the random draws then differ
    from a whole run's)."""
    from repro_torch.configs import get_config
    want = lambda *ks: names is None or any(k in names for k in ks)
    cfg, cfg_g2, cfg_ds = (get_config(a) for a in
                           ("qwen1.5-0.5b", "gemma2-2b", "ds27b"))
    rng = np.random.default_rng(0)
    cases = {}
    t0 = time.perf_counter()
    if want("kv_layer_gather"):
        cases["kv_layer_gather"] = gather_cases(cfg, rng)
    if want("kv_layer_scatter"):
        cases["kv_layer_scatter"] = scatter_cases(cfg, rng)
    if want("flash_attention"):
        cases["flash_attention"] = flash_cases(cfg, rng)
    if want("paged_attention"):
        cases["paged_attention"] = paged_cases(cfg, rng)
    print(f"phase 3, qwen's cases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with quick_timing():
        if want("flash_attention"):
            cases["flash_attention"] += gemma2_flash_cases(cfg_g2, rng)
        if want("paged_attention"):
            cases["paged_attention"] += gemma2_paged_cases(cfg_g2, rng)
        if want("flash_attention"):
            cases["flash_attention"] += mla_flash_cases(cfg_ds, rng)
        if want("kv_layer_gather", "kv_layer_scatter"):
            gather_ds, scatter_ds = ds27b_copy_cases(cfg_ds, rng)
            for name, more in (("kv_layer_gather", gather_ds),
                               ("kv_layer_scatter", scatter_ds)):
                if name in cases:
                    cases[name] += more
    if want("grouped_gemm"):
        cases["grouped_gemm"] = grouped_gemm_cases(cfg_ds, rng)
    if want("mla_decode"):
        cases["mla_decode"] = mla_decode_cases(cfg_ds, rng)
    print(f"phase 3, gemma2's and ds27b's cases: "
          f"{time.perf_counter() - t0:.1f} s")
    cfg_m2 = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    if want("ssd_chunk_scan"):
        cases["ssd_chunk_scan"] = ssd_cases(cfg_m2)
    if want("ssm_step"):
        cases["ssm_step"] = ssm_step_cases(cfg_m2)
        for arch, got in decode_layer_check().items():
            print(f"one {arch} decode layer over 8 slots: "
                  f"{sum(got.values())} launches, {json.dumps(got)}")
    if want("causal_conv"):
        cases["causal_conv"] = conv_cases(cfg_m2)
    if want("ssd_chunk_scan", "ssm_step", "causal_conv"):
        print(f"phase 3, the SSM cases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if want("flash_attention", "paged_attention"):
        with quick_timing():
            flash_r, paged_r = registration_attention_cases(rng)
        for name, more in (("flash_attention", flash_r),
                           ("paged_attention", paged_r)):
            if name in cases:
                cases[name] += more
    if want("grouped_gemm"):
        with quick_timing():
            cases["grouped_gemm"] += granite_gemm_cases()
    if want("grouped_gemm_bwd"):
        t1 = time.perf_counter()
        cases["grouped_gemm_bwd"] = grouped_gemm_bwd_cases()
        print(f"phase 3, the grouped GEMM's backward at granite's and "
              f"ds27b's shapes and the walk's edges: "
              f"{time.perf_counter() - t1:.1f} s")
    cfg_z2 = get_config("zamba2-2.7b")
    if want("flash_attention", "paged_attention"):
        with quick_timing():
            flash_z, paged_z = zamba2_attention_cases(cfg_z2, rng)
        for name, more in (("flash_attention", flash_z),
                           ("paged_attention", paged_z)):
            if name in cases:
                cases[name] += more
    print(f"phase 3, the registrations' and zamba2's attention and GEMM "
          f"cases: {time.perf_counter() - t0:.1f} s")
    if want("ssd_chunk_scan", "ssm_step", "causal_conv"):
        t0 = time.perf_counter()
        with quick_timing():
            zamba2_ssm = zamba2_ssm_cases(cfg_z2, names)
        for name, more in zamba2_ssm.items():
            cases[name] += more
        print(f"phase 3, zamba2's SSM cases: "
              f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if want("flash_attention", "paged_attention"):
        with quick_timing():
            flash_3, paged_3 = last_three_attention_cases(rng)
        for name, more in (("flash_attention", flash_3),
                           ("paged_attention", paged_3)):
            if name in cases:
                cases[name] += more
    if want("grouped_gemm", "grouped_gemm_bwd"):
        with quick_timing():
            fwd_l4, bwd_l4 = llama4_gemm_cases(
                fwd=want("grouped_gemm"), bwd=want("grouped_gemm_bwd"))
        for name, more in (("grouped_gemm", fwd_l4),
                           ("grouped_gemm_bwd", bwd_l4)):
            if name in cases:
                cases[name] += more
    if want("flash_attention", "paged_attention", "grouped_gemm",
            "grouped_gemm_bwd"):
        print(f"phase 3, llama4's, llava's and hubert's cases: "
              f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if want("flash_attention_bwd"):
        cases["flash_attention_bwd"] = flash_bwd_cases()
        print(f"phase 3, flash's backward: "
              f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if want("ssd_chunk_scan_bwd"):
        cases["ssd_chunk_scan_bwd"] = ssd_bwd_cases(cfg_m2, cfg_z2)
    if want("causal_conv_bwd"):
        cases["causal_conv_bwd"] = conv_bwd_cases(cfg_m2, cfg_z2)
    if want("ssd_chunk_scan_bwd", "causal_conv_bwd"):
        print(f"phase 3, the SSM backwards: "
              f"{time.perf_counter() - t0:.1f} s")
    print(f"phase 3, in time_ms and kernel_parts: {TIMING_S[0]:.1f} s "
          f"(main cases {TIMING['reps']} calls, the others "
          f"{QUICK_TIMING['reps']}, unprofiled)")
    return cases


def print_cases(cases: dict) -> None:
    for name, cs in cases.items():
        for c in cs:
            lib = c["library_ms"]
            print(f"{name} {json.dumps(c['shapes'])}: err {c['max_abs_err']:.3g}"
                  f" kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
                  f"library {'n/a' if lib is None else f'{lib:.4f} ms'} "
                  + (f"({c['library_name']}) " if "library_name" in c
                     else "")
                  + ("" if "library_ms_clean_l2" not in c else
                     f"(clean L2 {c['library_ms_clean_l2']:.4f} ms) ")
                  + f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
                  f"{100 * c['bound_ms'] / c['ms']:.1f} % of it)"
                  + ("" if "ms_clean_l2" not in c else
                     f"; clean L2 {c['ms_clean_l2']:.4f} ms")
                  + ("" if "state_rmw_ms" not in c else
                     f"; the state's in-place mul_ alone "
                     f"{c['state_rmw_ms']:.4f} ms")
                  + ("" if not c.get("parts_ms") else
                     "; warm " + ", ".join(f"{k} {v:.4f} ms"
                                           for k, v in c["parts_ms"].items()))
                  + ("" if "dx" not in c else "; " + ", ".join(
                      f"{p} alone {c[p]['ms']:.4f} ms (clean L2 "
                      f"{c[p]['ms_clean_l2']:.4f} ms, bound "
                      f"{c[p]['bound_ms']:.4f} ms by {c[p]['bound_by']}, "
                      f"{100 * c[p]['bound_ms'] / c[p]['ms']:.1f} % of it)"
                      for p in ("dx", "dw")))
                  + ("" if "autograd_err" not in c else
                     f"; against autograd of the plain forward "
                     f"{c['autograd_err']:.3g}")
                  + ("" if "rel_err" not in c else
                     f"; largest error over the largest |value| "
                     f"{c['rel_err']:.3g}")
                  + ("" if "rel_err_by_grad" not in c else " (" + ", ".join(
                      f"{k} {v:.3g}" for k, v in c["rel_err_by_grad"].items())
                     + ")")
                  + ("" if not c.get("lse_err") else
                     "; the forward's lse err " + ", ".join(
                         f"{k} {v:.3g}" for k, v in c["lse_err"].items()))
                  + ("" if not c.get("fwd_ms") else
                     "; forward " + ", ".join(
                         f"{k} " + " / ".join(f"{x:.4f}" for x in v) + " ms"
                         for k, v in c["fwd_ms"].items()))
                  + ("" if not c.get("fwd_lse") else
                     "; the forward with its lse: clean L2 "
                     f"{c['fwd_lse']['ms_clean_l2']:.4f} ms, plain "
                     f"{c['fwd_lse']['plain_ms']:.4f} ms, library "
                     + ("n/a" if c["fwd_lse"]["library_ms"] is None else
                        f"{c['fwd_lse']['library_ms']:.4f} ms "
                        f"({c['fwd_lse']['library_name']})")
                     + f", bound {c['fwd_lse']['bound_ms']:.4f} ms "
                     f"({c['fwd_lse']['bound_by']})")
                  + ("" if "fmas_issued" not in c else
                     f"; the gradient's FMAs {c['fmas']}, issued "
                     f"{c['fmas_issued']}"
                     + ("" if c["wgmma_fmas_issued"] is None else
                        f" ({c['wgmma_fmas_issued']} on wgmma as bf16 "
                        f"parts)")
                     + ("" if "fmas_pr32" not in c else
                        f", per-head dB/dC (PR 32) {c['fmas_pr32']}"
                        + ("" if c["mma_fmas_pr32"] is None else
                           f" ({c['mma_fmas_pr32']} as split TF32 MMAs)"))
                     + f", bound at the f32 peak "
                     f"{c['bound_ms_f32_peak']:.4f} ms")
                  + ("" if "workspace_mb" not in c else
                     f"; {c['heads_per_group']} heads a group, scratch "
                     f"{c['workspace_mb']:.1f} MB")
                  + ("" if not c.get("planted_err") else
                     "; planted faults fail: " + ", ".join(
                         f"{k} err {v:.3g}"
                         for k, v in c["planted_err"].items())))


def print_build_log(names) -> None:
    """ptxas's report of each kernel: its function, registers, spills,
    and any performance note (e.g. C7518/C7520: ``wgmma`` serialised)."""
    from repro_torch.kernels import build
    for name in names:
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if any(w in line for w in ("Function properties for",
                                           "registers", "spill",
                                           "Performance")):
                    print(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phases 4 and 5: serving
# ---------------------------------------------------------------------------


def serve(cfg, params, trajs, device, **kw):
    from repro_torch.serving import ServingSystem
    system = ServingSystem(cfg, params, device=device, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sessions = system.run_offline(trajs)
    if device != "cpu":
        torch.cuda.synchronize()
    return system, sessions, time.perf_counter() - t0


class MethodPatch:
    """``owner.name`` (a module's function or a class's method) replaced
    by ``wrap(original)`` while entered.  Patching a class, not an
    instance, leaves no instance holding a closure over itself, so a
    freed engine is freed at once."""

    def __init__(self, owner, name, wrap):
        self.owner, self.name, self.wrap = owner, name, wrap

    def __enter__(self):
        self.orig = self.owner.__dict__[self.name]
        setattr(self.owner, self.name, self.wrap(self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


class CallCounter(MethodPatch):
    """Counts the calls of ``module.name`` while it is entered."""

    def __init__(self, module, name: str):
        self.n = 0

        def wrap(fn):
            def counted(*args, **kw):
                self.n += 1
                return fn(*args, **kw)
            return counted

        super().__init__(module, name, wrap)


def persist_counter():
    """Counts the DE's persists (``kvio.serialize_blocks`` calls)."""
    from repro_torch.engines import kvio
    return CallCounter(kvio, "serialize_blocks")


# the kernels of a dense GQA model's serving path; the MoE and MLA ones
# (grouped_gemm, mla_decode) run only on ds27b's
GQA_KERNELS = ("kv_layer_gather", "kv_layer_scatter", "flash_attention",
               "paged_attention")


def check_launches(launches: dict, persists: int, path: str) -> None:
    """Every kernel of a GQA path launched, no other, the scatter once
    per persist."""
    assert all((n > 0) == (k in GQA_KERNELS) for k, n in launches.items()), \
        f"a kernel of the {path} path never launched, or another did: " \
        f"{launches}"
    assert launches["kv_layer_scatter"] == persists > 0, \
        f"{path}: {launches['kv_layer_scatter']} scatter launches for " \
        f"{persists} persists"


def serving_phase(cfg, device="cuda", rounds=AGENT_ROUNDS, n_agents=6,
                  block_tokens=64, max_seq=2048):
    """Returns (stats, launches, wall_s, tokens_per_s, blocking_wall_s,
    persists)."""
    from repro_torch import kernels
    from repro_torch.models import init_params
    from repro_torch.sim.traces import Round, Trajectory
    params = init_params(cfg, seed=0, device=device)
    trajs = lambda: [Trajectory(i, [Round(*r) for r in rounds])
                     for i in range(n_agents)]
    kw = dict(n_pe=1, n_de=1, mode="dualpath", block_tokens=block_tokens,
              max_seq=max_seq, de_slots=8)
    kernels.reset_launch_counts()
    with persist_counter() as persists:
        system, sessions, wall = serve(cfg, params, trajs(), device, **kw)
    launches = kernels.launch_counts()
    st = system.stats()
    assert all(s.rounds_done == len(rounds) for s in sessions), \
        "a round did not finish"
    assert st["store_reads"] > 0, "no FullBlock was read back"
    assert st["read_bytes_pe_side"] > 0 and st["read_bytes_de_side"] > 0, \
        "both read sides must be used"
    if device != "cpu":
        check_launches(launches, persists.n, "offline")
    _, sessions_b, wall_b = serve(cfg, params, trajs(), device,
                                  pipelined=False, **kw)
    assert [s.context for s in sessions] == \
        [s.context for s in sessions_b], "blocking arm diverged"
    return st, launches, wall, st["gen_tokens"] / wall, wall_b, persists.n


def profile_phase(cfg, rounds=AGENT_ROUNDS, n_agents=6, top=8,
                  max_seq=2048, params=None):
    """Where the time goes: the serving phase's pipelined run once more
    (or ``cfg``'s with ``rounds`` and ``max_seq`` on 1 PE + 1 DE, on
    ``params`` or seed 0's), under torch.profiler tracing the card only
    (:func:`profiled`)."""
    from repro_torch.models import init_params
    from repro_torch.sim.traces import Round, Trajectory
    if params is None:
        params = init_params(cfg, seed=0, device="cuda")
    trajs = [Trajectory(i, [Round(*r) for r in rounds])
             for i in range(n_agents)]
    kw = dict(n_pe=1, n_de=1, mode="dualpath", block_tokens=64,
              max_seq=max_seq, de_slots=8)
    return profiled(lambda: serve(cfg, params, trajs, "cuda", **kw)[2], top)


def profiled(run, top=8):
    """``run()`` (which returns its real wall s) under torch.profiler
    tracing the card only.  Returns (real wall s, device-busy s summed
    over kernels and copies, [(name, device ms, calls, [(kernel,
    launches, device ms)])] of the top entries and the port's
    kernels)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = run()
    rows = {}
    for key, (ns, count) in device_times(prof).items():
        name = short_name(key)[:60]
        # a port kernel's launches (split + combine kernels, or one
        # kernel per regime) read as one row under its wrapper's name,
        # calls counting its most launched kernel's launches (one per
        # wrapper call where a call launches a split kernel and maybe a
        # combine; the parts give each kernel's own); any other kernel is
        # a row of its own, by its full name
        group = next((w for w, prefixes in KERNEL_ROWS.items()
                      if name.startswith(prefixes)), key)
        _, ms, calls, parts = rows.get(group, (name, 0.0, 0, []))
        own_ms = ns / 1e6
        rows[group] = (group if group in KERNEL_ROWS else name,
                       ms + own_ms, max(calls, count),
                       parts + [(name, count, own_ms)])
    rows = sorted(rows.values(), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    # the top entries, and every port kernel's row wherever it ranks
    return wall, busy, [r for i, r in enumerate(rows)
                        if i < top or r[0] in KERNEL_ROWS]


def print_profile(wall, busy, rows, label="") -> None:
    """:func:`profile_phase`'s result, one row a line."""
    print(f"{label}where the time goes (profiled pipelined run): "
          f"{wall:.3f} s wall, {busy:.3f} s device busy "
          f"({100 * busy / wall:.1f} %)")
    for name, ms, calls, parts in rows:
        kernels_of = "" if len(parts) < 2 else " = " + " + ".join(
            f"{n} ({c}, {m:.1f} ms)" for n, c, m in parts)
        print(f"  {ms:9.1f} ms {calls:7d} calls  {name}{kernels_of}")


def online_system(cfg, params, device="cuda", *, pipelined=True,
                  tier_blocks=ONLINE_TIER_BLOCKS, block_tokens=64,
                  max_seq=2048, n_pe=1, n_de=1, **kw):
    """``n_pe`` PEs + ``n_de`` DEs (1 + 1 unless asked), dualpath, a DRAM
    tier of ``tier_blocks`` FullBlocks per node, agentic-TTL eviction and
    the think-time prefetcher; ``kw`` goes to the ServingSystem."""
    from repro_torch.core.config import TierConfig
    from repro_torch.engines.kvio import kv_row_bytes
    from repro_torch.serving import ServingSystem
    # a FullBlock is layers x block_tokens x (k ‖ v row) bytes
    itemsize = torch.empty((), dtype=getattr(
        torch, cfg.kv_cache_dtype)).element_size()
    tier_bytes = tier_blocks * cfg.n_layers * block_tokens * \
        kv_row_bytes(cfg, itemsize)
    return ServingSystem(
        cfg, params, device=device, pipelined=pipelined, n_pe=n_pe,
        n_de=n_de, mode="dualpath", block_tokens=block_tokens,
        max_seq=max_seq, de_slots=8,
        tier=TierConfig(dram_tier_bytes=tier_bytes,
                        tier_policy="agentic-ttl", prefetch=True), **kw)


def run_online_timed(system, trajs, arrivals, device):
    """``system.run_online``, synchronised; returns (sessions, real wall
    s)."""
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sessions = system.run_online(trajs, list(arrivals))
    if device != "cpu":
        torch.cuda.synchronize()
    return sessions, time.perf_counter() - t0


def online_workload(rounds=ONLINE_ROUNDS, n_agents=ONLINE_AGENTS,
                    mean_gap_s=0.5):
    """``n_agents`` trajectories of ``rounds`` and their Poisson arrival
    times (modelled seconds)."""
    from repro_torch.sim.traces import Round, Trajectory
    arrivals = np.cumsum(np.random.default_rng(7).exponential(
        mean_gap_s, n_agents)).tolist()
    trajs = [Trajectory(i, [Round(*r) for r in rounds])
             for i in range(n_agents)]
    return trajs, arrivals


def online_run(cfg, params, device="cuda", *, pipelined=True,
               rounds=ONLINE_ROUNDS, n_agents=ONLINE_AGENTS,
               mean_gap_s=0.5, **kw):
    """One online run: ``n_agents`` trajectories of ``rounds`` arriving
    at Poisson times on :func:`online_system`.  Returns (system,
    sessions, real wall s)."""
    trajs, arrivals = online_workload(rounds, n_agents, mean_gap_s)
    system = online_system(cfg, params, device, pipelined=pipelined, **kw)
    sessions, wall = run_online_timed(system, trajs, arrivals, device)
    return system, sessions, wall


def tier_counters(system) -> dict:
    """The online phase's tier counters in FullBlocks, which do not
    depend on the model's width or depth."""
    fb = system.layout.full_block_bytes
    st = system.stats()
    return {k: st[k] / fb for k in ("dram_hit_bytes", "tier_prefetch_bytes",
                                    "tier_evicted_bytes", "store_reads")}


def online_phase(cfg, device="cuda", **kw):
    """Online serving at full depth (see :func:`online_run`): every round
    finishes, all four kernels launch (the scatter once per persist), the
    tiers hit, prefetch and evict, and the blocking arm gives the
    pipelined arm's tokens.  Returns (stats, launches, wall_s,
    tokens_per_s, blocking_wall_s, tier counters in FullBlocks,
    persists)."""
    from repro_torch import kernels
    from repro_torch.models import init_params
    params = init_params(cfg, seed=0, device=device)
    kernels.reset_launch_counts()
    with persist_counter() as persists:
        system, sessions, wall = online_run(cfg, params, device, **kw)
    launches = kernels.launch_counts()
    st, blocks = system.stats(), tier_counters(system)
    n_rounds = len(kw.get("rounds", ONLINE_ROUNDS))
    assert all(s.rounds_done == n_rounds for s in sessions), \
        "an online round did not finish"
    for k, v in blocks.items():
        assert v > 0, f"online phase: {k} is 0"
    if device != "cpu":
        check_launches(launches, persists.n, "online")
    _, sessions_b, wall_b = online_run(cfg, params, device, pipelined=False,
                                       **kw)
    assert [s.context for s in sessions] == \
        [s.context for s in sessions_b], "online blocking arm diverged"
    return (st, launches, wall, st["gen_tokens"] / wall, wall_b, blocks,
            persists.n)


def gate_estimates(cfg, params, device, append: int) -> tuple:
    """The admission gate's TTFT estimates (modelled seconds) of a
    first-round arrival (``append`` new tokens, no hit) into an empty
    system and behind one queued arrival of the same size, from a probe
    system's own gate and load signals."""
    from repro_torch.core.config import SloConfig
    from repro_torch.core.scheduler import Request
    from repro_torch.serving import ServingSystem
    probe = ServingSystem(cfg, params, device=device, block_tokens=64,
                          max_seq=128, de_slots=1,
                          slo=SloConfig(admission=True))
    own = probe.time_model.pe_step_seconds([(0, append)])
    empty = probe.gate.ttft_estimate(probe._elastic_signals(), 0.0, own)
    probe.sched.pe_queue.append(Request(rid=-1, cached_tokens=0,
                                        new_tokens=append, gen_tokens=1))
    behind_one = probe.gate.ttft_estimate(probe._elastic_signals(), 0.0, own)
    return empty, behind_one


def slo_phase(cfg, device="cuda", rounds=SLO_ROUNDS, classes=SLO_CLASSES,
              arrivals=SLO_ARRIVALS, chunk=SLO_CHUNK):
    """The online SLO layer at full depth on :func:`online_system`: the
    gate, ``chunk``-token prefill slices and class order.

    The SLO sits half a queued round above the estimate behind one queued
    first round, so the first two arrivals are admitted and the
    interactive ones, which arrive while both wait, are deferred by the
    time one first round's prefill takes; they come back while the second
    batch round is being sliced and overtake it in the PE fifo.  A second
    setting serves the first rounds alone with no deferral allowed: the
    same arrivals are rejected.  Returns a dict of what it printed."""
    from repro_torch import kernels
    from repro_torch.core.config import SloConfig
    from repro_torch.engines import runtime
    from repro_torch.models import init_params
    from repro_torch.sim.traces import Round, Trajectory
    params = init_params(cfg, seed=0, device=device)
    empty, behind_one = gate_estimates(cfg, params, device, rounds[0][0])
    per_round = behind_one - empty
    slo_s, defer_s = behind_one + 0.5 * per_round, per_round
    trajs = lambda rs: [Trajectory(i, [Round(*r) for r in rs], slo_class=c)
                        for i, c in enumerate(classes)]

    def run(rs, **kw):
        system = online_system(cfg, params, device, slo=SloConfig(
            admission=True, admission_ttft_slo_s=slo_s,
            admission_defer_s=defer_s, prefill_chunk_tokens=chunk,
            class_aware=True, **kw))
        states = []
        system._set_state = lambda er, state, f=system._set_state: (
            states.append((er.req.rid, state.name)), f(er, state))
        _, wall = run_online_timed(
            system, trajs(rs), [a * per_round for a in arrivals], device)
        return system, wall, states

    kernels.reset_launch_counts()
    with persist_counter() as persists, \
            CallCounter(runtime, "append_step") as appends:
        system, wall, states = run(rounds)
    launches = kernels.launch_counts()
    st = system.stats()
    metrics = list(system.metrics.values())
    assert all(m.finished for m in metrics) and \
        st["finished_rounds"] == st["admitted_rounds"] == len(metrics) > 0, \
        "an admitted round did not finish"
    assert st["deferred_rounds"] > 0, "the gate deferred no round"
    assert st["prefill_chunks"] > 0 and \
        any(s == "PREFILL_CHUNKED" for _, s in states), "no prefill slice"
    overtakes = [(i.rid, b.rid) for i in metrics for b in metrics
                 if i.slo_class == "interactive" and b.slo_class == "batch"
                 and i.submit_t > b.submit_t
                 and i.prefill_done_t < b.prefill_done_t]
    assert overtakes, "no interactive round overtook an earlier batch round"
    if device != "cpu":
        check_launches(launches, persists.n, "slo")
        assert launches["flash_attention"] == cfg.n_layers * appends.n, \
            f"{launches['flash_attention']} flash launches for " \
            f"{appends.n} append_step calls"
    system_r, wall_r, _ = run(rounds[:1], admission_max_defers=0)
    st_r = system_r.stats()
    assert st_r["rejected_rounds"] > 0, "the gate rejected no round"
    return dict(stats=st, launches=launches, persists=persists.n,
                append_steps=appends.n, wall_s=wall,
                tokens_per_s=st["gen_tokens"] / wall, overtakes=overtakes,
                estimates_s=dict(empty=empty, behind_one=behind_one),
                arrivals_s=[a * per_round for a in arrivals],
                slo_s=slo_s, defer_s=defer_s, reject_wall_s=wall_r,
                reject_stats={k: st_r[k] for k in (
                    "admitted_rounds", "deferred_rounds", "rejected_rounds",
                    "finished_rounds", "gen_tokens")})


# ---------------------------------------------------------------------------
# phase 7: chaos (faults, hedged reads, fail-stop recovery), traced
# ---------------------------------------------------------------------------

def chaos_run(cfg, params, device="cuda", *, tracer=None, faults=None,
              hedge=False, **kw):
    """Phase 5's online workload, tier and prefetcher on 2 PEs + 2 DEs
    with split reads, optionally traced and under a FaultSchedule.  The
    kernel launch counts are set to 0 just before the run and read just
    after; ``kw`` goes to the ServingSystem.  Returns a dict: system,
    tracer, requests (every Request the scheduler got, in submission
    order), contexts, stats, launches, persists, wall_s, tokens_per_s."""
    from repro_torch import kernels
    from repro_torch.core.config import ResilienceConfig
    trajs, arrivals = online_workload()
    system = online_system(
        cfg, params, device, n_pe=2, n_de=2, split_reads=True,
        tracer=tracer,
        resilience=ResilienceConfig(faults=faults, hedge_reads=hedge), **kw)
    requests = []
    submit = system.sched.submit
    system.sched.submit = lambda r: (requests.append(r), submit(r))
    kernels.reset_launch_counts()
    with persist_counter() as persists:
        sessions, wall = run_online_timed(system, trajs, arrivals, device)
    launches = kernels.launch_counts()
    st = system.stats()
    assert all(s.done() and s.rounds_done == len(ONLINE_ROUNDS)
               for s in sessions), "a chaos round did not finish"
    return dict(system=system, tracer=tracer, requests=requests,
                contexts=[list(s.context) for s in sessions], stats=st,
                launches=launches, persists=persists.n, wall_s=wall,
                tokens_per_s=st["gen_tokens"] / wall)


def same_value(a, b) -> bool:
    """Equality with NaN equal to NaN, through dicts."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_value(a[k], b[k])
                                            for k in a)
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True
    return a == b


def plan_against_reads(run) -> list:
    """Per round: (plan, read, slack), each a {side: hit bytes} over the
    side's storage NIC and DRAM tier.  ``plan`` is the round's loading
    plan (``loading.plan_for`` on the request's own hit partition,
    ``tier=Request.hit_bytes_partition``), ``read`` what the run's trace
    shows the round read (``storage_read`` + ``tier_hit`` events), and
    ``slack`` half a FullBlock and a token when both storage NICs served
    the round, else 0: the runtime splits a read at whole FullBlocks and
    the plan at tokens, and tests/test_torch_faults.py shows the JAX
    reference's rounds a side apart by up to that rounding."""
    from repro_torch.core import loading
    layout = run["system"].layout
    kv = layout.n_layers * layout.bytes_per_token_layer
    read = {}
    for track, name, _, args in run["tracer"].iter_events():
        if name in ("storage_read", "tier_hit"):
            side = read.setdefault(int(track.split("/", 1)[1]),
                                   dict(pe=0, de=0))
            side[args["side"]] += args["nbytes"]
    out = []
    for r in run["requests"]:
        plan = dict(pe=0, de=0)
        for leg in loading.plan_for(
                r.read_path, r.read_split, r.cached_tokens * kv,
                r.new_tokens * kv, r.gen_tokens * kv,
                tier=r.hit_bytes_partition(kv)):
            if leg.phase == "load":
                for res in leg.resources:
                    if res in ("pe_snic", "pe_tier", "de_snic", "de_tier"):
                        plan[res[:2]] += leg.nbytes
        tok = r.read_tokens_by_side()
        slack = layout.full_block_bytes // 2 + kv \
            if tok["pe"] and tok["de"] else 0
        out.append((plan, read.get(r.rid, dict(pe=0, de=0)), slack))
    return out


def check_plans(run) -> dict:
    """The plans' bytes against what a traced run read, as the reference
    holds them: each round's plan carries exactly the hit bytes the round
    read, and each side within the round's page-rounding slack; summed
    over rounds, the plans equal the read ledgers (storage + tier) in
    total.  Returns the sums per side, plan and ledger, and the rounds
    that were split."""
    rounds = plan_against_reads(run)
    for i, (plan, read, slack) in enumerate(rounds):
        assert sum(plan.values()) == sum(read.values()), \
            f"round {i}: plan {plan}, read {read}"
        for s in ("pe", "de"):
            assert abs(plan[s] - read[s]) <= slack, \
                f"round {i}, {s} side: plan {plan}, read {read}, " \
                f"slack {slack}"
    st = run["stats"]
    plan = {s: sum(p[s] for p, _, _ in rounds) for s in ("pe", "de")}
    got = {s: st[f"read_bytes_{s}_side"] + st[f"dram_bytes_{s}_side"]
           for s in ("pe", "de")}
    assert sum(got.values()) == sum(plan.values()), \
        f"plans carry {plan} hit bytes, the ledgers hold {got}"
    return dict(plan=plan, runtime=got,
                split_rounds=sum(sl > 0 for _, _, sl in rounds))


def death_time(tracer, requests) -> tuple:
    """Where and when a DE dies: from a fault-free run's trace, the middle
    of the longest ``decode`` span of a round that started from a cache
    hit (so its recovery installs the hit again), and the DE that decoded
    it.  Returns (modelled time, DE, rid)."""
    by_rid = {r.rid: r for r in requests}
    spans = [(t1 - t0, t0, t1, int(track.split("/", 1)[1]))
             for track, _, t0, t1, _ in tracer.iter_spans("req/", "decode")]
    spans = [sp for sp in spans if by_rid[sp[3]].cached_tokens > 0]
    assert spans, "no round with a cache hit decoded"
    _, t0, t1, rid = max(spans)
    return t0 + 0.5 * (t1 - t0), by_rid[rid].de, rid


def first_difference(cfg, params, want, got, device) -> dict:
    """The first token where two runs' contexts differ, and the reference
    model's logit margin (top-1 minus top-2) at that position of the
    expected context."""
    from repro_torch.models import forward
    for agent, (a, b) in enumerate(zip(want, got)):
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   None)
        if pos is None:
            continue
        toks = torch.tensor([a[:pos]], dtype=torch.long, device=device)
        logits, _ = forward(params, cfg, toks, last_only=True)
        top = torch.topk(logits[0, -1].float(), 2).values
        return dict(agent=agent, position=pos, want=a[pos], got=b[pos],
                    margin=float(top[0] - top[1]))
    return {}


def death_arm(cfg, params, device, base) -> dict:
    """Arm (d): a DE dies while it decodes a round (the DE and the time
    from ``base``'s trace, :func:`death_time`), traced.  Returns the run,
    with the death time, the DE and the rid that was decoding."""
    from repro_torch.obs import Tracer, audit_serving
    from repro_torch.sim.faults import EngineDeath, FaultSchedule
    t_death, victim, rid = death_time(base["tracer"], base["requests"])
    run = chaos_run(cfg, params, device, tracer=Tracer(),
                    faults=FaultSchedule(
                        deaths=[EngineDeath(t_death, victim)]))
    st, st_a = run["stats"], base["stats"]
    assert st["engine_deaths"] == 1 and st["recovered_rounds"] > 0 and \
        st["n_de_final"] == 1, "the death arm did not recover"
    for k in ("store_writes", "trie_blocks"):
        assert st[k] == st_a[k], f"death arm: {k} {st[k]} against {st_a[k]}"
    assert st["store_reads"] >= st_a["store_reads"], "death arm read less"
    audit_serving(run["system"], run["tracer"], check_persists=True)
    recovered = list(run["tracer"].iter_events("recovered"))
    assert len(recovered) == st["recovered_rounds"], \
        f"{len(recovered)} recovered events, {st['recovered_rounds']} rounds"
    run.update(t_death=t_death, victim=victim, decoding_rid=rid)
    return run


def chaos_phase(cfg, device="cuda") -> dict:
    """Faults, hedged reads and fail-stop recovery at full width and
    depth, on phase 5's workload over 2 PEs + 2 DEs with split reads.

    (a) fault-free and traced: the trace audit (persists exactly once),
        the TTFT attribution against ``stats()``, and the loading plans'
        bytes against the read ledgers; (b) the same run untraced: equal
        tokens and ``stats()``; (c) node 0's storage NIC 8x slower and
        stragglers (p 0.4, 8x) with hedged reads: hedges moved tokens,
        and the chaos invariants (every round finishes, tokens, store
        writes, trie blocks and the hit bytes served equal (a)'s); (d) a
        DE dies while it decodes a round: it recovers, persists
        exactly once, reads at least as much, runs gather and flash more
        than (a), its trace passes the audit with one ``recovered`` event
        per recovered round, and gives (a)'s tokens (if a bf16 near-tie
        flips a token, the first difference and its margin are reported
        and the pair (a), (d) is run again in f32, where tokens must be
        equal).  Returns a dict of what it printed."""
    from repro_torch.models import init_params
    from repro_torch.obs import (Tracer, attribute_ttft, audit_serving,
                                 bottleneck_report)
    from repro_torch.sim.faults import (FaultSchedule, SlowdownWindow,
                                        StragglerModel)
    params = init_params(cfg, seed=0, device=device)
    out = {}
    # (a) fault-free, traced
    a = chaos_run(cfg, params, device, tracer=Tracer())
    st_a, tr = a["stats"], a["tracer"]
    audit = audit_serving(a["system"], tr, check_persists=True)
    assert audit["persist_bytes"] == st_a["store_writes"]
    rep = bottleneck_report(attribute_ttft(tr))
    assert rep["n"] == st_a["finished_rounds"], (rep["n"], st_a)
    assert rep["max_decomp_err_s"] < 1e-9, rep
    assert abs(rep["ttft_mean_s"] - st_a["ttft_mean"]) <= 1e-9, rep
    out["a"] = dict(run=a, audit=audit, report=rep, plans=check_plans(a),
                    trace=dict(spans=sum(1 for _ in tr.iter_spans()),
                               events=sum(1 for _ in tr.iter_events()),
                               counters=len(tr.counters)))
    # (b) the same run, untraced
    b = chaos_run(cfg, params, device)
    assert b["contexts"] == a["contexts"], "the untraced run's tokens differ"
    diff = [k for k in st_a if not same_value(st_a[k], b["stats"][k])]
    assert not diff and st_a.keys() == b["stats"].keys(), \
        f"untraced stats differ: {diff}"
    out["b"] = dict(run=b)
    # (c) hedged reads under a slow storage NIC and stragglers
    c = chaos_run(cfg, params, device, hedge=True, faults=FaultSchedule(
        windows=[SlowdownWindow("snic", 0.0, 1e9, 8.0, node=0)],
        straggler=StragglerModel(0.4, 8.0, seed=7)))
    st_c = c["stats"]
    assert st_c["hedged_reads"] > 0 and st_c["hedge_moved_tokens"] > 0, \
        "no read was hedged"
    assert c["contexts"] == a["contexts"], "the hedged arm's tokens differ"
    for k in ("store_writes", "trie_blocks"):
        assert st_c[k] == st_a[k], f"hedged arm: {k} {st_c[k]} != {st_a[k]}"
    # every hit byte is served once, from storage or from a DRAM tier: a
    # hedge moves blocks between sides, and so between the two sides'
    # tiers, which changes how many of them storage serves (the reference
    # does the same; tests/test_torch_faults.py shows it on both packages)
    total = lambda st: sum(st[f"{k}_bytes_{s}_side"] for k in ("read", "dram")
                           for s in ("pe", "de"))
    assert total(st_c) == total(st_a), "the hedge changed the hit total"
    out["c"] = dict(run=c)
    # (d) a DE dies while it decodes
    d = death_arm(cfg, params, device, a)
    if device != "cpu":
        for k in ("kv_layer_gather", "flash_attention"):
            assert d["launches"][k] > a["launches"][k], \
                f"recovery did not run {k} again: {d['launches'][k]} " \
                f"against {a['launches'][k]}"
    out["d"] = dict(run=d, first_difference=None, f32=None)
    if d["contexts"] != a["contexts"]:
        out["d"]["first_difference"] = first_difference(
            cfg, params, a["contexts"], d["contexts"], device)
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    kv_cache_dtype="float32")
        params32 = init_params(cfg32, seed=0, device=device)
        a32 = chaos_run(cfg32, params32, device, tracer=Tracer())
        d32 = death_arm(cfg32, params32, device, a32)
        assert d32["contexts"] == a32["contexts"], \
            f"f32 death arm diverged: " + json.dumps(first_difference(
                cfg32, params32, a32["contexts"], d32["contexts"], device))
        out["d"]["f32"] = dict(a=a32, d=d32)
    return out


# ---------------------------------------------------------------------------
# phase 8: elastic role flips and the compute network
# ---------------------------------------------------------------------------


def decode_state_bytes(cfg, slots: int, max_seq: int) -> int:
    """Bytes of a DE's decode state, from ``init_decode_state``'s shapes."""
    from repro_torch.models import init_decode_state
    st = init_decode_state(cfg, slots, max_seq, "meta")
    return sum(t.numel() * t.element_size() for t in st["kv"].values())


def engine_counting():
    """Patches of the engines' step, install and admit: an engine with a
    ``smoke`` dict adds to it its kernel launches, its calls, and the
    prefill tokens and decode steps they made."""
    from repro_torch import kernels
    from repro_torch.engines import runtime

    def counting(key):
        def wrap(orig):
            def counted(self, *a, **kw):
                box = getattr(self, "smoke", None)
                if box is None:
                    return orig(self, *a, **kw)
                before = kernels.launch_counts()
                work = [(k, getattr(self, k)) for k in
                        ("prefill_tokens", "decode_steps") if hasattr(self, k)]
                out = orig(self, *a, **kw)
                for k, v in kernels.launch_counts().items():
                    box[k] = box.get(k, 0) + v - before[k]
                for k, v in work:
                    box[k] = box.get(k, 0) + getattr(self, k) - v
                box[key] = box.get(key, 0) + 1
                return out
            return counted
        return wrap

    return [MethodPatch(runtime.PrefillEngine, "step", counting("steps")),
            MethodPatch(runtime.PrefillEngine, "install_hit_kv",
                        counting("installs")),
            MethodPatch(runtime.DecodeEngine, "step", counting("steps")),
            MethodPatch(runtime.DecodeEngine, "admit", counting("admits"))]


def flip_recording(flips: list, device):
    """A patch of ``ServingSystem._finish_flip`` that appends, per flip,
    its direction, engine, modelled time, the real host ms of the flip
    (synchronised: a new DE allocates its decode state), the change of
    ``torch.cuda.memory_allocated()`` across it, and the counts (see
    :func:`engine_counting`) of the engine it brought in."""
    from repro_torch.serving import ServingSystem
    sync = (lambda: None) if device == "cpu" else torch.cuda.synchronize
    allocated = (lambda: 0) if device == "cpu" else \
        torch.cuda.memory_allocated

    def wrap(orig):
        def recorded(self, rec):
            sync()
            m0, t0 = allocated(), time.perf_counter()
            orig(self, rec)
            sync()
            ms, m1 = 1e3 * (time.perf_counter() - t0), allocated()
            eng = self.pes.get(rec.engine) or self.des.get(rec.engine)
            eng.smoke = {}
            flips.append(dict(
                direction=f"{rec.from_kind}->{rec.to_kind}",
                engine=list(rec.engine), t_modelled=self.clock.now,
                host_ms=ms, allocated_delta=m1 - m0, counts=eng.smoke))
        return recorded

    return MethodPatch(ServingSystem, "_finish_flip", wrap)


def collective_counting():
    """A patch of ``ServingSystem._charge_collectives`` that sums on the
    system the tokens whose collectives it charged."""
    from repro_torch.serving import ServingSystem

    def wrap(orig):
        def counted(self, node, tokens):
            if self.time_model.collectives is not None and tokens > 0:
                self.smoke_coll_tokens = \
                    getattr(self, "smoke_coll_tokens", 0) + tokens
            return orig(self, node, tokens)
        return counted

    return MethodPatch(ServingSystem, "_charge_collectives", wrap)


def elastic_workload():
    """The elastic phase's trajectories and arrival times (modelled s)."""
    from repro_torch.sim.traces import Round, Trajectory
    w1, w2 = ELASTIC_WAVE1, ELASTIC_WAVE2
    trajs = [Trajectory(i, [Round(*r) for r in w1["rounds"]])
             for i in range(w1["n"])] + \
        [Trajectory(100 + i, [Round(*r) for r in w2["rounds"]])
         for i in range(w2["n"])]
    t2 = w1["n"] * w1["gap_s"] + w2["after_s"]
    return trajs, [i * w1["gap_s"] for i in range(w1["n"])] + [t2] * w2["n"]


def elastic_run(cfg, params, device, enabled: bool) -> dict:
    """The elastic workload on 2 PEs + 2 DEs with split reads and phase 5's
    tier, role flips on or off; kernel launch counts set to 0 just before
    the run and read just after.  Returns a dict: system, contexts,
    stats, launches, persists, wall_s, tokens_per_s, flips (see
    :func:`flip_recording`)."""
    import contextlib
    from repro_torch import kernels
    from repro_torch.core.config import ElasticConfig
    trajs, arrivals = elastic_workload()
    system = online_system(cfg, params, device, n_pe=2, n_de=2,
                           split_reads=True, elastic=ElasticConfig(
                               enabled=enabled, **ELASTIC))
    flips = []
    with contextlib.ExitStack() as stack:
        for patch in engine_counting():
            stack.enter_context(patch)
        stack.enter_context(flip_recording(flips, device))
        persists = stack.enter_context(persist_counter())
        kernels.reset_launch_counts()
        sessions, wall = run_online_timed(system, trajs, arrivals, device)
        launches = kernels.launch_counts()
    st = system.stats()
    assert all(s.done() and s.rounds_done == len(s.traj.rounds)
               for s in sessions), "an elastic round did not finish"
    return dict(system=system, contexts=[list(s.context) for s in sessions],
                stats=st, launches=launches, persists=persists.n,
                wall_s=wall, tokens_per_s=st["gen_tokens"] / wall,
                flips=flips)


def check_settled(system) -> None:
    """Every engine ACTIVE, the engine maps equal to the scheduler's view,
    no drain open, no tier pin left."""
    from repro_torch.serving.events import EngineLifecycle
    st = system.stats()
    assert all(lc == EngineLifecycle.ACTIVE
               for lc in system.engine_lifecycle.values()), \
        {e: lc.name for e, lc in system.engine_lifecycle.items()}
    kinds = {k: {e for e, s in system.sched.engines.items() if s.kind == k}
             for k in ("pe", "de")}
    assert set(system.pes) == kinds["pe"] and set(system.des) == kinds["de"]
    assert st["n_pe_final"] == len(system.pes) and \
        st["n_de_final"] == len(system.des)
    assert not system.drains.active and not system._reconfig_ready
    assert all(t.pinned_bytes() == 0 for t in system.tiers.values()), \
        "a tier pin was left"


def elastic_phase(cfg, device="cuda") -> dict:
    """Elastic role flips and the compute network at full width and depth.

    (e) :func:`elastic_workload` with role flips: at least one flip each
        way; a flipped-in PE prefilled (flash) and a flipped-in DE admitted
        and decoded a round (paged) and persisted (scatter); a DE→PE flip
        freed exactly the decode state (``memory_allocated`` within 1 % of
        its bytes from ``init_decode_state``'s shapes; a PE→DE flip
        allocated it); every round finished, every engine ended ACTIVE
        and no tier pin is left; all four kernels launched;
    (f) the same with role flips off: (e)'s tokens (if a bf16 near-tie
        flips a token, the first difference is reported and (e) and (f)
        run again in f32, where tokens must be equal);
    (g), (h) phase 5's workload on the same cluster with model collectives
        on the compute network (``collective_group_size`` 8) under 'vl'
        and 'fifo': equal tokens, both charge collectives, 'fifo' stalls
        them longer, (g) ends congested; all four kernels launched in (g).
    Returns a dict of what it printed."""
    from repro_torch.core.config import NetworkConfig
    from repro_torch.models import init_params
    params = init_params(cfg, seed=0, device=device)
    state_b = decode_state_bytes(cfg, 8, 2048)
    out = dict(state_bytes=state_b)
    e = elastic_run(cfg, params, device, True)
    st = e["stats"]
    by_dir = st["role_changes_by_direction"]
    assert by_dir["de->pe"] >= 1 and by_dir["pe->de"] >= 1, by_dir
    check_settled(e["system"])
    for f in e["flips"]:
        if device == "cpu":
            continue
        sign = -1 if f["direction"] == "de->pe" else 1
        assert abs(sign * f["allocated_delta"] - state_b) <= 0.01 * state_b, \
            f"{f['direction']} flip of {f['engine']} changed allocated " \
            f"bytes by {f['allocated_delta']}, the decode state is {state_b}"
    c_pe = [f["counts"] for f in e["flips"] if f["direction"] == "de->pe"]
    c_de = [f["counts"] for f in e["flips"] if f["direction"] == "pe->de"]
    assert any(c.get("prefill_tokens", 0) > 0 for c in c_pe), \
        "no flipped-in PE prefilled"
    assert any(c.get("admits", 0) > 0 and c.get("decode_steps", 0) > 0
               for c in c_de), "no flipped-in DE decoded"
    if device != "cpu":
        check_launches(e["launches"], e["persists"], "elastic")
        assert any(c.get("flash_attention", 0) > 0 for c in c_pe), \
            "no flipped-in PE launched flash"
        assert any(c.get("paged_attention", 0) > 0 and
                   c.get("kv_layer_scatter", 0) > 0 for c in c_de), \
            "no flipped-in DE launched paged and scatter"
    f = elastic_run(cfg, params, device, False)
    assert f["stats"]["role_changes"] == 0
    out.update(e=e, f=f, first_difference=None, f32=None)
    if e["contexts"] != f["contexts"]:
        out["first_difference"] = first_difference(
            cfg, params, f["contexts"], e["contexts"], device)
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    kv_cache_dtype="float32")
        params32 = init_params(cfg32, seed=0, device=device)
        e32 = elastic_run(cfg32, params32, device, True)
        f32 = elastic_run(cfg32, params32, device, False)
        assert e32["contexts"] == f32["contexts"], \
            "f32 elastic arm diverged: " + json.dumps(first_difference(
                cfg32, params32, f32["contexts"], e32["contexts"], device))
        out["f32"] = dict(e=e32["stats"], f=f32["stats"])
        del e32, f32
    with collective_counting():
        for arm, arb in (("g", "vl"), ("h", "fifo")):
            run = chaos_run(cfg, params, device, net=NetworkConfig(
                net_arbiter=arb, collective_group_size=8))
            tm = run["system"].time_model
            tokens = getattr(run["system"], "smoke_coll_tokens", 0)
            run["collective_tokens"] = tokens
            run["collective_s"] = tm.collective_seconds(
                tm.collectives.step_bytes(tokens))
            out[arm] = run
    g, h = out["g"], out["h"]
    assert g["contexts"] == h["contexts"], "the arbiters' tokens differ"
    assert g["collective_tokens"] > 0 and h["collective_tokens"] > 0, \
        "no collective was charged"
    assert h["stats"]["collective_stall_s"] > g["stats"]["collective_stall_s"], \
        "fifo did not stall the collectives longer than vl"
    assert g["stats"]["net_congestion"] > 0, "vl ended uncongested"
    if device != "cpu":
        check_launches(g["launches"], g["persists"], "network")
    # the systems hold their decode states; keep the numbers only
    for arm in ("e", "f", "g", "h"):
        out[arm].pop("system")
    gc.collect()
    return out


def reference_contexts(cfg, params, rounds, seed_tid, device):
    """The port's cache-free reference: full forward per round for the
    first token, then decode, as tests/test_serving.py's oracle."""
    from repro_torch.models import (append_step, decode_step, forward,
                                    init_decode_state)
    rng = np.random.default_rng(1000 + seed_tid)
    context = []
    for a, g in rounds:
        prompt = context + list(rng.integers(2, cfg.vocab_size, size=a))
        toks = torch.tensor([prompt], dtype=torch.long, device=device)
        logits, _ = forward(params, cfg, toks)
        cur = int(torch.argmax(logits[0, -1]))
        gen = [cur]
        st = init_decode_state(cfg, 1, len(prompt) + g + 4, device)
        append_step(params, cfg, toks, st,
                    torch.zeros(1, dtype=torch.long, device=device))
        for i in range(g - 1):
            lg, st = decode_step(
                params, cfg, torch.tensor([cur], device=device), st,
                torch.tensor([len(prompt) + i], device=device))
            cur = int(torch.argmax(lg[0]))
            gen.append(cur)
        context = prompt + gen
    return context


def identity_phase(cfg, device="cuda", rounds=((256, 8), (64, 8), (64, 8)),
                   block_tokens=64, max_seq=512, chunk=96):
    """f32 serving, unchunked and with ``chunk``-token prefill slices
    (the first round's 256 tokens in three), must give the cache-free
    reference's context.  Returns (context tokens, prefill slices of the
    chunked run)."""
    from repro_torch.core.config import SloConfig
    from repro_torch.models import init_params
    from repro_torch.sim.traces import Round, Trajectory
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                kv_cache_dtype="float32")
    params = init_params(cfg32, seed=1, device=device)
    want = reference_contexts(cfg32, params, rounds, 0, device)
    chunks = 0
    for slo in (None, SloConfig(prefill_chunk_tokens=chunk)):
        system, sessions, _ = serve(
            cfg32, params, [Trajectory(0, [Round(*r) for r in rounds])],
            device, n_pe=1, n_de=1, block_tokens=block_tokens,
            max_seq=max_seq, de_slots=2, slo=slo)
        got = sessions[0].context
        if got != want:
            first = next(i for i, (a, b) in enumerate(zip(got, want))
                         if a != b)
            raise AssertionError(
                f"f32 serving{'' if slo is None else ' with prefill slices'}"
                f" diverged from the cache-free reference at token {first}")
        st = system.stats()
        assert st["store_reads"] > 0 or system.blob_store.bytes_read > 0, \
            "no cache was read back"
        if slo is not None:
            chunks = st["prefill_chunks"]
            assert chunks > 0, "the f32 run was not sliced"
    return len(want), chunks


# ---------------------------------------------------------------------------
# phase 10: gemma2-2b (sliding-window and global layers, softcaps, dh 256)
# ---------------------------------------------------------------------------


class WindowCounter:
    """Counts the model's flash and paged calls that pass a window on a
    sequence longer than it.  It reads no device tensor, so the run it
    counts keeps its own syncs: the calls with a window are counted at
    the names ``models.layers`` calls, and each engine step's count is
    credited from the lengths the engines keep on the host.  A PE step
    makes one ``append_step`` per item of ``last_step_items`` (cached,
    size), each with the same calls, so an item past the window adds its
    share; a DE step passes the window when its longest slot does."""

    def __init__(self, window: int):
        self.window = window
        self.n = {"flash_attention": 0, "paged_attention": 0}
        self.step = dict.fromkeys(self.n, 0)     # the running step's calls

    def _layer(self, name):
        def wrap(fn):
            def counted(*args, window=0, **kw):
                self.step[name] += window > 0
                return fn(*args, window=window, **kw)
            return counted
        return wrap

    def _prefill(self, fn):
        def step(engine):
            self.step["flash_attention"] = 0
            out = fn(engine)
            items = engine.last_step_items
            past = sum(c + n > self.window for c, n in items)
            if past:
                self.n["flash_attention"] += \
                    self.step["flash_attention"] * past // len(items)
            return out
        return step

    def _decode(self, fn):
        def step(engine):
            self.step["paged_attention"] = 0
            longest = max((int(engine.lengths[i]) + 1
                           for i, er in enumerate(engine.slots)
                           if er is not None), default=0)
            out = fn(engine)
            if longest > self.window:
                self.n["paged_attention"] += self.step["paged_attention"]
            return out
        return step

    def __enter__(self):
        from repro_torch.engines import runtime
        from repro_torch.models import layers
        self.patches = [MethodPatch(layers, n, self._layer(n))
                        for n in self.n]
        self.patches += [
            MethodPatch(runtime.PrefillEngine, "step", self._prefill),
            MethodPatch(runtime.DecodeEngine, "step", self._decode)]
        for p in self.patches:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.__exit__(*exc)


def gemma2_phase(cfg, device="cuda", rounds=GEMMA2_ROUNDS,
                 n_agents=GEMMA2_AGENTS, max_seq=GEMMA2_MAX_SEQ,
                 identity=GEMMA2_IDENTITY) -> dict:
    """gemma2-2b served offline on 1 PE + 1 DE (dualpath, 64-token
    FullBlocks, 8 DE slots): every round finishes, all four kernels
    launch (the scatter once per persist), flash and paged run with the
    window on sequences longer than it, and the blocking arm gives the
    same tokens; then f32 token identity with the cache-free reference,
    unchunked and in prefill slices (:func:`identity_phase`)."""
    from repro_torch import kernels
    from repro_torch.models import init_params
    from repro_torch.sim.traces import Round, Trajectory
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device=device)
    trajs = lambda: [Trajectory(i, [Round(*r) for r in rounds])
                     for i in range(n_agents)]
    kw = dict(n_pe=1, n_de=1, mode="dualpath", block_tokens=64,
              max_seq=max_seq, de_slots=8)
    kernels.reset_launch_counts()
    with persist_counter() as persists, \
            WindowCounter(cfg.local_window) as windowed:
        system, sessions, wall = serve(cfg, params, trajs(), device, **kw)
    launches = kernels.launch_counts()
    # the run's own peak, weights included: above what was allocated
    # before the phase
    peak = torch.cuda.max_memory_allocated() - base \
        if device != "cpu" else None
    st = system.stats()
    assert all(s.rounds_done == len(rounds) for s in sessions), \
        "a gemma2 round did not finish"
    assert st["store_reads"] > 0, "no FullBlock was read back"
    if device != "cpu":
        check_launches(launches, persists.n, "gemma2")
    assert all(n > 0 for n in windowed.n.values()), \
        f"a kernel never ran its window past it: {windowed.n}"
    contexts = [len(s.context) for s in sessions]
    assert min(contexts) > cfg.local_window
    del system
    _, sessions_b, wall_b = serve(cfg, params, trajs(), device,
                                  pipelined=False, **kw)
    assert [s.context for s in sessions] == \
        [s.context for s in sessions_b], "gemma2 blocking arm diverged"
    del params, sessions, sessions_b
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    n, chunks = identity_phase(cfg, device, **identity)
    return dict(stats=st, launches=launches, windowed=windowed.n,
                persists=persists.n, wall_s=wall,
                tokens_per_s=st["gen_tokens"] / wall, blocking_wall_s=wall_b,
                context_lens=contexts, peak_allocated=peak,
                identity_tokens=n, identity_chunks=chunks)


# ---------------------------------------------------------------------------
# phase 11: ds27b (MoE + MLA, the paper's own model)
# ---------------------------------------------------------------------------


class PathCounter:
    """Counts what the ds27b phase's launches follow from: the packer's
    batch items (one ``append_step`` each) and their (rows, kv_len), the
    hit installs (one ``kvio.layer_stream`` each) and the DE persists.
    Patches the engine
    classes' methods while entered and reads no device tensor."""

    def __init__(self):
        self.items = self.installs = 0
        self.appends = set()            # (rows, kv_len) of each item

    def _prefill(self, fn):
        def step(engine):
            out = fn(engine)
            self.items += len(engine.last_step_items)
            self.appends.update((n, cached + n)
                                for cached, n in engine.last_step_items)
            return out
        return step

    def _install(self, fn):
        def install(engine, er, payload):
            self.installs += payload is not None and len(payload) > 0
            return fn(engine, er, payload)
        return install

    def __enter__(self):
        from repro_torch.engines import runtime
        self.patches = [
            MethodPatch(runtime.PrefillEngine, "step", self._prefill),
            MethodPatch(runtime.PrefillEngine, "install_hit_kv",
                        self._install),
            persist_counter()]
        for p in self.patches:
            p.__enter__()
        return self

    @property
    def persists(self) -> int:
        return self.patches[2].n

    def __exit__(self, *exc):
        for p in self.patches:
            p.__exit__(*exc)


def host_syncs(fn) -> int:
    """How many synchronising CUDA operations ``fn()`` makes, as
    PyTorch's sync debug mode sees them (it warns at each; a prototype
    that, by its own notice, does not see every kind): a host read of a
    device value is one."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def model_step_syncs(cfg, params, max_seq: int) -> dict:
    """Host syncs of one ``decode_step`` over 8 slots and one 256-token
    ``append_step``: each reads the longest row's length once
    (``model._check_fits``), and the MoE and MLA layers add none, so each
    must make exactly one."""
    from repro_torch.models import append_step, decode_step, \
        init_decode_state
    dev = params["embed"]["tok"].device
    out = {}
    for name, b, s in (("decode_step", 8, 1), ("append_step", 1, 256)):
        state = init_decode_state(cfg, b, max_seq, dev)
        toks = torch.randint(2, cfg.vocab_size, (b, s), device=dev)
        lengths = torch.full((b,), 4096, device=dev)
        step = (lambda: decode_step(params, cfg, toks[:, 0], state, lengths)) \
            if s == 1 else \
            (lambda: append_step(params, cfg, toks, state, lengths))
        out[name] = host_syncs(step)
        del state
    return out


def predicted_launches(cfg, items: int, installs: int, persists: int,
                       decode_steps: int) -> dict:
    """Each kernel's launches from the packer's items, the installs, the
    persists, the decode steps and the layer kinds.  Attention models:
    flash once per layer of every ``append_step``, the grouped GEMM three
    times per MoE layer of every ``append_step`` and decode step, per
    layer of every decode step the absorbed decode (MLA) or the paged
    kernel (GQA), the gather once per layer of every FullBlock install,
    the scatter once per persist.  SSM models: the SSD scan once per
    layer of every ``append_step``, the recurrent step once per layer of
    every decode step (which writes the state and every conv tail in
    place: no copy), the causal conv once per layer of every
    ``append_step`` only (a decode token's conv runs inside the recurrent
    step's launch), nothing else (a blob install and persist are one copy
    each, no kernel).  Hybrid models: the SSM kernels per Mamba2 layer as
    an SSM model's, and flash once per shared-block application of every
    ``append_step``, paged once per application of every decode step."""
    n_l, n_moe = cfg.n_layers, sum(cfg.moe_layer_mask())
    out = {k: 0 for k in KERNEL_SOURCES}
    if cfg.family in ("ssm", "hybrid"):
        out.update(ssd_chunk_scan=n_l * items, ssm_step=n_l * decode_steps,
                   causal_conv=n_l * items)
        if cfg.family == "hybrid":
            n_apps = n_l // cfg.hybrid_period
            out.update(flash_attention=n_apps * items,
                       paged_attention=n_apps * decode_steps)
        return out
    mla = cfg.attn_variant == "mla"
    out.update(kv_layer_gather=n_l * installs, kv_layer_scatter=persists,
               flash_attention=n_l * items,
               grouped_gemm=3 * n_moe * (items + decode_steps),
               paged_attention=0 if mla else n_l * decode_steps,
               mla_decode=n_l * decode_steps if mla else 0)
    return out


class RegimeCounter(MethodPatch):
    """Counts the grouped GEMM's launches by regime, from the shapes the
    wrapper picks it from (``grouped_gemm.regime``): host-side, no
    device read."""

    def __init__(self):
        import importlib
        gg = importlib.import_module("repro_torch.kernels.grouped_gemm")
        self.n = dict.fromkeys(gg.REGIMES, 0)

        def wrap(fn):
            def counted(*args):
                mode = fn(*args)
                self.n[mode] += 1
                return mode
            return counted

        super().__init__(gg, "regime", wrap)


def moe_phase(cfg, device="cuda", rounds=DS27B_ROUNDS,
              n_agents=DS27B_AGENTS, max_seq=DS27B_MAX_SEQ,
              identity=DS27B_IDENTITY, profile=True) -> dict:
    """An MoE model (ds27b over MLA, llama4 over GQA) served offline on 1
    PE + 1 DE (dualpath, 64-token FullBlocks, 8 DE slots): every round
    finishes, FullBlock rows are the config's, the launches equal those
    predicted (:func:`predicted_launches`: MLA decodes through
    ``mla_decode``, GQA through ``paged_attention``), the grouped GEMM
    runs in both regimes (:class:`RegimeCounter`), and the blocking arm
    gives the same tokens; a model step makes one host sync, not one per
    layer (:func:`model_step_syncs`); a third run under torch.profiler
    (``profile``); then f32 token identity at full width,
    ``identity["depth"]`` layers and, with ``identity["n_experts"]``,
    that many routed experts, with the cache-free reference, unchunked
    and in prefill slices (:func:`identity_phase`)."""
    from repro_torch import kernels
    from repro_torch.engines.kvio import kv_row_bytes
    from repro_torch.models import init_params
    from repro_torch.sim.traces import Round, Trajectory
    cuda = device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    if cuda:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trajs = lambda: [Trajectory(i, [Round(*r) for r in rounds])
                     for i in range(n_agents)]
    kw = dict(n_pe=1, n_de=1, mode="dualpath", block_tokens=64,
              max_seq=max_seq, de_slots=8)
    kernels.reset_launch_counts()
    with PathCounter() as path, RegimeCounter() as regimes:
        system, sessions, wall = serve(cfg, params, trajs(), device, **kw)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    st = system.stats()
    assert all(s.rounds_done == len(rounds) for s in sessions), \
        f"a {cfg.name} round did not finish"
    assert st["store_reads"] > 0, "no FullBlock was read back"
    mla = cfg.attn_variant == "mla"
    row = system.layout.bytes_per_token_layer
    assert row == kv_row_bytes(cfg) == (
        cfg.mla.kv_lora_rank * 2 + cfg.mla.rope_head_dim * 2 if mla else
        2 * cfg.n_kv_heads * cfg.head_dim * 2), row
    predicted = predicted_launches(cfg, path.items, path.installs,
                                   path.persists, st["decode_steps"])
    if cuda:
        assert launches == predicted, \
            f"{cfg.name} launches {launches}, predicted {predicted}"
        assert all(launches[k] > 0 for k in (
            "kv_layer_gather", "kv_layer_scatter", "flash_attention",
            "grouped_gemm", "mla_decode" if mla else "paged_attention")), \
            launches
        assert all(n > 0 for n in regimes.n.values()), \
            f"{cfg.name}: a grouped-GEMM regime never ran: {regimes.n}"
    contexts = [len(s.context) for s in sessions]
    del system
    system, sessions_b, wall_b = serve(cfg, params, trajs(), device,
                                       pipelined=False, **kw)
    assert [s.context for s in sessions] == \
        [s.context for s in sessions_b], f"{cfg.name} blocking arm diverged"
    del system
    syncs = model_step_syncs(cfg, params, max_seq) if cuda else None
    if cuda:
        assert syncs == {"decode_step": 1, "append_step": 1}, \
            f"host syncs per model step: {syncs}"
    prof = profile_phase(cfg, rounds, n_agents, max_seq=max_seq,
                         params=params) if profile else None
    # the bf16 weights go before the f32 identity's come
    del params, sessions, sessions_b
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cut = dict(n_layers=identity["depth"])
    if identity.get("n_experts"):
        cut["moe"] = dataclasses.replace(cfg.moe,
                                         n_experts=identity["n_experts"])
    n, chunks = identity_phase(
        dataclasses.replace(cfg, **cut), device,
        **{k: v for k, v in identity.items()
           if k not in ("depth", "n_experts")})
    return dict(stats=st, launches=launches, predicted=predicted,
                regimes=regimes.n, items=path.items,
                appends=sorted(path.appends), installs=path.installs,
                persists=path.persists, wall_s=wall,
                tokens_per_s=st["gen_tokens"] / wall,
                blocking_wall_s=wall_b, context_lens=contexts,
                peak_allocated=peak, init_s=init_s, row_bytes=row,
                step_syncs=syncs, profile=prof, identity_tokens=n,
                identity_chunks=chunks, identity_depth=identity["depth"],
                identity_experts=identity.get("n_experts"))

# ---------------------------------------------------------------------------
# phases 13 and 15: mamba2-1.3b (SSM) and zamba2-2.7b (hybrid), the
# state-blob path
# ---------------------------------------------------------------------------


class BlobCounter(PathCounter):
    """:class:`PathCounter` for the SSM family, whose persists are state
    blobs (``kvio.state_to_blob`` calls) and whose installs of a hit are
    blobs (``kvio.blob_to_state`` calls)."""

    def __enter__(self):
        from repro_torch.engines import kvio
        super().__enter__()
        self.blob_codec = [CallCounter(kvio, "state_to_blob"),
                           CallCounter(kvio, "blob_to_state")]
        for p in self.blob_codec:
            p.__enter__()
        return self

    @property
    def persists(self) -> int:
        return self.blob_codec[0].n

    @property
    def blob_installs(self) -> int:
        return self.blob_codec[1].n

    def __exit__(self, *exc):
        for p in self.blob_codec:
            p.__exit__(*exc)
        super().__exit__(*exc)


def blob_copy_ms(cfg, state, device, reps: int = 5) -> dict:
    """One slot's state to a blob (D2H) and back (H2D), timed alone by
    the host clock around synchronised calls: median ms and GB/s."""
    from repro_torch.engines import kvio
    axes = kvio.batch_axes_of_state(cfg)
    one = kvio.slot_get(state, axes, 0)
    max_seq = one["shared"]["k"].shape[2] if "shared" in one else 0
    d2h, h2d = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = kvio.state_to_blob(one)
        t1 = time.perf_counter()
        kvio.blob_to_state(cfg, blob, device, max_seq)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        d2h.append((t1 - t0) * 1e3)
        h2d.append((t2 - t1) * 1e3)
    n = len(blob)
    return dict(bytes=n, d2h_ms=float(np.median(d2h)),
                h2d_ms=float(np.median(h2d)),
                d2h_gb_s=n / np.median(d2h) / 1e6,
                h2d_gb_s=n / np.median(h2d) / 1e6)


def blob_bytes(cfg, max_seq: int) -> int:
    """One session's state blob from the config: per Mamba2 layer the f32
    SSD state (H x P x N) and the conv tails of x, B and C (cw - 1 rows
    of d_inner + 2 N) in the activation dtype, then for a hybrid the
    shared block's K and V for each application at ``max_seq`` tokens in
    the cache dtype."""
    s = cfg.ssm
    d_inner, n = s.expand * cfg.d_model, s.n_groups * s.d_state
    act = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    mamba = cfg.n_layers * (d_inner * n * 4 +
                            (s.conv_width - 1) * (d_inner + 2 * n) * act)
    if cfg.family != "hybrid":
        return mamba
    kv = torch.finfo(getattr(torch, cfg.kv_cache_dtype)).bits // 8
    return mamba + 2 * (cfg.n_layers // cfg.hybrid_period) * max_seq * \
        cfg.n_kv_heads * cfg.head_dim * kv


def decode_layer_kernels(cfg, layer, b=8, reps=20) -> tuple:
    """What one Mamba2 layer's decode step launches over ``b`` slots at
    ``cfg``'s widths (``layer``: one layer's weights; a zero state):
    ``ssm_step``'s launches a step by its wrapper's count, and {kernel or
    copy name:
    launches a step} as torch.profiler saw ``reps`` warm steps after a
    warm-up cycle of as many (a session can miss its first few records,
    so these are rounded).  The token's conv and the recurrence are one
    ``ssm_step`` launch, which writes the state and every tail in place,
    so no ``Memcpy`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import ssm_step
    from repro_torch.models import ssm
    state = ssm.init_ssm_state(cfg, b, "cuda")
    x = torch.randn((b, 1, cfg.d_model), device="cuda").to(
        getattr(torch, cfg.param_dtype))
    ssm.ssm_decode_step(layer, cfg, x, state)
    torch.cuda.synchronize()
    before = ssm_step.launches
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for cycle in range(2):              # warm-up, then the one read
            for _ in range(reps):
                ssm.ssm_decode_step(layer, cfg, x, state)
            torch.cuda.synchronize()
            if cycle == 0:
                prof.step()
    steps = (ssm_step.launches - before) / (2 * reps)
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = short_name(e.key)
            out[name] = out.get(name, 0) + e.count
    return steps, {k: round(n / reps) for k, n in out.items()}


def decode_layer_check() -> dict:
    """One Mamba2 decode layer of mamba2-1.3b and of zamba2-2.7b at full
    width over 8 slots (:func:`decode_layer_kernels`, one layer's seed-0
    weights): each launches ``ssm_step`` once and copies no tail.
    Returns {arch: kernels}."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    out = {}
    for arch in ("mamba2-1.3b", "zamba2-2.7b"):
        cfg = get_config(arch)
        one = dataclasses.replace(cfg, n_layers=cfg.hybrid_period
                                  if cfg.family == "hybrid" else 1)
        steps, got = decode_layer_kernels(
            cfg, init_params(one, seed=0)["blocks"][0])
        assert steps == 1 and not any(k.startswith("Memcpy") for k in got), \
            f"{arch}: a decode layer launched ssm_step {steps} times a " \
            f"step and {got}"
        out[arch] = got
    return out


def blob_phase(cfg, device="cuda", rounds=MAMBA2_ROUNDS,
               n_agents=MAMBA2_AGENTS, max_seq=MAMBA2_MAX_SEQ,
               identity=MAMBA2_IDENTITY, profile=True) -> dict:
    """An SSM or hybrid model (mamba2-1.3b, zamba2-2.7b) served offline on
    1 PE + 1 DE (dualpath, 8 DE slots): every round finishes; rounds 2
    and 3 continue from their session's state blob (the blob store read
    once per such round, never split across the read sides), each blob
    the size its config gives (:func:`blob_bytes`: a hybrid's carries its
    shared block's K/V at ``max_seq``); the launches equal those
    predicted (:func:`predicted_launches`: the SSD scan, the recurrent
    step and the causal conv per Mamba2 layer, a hybrid's flash and paged
    per shared-block application, nothing else); the blocking arm gives
    the same tokens; a third run under torch.profiler (``profile``), and
    the blob's D2H and H2D alone; then f32 token identity at full width
    and ``identity["depth"]`` layers with the cache-free reference,
    unchunked and in prefill slices (:func:`identity_phase`)."""
    from repro_torch import kernels
    from repro_torch.models import init_params
    from repro_torch.sim.traces import Round, Trajectory
    cuda = device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device=device)
    trajs = lambda: [Trajectory(i, [Round(*r) for r in rounds])
                     for i in range(n_agents)]
    kw = dict(n_pe=1, n_de=1, mode="dualpath", block_tokens=64,
              max_seq=max_seq, de_slots=8)
    kernels.reset_launch_counts()
    with BlobCounter() as path:
        system, sessions, wall = serve(cfg, params, trajs(), device, **kw)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    st = system.stats()
    assert all(s.rounds_done == len(rounds) for s in sessions), \
        f"a {cfg.name} round did not finish"
    blobs = system.blob_store
    raw = blob_bytes(cfg, max_seq)
    sizes = {len(b) for b, _ in blobs._blobs.values()}
    assert sizes == {raw}, f"{cfg.name} blobs of {sizes} bytes, want {raw}"
    n_reads = n_agents * (len(rounds) - 1)
    assert blobs.bytes_read == n_reads * raw, \
        f"blob reads {blobs.bytes_read} bytes, want {n_reads} x {raw}"
    assert path.blob_installs == n_reads and path.installs == n_reads
    assert st["split_reads"] == 0 and \
        st["read_bytes_pe_side"] % raw == 0 and \
        st["read_bytes_de_side"] % raw == 0 and \
        st["read_bytes_pe_side"] + st["read_bytes_de_side"] == \
        blobs.bytes_read, "a blob read was split across the sides"
    assert st["store_reads"] == st["store_writes"] == 0
    predicted = predicted_launches(cfg, path.items, path.installs,
                                   path.persists, st["decode_steps"])
    if cuda:
        assert launches == predicted, \
            f"{cfg.name} launches {launches}, predicted {predicted}"
    contexts = [len(s.context) for s in sessions]
    copies = blob_copy_ms(cfg, system.des[(1, 0)].state, device) \
        if cuda else None
    del system
    system, sessions_b, wall_b = serve(cfg, params, trajs(), device,
                                       pipelined=False, **kw)
    assert [s.context for s in sessions] == \
        [s.context for s in sessions_b], f"{cfg.name} blocking arm diverged"
    del system
    prof = profile_phase(cfg, rounds, n_agents, max_seq=max_seq,
                         params=params) if profile else None
    del params, sessions, sessions_b
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    depth = identity["depth"]
    n, chunks = identity_phase(
        dataclasses.replace(cfg, n_layers=depth), device,
        **{k: v for k, v in identity.items() if k != "depth"})
    return dict(stats=st, launches=launches, predicted=predicted,
                items=path.items, appends=sorted(path.appends),
                blob_reads=blobs.bytes_read // raw, blob_bytes=raw,
                blob_writes=blobs.bytes_written // raw,
                persists=path.persists, wall_s=wall,
                tokens_per_s=st["gen_tokens"] / wall,
                blocking_wall_s=wall_b, context_lens=contexts,
                peak_allocated=peak, blob_copies=copies, profile=prof,
                identity_tokens=n, identity_chunks=chunks,
                identity_depth=depth)


def print_blob_phase(r: dict, label: str) -> None:
    """:func:`blob_phase`'s result, as phases 13 and 15 print it."""
    st = r["stats"]
    print(f"{label} stats:", json.dumps(st))
    print(f"{label}: {r['wall_s']:.3f} s real wall (pipelined), "
          f"{r['blocking_wall_s']:.3f} s (blocking), "
          f"{r['tokens_per_s']:.1f} generated tokens/s, launches "
          f"{r['launches']} (predicted {r['predicted']} from "
          f"{r['items']} batch items (rows, end) {r['appends']} and "
          f"{st['decode_steps']} decode steps); state blob "
          f"{r['blob_bytes']} bytes, read {r['blob_reads']} times "
          f"(never split: pe side {st['read_bytes_pe_side']}, de side "
          f"{st['read_bytes_de_side']} bytes), written "
          f"{r['blob_writes']} times; one blob alone: "
          f"{json.dumps(r['blob_copies'])}; contexts "
          f"{r['context_lens']}; peak memory_allocated of the run "
          f"(weights included) {r['peak_allocated']} bytes")
    print(f"{label} f32 identity at depth {r['identity_depth']}: "
          f"{r['identity_tokens']} context tokens equal the cache-free "
          f"reference, unchunked and in {r['identity_chunks']} + 1 "
          f"prefill slices")
    if r["profile"]:
        print_profile(*r["profile"], label=f"{label}: ")


# ---------------------------------------------------------------------------
# phase 14: granite-moe-3b-a800m, minicpm-2b, nemotron-4-15b
# ---------------------------------------------------------------------------


def registration_run(cfg, device="cuda", rounds=REG_ROUNDS,
                     n_agents=REG_AGENTS, max_seq=REG_MAX_SEQ,
                     params=None) -> dict:
    """One registered model served offline on 1 PE + 1 DE (dualpath,
    64-token FullBlocks, 8 DE slots): every round finishes, the launches
    equal those predicted (gather, scatter, flash and paged, and for an
    MoE model the grouped GEMM), the blocking arm gives the same
    tokens.  On seed 0's weights, freed with the caches before it
    returns, or on ``params``, which it leaves to the caller."""
    from repro_torch import kernels
    from repro_torch.models import init_params
    from repro_torch.sim.traces import Round, Trajectory
    cuda = device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    own = params is None
    if own:
        params = init_params(cfg, seed=0, device=device)
    trajs = lambda: [Trajectory(i, [Round(*r) for r in rounds])
                     for i in range(n_agents)]
    kw = dict(n_pe=1, n_de=1, mode="dualpath", block_tokens=64,
              max_seq=max_seq, de_slots=8)
    kernels.reset_launch_counts()
    with PathCounter() as path:
        system, sessions, wall = serve(cfg, params, trajs(), device, **kw)
    launches = kernels.launch_counts()
    # the run's own peak, weights included when they were made here
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    st = system.stats()
    assert all(s.rounds_done == len(rounds) for s in sessions), \
        f"a {cfg.name} round did not finish"
    assert st["store_reads"] > 0, "no FullBlock was read back"
    predicted = predicted_launches(cfg, path.items, path.installs,
                                   path.persists, st["decode_steps"])
    if cuda:
        assert launches == predicted, \
            f"{cfg.name} launches {launches}, predicted {predicted}"
    del system
    system, sessions_b, wall_b = serve(cfg, params, trajs(), device,
                                       pipelined=False, **kw)
    assert [s.context for s in sessions] == \
        [s.context for s in sessions_b], f"{cfg.name} blocking arm diverged"
    del system, sessions, sessions_b
    if own:
        del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(stats=st, launches=launches, predicted=predicted,
                items=path.items, appends=sorted(path.appends),
                installs=path.installs, persists=path.persists,
                wall_s=wall, tokens_per_s=st["gen_tokens"] / wall,
                blocking_wall_s=wall_b, peak_allocated=peak,
                phase_s=time.perf_counter() - t0)


def registrations_phase(device="cuda", archs=REG_ARCHS, reduce=False,
                        **kw) -> dict:
    """:func:`registration_run` for each of ``archs`` at full width and
    depth (``reduce``: their reduced configs, for a CPU rehearsal), one
    after another."""
    from repro_torch.configs import get_config
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        out[arch] = registration_run(cfg.reduced() if reduce else cfg,
                                     device, **kw)
    return out



# ---------------------------------------------------------------------------
# phases 16-18: llama4-maverick-400b-a17b (MoE of period 2), llava-next-34b
# (the VLM connector), hubert-xlarge (the encoder)
# ---------------------------------------------------------------------------


def llama4_phase(cfg, device="cuda", depth=LLAMA4_DEPTH,
                 identity=LLAMA4_IDENTITY, **kw) -> dict:
    """llama4 at ``depth`` layers (one dense, then one MoE of 128 experts,
    top-1, at 2) through :func:`moe_phase` with ds27b's rounds, agents
    and cache: launches equal to the prediction (flash 2 per item, paged
    2 per decode step, the grouped GEMM 3 per item and per decode step,
    the gather 2 per install, the scatter 1 per persist), both grouped-GEMM
    regimes, equal blocking tokens, one host read a model step, a profile,
    then f32 identity at ``identity``'s depth with its experts cut."""
    cfg = dataclasses.replace(cfg, n_layers=depth)
    assert cfg.moe_layer_mask() == (False, True) * (depth // 2), \
        cfg.moe_layer_mask()
    return moe_phase(cfg, device, identity=identity, **kw)


def vlm_path(cfg, params, device="cuda", patches=LLAVA_PATCHES,
             text=LLAVA_TEXT, steps=LLAVA_STEPS,
             max_seq=LLAVA_VLM_MAX_SEQ) -> dict:
    """The VLM path on a fresh one-slot decode state: ``append_step`` with
    ``patches`` patch embeddings of width ``frontend_embed_dim`` from a
    seed, a ``text``-token append by token ids, then ``steps`` greedy
    ``decode_step``s from the text's last logits.  Every logit is
    finite; on the card flash launches once per layer of each append and
    paged once per layer of each step, nothing else."""
    from repro_torch import kernels
    from repro_torch.models import append_step, decode_step, \
        init_decode_state
    cuda = device != "cpu"
    gen = torch.Generator(device=device).manual_seed(17)
    emb = torch.randn((1, patches, cfg.frontend_embed_dim), generator=gen,
                      device=device).to(getattr(torch, cfg.param_dtype))
    toks = torch.randint(2, cfg.vocab_size, (1, text), generator=gen,
                         device=device)
    assert patches + text + steps <= max_seq, (patches, text, steps)
    state = init_decode_state(cfg, 1, max_seq, device)
    at = lambda n: torch.tensor([n], device=device)
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lg_img, state = append_step(params, cfg, emb, state, at(0))
    finite = torch.isfinite(lg_img).all()
    lg, state = append_step(params, cfg, toks, state, at(patches))
    finite &= torch.isfinite(lg).all()
    cur = lg[0, -1].argmax()
    gen_toks = [cur]
    for i in range(steps):
        lg, state = decode_step(params, cfg, cur[None], state,
                                at(patches + text + i))
        finite &= torch.isfinite(lg).all()
        cur = lg[0].argmax()
        gen_toks.append(cur)
    ok = bool(finite)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    assert ok, "a VLM logit is not finite"
    assert lg_img.shape == (1, patches, cfg.vocab_size), lg_img.shape
    if cuda:
        want = dict.fromkeys(launches, 0)
        want.update(flash_attention=2 * cfg.n_layers,
                    paged_attention=steps * cfg.n_layers)
        assert launches == want, f"VLM path launches {launches}, want {want}"
    return dict(wall_s=wall, launches=launches, max_seq=max_seq,
                tokens=[int(t) for t in gen_toks])


def vlm_identity(cfg, device="cuda", depth=4, chunk=1024,
                 patches=LLAVA_PATCHES) -> dict:
    """f32 at ``depth`` layers: the patch embeddings appended in
    ``chunk``-row slices to a fresh state give the unchunked
    ``forward``'s logits over the same embeddings (within TOLS[f32] of
    the largest, the last row's greedy token equal)."""
    from repro_torch.models import append_step, forward, init_decode_state, \
        init_params
    cfg32 = dataclasses.replace(cfg, n_layers=depth, param_dtype="float32",
                                kv_cache_dtype="float32")
    params = init_params(cfg32, seed=1, device=device)
    gen = torch.Generator(device=device).manual_seed(18)
    emb = torch.randn((1, patches, cfg.frontend_embed_dim), generator=gen,
                      device=device)
    want, _ = forward(params, cfg32, emb)
    state = init_decode_state(cfg32, 1, -(-patches // 64) * 64, device)
    got = []
    for s0 in range(0, patches, chunk):
        lg, state = append_step(params, cfg32, emb[:, s0:s0 + chunk], state,
                                torch.tensor([s0], device=device))
        got.append(lg)
    got = torch.cat(got, dim=1)
    err = float((got - want).abs().max())
    tol = TOLS[torch.float32] * max(1.0, float(want.abs().max()))
    assert err <= tol, f"VLM f32 slices off the forward by {err} > {tol}"
    assert int(got[0, -1].argmax()) == int(want[0, -1].argmax())
    del params, state
    return dict(depth=depth, slices=-(-patches // chunk), max_abs_err=err,
                tol=tol)


def llava_phase(cfg, device="cuda", depth=LLAVA_DEPTH,
                identity=LLAVA_IDENTITY, rounds=REG_ROUNDS,
                n_agents=REG_AGENTS, max_seq=REG_MAX_SEQ,
                profile=True) -> dict:
    """llava at ``depth`` layers: (a) served offline by token ids
    (:func:`registration_run`, its checks, at the registrations' rounds)
    and profiled; (b) the VLM path (:func:`vlm_path`) on the same
    weights; (c) f32 identity at ``identity["depth"]``
    (:func:`vlm_identity`).  The peak ``memory_allocated`` spans (a) and
    (b), weights included."""
    from repro_torch.models import init_params
    cuda = device != "cpu"
    cfg = dataclasses.replace(cfg, n_layers=depth)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    if cuda:
        torch.cuda.synchronize()
        weights = torch.cuda.memory_allocated() - base
    init_s = time.perf_counter() - t0
    out = registration_run(cfg, device, rounds, n_agents, max_seq,
                           params=params)
    if cuda:
        # (a)'s peak above its start, which held the weights
        peak = out["peak_allocated"] + weights
        torch.cuda.reset_peak_memory_stats()
    out["profile"] = profile_phase(cfg, rounds, n_agents, max_seq=max_seq,
                                   params=params) \
        if profile and cuda else None
    out["vlm"] = vlm_path(cfg, params, device)
    if cuda:
        out.update(weights_allocated=weights, peak_allocated=max(
            peak, torch.cuda.max_memory_allocated() - base))
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["identity"] = vlm_identity(cfg, device, **identity)
    out.update(depth=depth, init_s=init_s)
    return out


class FlashCausality(MethodPatch):
    """Counts the model's flash calls by ``causal`` (at the name
    ``models.layers`` calls; host-side)."""

    def __init__(self):
        from repro_torch.models import layers
        self.n = {True: 0, False: 0}

        def wrap(fn):
            def counted(*args, causal=True, **kw):
                self.n[bool(causal)] += 1
                return fn(*args, causal=causal, **kw)
            return counted

        super().__init__(layers, "flash_attention", wrap)


def hubert_phase(cfg, device="cuda", clips=HUBERT_CLIPS,
                 frames=HUBERT_FRAMES, identity=HUBERT_IDENTITY,
                 profile=True) -> dict:
    """hubert at published width and depth: a bf16 ``forward`` over
    ``clips`` x ``frames`` frame embeddings from a seed gives finite
    logits, launching flash once per layer, bidirectional, and nothing
    else; timed over 3 forwards (and once under torch.profiler).  Then
    f32 at ``identity["depth"]`` layers: the card's ``forward`` on one
    clip equals the port's CPU forward (the kernels' plain versions)
    within ``TOLS[f32]`` of the largest logit, and moving the last
    frame moves the first frame's logits."""
    from repro_torch import kernels
    from repro_torch.models import forward, init_params
    cuda = device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(19)
    x = torch.randn((clips, frames, cfg.frontend_embed_dim), generator=gen,
                    device=device).to(getattr(torch, cfg.param_dtype))
    kernels.reset_launch_counts()
    with FlashCausality() as causality:
        logits, state = forward(params, cfg, x)
    launches = kernels.launch_counts()
    assert state is None and logits.shape == (clips, frames,
                                              cfg.vocab_size), logits.shape
    assert bool(torch.isfinite(logits).all()), "a hubert logit is not finite"
    if cuda:
        want = dict.fromkeys(launches, 0)
        want["flash_attention"] = cfg.n_layers
        assert launches == want, f"hubert launches {launches}, want {want}"
        assert causality.n == {True: 0, False: cfg.n_layers}, causality.n
    del logits

    def timed():
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(params, cfg, x)
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = [timed() for _ in range(3)]
    prof = profiled(timed) if profile and cuda else None
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    del params, x
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=identity["depth"],
                                param_dtype="float32",
                                kv_cache_dtype="float32")
    p32 = init_params(cfg32, seed=1, device=device)
    clip = torch.randn((1, frames, cfg.frontend_embed_dim), generator=gen,
                       device=device)
    card, _ = forward(p32, cfg32, clip)
    host = forward(_to_cpu(p32), cfg32, clip.cpu())[0]
    err = float((card.cpu() - host).abs().max())
    tol = TOLS[torch.float32] * max(1.0, float(host.abs().max()))
    assert err <= tol, f"hubert f32 card vs CPU off by {err} > {tol}"
    moved = clip.clone()
    moved[:, -1] += 1.0
    first = float((forward(p32, cfg32, moved)[0][:, 0] - card[:, 0])
                  .abs().max())
    assert first > 0, "moving the last frame left the first frame's logits"
    del p32
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(launches=launches, causality=causality.n, walls_s=walls,
                clips=clips, frames=frames,
                frames_per_s=clips * frames / float(np.median(walls)),
                profile=prof, peak_allocated=peak,
                identity=dict(depth=identity["depth"], max_abs_err=err,
                              tol=tol, first_frame_moved_by=first))


# ---------------------------------------------------------------------------
# phases 19 and 20: training and checkpoints (qwen1.5-0.5b, then the MoE
# granite-moe-3b-a800m)
# ---------------------------------------------------------------------------


class RouteRecorder(MethodPatch):
    """Every ``models.moe.route`` call's expert indices, on the host, in
    call order, while entered (one per MoE layer of a forward, again for
    remat's recompute)."""

    def __init__(self):
        from repro_torch.models import moe
        self.idx = []

        def wrap(fn):
            def recorded(*args, **kw):
                vals, idx = fn(*args, **kw)
                self.idx.append(idx.cpu())
                return vals, idx
            return recorded

        super().__init__(moe, "route", wrap)


def same_routes(card: list, host: list) -> int:
    """Raise unless both devices routed every token of every MoE layer
    call to the same experts, naming the first call and token that
    differ; returns the number of routed (token, slot)s compared."""
    assert len(card) == len(host), (len(card), len(host))
    for call, (a, b) in enumerate(zip(card, host)):
        if not torch.equal(a, b):
            t = int((a != b).any(dim=-1).nonzero()[0])
            raise AssertionError(
                f"MoE route call {call} (layers in order, remat's recompute "
                f"after the forward) sends token {t} to experts "
                f"{a[t].tolist()} on the card, {b[t].tolist()} on the CPU")
    return sum(a.numel() for a in card)


def cut(cfg, depth: int, n_experts=None, vocab=None, **kw):
    """``cfg`` at ``depth`` layers and, with ``n_experts``, that many routed
    experts, with ``vocab`` that many tokens (``kw`` replaces other
    fields)."""
    if n_experts:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=n_experts)
    if vocab:
        kw["vocab_size"] = vocab
    return dataclasses.replace(cfg, n_layers=depth, **kw)


def train_identity(cfg, device="cuda", depth=2, batch=2, seq=129, micro=2,
                   steps=3, lr=TRAIN_LR, n_experts=None, vocab=None) -> dict:
    """(a) f32 at ``depth`` layers (``n_experts`` routed experts and a
    ``vocab``-token vocabulary, if given) from one ``init_params`` seed:
    for an
    MoE model, the first batch's every MoE layer routes every token to the
    same experts on ``device`` as on the CPU (so that a failure below says
    whether routing or arithmetic differs); the first batch's gradients
    on ``device`` equal the port's CPU path's (the kernels' plain
    versions) within 1e-4 of each leaf's largest |g|, and ``steps`` AdamW
    steps give losses within 1e-4 relative.  Each step is
    ``make_train_step``'s composition, ``loss_and_grads`` then the
    optimizer's update, taken apart to keep the first gradients."""
    import contextlib
    from repro_torch.models import init_params
    from repro_torch.training import (SyntheticLM, loss_and_grads,
                                      make_optimizer)
    from repro_torch.training.tree import leaves, leaves_with_paths, tree_map
    cfg32 = cut(cfg, depth, n_experts, vocab, param_dtype="float32")
    card = init_params(cfg32, seed=3, device=device)
    host = tree_map(lambda t: t.to("cpu", copy=True), card)
    pipe = SyntheticLM(cfg32.vocab_size, batch, seq, seed=4)
    batches = [pipe.next_batch() for _ in range(steps)]
    losses, first, routes = {}, {}, {}
    for name, params in (("card", card), ("host", host)):
        opt_init, opt_update = make_optimizer(cfg32.optimizer,
                                              cfg32.opt_state_dtype)
        opt = opt_init(params)
        losses[name] = []
        for bt in batches:
            record = RouteRecorder() if cfg.family == "moe" and \
                name not in first else contextlib.nullcontext()
            with record:
                loss, grads = loss_and_grads(params, cfg32, bt,
                                             n_microbatches=micro)
            if isinstance(record, RouteRecorder):
                routes[name] = record.idx
            first.setdefault(name, grads)
            params, opt = opt_update(params, grads, opt, lr=lr)
            losses[name].append(float(loss))
        del params, opt, grads
    routed = same_routes(routes["card"], routes["host"]) if routes else 0
    worst = 0.0
    for (path, gc_), gh in zip(leaves_with_paths(first["card"]),
                               leaves(first["host"])):
        err = float((gc_.cpu() - gh).abs().max())
        scale = float(gh.abs().max())
        assert err <= 1e-4 * scale, \
            f"f32 gradient of {'/'.join(path)} off by {err} > 1e-4 x {scale}"
        worst = max(worst, err / scale if scale else 0.0)
    del first, card, host
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                  losses["host"]))
    assert rel <= 1e-4, f"f32 losses {losses['card']} against the CPU's " \
        f"{losses['host']}"
    return dict(losses=losses, loss_rel_err=rel, grad_rel_err=worst,
                routed_compared=routed)


def predicted_train_launches(cfg, steps: int, micro: int, remat) -> dict:
    """A model's training launches: per attention block (every layer of
    a GQA or MLA model, each of the hybrid's shared-block applications)
    and microbatch, flash forward once, and once more when full remat
    recomputes the block in the backward, and flash's backward once; per
    MoE layer and microbatch, the grouped GEMM three times (gate, up,
    down) and three more under remat, and its backward three times (one
    call each for the three products' dX and dW); per Mamba2 layer and
    microbatch, the conv and the SSD scan once each, again under remat,
    and each one's backward once; nothing else (the decode step never)."""
    runs = (2 if remat else 1) * micro * steps
    n_moe = sum(cfg.moe_layer_mask()) if cfg.family == "moe" else 0
    n_mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // (cfg.hybrid_period or 1)
              }.get(cfg.family, cfg.n_layers)
    out = {k: 0 for k in KERNEL_SOURCES}
    out.update(flash_attention=runs * n_attn,
               flash_attention_bwd=n_attn * micro * steps,
               grouped_gemm=3 * runs * n_moe,
               grouped_gemm_bwd=3 * n_moe * micro * steps,
               ssd_chunk_scan=runs * n_mamba, causal_conv=runs * n_mamba,
               ssd_chunk_scan_bwd=n_mamba * micro * steps,
               causal_conv_bwd=n_mamba * micro * steps)
    return out


def train_resume(cfg, device="cuda", depth=2, batch=4, seq=129, micro=2,
                 every=2, crash=3, steps=5, lr=TRAIN_LR,
                 n_experts=None, vocab=None) -> dict:
    """(c) ``FaultTolerantRunner`` at ``depth`` layers in bf16
    (``n_experts`` routed experts and a ``vocab``-token vocabulary, if
    given): a run that
    crashes after step ``crash``, resumed from its last checkpoint and run
    to ``steps``, gives the losses of the steps after the checkpoint and
    the final parameters of an uninterrupted run bit for bit, all three
    runs under ``torch.use_deterministic_algorithms``.  The
    checkpoints go to a temporary directory, removed afterwards; each
    save and the restore are timed."""
    import shutil
    import tempfile
    from repro_torch.ckpt import FaultTolerantRunner, checkpoint
    from repro_torch.models import init_params
    from repro_torch.training import SyntheticLM, make_train_step
    from repro_torch.training.tree import leaves
    cfg_d = cut(cfg, depth, n_experts, vocab)
    opt_init, train_step = make_train_step(cfg_d, lr=lr, n_microbatches=micro)
    saves = []

    def timed_save(fn):
        def save(*args, **kw):
            t0 = time.perf_counter()
            name = fn(*args, **kw)
            saves.append((time.perf_counter() - t0, os.path.getsize(name)))
            return name
        return save

    def runner(path, ckpt_every):
        params = init_params(cfg_d, seed=2, device=device)
        return FaultTolerantRunner(
            path, train_step, params, opt_init(params),
            SyntheticLM(cfg_d.vocab_size, batch, seq, seed=3),
            ckpt_every=ckpt_every)

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    # an op on this path without a deterministic form raises and names
    # itself, rather than breaking the bitwise equality now and then
    torch.use_deterministic_algorithms(True)
    try:
        with MethodPatch(checkpoint, "save_checkpoint", timed_save):
            crashed = runner(os.path.join(root, "a"), every)
            try:
                crashed.run(steps, crash_at=crash)
                raise AssertionError("the injected crash did not happen")
            except RuntimeError as e:
                assert "injected crash" in str(e), e
            del crashed
            resumed = runner(os.path.join(root, "a"), every)
            t0 = time.perf_counter()
            assert resumed.try_resume()
            restore_s = time.perf_counter() - t0
            at = resumed.step
            assert at == crash // every * every, at
            resumed.run(steps)
            whole = runner(os.path.join(root, "b"), 10 * steps)
            ref_losses = whole.run(steps)
        assert resumed.losses == ref_losses[at:], (resumed.losses,
                                                   ref_losses)
        for a, b in zip(leaves(resumed.params), leaves(whole.params)):
            assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                               b.view(torch.uint8) if b.dim() else b), \
                "resumed parameters differ from the uninterrupted run's"
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        shutil.rmtree(root, ignore_errors=True)
    return dict(resumed_at=at, losses=ref_losses, saves=saves,
                restore_s=restore_s)


class GradFinite(MethodPatch):
    """While entered, every ``loss_and_grads`` of a train step keeps each
    gradient's L2 norm on the device (``torch._foreach_norm``: a few
    launches for the whole tree, no host read in the step).  A norm is
    non-finite when its leaf holds a NaN or an inf (or when its sum of
    squares passes f32's range, |g| ~ 1e19, a failure too).
    :meth:`check`, after the timed steps, reads them once and names the
    leaves of the first step with a non-finite gradient; ``steps``
    counts the steps checked."""

    def __init__(self):
        from repro_torch.training import train
        from repro_torch.training.tree import leaves_with_paths
        self.paths, self.norms = None, []

        def wrap(fn):
            def checked(*args, **kw):
                loss, grads = fn(*args, **kw)
                paths, flat = zip(*leaves_with_paths(grads))
                self.paths = [".".join(p) for p in paths]
                self.norms.append(torch.stack(torch._foreach_norm(
                    list(flat))))
                return loss, grads
            return checked

        super().__init__(train, "loss_and_grads", wrap)

    @property
    def steps(self) -> int:
        return len(self.norms)

    def check(self) -> None:
        ok = torch.stack(self.norms).isfinite().cpu()
        for k, row in enumerate(ok):
            if not bool(row.all()):
                bad = [p for p, o in zip(self.paths, row.tolist()) if not o]
                raise AssertionError(f"non-finite gradients in step {k + 1}: "
                                     f"{bad[:8]}")


def train_steps(cfg, device="cuda", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                micro=TRAIN_MICRO, steps=TRAIN_STEPS, lr=TRAIN_LR,
                remat="full", profile=True, falling=True,
                grad_check=False) -> dict:
    """``steps`` bf16 train steps of ``cfg`` at its depth
    (``make_train_step`` -> ``loss_fn`` -> ``forward`` through the
    kernels and their hand-written backwards -> AdamW), ``micro``
    microbatches a step: finite losses, with ``falling`` the last below
    the first, with ``grad_check`` every gradient of every step finite
    (:class:`GradFinite`: kept on the device, read after the timed
    steps), and on the card every launch count equal to
    :func:`predicted_train_launches`; host seconds per step (the median
    of steps 2 on), trained tokens per real second, the peak of
    ``memory_allocated`` over what the process held before, and with
    ``profile`` one more step profiled."""
    from repro_torch import kernels
    from repro_torch.models import init_params
    from repro_torch.training import SyntheticLM, make_train_step
    cuda = device != "cpu"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device=device)
    opt_init, train_step = make_train_step(cfg, lr=lr, n_microbatches=micro,
                                           remat=remat)
    opt = opt_init(params)
    pipe = SyntheticLM(cfg.vocab_size, batch, seq, seed=1)
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def step():
        nonlocal params, opt
        sync()
        t0 = time.perf_counter()
        params, opt, loss = train_step(params, opt, pipe.next_batch())
        loss = float(loss)
        return time.perf_counter() - t0, loss

    checked = GradFinite() if grad_check else contextlib.nullcontext()
    kernels.reset_launch_counts()
    with checked:
        walls, losses = zip(*(step() for _ in range(steps)))
    launches = kernels.launch_counts()
    if grad_check:
        checked.check()
    assert all(np.isfinite(losses)), losses
    assert not falling or losses[-1] < losses[0], losses
    if cuda:
        want = predicted_train_launches(cfg, steps, micro, remat)
        assert launches == want, f"training launches {launches}, want {want}"
    step_s = float(np.median(walls[1:]))
    out = dict(depth=cfg.n_layers, params=cfg.param_count(), batch=batch,
               seq=seq, micro=micro, steps=steps,
               losses=list(losses), walls_s=list(walls), step_s=step_s,
               tokens_per_s=batch * (seq - 1) / step_s, launches=launches,
               grads_checked=checked.steps if grad_check else None,
               peak_allocated=torch.cuda.max_memory_allocated() - base
               if cuda else None, base_allocated=base if cuda else None,
               profile=profiled(lambda: step()[0]) if profile and cuda
               else None)
    del params, opt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def train_phase(cfg, device="cuda", identity=TRAIN_IDENTITY,
                batch=TRAIN_BATCH, seq=TRAIN_SEQ, micro=TRAIN_MICRO,
                steps=TRAIN_STEPS, lr=TRAIN_LR, resume=TRAIN_RESUME,
                remat="full", profile=True, grad_check=False) -> dict:
    """Phases 19-22: training and checkpoints on ``cfg`` at published
    widths, ``micro`` microbatches a step (qwen1.5-0.5b's 2, granite's 4,
    ds27b's 8, mamba2's 4).  (a) :func:`train_identity`; (b) the slice's
    path at ``cfg``'s depth (full, or ds27b's cut) in bf16,
    :func:`train_steps`; (c) :func:`train_resume`."""
    t0 = time.perf_counter()
    out = dict(identity=train_identity(cfg, device, lr=lr, **identity))
    out["identity"]["wall_s"] = time.perf_counter() - t0
    out.update(train_steps(cfg, device, batch, seq, micro, steps, lr, remat,
                           profile, grad_check=grad_check))
    t0 = time.perf_counter()
    out["resume"] = dict(train_resume(cfg, device, lr=lr, **resume),
                         **resume)
    out["resume"]["wall_s"] = time.perf_counter() - t0
    out["identity"].update(identity)
    return out


def print_train_phase(r: dict, label: str = "train") -> None:
    idn, rs = r["identity"], r["resume"]
    def experts(d):
        cuts = ([f"{d['n_experts']} routed experts"] if d.get("n_experts")
                else []) + ([f"{d['vocab']} tokens"] if d.get("vocab")
                            else [])
        return " with " + " and ".join(cuts) if cuts else ""
    print(f"{label} (a) f32 at depth {idn['depth']}{experts(idn)}, card "
          f"against the CPU: "
          + (f"{idn['routed_compared']} routed (token, slot)s of the first "
             f"batch sent to the same experts on both; "
             if idn["routed_compared"] else "")
          + f"losses {idn['losses']['card']} vs "
          f"{idn['losses']['host']} (max rel err {idn['loss_rel_err']:.3g}), "
          f"first-step gradients within {idn['grad_rel_err']:.3g} of each "
          f"leaf's largest |g|; {idn['wall_s']:.1f} s")
    print(f"{label} (b) bf16 at depth {r['depth']} ({r['params']} "
          f"parameters), {r['batch']} x {r['seq']} tokens "
          f"in {r['micro']} microbatches: losses {r['losses']}; host s per "
          f"step {[round(w, 4) for w in r['walls_s']]}, median of steps 2-"
          f"{r['steps']} {r['step_s']:.4f} s, {r['tokens_per_s']:.1f} "
          f"trained tokens per real second; launches {r['launches']}; "
          + ("" if not r.get("grads_checked") else
             f"every gradient of {r['grads_checked']} steps finite; ")
          + f"peak "
          f"memory_allocated {r['peak_allocated']} bytes over the "
          f"{r['base_allocated']} held before the phase's weights")
    if r["profile"]:
        print_profile(*r["profile"], label=f"{label} (b) one step: ")
    print(f"{label} (c) bf16 at depth {rs['depth']}{experts(rs)}: crash "
          f"after step {rs['crash']}, resumed at "
          f"step {rs['resumed_at']}, run to {rs['steps']}: losses "
          f"and final parameters equal the uninterrupted run's bit for bit "
          f"({rs['losses']}); saves (s, bytes) "
          f"{[(round(t, 3), n) for t, n in rs['saves']]}, restore "
          f"{rs['restore_s']:.3f} s; {rs['wall_s']:.1f} s")


def train_mla_phase(device="cuda", depth=TRAIN_MLA_DEPTH) -> dict:
    """Phase 21: ds27b, MoE over MLA, through :func:`train_phase`: (b) at
    published widths cut to ``depth`` layers (flash at q/k 192, v 128
    with its lse, ``flash_attention_bwd`` at the same widths, the grouped
    GEMM and its backward), (a) and (c) at depth 2 with the routed
    experts and the vocabulary cut (``TRAIN_MLA_IDENTITY``,
    ``TRAIN_MLA_RESUME``)."""
    from repro_torch.configs import get_config
    cfg = get_config("ds27b")
    return train_phase(cut(cfg, depth), device, identity=TRAIN_MLA_IDENTITY,
                       batch=TRAIN_MLA_BATCH, micro=cfg.microbatches_train_4k,
                       steps=TRAIN_MLA_STEPS, lr=TRAIN_MLA_LR,
                       resume=TRAIN_MLA_RESUME)


def train_ssm_phase(device="cuda", profile=True, reduce=False) -> dict:
    """Phase 22: SSM and hybrid training at published widths.  (a)
    :func:`train_identity` on mamba2-1.3b at depth 2 and zamba2-2.7b at
    depth 6 (``TRAIN_SSM_IDENTITY``; the SSD scan's chunk of 256 and a
    43-row chunk, whose plain gradient is finite only because its mask
    exponentiates the kept entries alone); (b) mamba2-1.3b at full depth
    through the SSD scan, the conv and their hand-written backwards, every
    gradient finite (:class:`GradFinite`); (c) its crash and resume at
    depth 2 (``TRAIN_RESUME``); (d) zamba2 at
    depth 6 in bf16 (:func:`train_steps`), its
    shared block through flash at (80, 80) and flash's backward, launches
    as predicted.  ``reduce`` takes both models' reduced configs and
    65-token rows in (b) and (d): a rehearsal on the CPU."""
    from repro_torch.configs import get_config
    m2, z2 = get_config("mamba2-1.3b"), get_config("zamba2-2.7b")
    if reduce:
        m2, z2 = m2.reduced(), z2.reduced()
    seq = 65 if reduce else TRAIN_SEQ
    out = {}
    for key, cfg, depth in (("identity", m2, TRAIN_SSM_IDENTITY["depth"]),
                            ("identity_hybrid", z2, TRAIN_HYBRID_DEPTH)):
        t0 = time.perf_counter()
        kw = dict(TRAIN_SSM_IDENTITY, depth=depth)
        out[key] = dict(train_identity(cfg, device, **kw), **kw)
        out[key]["wall_s"] = time.perf_counter() - t0
    out.update(train_steps(m2, device, TRAIN_SSM_BATCH, seq,
                           m2.microbatches_train_4k, TRAIN_SSM_STEPS,
                           profile=profile, grad_check=True))
    t0 = time.perf_counter()
    out["resume"] = dict(train_resume(m2, device, **TRAIN_RESUME),
                         **TRAIN_RESUME)
    out["resume"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["hybrid"] = train_steps(
        cut(z2, TRAIN_HYBRID_DEPTH), device, TRAIN_SSM_BATCH, seq,
        z2.microbatches_train_4k, TRAIN_HYBRID_STEPS, profile=False,
        falling=False, grad_check=True)
    out["hybrid"]["wall_s"] = time.perf_counter() - t0
    return out


def print_train_ssm_phase(r: dict) -> None:
    print_train_phase(r, "ssm train")
    z = r["identity_hybrid"]
    print(f"ssm train (a) zamba2 f32 at depth {z['depth']}, card against "
          f"the CPU: losses {z['losses']['card']} vs {z['losses']['host']} "
          f"(max rel err {z['loss_rel_err']:.3g}), first-step gradients "
          f"within {z['grad_rel_err']:.3g} of each leaf's largest |g|; "
          f"{z['wall_s']:.1f} s")
    h = r["hybrid"]
    print(f"ssm train (d) zamba2 bf16 at depth {h['depth']} ({h['params']} "
          f"parameters), {h['batch']} x {h['seq']} tokens in {h['micro']} "
          f"microbatches: losses {h['losses']}; every gradient of "
          f"{h['grads_checked']} steps finite; host s per step "
          f"{[round(w, 4) for w in h['walls_s']]}, "
          f"{h['tokens_per_s']:.1f} trained tokens per real second; "
          f"launches {h['launches']}; peak memory_allocated "
          f"{h['peak_allocated']} bytes; {h['wall_s']:.1f} s")


def print_moe_phase(r: dict, label: str) -> None:
    """:func:`moe_phase`'s result (phases 11 and 16)."""
    st = r["stats"]
    print(f"{label} stats:", json.dumps(st))
    print(f"{label}: weights drawn in {r['init_s']:.3f} s; "
          f"{r['wall_s']:.3f} s real wall (pipelined), "
          f"{r['blocking_wall_s']:.3f} s (blocking), "
          f"{r['tokens_per_s']:.1f} generated tokens/s, launches "
          f"{r['launches']} (predicted {r['predicted']} from "
          f"{r['items']} batch items (rows, kv_len) {r['appends']}, "
          f"{r['installs']} installs, {r['persists']} persists, "
          f"{st['decode_steps']} decode steps); grouped GEMM by regime "
          f"{r['regimes']}; FullBlock rows {r['row_bytes']} bytes; "
          f"contexts {r['context_lens']}; peak memory_allocated of the "
          f"run (weights included) {r['peak_allocated']} bytes; host "
          f"syncs of one 8-slot decode_step and one 256-token append_step "
          f"{r['step_syncs']}")
    experts = "" if not r["identity_experts"] else \
        f" with {r['identity_experts']} routed experts"
    print(f"{label} f32 identity at depth {r['identity_depth']}{experts}: "
          f"{r['identity_tokens']} context tokens equal the cache-free "
          f"reference, unchunked and in {r['identity_chunks']} + 1 "
          f"prefill slices")
    if r["profile"]:
        print_profile(*r["profile"], label=f"{label}: ")


def print_llava_phase(r: dict) -> None:
    st, v, idt = r["stats"], r["vlm"], r["identity"]
    print(f"llava (depth {r['depth']}): weights drawn in {r['init_s']:.3f} "
          f"s, {r.get('weights_allocated')} bytes; {r['wall_s']:.3f} s real "
          f"wall (pipelined), {r['blocking_wall_s']:.3f} s (blocking), "
          f"{r['tokens_per_s']:.1f} generated tokens/s, launches "
          f"{r['launches']} (predicted from {r['items']} batch items "
          f"{r['appends']}, {r['installs']} installs, {r['persists']} "
          f"persists, {st['decode_steps']} decode steps); peak "
          f"memory_allocated (weights included) {r['peak_allocated']} "
          f"bytes; stats " + json.dumps(st))
    if r["profile"]:
        print_profile(*r["profile"], label="llava: ")
    print(f"llava VLM path: {LLAVA_PATCHES} patch embeddings, "
          f"{LLAVA_TEXT} text tokens, {LLAVA_STEPS} decode steps on a "
          f"{v['max_seq']}-token state: {v['wall_s']:.3f} s real wall, "
          f"launches {v['launches']}, tokens {v['tokens']}")
    print(f"llava f32 identity at depth {idt['depth']}: the patch append "
          f"in {idt['slices']} slices equals the unchunked forward, max "
          f"|err| {idt['max_abs_err']:.3g} (tolerance {idt['tol']:.3g})")


def print_hubert_phase(r: dict) -> None:
    idt = r["identity"]
    walls = ", ".join(f"{w:.4f}" for w in r["walls_s"])
    print(f"hubert: forward over {r['clips']} x {r['frames']} frames "
          f"in {walls} s real wall ({r['frames_per_s']:.0f} frames/s), "
          f"launches {r['launches']}, flash calls by causal "
          f"{r['causality']}; peak memory_allocated (weights included) "
          f"{r['peak_allocated']} bytes")
    if r["profile"]:
        print_profile(*r["profile"], label="hubert: ")
    print(f"hubert f32 at depth {idt['depth']}: card vs CPU max |err| "
          f"{idt['max_abs_err']:.3g} (tolerance {idt['tol']:.3g}); moving "
          f"the last frame moved the first frame's logits by "
          f"{idt['first_frame_moved_by']:.3g}")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return [_to_cpu(v) for v in tree]


# ---------------------------------------------------------------------------
# the event simulator: modelled cluster time, run on the host
# ---------------------------------------------------------------------------


def json_safe(x):
    """``x`` with every NaN float replaced by None (strict JSON)."""
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    if isinstance(x, float) and x != x:
        return None
    return x


def sim_same(got: dict, want: dict) -> list:
    """Keys of two ``results()`` dicts that differ, NaN equal to NaN."""
    return [k for k in sorted(set(got) | set(want))
            if not same_value(got.get(k), want.get(k))]


def _sim_io_mode(mode: str, n_agents: int, max_len: int) -> dict:
    """One mode of (a), in a process of its own: real host seconds, the
    events, ``results()`` and the kernel launches the run made."""
    from repro_torch import kernels
    from repro_torch.sim import (DS_660B, HOPPER_NODE, Sim, SimConfig,
                                 generate_dataset)
    kernels.reset_launch_counts()
    trajs = generate_dataset(n_agents, max_len, seed=0)
    cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=2, D=4, mode=mode)
    t0 = time.perf_counter()
    sim = Sim(cfg, trajs).run()
    host = time.perf_counter() - t0
    return dict(host_s=host, events=sim.loop.n_events, results=sim.results(),
                launches=kernels.launch_counts())


def sim_io_start(n_agents=SIM_IO_AGENTS, max_len=SIM_IO_MAX_LEN):
    """Start (a)'s three modes side by side, one spawned process each on
    the host's cores; :func:`sim_io_bound` collects them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ex = ProcessPoolExecutor(len(SIM_IO_MODES),
                             mp_context=multiprocessing.get_context("spawn"))
    return n_agents, ex, [ex.submit(_sim_io_mode, m, n_agents, max_len)
                          for m in SIM_IO_MODES]


def sim_io_bound(started=None) -> dict:
    """(a) DS 660B on the paper's Hopper nodes at 2P4D, the Table 2 64K
    trajectories, in the basic, dualpath and oracle modes (fig. 7's DS
    660B 2P4D shape), as :func:`sim_io_start` started them (now, if
    ``started`` is None): every agent finishes, dualpath's ``jct_max``
    under 0.95 x basic's, oracle's within 1.02 x dualpath's, and
    dualpath's mean TPOT within 15 % of basic's, and no mode launched a
    kernel.  JCT and TPOT are modelled seconds; ``host_s`` is real host
    time, each mode's in its own process."""
    n_agents, ex, runs = started or sim_io_start()
    with ex:
        out = {m: run.result() for m, run in zip(SIM_IO_MODES, runs)}
    for m, o in out.items():
        assert o["results"]["finished_agents"] == n_agents, (m, o["results"])
        launches = o.pop("launches")
        assert not any(launches.values()), (m, launches)
    rb, rd, ro = (out[m]["results"] for m in SIM_IO_MODES)
    assert rd["jct_max"] < rb["jct_max"] * 0.95, (rb["jct_max"],
                                                 rd["jct_max"])
    assert ro["jct_max"] <= rd["jct_max"] * 1.02, (rd["jct_max"],
                                                  ro["jct_max"])
    assert abs(rd["tpot_mean"] - rb["tpot_mean"]) / rb["tpot_mean"] < 0.15, \
        (rb["tpot_mean"], rd["tpot_mean"])
    return out


def sim_microbench(settle_device="cuda") -> dict:
    """(b) benchmarks/microbench_sim.py's workload: 10 nodes (2 P, 8 D),
    60 agents of at most 8192 tokens arriving over 4 s, split reads, the
    compute network saturated at 0.8 background load, a 12 s horizon.
    ``Sim``, ``VectorSim`` with the numpy settle and ``VectorSim`` with
    the settle on ``settle_device`` must give equal ``results()`` (NaN
    equal to NaN), and the device settle must have run.  Events per host
    second are real measurements of the host."""
    from repro_torch.core.config import NetworkConfig
    from repro_torch.sim import (DS_660B, HOPPER_NODE, Sim, SimConfig,
                                 VectorSim, generate_dataset)
    n = SIM_MICRO["nodes"]
    p = max(1, n // 4)
    cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=p, D=n - p,
                    nodes_per_pe_group=1, nodes_per_de_group=1,
                    split_reads=True,
                    net=NetworkConfig(
                        net_bw=SIM_MICRO["bw_per_node"] * n,
                        net_bg_load=SIM_MICRO["bg_load"],
                        net_bg_chunk_bytes=SIM_MICRO["bg_chunk"]))
    trajs = generate_dataset(SIM_MICRO["agents"], SIM_MICRO["max_len"],
                             seed=0)
    step = SIM_MICRO["window_s"] / max(len(trajs) - 1, 1)
    arrivals = [i * step for i in range(len(trajs))]
    out, results = {}, {}
    for name, make in (
            ("Sim", lambda: Sim(cfg, trajs)),
            ("VectorSim", lambda: VectorSim(cfg, trajs)),
            ("VectorSim_device", lambda: VectorSim(
                cfg, trajs, settle_device=settle_device))):
        t0 = time.perf_counter()
        sim = make().run(arrivals=list(arrivals),
                         until=SIM_MICRO["horizon_s"])
        host = time.perf_counter() - t0
        results[name] = sim.results()
        out[name] = dict(host_s=host, events=sim.loop.n_events)
        if name == "VectorSim_device":
            out[name]["device_settles"] = sim._settle_kernel.calls
            assert sim._settle_kernel.calls > 0, "the device settle never ran"
    for name in ("VectorSim", "VectorSim_device"):
        bad = sim_same(results[name], results["Sim"])
        assert not bad, f"{name} results differ from Sim's at {bad}"
    n_ev = out["Sim"]["events"]
    for name, o in out.items():
        # event-equivalent: the per-object engine's event count over each
        # engine's host seconds (the pool needs far fewer own events)
        o["events_per_s"] = n_ev / o["host_s"]
        o["own_events_per_s"] = o["events"] / o["host_s"]
    out["results"] = results["Sim"]
    return out


def sim_traced(n_agents=SIM_TRACED_AGENTS) -> dict:
    """(c) a traced dualpath run (1P2D, the Table 2 32K trajectories):
    ``audit_sim`` holds every storage-NIC span against the NICs' byte
    counters, and every round's charged bytes equal its loading plan's
    to the byte."""
    from repro_torch.core.loading import resource_bytes
    from repro_torch.obs import Tracer, audit_sim
    from repro_torch.sim import (DS_660B, HOPPER_NODE, Sim, SimConfig,
                                 generate_dataset)
    trajs = generate_dataset(n_agents, 32768, seed=0)
    cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=1, D=2,
                    mode="dualpath")
    tracer = Tracer()
    t0 = time.perf_counter()
    sim = Sim(cfg, trajs, tracer=tracer).run()
    host = time.perf_counter() - t0
    r = sim.results()
    assert r["finished_agents"] == n_agents, r
    audit = audit_sim(sim, tracer)
    checked = 0
    for rs in sim.rounds:
        if rs.done_t < 0 or rs.req.read_path is None:
            continue
        legs = [leg for leg in sim._request_legs(rs.req)
                if leg.phase != "decode"]        # persists aggregate
        want = {k: v for k, v in resource_bytes(legs).items() if v}
        got = {k: v for k, v in rs.charged.items() if v}
        assert got == want, (rs.req.rid, got, want)
        checked += 1
    assert checked == r["finished_rounds"], (checked, r["finished_rounds"])
    return dict(host_s=host, events=sim.loop.n_events, audit=audit,
                rounds_checked=checked, results=r)


def sim_phase(settle_device="cuda", io_started=None) -> dict:
    """Phase 12: the event simulator (``repro_torch.sim``), which models
    the paper's cluster in modelled time on the host; only (b)'s opt-in
    settle touches the card.  (a)'s three runs go to processes of their
    own, started by :func:`sim_io_start` (``io_started``: the smoke
    starts them with phase 3, whose numbers are device times).  It
    launches none of the port's kernels: the counts, zeroed before it,
    must read 0 after it."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out = dict(io_bound=sim_io_bound(io_started),
               micro=sim_microbench(settle_device),
               traced=sim_traced())
    out["launches"] = kernels.launch_counts()
    assert not any(out["launches"].values()), out["launches"]
    return out


SIM_KEYS = ("finished_agents", "finished_rounds", "jct_mean", "jct_max",
            "ttft_mean", "ttft_p99", "tpot_mean", "tpot_p99", "sim_time",
            "snic_hit_read_bytes", "collective_stall_s")


def print_sim(sim: dict) -> None:
    io, micro, tr = sim["io_bound"], sim["micro"], sim["traced"]
    rb, rd, ro = (io[m]["results"] for m in ("basic", "dualpath", "oracle"))
    print(f"sim (a) DS 660B 2P4D, {SIM_IO_AGENTS} agents at "
          f"{SIM_IO_MAX_LEN}: real host s basic {io['basic']['host_s']:.2f}"
          f", dualpath {io['dualpath']['host_s']:.2f}, oracle "
          f"{io['oracle']['host_s']:.2f}; modelled jct_max basic "
          f"{rb['jct_max']!r}, dualpath {rd['jct_max']!r}, oracle "
          f"{ro['jct_max']!r}; modelled speed-up basic/dualpath "
          f"{rb['jct_max'] / rd['jct_max']:.4f}; modelled tpot_mean basic "
          f"{rb['tpot_mean']!r}, dualpath {rd['tpot_mean']!r}")
    print("sim (b) microbench workload: " + "; ".join(
        f"{k} {micro[k]['host_s']:.3f} real host s, {micro[k]['events']} "
        f"own events, {micro[k]['events_per_s']:.0f} event-equivalent/s"
        for k in ("Sim", "VectorSim", "VectorSim_device"))
        + f"; device settles {micro['VectorSim_device']['device_settles']};"
        " results equal across the three")
    print(f"sim: kernel launches {json.dumps(sim['launches'])}")
    print(f"sim (c) traced dualpath, {SIM_TRACED_AGENTS} agents: "
          f"{tr['host_s']:.3f} real host s, {tr['events']} events, audit "
          f"{json.dumps(tr['audit'])}, {tr['rounds_checked']} rounds' "
          f"charges equal their plans")
    host = sum(io[m]["host_s"] for m in io) + tr["host_s"] + sum(
        micro[k]["host_s"] for k in ("Sim", "VectorSim", "VectorSim_device"))
    print(json.dumps({"sim": json_safe(dict(
        host_s=host,
        io_bound={m: dict(host_s=io[m]["host_s"], events=io[m]["events"],
                          modelled={k: io[m]["results"][k]
                                    for k in SIM_KEYS}) for m in io},
        micro={k: v for k, v in micro.items() if k != "results"},
        micro_modelled={k: micro["results"][k] for k in SIM_KEYS},
        traced=dict(host_s=tr["host_s"], events=tr["events"],
                    rounds_checked=tr["rounds_checked"],
                    modelled={k: tr["results"][k] for k in SIM_KEYS})))}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    if sys.argv[1:2] == ["--split-sweep"]:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        build.build()
        print("\n".join(split_sweep(get_config("qwen1.5-0.5b"))))
        return 0

    if sys.argv[1:2] == ["--kernels"]:
        names = sys.argv[2].split(",") if len(sys.argv) > 2 else []
        if not names or not set(names) <= set(KERNEL_SOURCES):
            print(f"chip_smoke: --kernels takes names among "
                  f"{sorted(KERNEL_SOURCES)}", file=sys.stderr)
            return 2
        print(f"torch {torch.__version__} cuda {torch.version.cuda}")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sources = sorted({KERNEL_SOURCES[n] for n in names} - {None})
        t0 = time.perf_counter()
        build.build(sources)
        print(f"build: {time.perf_counter() - t0:.1f} s")
        print_build_log(sources)
        print_cases(kernel_cases(names))
        return 0

    if sys.argv[1:2] == ["--sim"]:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        print_sim(sim_phase())
        return 0

    if sys.argv[1:2] == ["--train-mla"]:
        print(f"torch {torch.__version__} cuda {torch.version.cuda}")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build()
        t0 = time.perf_counter()
        print_train_phase(train_mla_phase(), "mla train")
        print(f"phase 21 wall: {time.perf_counter() - t0:.1f} s")
        return 0

    if sys.argv[1:2] == ["--train-ssm"]:
        print(f"torch {torch.__version__} cuda {torch.version.cuda}")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build()
        t0 = time.perf_counter()
        print_train_ssm_phase(train_ssm_phase())
        print(f"phase 22 wall: {time.perf_counter() - t0:.1f} s")
        return 0

    if sys.argv[1:2] == ["--persist-ab"]:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        build.build()
        pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 10
        print(json.dumps(persist_serving_ab(get_config("qwen1.5-0.5b"),
                                            pairs)))
        return 0

    # 1. environment
    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        """The host wall since the previous lap: each phase's share of the
        whole run."""
        now = time.perf_counter()
        print(f"phase {phase} wall: {now - clock[0]:.1f} s")
        clock[0] = now

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    build.build()
    print(f"build of {len(build.SOURCES)} sources: "
          f"{time.perf_counter() - t0:.1f} s")
    print_build_log(build.SOURCES)
    lap("1-2")

    # 3. kernels against their plain versions; phase 12's (a) runs on
    # the host's other cores meanwhile
    sim_io = sim_io_start()
    cases = kernel_cases()
    print_cases(cases)
    cfg, cfg_g2, cfg_ds = (get_config(a) for a in
                           ("qwen1.5-0.5b", "gemma2-2b", "ds27b"))
    alternating = gather_against_indexing(cfg)
    for k, flushes in alternating.items():
        print(f"{k}, {len(flushes['dirty'])} alternating rounds, ms median "
              "[min, max]: " + "; ".join(
                  f"{f} {np.median(v):.4f} [{min(v):.4f}, {max(v):.4f}]"
                  for f, v in flushes.items()))
    persist = persist_ab(cfg)
    for way, (host_ms, d2h_ms) in persist.items():
        print(f"persist of 16 FullBlocks, {way} way: {host_ms:.3f} ms host "
              f"(median), {d2h_ms:.3f} ms D2H device time per persist")
    lap("3")

    # 4. serving at full width, bf16
    st, launches, wall, tps, wall_b, persists = serving_phase(cfg)
    print("serving stats:", json.dumps(st))
    print(f"serving: {wall:.3f} s real wall (pipelined), {wall_b:.3f} s "
          f"(blocking), {tps:.1f} generated tokens/s, launches {launches}, "
          f"{persists} persists")

    print_profile(*profile_phase(cfg))
    lap("4")

    # 5. online serving with DRAM tiers and the think-time prefetcher
    st_o, launches_o, wall_o, tps_o, wall_ob, blocks_o, persists_o = \
        online_phase(cfg)
    print("online stats:", json.dumps(st_o))
    print(f"online: {wall_o:.3f} s real wall (pipelined), {wall_ob:.3f} s "
          f"(blocking), {tps_o:.1f} generated tokens/s, launches "
          f"{launches_o}, {persists_o} persists; tier of {ONLINE_TIER_BLOCKS} FullBlocks per node, "
          f"in FullBlocks: {json.dumps(blocks_o)}; modelled seconds: wall "
          f"{st_o['wall_s']:.4f}, ttft_p99 {st_o['ttft_p99']:.4f}, "
          f"tpot_mean {st_o['tpot_mean']:.6f}")
    lap("5")

    # 6. the online SLO layer
    slo = slo_phase(cfg)
    st_s = slo["stats"]
    print("slo stats:", json.dumps(st_s))
    print(f"slo: {slo['wall_s']:.3f} s real wall, "
          f"{slo['tokens_per_s']:.1f} generated tokens/s, launches "
          f"{slo['launches']}, {slo['persists']} persists, "
          f"{slo['append_steps']} append_step calls; modelled seconds: gate "
          f"estimates {json.dumps(slo['estimates_s'])}, SLO "
          f"{slo['slo_s']:.6f}, defer {slo['defer_s']:.6f}, arrivals "
          f"{slo['arrivals_s']}, wall "
          f"{st_s['wall_s']:.4f}; admitted {st_s['admitted_rounds']}, "
          f"deferred {st_s['deferred_rounds']}, rejected "
          f"{st_s['rejected_rounds']}, prefill slices "
          f"{st_s['prefill_chunks']}; interactive over batch (rids) "
          f"{slo['overtakes']}; latency_by_class (modelled s) "
          f"{json.dumps(st_s['latency_by_class'])}")
    print(f"slo, first rounds with no deferral allowed: "
          f"{slo['reject_wall_s']:.3f} s real wall, "
          f"{json.dumps(slo['reject_stats'])}")
    lap("6")

    # 7. chaos: traced, hedged reads, a DE's fail-stop and its recovery
    chaos = chaos_phase(cfg)
    for arm, title in (("a", "fault-free, traced"), ("b", "untraced"),
                       ("c", "hedged reads"), ("d", "a DE dies")):
        r = chaos[arm]["run"]
        print(f"chaos ({arm}) {title}: {r['wall_s']:.3f} s real wall, "
              f"{r['tokens_per_s']:.1f} generated tokens/s, launches "
              f"{r['launches']}, {r['persists']} persists; stats "
              + json.dumps(r["stats"]))
    ca, cd = chaos["a"], chaos["d"]["run"]
    print(f"chaos (a): trace {json.dumps(ca['trace'])}; audit "
          f"{json.dumps(ca['audit'])}; TTFT attribution (modelled s) "
          f"{json.dumps(ca['report'])}; plans against the runtime "
          f"{json.dumps(ca['plans'])}")
    print(f"chaos (d): DE {list(cd['victim'])} dies at modelled "
          f"{cd['t_death']!r} s while it decodes rid {cd['decoding_rid']}; "
          f"recovered {cd['stats']['recovered_rounds']} rounds; bf16 tokens "
          + ("equal (a)'s" if chaos["d"]["first_difference"] is None else
             "differ from (a)'s at " + json.dumps(
                 chaos["d"]["first_difference"]) + "; in f32 (a) and (d) "
             "give equal tokens (death at modelled "
             f"{chaos['d']['f32']['d']['t_death']!r} s)"))
    lap("7")

    # 8. elastic role flips and the compute network
    el = elastic_phase(cfg)
    for arm, title in (("e", "elastic on"), ("f", "elastic off"),
                       ("g", "collectives, vl"), ("h", "collectives, fifo")):
        r = el[arm]
        s_ = r["stats"]
        print(f"elastic ({arm}) {title}: {r['wall_s']:.3f} s real wall, "
              f"{r['tokens_per_s']:.1f} generated tokens/s, flips "
              f"{json.dumps(s_['role_changes_by_direction'])}, "
              f"_finish_flip real host ms "
              f"{[round(x['host_ms'], 3) for x in r.get('flips', [])]}, "
              f"launches {r['launches']}, {r['persists']} persists; "
              f"modelled seconds: wall {s_['wall_s']!r}, reconfig_drain_s "
              f"{s_['reconfig_drain_s']!r}, collective_stall_s "
              f"{s_['collective_stall_s']!r}, transfer_backlog_s "
              f"{s_['transfer_backlog_s']!r}; net_congestion "
              f"{s_['net_congestion']!r}, paced_flushes "
              f"{s_['paced_flushes']}, deferred_wrs {s_['deferred_wrs']}"
              + ("" if "collective_tokens" not in r else
                 f", collectives over {r['collective_tokens']} tokens "
                 f"({r['collective_s']!r} modelled s)")
              + "; stats " + json.dumps(s_))
    for x in el["e"]["flips"]:
        print(f"elastic (e) flip {x['direction']} of {x['engine']} at "
              f"modelled {x['t_modelled']!r} s: {x['host_ms']:.3f} ms real "
              f"host, memory_allocated {x['allocated_delta']:+d} bytes "
              f"(decode state {el['state_bytes']}); the engine it brought "
              f"in: {json.dumps(x['counts'])}")
    print("elastic: bf16 tokens of (e) and (f) " + (
        "equal" if el["first_difference"] is None else
        "differ at " + json.dumps(el["first_difference"]) +
        "; in f32 (e) and (f) give equal tokens"))
    lap("8")

    # 9. f32 token identity with the cache-free reference
    n, chunks = identity_phase(cfg)
    print(f"f32 identity: {n} context tokens equal the cache-free reference, "
          f"unchunked and in {chunks} + 1 prefill slices")
    lap("9")

    # 10. gemma2-2b: local and global layers, softcaps, head dim 256
    g2 = gemma2_phase(cfg_g2)
    st_g = g2["stats"]
    print("gemma2 stats:", json.dumps(st_g))
    print(f"gemma2: {g2['wall_s']:.3f} s real wall (pipelined), "
          f"{g2['blocking_wall_s']:.3f} s (blocking), "
          f"{g2['tokens_per_s']:.1f} generated tokens/s, launches "
          f"{g2['launches']}, {g2['persists']} persists; launches with the "
          f"window on sequences past it {g2['windowed']}; contexts "
          f"{g2['context_lens']}; peak memory_allocated of the run "
          f"(weights included) "
          f"{g2['peak_allocated']} bytes")
    print(f"gemma2 f32 identity: {g2['identity_tokens']} context tokens "
          f"equal the cache-free reference, unchunked and in "
          f"{g2['identity_chunks']} + 1 prefill slices")
    print_profile(*profile_phase(cfg_g2, GEMMA2_ROUNDS, GEMMA2_AGENTS,
                                 max_seq=GEMMA2_MAX_SEQ), label="gemma2: ")
    lap("10")

    # 11. ds27b: MoE + MLA, the paper's own model
    gc.collect()
    torch.cuda.empty_cache()
    ds = moe_phase(cfg_ds)
    assert set(ds["appends"]) == set(DS27B_APPENDS), \
        f"ds27b appends {ds['appends']}, phase 3 held flash at " \
        f"{DS27B_APPENDS}"
    print_moe_phase(ds, "ds27b")
    lap("11")

    # 12. the event simulator: modelled cluster time on the host
    sim = sim_phase(io_started=sim_io)
    print_sim(sim)
    lap("12")

    # 13. mamba2-1.3b: the SSM family's state-blob path
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m2 = blob_phase(get_config("mamba2-1.3b"))
    m2_s = time.perf_counter() - t0
    print_blob_phase(m2, "mamba2")
    print(f"mamba2 phase: {m2_s:.1f} s")
    lap("13")

    # 14. the registrations: granite-moe-3b-a800m, minicpm-2b,
    # nemotron-4-15b, one after another
    t0 = time.perf_counter()
    reg = registrations_phase()
    for arch, r in reg.items():
        s_ = r["stats"]
        print(f"{arch}: {r['wall_s']:.3f} s real wall (pipelined), "
              f"{r['blocking_wall_s']:.3f} s (blocking), "
              f"{r['tokens_per_s']:.1f} generated tokens/s, launches "
              f"{r['launches']} (predicted from {r['items']} batch items "
              f"{r['appends']}, {r['installs']} installs, {r['persists']} "
              f"persists, {s_['decode_steps']} decode steps); "
              f"{r['phase_s']:.1f} s with the weights; stats "
              + json.dumps(s_))
    print(f"registrations phase: {time.perf_counter() - t0:.1f} s")
    lap("14")

    # 15. zamba2-2.7b: the hybrid's blob path (Mamba2 states and the
    # shared block's K/V), flash and paged at head dim 80, the scan at N 64
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    z2 = blob_phase(get_config("zamba2-2.7b"), max_seq=ZAMBA2_MAX_SEQ,
                    identity=ZAMBA2_IDENTITY)
    z2_s = time.perf_counter() - t0
    assert set(z2["appends"]) == set(ZAMBA2_APPENDS), \
        f"zamba2 appends {z2['appends']}, phase 3 held flash at " \
        f"{ZAMBA2_APPENDS}"
    print_blob_phase(z2, "zamba2")
    print(f"zamba2 phase: {z2_s:.1f} s")
    lap("15")

    # 16. llama4-maverick-400b-a17b: MoE of period 2, 128 experts top-1
    gc.collect()
    torch.cuda.empty_cache()
    l4 = llama4_phase(get_config(LLAMA4))
    assert set(l4["appends"]) == set(LLAMA4_APPENDS), \
        f"llama4 appends {l4['appends']}, phase 3 held flash at " \
        f"{LLAMA4_APPENDS}"
    print_moe_phase(l4, "llama4")
    lap("16")

    # 17. llava-next-34b: served by token ids, then the VLM path
    gc.collect()
    torch.cuda.empty_cache()
    lv = llava_phase(get_config(LLAVA))
    print_llava_phase(lv)
    lap("17")

    # 18. hubert-xlarge: the encoder, forward only
    gc.collect()
    torch.cuda.empty_cache()
    hb = hubert_phase(get_config(HUBERT))
    print_hubert_phase(hb)
    lap("18")

    # 19. training and checkpoints: qwen1.5-0.5b through flash's backward
    gc.collect()
    torch.cuda.empty_cache()
    tr = train_phase(cfg)
    print_train_phase(tr)
    lap("19")

    # 20. MoE training: granite-moe-3b-a800m through the grouped GEMM's
    # hand-written backward
    gc.collect()
    torch.cuda.empty_cache()
    cfg_gr = get_config(GRANITE)
    trm = train_phase(cfg_gr, batch=TRAIN_MOE_BATCH,
                      micro=cfg_gr.microbatches_train_4k,
                      steps=TRAIN_MOE_STEPS)
    print_train_phase(trm, "moe train")
    lap("20")

    # 21. MLA training: ds27b (MoE over MLA) through flash's backward at
    # q/k 192, v 128
    gc.collect()
    torch.cuda.empty_cache()
    trl = train_mla_phase()
    print_train_phase(trl, "mla train")
    lap("21")

    # 22. SSM and hybrid training: mamba2-1.3b and zamba2-2.7b through the
    # SSD scan's and the conv's hand-written backwards
    gc.collect()
    torch.cuda.empty_cache()
    trs = train_ssm_phase()
    print_train_ssm_phase(trs)
    lap("22")

    # 23. kernels line, then the contract line
    meta = {
        "kv_layer_gather": ("src/repro_torch/kernels/csrc/kv_gather.cu",
                            "src/repro/kernels/kv_gather.py:30"),
        "kv_layer_scatter": ("src/repro_torch/kernels/csrc/kv_scatter.cu",
                             "src/repro/kernels/kv_gather.py:61"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:107"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:76"),
        # jnp/lax in the reference, not Pallas: jax.lax.ragged_dot and
        # the absorbed decode's einsums
        "grouped_gemm": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                         "src/repro/models/moe.py:64"),
        "mla_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                       "src/repro/models/mla.py:109"),
        # jnp in the reference: the chunked scan, the recurrence, the conv
        "ssd_chunk_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                           "src/repro/models/ssm.py:59"),
        "ssm_step": ("src/repro_torch/kernels/csrc/ssm_step.cu",
                     "src/repro/models/ssm.py:138"),
        "causal_conv": ("src/repro_torch/kernels/causal_conv.py",
                        "src/repro/models/ssm.py:31"),
        # no Pallas counterpart: the reference's training differentiates
        # its jnp attention with XLA, and transposes jax.lax.ragged_dot
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/models/layers.py:100"),
        "grouped_gemm_bwd": (
            "src/repro_torch/kernels/csrc/grouped_gemm_bwd.cu",
            "src/repro/models/moe.py:64"),
        # jax.grad of the scan's lax.scan and of the jnp conv
        "ssd_chunk_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                               "src/repro/models/ssm.py:59"),
        "causal_conv_bwd": ("src/repro_torch/kernels/causal_conv.py",
                            "src/repro/models/ssm.py:31"),
    }
    # the main path each kernel's launches are read from: the offline
    # qwen run for the four of every path, ds27b's for its own two,
    # mamba2's for the SSM family's three, qwen's training for flash's
    # backward, granite's training for the grouped GEMM's, mamba2's
    # training for the SSD scan's and the conv's
    main_path = {name: launches[name] for name in GQA_KERNELS}
    main_path.update({name: ds["launches"][name]
                      for name in ("grouped_gemm", "mla_decode")})
    main_path.update({name: m2["launches"][name]
                      for name in ("ssd_chunk_scan", "ssm_step",
                                   "causal_conv")})
    main_path["flash_attention_bwd"] = tr["launches"]["flash_attention_bwd"]
    main_path["grouped_gemm_bwd"] = trm["launches"]["grouped_gemm_bwd"]
    for name in ("ssd_chunk_scan_bwd", "causal_conv_bwd"):
        main_path[name] = trs["launches"][name]
    short = {"granite-moe-3b-a800m": "granite", "minicpm-2b": "minicpm",
             "nemotron-4-15b": "nemotron"}
    line = []
    for name, cs in cases.items():
        main_case = cs[0]
        line.append(dict(
            name=name, route="cuda" if KERNEL_SOURCES[name] else "triton",
            source=meta[name][0],
            replaces=meta[name][1], launches=main_path[name],
            launches_by_path=dict(offline=launches[name],
                                  online=launches_o[name],
                                  slo=slo["launches"][name],
                                  chaos=ca["run"]["launches"][name],
                                  chaos_death=cd["launches"][name],
                                  elastic=el["e"]["launches"][name],
                                  network=el["g"]["launches"][name],
                                  gemma2=g2["launches"][name],
                                  ds27b=ds["launches"][name],
                                  sim=sim["launches"][name],
                                  mamba2=m2["launches"][name],
                                  **{short[a]: r["launches"][name]
                                     for a, r in reg.items()},
                                  zamba2=z2["launches"][name],
                                  llama4=l4["launches"][name],
                                  llava=lv["launches"][name],
                                  llava_vlm=lv["vlm"]["launches"][name],
                                  hubert=hb["launches"][name],
                                  train=tr["launches"][name],
                                  train_moe=trm["launches"][name],
                                  train_mla=trl["launches"][name],
                                  train_ssm=trs["launches"][name],
                                  train_hybrid=trs["hybrid"]["launches"][
                                      name]),
            max_abs_err=max(c["max_abs_err"] for c in cs),
            ms=main_case["ms"], kernel_ms=main_case["ms"],
            ms_clean_l2=main_case.get("ms_clean_l2"),
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], shapes=main_case["shapes"],
            cases=cs))
    line[1]["persist_ms"] = {w: dict(host_ms=h, d2h_ms=d)
                             for w, (h, d) in persist.items()}
    line[1]["persists_by_path"] = dict(offline=persists, online=persists_o,
                                       slo=slo["persists"],
                                       chaos=ca["run"]["persists"],
                                       chaos_death=cd["persists"],
                                       elastic=el["e"]["persists"],
                                       network=el["g"]["persists"],
                                       gemma2=g2["persists"],
                                       ds27b=ds["persists"],
                                       **{short[a]: r["persists"]
                                          for a, r in reg.items()},
                                       mamba2=m2["persists"],
                                       zamba2=z2["persists"],
                                       llama4=l4["persists"],
                                       llava=lv["persists"],
                                       llava_vlm=lv["vlm"]["launches"][
                                           "kv_layer_scatter"],
                                       hubert=hb["launches"][
                                           "kv_layer_scatter"])
    for entry in line[2:4]:
        entry["gemma2_windowed_launches"] = g2["windowed"][entry["name"]]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
