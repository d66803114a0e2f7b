#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each printing one JSON line:

1. env     — the card (nvidia-smi name and power limit), torch and CUDA
             versions, and the build of every kernel from ``csrc/`` with
             each kernel's registers and spill bytes from ptxas.
2. kernels — each hand-written InCRS kernel against its plain torch
             version on the card (the five Table II operands at N = 512,
             incrs-docword also at N = 128 and 640, edge operands and a
             skewed one whose first row tile holds most of the
             non-zeros), the three bitwise against each other.
3. serve   — the main path: ``SpMMEngine`` on the five Table II workloads
             at their published sizes, then incrs-docword with each
             explicit variant, every request checked against the float64
             product on the host; then the serving launcher once as a
             subprocess. Launch counters are zeroed just before and read
             just after, and must equal the waves.
4. profile — incrs-docword served again in a fresh process (this script
             with --profile), after phase 10 and in the same process as
             docword as bsr and as dense plans and the granite bsr plan:
             plain for the wall time and the host's staging, then under
             torch.profiler for device time by kind (kernel, copies); the
             idle share of the card. In phase 13 the same for the
             lifecycle's operands.
5. times   — the three InCRS orders' median times over CUDA events on
             each Table II operand at N = 512 (incrs-docword also at 128
             and 640), beside ``torch.sparse.mm`` and the bound of the
             card; at incrs-docword, N = 512, also each plain version and
             the pipelined kernel at other cluster sizes, warp counts and
             block widths (``pipe_geometries``, each bitwise equal to
             expand).
   autotune — the tuning layer (``kernels.autotune``; the cache a fresh
             file under build/, so every run tunes from cold): with the
             cache empty, ``ops.spmm(variant="auto")`` launches the cost
             model's order; then the InCRS orders swept (every launch knob
             that passes the launch check) on the five Table II operands at
             N = 512 and incrs-docword at 64, 128, 384 and 640 columns,
             each sweep's candidates, skips (with the rule), measured µs
             beside the prediction, winner, overhead and seconds printed,
             every measured candidate's C bitwise equal to expand's and
             within 1e-4 of the plain version; with the cache filled,
             ``ops.spmm(auto)``, a ``plan(..., tune="cache")`` and an
             ``SpMMEngine`` each launch the winner at its geometry once a
             call or wave and no other kernel; index matching swept
             (R = 32, 64, 128 and its geometries) at mesh-docword4 and its
             winner launched by ``ops.spmm``; the launch check's occupancy
             rule against the card for every instance of every wrapper; a
             swap to an operand the check refuses raises and the old one
             keeps serving. Training's stripes are swept in phase train.
   spgemm_auto — after phase spgemm: at each Table IV workload the engine
             ``auto`` picked, its predicted µs, and its wall against the
             fastest engine's wall in phase spgemm (a ratio, not gated).
6. spgemm_kernels — the sparse × sparse kernels against their plain
             versions on the card: the eight Table IV operands as A·Aᵀ at
             R = 128 (mesh-docword4 also at R = 32) and edge operands;
             condense + merge and merge bitwise equal to index matching and
             to plain merge, the gather bitwise equal to its plain version
             and its repeat; each of the four kernels' two instances
             bitwise equal to each other.
7. spgemm  — the second path: ``ops.spmm(A, A)`` through every engine, an
             InCRS right-hand side, R = 32, and ``spgemm.spgemm`` on the
             eight Table IV workloads at their published sizes, every C
             checked against the float64 product on the host and every
             call's launches against its engine, each call's wall split
             into host time, device span and wait, and the caching
             allocator's cudaMalloc, cudaFree and retry counts around it.
             Counters are zeroed just before and read just after; the
             second designs' instances must each have run.
   spgemm_alloc — mesh-mks4's and mesh-bates' condense + merge calls in
             turn, the allocator's cache warm and emptied, each call's
             wall, CPU time and allocator counters, and one fresh
             cudaMalloc of bates' R = 32 stripes.
8. spgemm_times — mesh-docword4 at R = 128: each kernel's median time
             beside its plain version, the library call and the bound
             (the gather and merge also in their first designs).
   spgemm_operands — the eight Table IV operands at R = 128, and at R =
             32 where the stripes fit: index matching and condense (R =
             128, docword also at 32), each in the ring instance and the
             general one (the first design), beside torch.sparse.mm, the
             bound and the ring's packing pre-pass alone; merge (ring and
             general, beside stripes.sum(0) and stripes.sum(), a read of
             the same bytes) and the gather (R = 128; tile and general,
             beside A_csr.to_dense(), a fill of the output and a pad of
             the stripes to the output's shape), each with its bound; the
             instance each rule picks.
9. plan_kernels — the BSR and dense kernels against their plain versions
             (and, in f32, float64) on the card: the five Table II
             operands as BSR (blocks 50, 10, 50, 60, 50) at N = 512, the
             granite-34b MLP operand W_up^T (24576 x 6144, block 128,
             density 0.25) in both formats, docword dense, and edge
             operands (split-K, skewed block-rows); granite, docword
             dense and one general-instance edge each also in bf16 (held
             row by row). Every call runs twice, bitwise equal, and names
             the instance and K splits that ran.
10. plan_serve — the third path: ``SpMMEngine(plan_for_operand(...))``
             as bsr and as dense on the five Table II operands at full
             size and the granite operand, each with the mixed-width
             trace of phase 3. Counters are zeroed just before and read
             just after; every wave launches one kernel of its format and
             no other. Then the serving launcher as a subprocess with
             --format bsr and --format dense on the five Table II
             workloads and once with --spmm-swap, 8 at a time, checked
             for its exit code, error and launches (two waves each: its
             printed rate measures nothing).
             Then bf16 bsr and dense plans of docword served with bf16
             requests, one launch of the bf16 instance per wave.
11. plan_times — both kernels at the granite operand and at docword,
             N = 512, in f32 and in bf16: median time, plain version,
             library call, bound; the card's SM clock and power while the
             f32 dense kernel and torch.matmul run at granite
             (``plan_clocks``); then the dense instances at other K
             splits, ring depths and (bf16) tile widths
             (``plan_geometries``).
   tenancy — the eighth path: one ``TenantPool`` over the five Table II
             operands as raw InCRS, docword as a bsr plan (block 50) and
             as a dense plan, and granite-34b's W_up^T as two raw-InCRS
             checkpoints of one W pruned to density 0.1 and 0.05; its
             budget is one byte below the two granite tenants together.
             Phase 3's mixed-width trace is interleaved across the
             tenants, each request submitted (a revival timed) and
             drained before the next, counters zeroed just before: every
             request within 1e-4 of float64, one launch a wave of the
             tenant's kernel, each granite tenant evicted and revived.
             Then the memory evictions free (an InCRS tenant's at least
             its counted bytes; a plan tenant's printed), the pool's
             stats, each tenant's latency, revivals and shared memory a
             launch, a CUDA engine's cost-model seed, and the serve bench
             (--smoke) and the spmm_serve example as two subprocesses at
             once.
12. train — the fifth path: granite-34b's MLP (W_up 6144 -> 24576, tanh,
             W_down back) trained at full width for 8 AdamW steps on 512
             token rows, once as incrs (density 0.1, section 256) and once
             as bsr (block 128, density 0.25): the packing timed; step 0's
             gradients (live slots) and dL/dh within 1e-4 of a float64
             dense oracle (on the card); l2's dx kernel on the transposed
             stripes or block lists within 1e-5 of its plain version;
             each product
             of a step timed alone (the forwards, dx beside its plain
             version and a library call, each dW beside the dense x^T dy);
             then the steps, each split by CUDA events into forward,
             backward and optimizer, with peak memory. For incrs, each
             product's stripes (l1's and l2's forward, l2's transposed for
             dx) are swept first at T = 512 (phase autotune's protocol),
             so ``auto`` launches each product's winner. Counters are
             zeroed just before the steps and read just after: 3 launches a
             step of the format's kernel (for incrs, of the orders ``auto``
             picks) and none of another. The loss falls,
             pad slots and zero tiles stay 0.0, the trained l1 is served
             by SpMMEngine within 1e-4 of float64 one launch a wave (the
             training example runs at the end of phase lifecycle).
   sharded — between incrs's phases train and lifecycle, the ninth
             path: train's incrs l1 (granite-34b's W_up^T at density 0.1)
             cut by ``Linear.shard`` into 8 row panels of 3072 rows on
             one card named 8 times. ``ops.spmm`` at every order and
             ``auto`` on it and on incrs-docword (8 panels of 88 rows),
             N = 512: C bitwise equal to the single-device kernel's (each
             shard's rows) and within 1e-4 of float64, each shard's launch
             against its plain version, a shard's kernel, the single-device
             kernel and both ``spmm`` calls timed; phase 3's trace through
             a single-device and a sharded engine, results equal, 8
             launches a wave; 2 AdamW steps with l1 sharded (step 0's
             forward and dW bitwise equal to the single-device layer's, dx
             within 1e-4, the dx reduction timed; the loss falls, pad slots
             0.0, launches counted); the sharded layer re-pruned to 0.05
             and swapped into the running sharded engine, every result
             within 1e-4 of float64 of the repacked weight; the operand's
             bytes sharded and single; where more than one card is
             visible, a mesh over all of them. Counters zeroed just
             before each run of the path.
13. lifecycle — after each format's phase train, on its trained student
             (the sixth path): an SpMMEngine serves l1 (W_up) with the
             first half of phase 3's trace; the prune callback re-prunes
             l1 at one due step (incrs to density 0.05, bsr to block
             density 0.125), timed on the host; one wave is launched, the
             repacked l1 is hot-swapped in (``swap_pattern``, timed) and
             the rest of the trace served: every request within 1e-4 of
             float64 of the weight in force when its wave launched, one
             launch a wave, counters zeroed just before. Then step 0's
             gradients on the new live set against float64, 2 AdamW steps
             on the repacked moments (3 launches a step, no other kernel,
             split forward / backward / optimizer), survivors carried over
             and pruned slots gone, pad slots and zero tiles 0.0, latency
             before and after the swap (and the served operand's kernel
             alone on a 512-column panel, before and after), peak memory;
             after both formats, the reprune example and the training
             example (incrs and bsr) as three subprocesses at once.
14. crs_plan — the seventh path: granite-34b's W_up^T (24576 x 6144,
             density 0.1) planned once by ``plan_for_operand`` as ``crs``
             (R = 128), times B^T = top-5 % activations (307 of 6,144 per
             row, 512 rows): index matching and condense + merge (a crs and
             an InCRS B^T), each called twice (RHS prep, then a memo hit),
             C within 1e-4 of float64 on the host, condense + merge bitwise
             equal to index matching, counters zeroed just before; the
             plan's and the bind's host time; each kernel on the plan's
             operands against its plain version, timed beside its bound and
             a library call. Then mesh-docword4 at R = 128 and 32: a bound
             plan's calls beside ops.spmm(A, A) through the same engine,
             bitwise equal.
15. lm_kernels — the flash-attention kernels against their plain version
             on the card, f32 (the FMA kernel) and bf16 (the tensor-core
             kernel), each call checked to launch its type's kernel:
             granite-34b's prefill wave (B = 2,
             S = 8192, one KV head, 48 query heads, hd 128), a mixtral
             shape (window 4096, KV 8, G 4), a recurrentgemma shape (soft
             cap 30, window 2048, hd 256), phase 19's qwen2-moe (KV 16,
             G 1, hd 128), musicgen (KV 24, G 1, hd 64) and internvl2
             (KV 2, G 7, hd 64) prefill shapes at S = 8192, and edge
             shapes. bf16 is held
             on every query row; at granite's wave the same check must
             reject a planted fault (key tile 0 dropped past row 4096).
16. lm_serve — the fourth path: granite-34b at full width, depth cut to
             4 layers, served by ``ServeEngine``: 2 requests of 8,192
             tokens (one wave through the kernel, one launch per layer)
             and 4 of 512 (the dense branch, no launch), counters zeroed
             just before; the long wave profiled for the idle share, its
             records held against the launch counters (flash records
             against the flash counter, GEMM records against the host's
             GEMM ops, kernel records against the host's launch calls),
             and profiled again in a fresh process (this script with
             --lm-profile, up to 3 runs) where one was lost; the
             f32 decode logits against a teacher-forced prefill; the
             launcher as a subprocess. Device time is sorted by kernel
             symbol: the flash kernels by the names the wrapper exports.
17. lm_times — the bf16 kernel at granite's wave: median time, TFLOP/s
             and share of the bound, beside the f32 kernel on the same
             values, the plain version and scaled_dot_product_attention.
18. lm_train — the LM's training path: one granite-34b layer at full
             width, step 0's f32 loss and grads (TF32 off) against float64
             on the card (1e-4 of each tensor's max) and the bf16 loss
             against the f32 one (2e-2); granite-34b at full width cut to
             4 layers (bf16 compute, f32 params, remat "dots"), 8 AdamW
             steps on 4 x 2,048-token batches, each step's forward +
             backward and optimizer ms, tokens/s, loss, grad norm and peak
             memory, the loss falling, every parameter with a finite
             nonzero step-0 grad and no flash launch; one narrow layer at
             S = 8,192 in train mode with wq/wk/wv grads nonzero and equal
             to the CPU's (the chunked torch attention, never the flash
             kernel, which refuses inputs that require grad); GPipe over 4
             stages of 6,144 x 6,144 InCRS (density 0.1, ``stack_init``)
             on cuda:0 named 4 times, 8 microbatches of 512 rows: the
             forward bitwise equal to the stages in turn, step 0's value
             grads within 1e-4 of a float64 dense oracle, pad slots 0.0,
             32 forward and 32 dx launches a step, 2 steps timed beside
             the stages run in turn on the whole batch; then the training
             launcher as subprocesses, a run resumed from its step-4
             checkpoint giving steps 5-8's losses bitwise. Counters are
             zeroed just before the pipeline's runs and read just after.
             ``python3 chip_smoke.py --lm-train`` runs this phase alone.
19. lm_families — the MoE FFN and the embeds front end: mixtral-8x7b
             (2 of 32 layers), qwen2-moe-a2.7b (4 of 24), musicgen-medium
             (6 of 48) and internvl2-1b (6 of 24), each served and
             trained at that depth, at full width. Each: ``ServeEngine`` serves 2 requests of
             8,192 positions (prefix embeds included: one wave, one flash
             launch a layer) and 4 of 512 (none), counters zeroed just
             before each, the long wave's dropped (token, expert)
             assignments counted at capacity 1.25; the f32 decode logits
             against a teacher-forced prefill (MoE at capacity_factor
             E / k, so nothing drops); one layer's step-0 f32 grads
             against float64 (1e-4 of each tensor's max; an MoE's float64
             run takes the checked run's routing and counts the routes
             its own router would flip) and its bf16 grads inside
             lm_train's band; for an MoE the bf16 loss and grads again,
             bitwise, and a zeroed router routing every token to experts
             0..k-1; 8 AdamW steps on one batch (bf16 compute, f32
             params, remat "dots", 4 x 2,048 tokens), each step's ms,
             tokens/s and peak
             memory, the loss falling, every step-0 grad finite, experts
             no token reached counted. Then the serving launcher as a
             subprocess for qwen2-moe and internvl2 smoke configs at
             8,192 positions, while the training launcher on qwen2-moe's
             is resumed from its step-4 checkpoint, steps 5-8 bitwise.
             ``python3 chip_smoke.py --lm-families`` runs this phase alone.
20. lm_recurrent — the SSD and RG-LRU mixers: mamba2-370m (12 of 48
             layers) and recurrentgemma-2b (13 of 26, one repetition of
             its pattern: 9 RG-LRU, 4 local attention), each served and
             trained at that depth, at full width. Each:
             ``ServeEngine`` serves 2 requests of 8,192 positions (one
             wave: one flash launch a
             local-attention layer, 8 for recurrentgemma, none for
             mamba2) and 4 of 512 (none), counters zeroed just before
             each; the f32 decode logits against a teacher-forced
             prefill, the mixers' leaves redrawn so that the state
             carries the output; the served decode
             cache's bytes a sequence (the SSD state and conv tail; the
             RG-LRU state, conv tail and the 2,048-slot ring) equal at
             8,200 and 524,288 positions; one layer's step-0 f32 grads
             against float64 and its bf16 grads inside lm_train's band,
             every grad finite at mamba2's chunk of 256; 8 AdamW steps on
             one batch of 4 x 2,048 tokens (bf16 compute, f32 params,
             remat "dots"; recurrentgemma's in 4 microbatches), the loss
             falling. Then the serving launcher as a subprocess on
             recurrentgemma's smoke config at 8,192
             positions (1 flash launch), while the training launcher on
             mamba2's is resumed from its step-4 checkpoint, steps 5-8
             bitwise. ``python3 chip_smoke.py --lm-recurrent`` runs this
             phase alone; ``--lm-recurrent-profile`` profiles both archs'
             long prefill and training step in a process of its own.
   lm_sharded — the dense LM over a (data 2, model 4) mesh of one card
             named 8 times (``models.spmd``): granite-34b at full width
             cut to 1 layer (2 until the mesh across processes came),
             f32. One AdamW step on 4 x 1,024 tokens with
             FSDP and ZeRO-1 against the one-device step on the same
             seeded weights (the one-device reference first, its grads
             and first moments to the host, its model freed; the loss
             within 1e-5, each gathered gradient and first moment within
             1e-4 of its max), step ms of both, peak GB and the
             collectives by kind; then a prefill of 2 x 8,192 tokens (one
             sequence a data shard) and 4 decode steps under the default
             rules against one device (logits within 1e-4 of max|logit|
             at every step), 8 flash launches in the sharded prefill (8
             coordinates x 1 layer), counters zeroed just before; every
             run's collectives equal a meta-device run's to the byte.
             ``python3 chip_smoke.py --lm-sharded`` runs the build, this
             phase, lm_sharded_families and the mesh dry run alone.
   lm_sharded_families — the MoE, SSD and RG-LRU families through the
             same checks (``_sharded_arch``), each at full width cut to
             its depth (LM_FAMILIES_SHARDED: mixtral-8x7b 1 layer,
             qwen2-moe-a2.7b 1, mamba2-370m 6, recurrentgemma-2b 4; the
             train batch 4 x 1,024 tokens, recurrentgemma's 2 x 1,024).
             The MoE families print the tokens whose experts differ
             between the sharded run and one device, and where any do,
             the reference runs again on the sharded routes
             (``MoE.held_route``) before the comparison. Flash launches
             of the sharded prefill: 8 coordinates x the attention layers
             (8, 8, 0, 8); peaks under 70 GB.
             Then one sharded step of examples/train_sparse_lm.py's
             block-sparse configuration (d 768, 12 layers, blocks of 32)
             with half of each mask's blocks zeroed, held to one device,
             a zeroed block's gathered gradient 0.
   lm_dist — the mesh across processes: granite-34b at full width cut to
             1 layer, f32, on a (data 2, model 2) mesh of cuda:0 named
             four times, one process a coordinate (``launch.ranks.spawn``,
             torch.multiprocessing's spawn) joined by a gloo process
             group, CUDA tensors staged through host memory: one AdamW
             step of 2 x 1,024 tokens (FSDP and ZeRO-1), then a prefill of
             1 x 8,192 (each rank launches the flash kernel on its 24
             heads) and 4 decode steps; then the one-process path on the
             same mesh shape from the same seeds. Every rank's loss within
             1e-5, gradients, first moments and logits within 1e-4 of
             their max, its collectives' counts and bytes the one-process
             run's, its flash launches the one-process run's a
             coordinate; per-rank step, prefill and decode ms beside the
             one-process run's, and the host seconds of the transport. A
             rank that fails or outlives the phase's timeout fails the
             smoke. ``python3 chip_smoke.py --lm-dist`` runs the build and
             this phase alone.
21. proofs, dryrun, examples — with every exit-code subprocess of the
             smoke in one pool at the end (``late_checks``: these four,
             tenancy's serve bench and example, the training and
             lifecycle examples, the LM training launcher's resumed
             pair; beside them the LM serving launchers and their
             in-process training resumes): ``python -m
             repro_torch.analysis --check`` (every seeded case of the ten
             wrappers on the card: bounds, accumulator, coverage, race and
             ring checks; its proof matrix printed on lines of its own,
             every cell proved or n/a); ``python -m
             repro_torch.launch.dryrun --all`` (each applicable arch x
             shape cell's bytes against the card, and the depth that
             fits; its parameter and AdamW bytes of lm_train's granite-34b
             at LM_DEPTH layers equal to what the card held, its peak
             beside the measured one); ``python -m
             repro_torch.launch.dryrun --all --single-pod`` (phase
             dryrun_mesh: every cell's bytes a device on JAX's 16 x 16
             mesh, the dense families' collectives, granite-34b's
             train_4k among them); the quickstart and lm_serve examples,
             each exiting 0.
22. profile_in_process — last, so that it perturbs no later profile:
             phase 4's plan-path operands (docword bsr and dense, granite
             bsr) planned again and each served once under torch.profiler
             in this process, its kernel records against its 16 launches
             (ROADMAP P4: the profiler losing records late in the smoke),
             Kineto's log on and its count of the records it discards
             ("Out-of-range") kept. A loss is printed, not failed.

Then the card's line, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py --serial`` runs
the same smoke with the subprocesses that it otherwise runs at once
(``_concurrently``) one after another. Any failed check raises. Without a
CUDA device, or without the rest of the repository, it exits non-zero and
prints no result.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

KERNELS = (  # (entry point, variant, Pallas kernel it replaces)
    ("incrs_spmm", "expand", "src/repro/kernels/incrs_spmm.py:111"),
    ("incrs_spmm_reuse", "reuse", "src/repro/kernels/incrs_spmm.py:178"),
    ("incrs_spmm_pipelined", "pipelined",
     "src/repro/kernels/incrs_spmm.py:252"),
)
RAN_BY = {v: k for k, v, _ in KERNELS}
SOURCE = "src/repro_torch/kernels/csrc/incrs_spmm.cu"
TABLE2 = ("incrs-docword", "incrs-amazon", "incrs-belcastro", "incrs-norris",
          "incrs-mks")
TABLE4 = ("mesh-amazon4", "mesh-docword4", "mesh-mks4", "mesh-norris4",
          "mesh-arenas", "mesh-bates", "mesh-gleich", "mesh-sch")
SPGEMM_KERNELS = (  # (name, source, Pallas kernel it replaces)
    ("incrs_gather", "src/repro_torch/kernels/csrc/incrs_gather.cu",
     "src/repro/kernels/incrs_gather.py:28"),
    ("index_match_spmm", "src/repro_torch/kernels/csrc/index_match.cu",
     "src/repro/kernels/index_match_spmm.py:48"),
    ("spgemm_condense", "src/repro_torch/kernels/csrc/index_match.cu",
     "src/repro/spgemm/kernels.py:48"),
    ("spgemm_merge", "src/repro_torch/kernels/csrc/index_match.cu",
     "src/repro/spgemm/kernels.py:97"),
)
ENGINE_LAUNCHES = {   # densify's InCRS product: the order auto picks
    "reference": {"index_match_spmm": 1},
    "condense_merge": {"spgemm_condense": 1, "spgemm_merge": 1},
    "densify": {"incrs_gather": 1},
}
INCRS_KERNELS = tuple(k for k, _, _ in KERNELS)
STRIPES_MAX_BYTES = 8e9  # condense_merge at R = 32 only below this
# H100 SXM: HBM rate, and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor-core peak, dense
KERNEL_TOL = 1e-5        # max|kernel - plain| <= KERNEL_TOL * max|C|
SERVE_TOL = 1e-4         # max|served - float64 host| <= SERVE_TOL * max|C|
BF16_TOL = 1e-2          # bf16: per row, max|kernel - plain| <= BF16_TOL *
                         # that row's max|C| (flash_attention's rule)
PLAN_KERNELS = (  # (name, source, Pallas kernel it replaces)
    ("bsr_spmm", "src/repro_torch/kernels/csrc/bsr_spmm.cu",
     "src/repro/kernels/bsr_spmm.py:37"),
    ("dense_mm", "src/repro_torch/kernels/csrc/dense_mm.cu",
     "src/repro/kernels/dense_mm.py:21"),
)
# Table II operands as BSR: the largest block side <= 64 dividing M and K.
TABLE2_BLOCK = {"incrs-amazon": 50, "incrs-belcastro": 10,
                "incrs-docword": 50, "incrs-norris": 60, "incrs-mks": 50}
# The granite-34b dense GELU MLP (src/repro/configs/granite_34b.py: d_model
# 6144, d_ff 24576) pruned by the repo's BlockSparsity default (block 128,
# density 0.25, src/repro/models/config.py); A = W_up^T, W_up seeded normal
# with scale 0.02.
GRANITE = {"d_model": 6144, "d_ff": 24576, "block": 128, "density": 0.25,
           "scale": 0.02, "seed": 0}
GRANITE_NAME = "granite-34b W_up^T"
# The plan-path engine runs profiled after the counted run (phase 4).
PROFILED = {("incrs-docword", "bsr"), ("incrs-docword", "dense"),
            (GRANITE_NAME, "bsr")}


_T0 = time.perf_counter()


def auto_kernel(ops, prep, n):
    """The InCRS kernel ``ops.spmm(prep, B, variant="auto")`` launches for
    an n-column B: the tuned entry's order, else the cost model's."""
    return RAN_BY[ops.resolve_incrs(prep, n)[0]]


def wave_widths(width, cap=512, quantum=128):
    """The bucketed widths of the waves one request of ``width`` columns
    takes alone in an engine of wave cap ``cap``."""
    parts = [cap] * (width // cap) + ([width % cap] if width % cap else [])
    return [-(-w // quantum) * quantum for w in parts]


def auto_orders(ops, preps, cap=512, quantum=128):
    """The InCRS kernels auto may launch for ``preps`` at any wave width
    up to ``cap``."""
    return {auto_kernel(ops, p, w) for p in preps
            for w in range(quantum, cap + 1, quantum)}


def emit(obj) -> None:
    """One JSON line, in one write (threads that wait on subprocesses may
    emit too); a phase's line also gets the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ----------------------------------------------------------------------
def phase_env(torch, build):
    from repro_torch.analysis import launch_check
    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [dict(source=name, **k) for name in build.sources()
             for k in launch_check.ptxas_kernels(build.build_log(name))]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "sources": build.sources(), "ptxas": ptxas})


def _edge_operands():
    """Small operands that reach each masked edge of the kernels (the
    proofs' ``edge_*`` cases too)."""
    from repro_torch.analysis import cases
    return cases.edge_incrs()


def _compare(torch, K, idx, val, b, *, section, bm, bn, label):
    """Each kernel against its plain version, and the three bitwise."""
    outs = {}
    errs = {}
    for name, _, _ in KERNELS:
        before = K.LAUNCHES[name]
        out = getattr(K, name)(idx, val, b, section=section, bm=bm, bn=bn)
        torch.cuda.synchronize()
        check(K.LAUNCHES[name] == before + 1, f"{name} counted its launch")
        ref = K.plain(name, idx, val, b, section=section, bm=bm, bn=bn)
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((out - ref).abs().max())
        check(bool(torch.isfinite(out).all()), f"{name} finite on {label}")
        check(err <= KERNEL_TOL * scale,
              f"{name} on {label}: max|err| {err} > {KERNEL_TOL} * {scale}")
        outs[name], errs[name] = out, err
    first = outs[KERNELS[0][0]]
    for name, _, _ in KERNELS[1:]:
        check(torch.equal(outs[name], first),
              f"{name} bitwise equal to incrs_spmm on {label}")
    return errs


def phase_kernels(torch, K, ops, InCRS, table2):
    results = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs_512 = None
    for wl_name, inc in table2.items():
        prep = ops.prepare_incrs(inc, device="cuda")
        kp = prep.n_sections * prep.section
        m, k = prep.shape
        for n in (128, 512, 640) if wl_name == "incrs-docword" else (512,):
            bn = ops.default_bn(n)
            np_ = -(-n // bn) * bn
            b = torch.zeros(kp, np_, device="cuda")
            b[:k, :n] = torch.randn(k, n, generator=gen, device="cuda")
            errs = _compare(torch, K, prep.idx, prep.val, b,
                            section=prep.section, bm=128, bn=bn,
                            label=f"{wl_name} N={n}")
            if wl_name == "incrs-docword" and n == 512:
                errs_512 = errs
            results.append({"operand": wl_name, "shape": [m, k],
                             "stripes": list(prep.idx.shape), "n": n,
                             "bn": bn, "max_abs_err": errs})
    for label, dense in _edge_operands().items():
        inc = InCRS.from_dense(dense)
        ep = ops.prepare_incrs(inc, pad_rows_to=1, device="cuda")
        kp = ep.n_sections * ep.section
        for n in (128, 384):
            b = torch.zeros(kp, n, device="cuda")
            b[:dense.shape[1]] = torch.randn(dense.shape[1], n,
                                             generator=gen, device="cuda")
            errs = _compare(torch, K, ep.idx, ep.val, b, section=ep.section,
                            bm=128, bn=n, label=f"{label} N={n}")
            got = ops.spmm(inc, b[:dense.shape[1]], device="cuda").cpu()
            want = dense.astype(np.float64) @ \
                b[:dense.shape[1]].cpu().numpy().astype(np.float64)
            scale = max(float(np.abs(want).max()), 1e-30)
            check(float(np.abs(got.numpy() - want).max()) <= SERVE_TOL * scale,
                  f"ops.spmm on {label} N={n} against float64")
            results.append({"operand": label, "shape": list(dense.shape),
                            "smax": int(ep.idx.shape[2]), "n": n,
                            "max_abs_err": errs})
    emit({"phase": "kernels", "names": [k[0] for k in KERNELS],
          "tolerance": f"max|kernel-plain| <= {KERNEL_TOL} * max|C|",
          "bitwise_across_kernels": True, "checks": results})
    return errs_512


def _trace(k, seed):
    rng = np.random.default_rng(seed)
    widths = [(256, 128, 64, 384)[r % 4] for r in range(32)] + [1200]
    return [rng.normal(size=(k, w)).astype(np.float32) for w in widths]


def phase_serve(K, engine_mod, table2):
    from repro_torch.kernels import ops
    K.reset_launches()
    runs = [(name, "auto") for name in TABLE2] + \
        [("incrs-docword", v) for _, v, _ in KERNELS]
    traces = {}
    for wl_name, variant in runs:
        inc = table2[wl_name]
        crs = inc.crs
        if wl_name not in traces:        # one workload's reference at a time
            panels = _trace(crs.shape[1], seed=1)
            traces = {wl_name: (panels, crs.to_dense().astype(np.float64) @
                                np.concatenate(panels, axis=1).astype(
                                    np.float64))}
        panels, ref = traces[wl_name]
        before = dict(K.LAUNCHES)
        eng = engine_mod.SpMMEngine(inc, max_wave_cols=512, variant=variant,
                                    device="cuda")
        reqs = [engine_mod.SpMMRequest(i, p) for i, p in enumerate(panels)]
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        check(len(done) == len(reqs) and all(r.done for r in reqs),
              f"{wl_name}/{variant}: every request served")
        off, worst = 0, 0.0
        for r in reqs:
            want = ref[:, off:off + r.b.shape[1]]
            off += r.b.shape[1]
            check(r.out.shape == want.shape and np.isfinite(r.out).all(),
                  f"{wl_name}/{variant} request {r.rid} finite, right shape")
            err = float(np.abs(r.out - want).max())
            cmax = max(float(np.abs(want).max()), 1e-30)
            check(err <= SERVE_TOL * cmax,
                  f"{wl_name}/{variant} request {r.rid}: {err} > "
                  f"{SERVE_TOL} * {cmax}")
            worst = max(worst, err / cmax)
        delta = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        ran = {RAN_BY[variant]} if variant != "auto" else \
            auto_orders(ops, [eng.prep])
        check(sum(delta.values()) == eng.stats["waves"] and
              all(k in ran for k, v in delta.items() if v),
              f"{wl_name}/{variant}: launches {delta} are one a wave of "
              f"{eng.stats['waves']}, each of {sorted(ran)}")
        s = eng.stats_summary()
        emit({"phase": "serve", "workload": wl_name, "variant": variant,
              "a_shape": list(crs.shape), "nnz": crs.nnz,
              "stripes": list(eng.prep.idx.shape),
              "requests": s["requests"], "waves": s["waves"],
              "split_requests": int(eng.stats["split_requests"]),
              "launches": delta, "requests_per_s": s["requests_per_s"],
              "latency_ms_p50": s["latency_ms"]["p50"],
              "latency_ms_p99": s["latency_ms"]["p99"],
              "wave_ms_p50": s["wave_ms"]["p50"],
              "prep_overlap_fraction": s["prep_overlap_fraction"],
              "max_rel_err": worst})
    launches = dict(K.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"every kernel ran on the main path: {launches}")
    return launches


# phase serve's serving launcher: an exit-code subprocess (run in
# ``late_checks``)
SERVE_LAUNCHER = ("repro_torch.launch.serve", "--spmm", "--workload",
                  "incrs-docword", "--scale", "1.0", "--device", "cuda")


def report_serve_launcher(result):
    rc, wall, out, err = result
    emit({"phase": "serve_launcher", "cmd": " ".join(SERVE_LAUNCHER),
          "rc": rc, "wall_s": wall, "stdout": out.strip()[-2000:],
          "stderr": err.strip()[-2000:]})
    check(rc == 0, "launcher exited 0")


INCRS_SYMBOLS = ("expand_kernel", "reuse_kernel", "pipelined_kernel")


def profile_job(operand, k, *, workload="incrs-docword", fmt="incrs",
                kernel_keys=INCRS_SYMBOLS):
    """One operand for ``phase_profile``: an InCRS or a bound plan, its K
    columns, and the kernel symbols that are its format's."""
    return {"operand": operand, "k": k, "workload": workload, "fmt": fmt,
            "kernel_keys": list(kernel_keys)}


def phase_profile(torch, jobs):
    """Serve runs of each ``profile_job`` after the counted main path, in
    one fresh process (``chip_smoke.py --profile``, given the jobs through
    a file under ``build/``): one to warm, one plain for the wall time and
    the host's share of it, then the same run under torch.profiler for
    the card's busy time by kind. Late in this long process the profiler
    records only part of a serve's launches, and in a fresh one all of
    them. The idle share is taken against the plain run, since the
    profiler slows the host. A kernel is the format's when its symbol
    holds one of the job's ``kernel_keys``; the run fails if none did. Up
    to ``PROFILE_TRIES`` profiled runs are made until one records such a
    kernel for every wave; the fullest is reported, with each run's count
    of those records."""
    path = os.path.join(ROOT, "build", "profile_jobs.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(jobs, path)
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--profile", path],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    finally:
        os.remove(path)
    labels = [f"{j['workload']} {j['fmt']}" for j in jobs]
    check(proc.returncode == 0, f"profile of {labels}: the child exited "
          f"{proc.returncode}: {proc.stderr.strip()[-2000:]}")
    results = [json.loads(line) for line in proc.stdout.splitlines()
               if line.startswith("{")]
    check(len(results) == len(jobs), f"profile of {labels}: "
          f"{len(results)} results")
    for job, res in zip(jobs, results):
        s, s_prof, by_kind, seen = (res["plain"], res["profiled"],
                                    res["device_ms_by_kind"], res["seen"])
        check(max(seen) > 0, f"profile of {job['workload']} {job['fmt']}: "
              f"no device time in a kernel whose symbol holds "
              f"{job['kernel_keys']} in {len(seen)} sessions")
        wall_ms = s["elapsed_s"] * 1e3
        busy_ms = sum(by_kind.values())
        emit({"phase": "profile", "workload": job["workload"],
              "format": job["fmt"], "variant": "auto", "waves": s["waves"],
              "wall_ms": wall_ms,
              "wall_ms_profiled": s_prof["elapsed_s"] * 1e3,
              "device_ms_by_kind": by_kind, "device_busy_ms": busy_ms,
              "kernel_records_by_session": seen,
              "profile_complete": max(seen) == s_prof["waves"],
              "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms
              else "not measured",
              "host_staging_ms": s["prep_s_total"] * 1e3,
              "host_staging_hidden_ms": s["prep_s_hidden"] * 1e3,
              "wave_ms_sum": s["wave_ms"]["mean"] * s["waves"],
              "prep_overlap_fraction": s["prep_overlap_fraction"],
              "requests_per_s": s["requests_per_s"]})


# Profiled serve runs per profile at most.
PROFILE_TRIES = 3


# Kineto's lines of dropped records, a full buffer, and its own count of
# the records it discards ("Out-of-range", "CPU GPU out-of-order")
P4_MESSAGE = re.compile(r"drop|overflow|record counts", re.I)


class _Stderr:
    """File descriptor 2 captured for a block (Kineto and CUPTI log there,
    below Python) and written back after it; ``p4`` holds its lines that
    speak of dropped or discarded records or a full buffer (ROADMAP
    P4)."""

    def __enter__(self):
        import tempfile
        sys.stderr.flush()
        self._saved = os.dup(2)
        self._file = tempfile.TemporaryFile()
        os.dup2(self._file.fileno(), 2)
        return self

    def __exit__(self, *exc):
        sys.stderr.flush()
        os.dup2(self._saved, 2)
        os.close(self._saved)
        self._file.seek(0)
        text = self._file.read().decode(errors="replace")
        self._file.close()
        sys.stderr.write(text)
        self.p4 = [ln.strip()[:300] for ln in text.splitlines()
                   if P4_MESSAGE.search(ln)]
        return False


def _profiled_serve(torch, serve, keys, kernel_kind):
    """One ``serve()`` under torch.profiler: the device ms by kind (the
    format's kernel by its symbols ``keys``, the copies, the rest), the
    count of the format's kernel records, the serve's summary and Kineto's
    lines of dropped or discarded records (ROADMAP P4)."""
    from torch.profiler import ProfilerActivity, profile
    with _Stderr() as err, profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) \
            as prof:
        s_prof = serve()
    by_kind = {kernel_kind: 0.0, "memcpy_h2d": 0.0, "memcpy_d2h": 0.0,
               "other": 0.0}
    n_kernels = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue    # host ops: their device time is counted on the
        us = getattr(ev, "self_device_time_total",  # device
                     getattr(ev, "self_cuda_time_total", 0.0))
        key = ev.key.lower()
        kind = (kernel_kind if any(k in key for k in keys) else
                "memcpy_h2d" if "htod" in key else
                "memcpy_d2h" if "dtoh" in key else "other")
        by_kind[kind] += us / 1e3
        n_kernels += ev.count if kind == kernel_kind else 0
    return n_kernels, by_kind, s_prof, err.p4


def _plan_serve_fn(torch, engine_mod, operand, k):
    """``serve()``: phase 3's trace of ``k``-row panels through a fresh
    SpMMEngine over ``operand``, synchronized; returns its summary."""
    panels = _trace(k, seed=1)

    def serve():
        eng = engine_mod.SpMMEngine(operand, max_wave_cols=512,
                                    device="cuda")
        for i, p in enumerate(panels):
            eng.submit(engine_mod.SpMMRequest(i, p))
        eng.run()
        torch.cuda.synchronize()
        return eng.stats_summary()
    return serve


def phase_profile_in_process(torch, engine_mod, api, operands):
    """ROADMAP P4: each plan-path operand (label, format, dense A, block)
    planned on the card and its serve profiled in this process, as the
    profile phase did before it moved to a fresh process; the kernel
    records it keeps against the waves' launches (16 each), with Kineto's
    log on (``KINETO_LOG_LEVEL``) and its lines of dropped or discarded
    records kept: its "Record counts" line counts the records it drops
    as outside the profile's window ("Out-of-range"). A loss is printed,
    not failed: the fresh process's profile is the one read."""
    out = []
    for label, fmt, a, block in operands:
        bound = api.plan_for_operand(a, api.SparseSpec(fmt, block=block),
                                     device="cuda")
        serve = _plan_serve_fn(torch, engine_mod, bound, bound.shape[1])
        serve()                                     # warm
        n, by_kind, s, msgs = _profiled_serve(
            torch, serve, (f"{fmt}_kernel", f"{fmt}src"), f"kernel_{fmt}")
        out.append({"workload": label, "format": fmt,
                    "kernel_records": n, "waves": s["waves"],
                    "lost": s["waves"] - n, "device_ms_by_kind": by_kind,
                    "kineto_lines": msgs})
        del bound, serve
    emit({"phase": "profile_in_process", "runs": out,
          "records": sum(r["kernel_records"] for r in out),
          "expected": sum(r["waves"] for r in out),
          "kineto_log_level": os.environ.get("KINETO_LOG_LEVEL"),
          "kineto_lines": [m for r in out for m in r["kineto_lines"]]})


def profile_child(path) -> int:
    """The fresh process of ``phase_profile``: for each job saved at
    ``path``, serve its operand with phase 3's trace (warm, plain, then
    profiled) and print one JSON line of the plain and profiled
    summaries, the device ms by kind of the fullest profiled run and each
    run's count of the format's kernel records."""
    import torch
    sys.path.insert(0, SRC)
    from repro_torch.serve import engine as engine_mod
    for job in torch.load(path, weights_only=False):
        keys = tuple(job["kernel_keys"])
        serve = _plan_serve_fn(torch, engine_mod, job["operand"], job["k"])
        serve()                 # the operand's first launches in a process
        s = serve()
        seen, best = [], None
        for _ in range(PROFILE_TRIES):
            n_kernels, by_kind, s_prof, _ = _profiled_serve(
                torch, serve, keys, f"kernel_{job['fmt']}")
            seen.append(n_kernels)
            if best is None or n_kernels > best[0]:
                best = (n_kernels, by_kind, s_prof)
            if n_kernels == s_prof["waves"]:
                break
        print(json.dumps({"plain": s, "profiled": best[2],
                          "device_ms_by_kind": best[1], "seen": seen}),
              flush=True)
    return 0


def _time_ms(torch, fn, flush, reps=30, lead=1):
    """Median ms of ``fn`` over CUDA events, L2 flushed before each run
    (``lead`` times: more work queued ahead of a short kernel whose
    wrapper takes the host longer than one flush takes the card)."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        for _ in range(lead):
            flush.zero_()   # evicts L2, and keeps the card busy while the
        s = torch.cuda.Event(enable_timing=True)   # host enqueues fn
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _incrs_bound(torch, prep, n):
    """The least time of C = A @ B at N columns: each input read once (idx
    in full, since the pad slots must be read to be skipped; val of the
    live slots; the rows of B that a live slot references), C's M rows
    written once; 2 flops per live slot and column at the f32 rate
    outside the tensor cores. Returns (bytes, flops, ms by bytes, ms by
    operations, live slots)."""
    idx = prep.idx
    live = (idx >= 0) & (idx < prep.section)
    n_live = int(live.sum())
    rows_b = torch.unique((idx.long() + torch.arange(
        prep.n_sections, device=idx.device).view(1, -1, 1) *
        prep.section)[live])
    nbytes = idx.numel() * 4 + n_live * 4 + rows_b.numel() * n * 4 + \
        prep.shape[0] * n * 4
    flops = 2 * n_live * n
    return (nbytes, flops, nbytes / HBM_BYTES_PER_S * 1e3,
            flops / F32_FLOP_PER_S * 1e3, n_live)


# Where the three orders are timed: every Table II operand at N = 512,
# incrs-docword also at 128 and 640.
TIME_CASES = [(name, 512) for name in TABLE2] + \
    [("incrs-docword", 128), ("incrs-docword", 640)]
# The pipelined geometries timed beside the one the wrapper picks
# (incrs-docword, N = 512), as changes to pipelined_geometry's arguments:
# no cluster (the design without multicast) and a cluster of 4; 16 and 31
# consumer warps (one row each); one column per lane (32 KB ring stages),
# and that with 8 warps, two CTAs an SM.
PIPE_SWEEP = [{}, {"cluster": 1}, {"cluster": 4}, {"warps": 16},
              {"warps": 31}, {"cols_per_lane": 1},
              {"cols_per_lane": 1, "warps": 8}]


def _pipe_sweep(torch, K, prep, b, n, flush, want):
    """The pipelined kernel at each geometry of PIPE_SWEEP, each run
    bitwise equal to expand."""
    out = []
    mp, _, smax = prep.idx.shape
    for change in PIPE_SWEEP:
        try:
            g = K.pipelined_geometry(mp, n, smax, prep.section, **change)
        except ValueError:          # does not fit one SM's shared memory
            continue

        def fn(g=g):
            return K._launch("incrs_spmm_pipelined", prep.idx, prep.val, b,
                             prep.section, geometry=g)
        check(torch.equal(fn(), want), f"pipelined at {g} equal to expand")
        out.append({**g._asdict(), "ms": _time_ms(torch, fn, flush)})
    emit({"phase": "pipe_geometries", "workload": "incrs-docword", "n": n,
          "picked": K.launch_geometry("incrs_spmm_pipelined", n, smax,
                                      prep.section, m=mp)._asdict(),
          "geometries": out})


def phase_times(torch, K, ops, table2, errs_512, launches):
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for wl_name, n in TIME_CASES:
        inc = table2[wl_name]
        prep = ops.prepare_incrs(inc, device="cuda")
        kp = prep.n_sections * prep.section
        b = torch.zeros(kp, n, device="cuda")
        b[:inc.shape[1]] = torch.randn(inc.shape[1], n, generator=gen,
                                       device="cuda")
        crs = inc.crs
        a_csr = torch.sparse_csr_tensor(
            torch.from_numpy(crs.row_ptr), torch.from_numpy(
                crs.col_idx.astype(np.int64)),
            torch.from_numpy(crs.values), size=crs.shape,
            check_invariants=True).to("cuda")
        b_k = b[:inc.shape[1]].contiguous()
        library_ms = _time_ms(torch, lambda: torch.sparse.mm(a_csr, b_k),
                              flush)
        nbytes, flops, t_bytes, t_ops, n_live = _incrs_bound(torch, prep, n)
        bound_ms = max(t_bytes, t_ops)
        args = (prep.idx, prep.val, b)
        kw = dict(section=prep.section, bm=128, bn=n)
        ms = {}
        for name, _, _ in KERNELS:
            fn = getattr(K, name)
            ms[name] = _time_ms(torch, lambda: fn(*args, **kw), flush)
        mp, n_sec, _ = prep.idx.shape
        emit({"phase": "times", "workload": wl_name, "n": n,
              "stripes": list(prep.idx.shape),
              "live_per_row_section": n_live / (mp * n_sec),
              "bytes": nbytes, "flops": flops, "bound_bytes_ms": t_bytes,
              "bound_ops_ms": t_ops, "bound_ms": bound_ms,
              "library": "torch.sparse.mm (CSR)", "library_ms": library_ms,
              "ms": ms})
        if (wl_name, n) != ("incrs-docword", 512):
            continue
        _pipe_sweep(torch, K, prep, b, n, flush, K.incrs_spmm(*args, **kw))
        for name, _, replaces in KERNELS:
            fn = getattr(K, name)
            ms_warm = _time_ms(torch, lambda: fn(*args, **kw),
                               torch.empty(0, device="cuda"))
            plain_ms = _time_ms(torch, lambda: K.plain(name, *args, **kw),
                                flush, reps=20)
            rows.append({"name": name, "route": "cuda", "source": SOURCE,
                         "replaces": replaces, "launches": launches[name],
                         "max_abs_err": errs_512[name], "ms": ms[name],
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations",
                         "library_ms": library_ms, "ms_l2_warm": ms_warm})
    return rows


# ----------------------------------------------------------------------
# The tuning layer: sweeps of the InCRS orders and of index matching, the
# picks they feed, the launch check's occupancy rule and a refused swap.
AUTOTUNE_CASES = [(name, 512) for name in TABLE2] + \
    [("incrs-docword", n) for n in (64, 128, 384, 640)]
AUTOTUNE_REPS = 10
AUTOTUNE_TOL = 1e-4      # max|candidate - plain| <= AUTOTUNE_TOL * max|C|
AUTOTUNE_ENGINE_WAVES = 3


class _Recorder:
    """Every InCRS launch's (kernel, geometry) while active, recorded at
    the wrapper's one launch site."""

    def __init__(self, K):
        self.K, self.seen, self._real = K, [], K._launch

    def __enter__(self):
        real, seen = self._real, self.seen

        def record(name, idx, val, b, section, geometry=None):
            out = real(name, idx, val, b, section, geometry)
            seen.append((name, None if geometry is None
                         else tuple(geometry)))
            return out
        self.K._launch = record
        return self

    def __exit__(self, *exc):
        self.K._launch = self._real


def sweep_incrs(torch, A, idx, val, b, section, label, extra=None):
    """``autotune.tune`` on stripes (idx, val) times ``b`` (K x N) with
    every candidate measured: each candidate's C bitwise equal to
    expand's at its own geometry and within AUTOTUNE_TOL of the plain
    version; the cost model's cold pick timed at its own geometry by the
    same protocol; the sweep's record printed. Returns the winner."""
    n = b.shape[1]
    bn = A.ops.default_bn(n)
    kp = idx.shape[1] * section
    bp = torch.nn.functional.pad(b, (0, -(-n // bn) * bn - n,
                                     0, kp - b.shape[0])).contiguous()
    pick = A.autotune.model_pick_variant(
        A.K._resolve_row_tile(idx.shape[0], 128)[1], bp.shape[1],
        n_sections=idx.shape[1], smax=idx.shape[2], section=section)
    pick_us = A.autotune._measure_us(
        lambda: getattr(A.K, RAN_BY[pick])(idx, val, bp, section=section,
                                           bn=bn),
        AUTOTUNE_REPS, idx.device, A.autotune._flush_buffer(idx.device))
    want = A.K.incrs_spmm(idx, val, bp, section=section, bn=bn)
    ref = A.K.plain("incrs_spmm", idx, val, bp, section=section, bn=bn)
    scale = max(float(ref.abs().max()), 1e-30)
    errs = []

    def verify(variant, geo, out):
        check(torch.equal(out, want), f"autotune {label}: {variant} at "
              f"{tuple(geo)} bitwise equal to expand")
        err = float((out - ref).abs().max())
        check(err <= AUTOTUNE_TOL * scale, f"autotune {label}: {variant} "
              f"at {tuple(geo)} off its plain version by {err}")
        errs.append(err)
    del b
    cfg = A.autotune.tune(idx, val, bp[:, :n], section=section,
                          reps=AUTOTUNE_REPS, top_k=None, verify=verify)
    rec = A.autotune.LAST_SWEEP
    if rec.cache_hit:       # stripes of a shape swept before: its winner
        verify(cfg.variant, cfg.geometry, getattr(  # on these stripes
            A.K, RAN_BY[cfg.variant])(idx, val, bp, section=section, bn=bn,
                                      geometry=cfg.launch_geometry))
    check(rec.cache_hit or (len(rec.measured) >= 3 and
                            {m["variant"] for m in rec.measured} ==
                            set(RAN_BY)),
          f"autotune {label}: every order measured, {rec.measured}")
    emit({"phase": "autotune", "workload": label, "n": n,
          "n_padded": bp.shape[1], "stripes": list(idx.shape),
          "section": section, **(extra or {}), **rec.to_json(),
          "overhead_factor": cfg.overhead_factor, "model_pick": pick,
          "model_pick_us": pick_us,
          "model_pick_over_winner": pick_us / cfg.measured_us,
          "max_abs_err": max(errs), "tolerance":
              f"bitwise equal to expand; max|C - plain| <= {AUTOTUNE_TOL}"
              f" * max|C|"})
    return cfg


def _auto_launch(torch, A, op, b, label, want):
    """One ``op(b)`` call, counters zeroed just before: exactly one launch
    of ``want`` = (kernel, geometry) and no other kernel."""
    A.K.reset_launches()
    with _Recorder(A.K) as rec:
        op(b)
        torch.cuda.synchronize()
    launches = {k: v for k, v in A.K.LAUNCHES.items() if v}
    check(rec.seen == [want] and launches == {want[0]: 1},
          f"autotune {label}: launched {rec.seen} ({launches}), want "
          f"{want}")


def _refused_swap(torch, A, inc, prep):
    """An engine pinned to reuse on incrs-docword; a swap to one-section
    stripes of the same logical shape whose first row holds 5,000 slots
    (a reuse CTA would stage past an SM's shared memory) must raise
    KernelConfigError, and the old operand keeps serving."""
    m, k = prep.shape
    section = -(-k // 256) * 256
    idx = torch.full((prep.padded_rows, 1, 5000), -1, dtype=torch.int32,
                     device="cuda")
    idx[0, 0] = torch.arange(5000, dtype=torch.int32, device="cuda")
    bad = A.ops.PreparedOperand(idx, torch.ones(idx.shape, device="cuda"),
                                (m, k), section)
    eng = A.E.SpMMEngine(prep, max_wave_cols=512, variant="reuse",
                         device="cuda")
    try:
        eng.swap_pattern(bad)
        refused = None
    except A.L.KernelConfigError as exc:
        refused = str(exc)
    check(refused is not None and eng.prep is prep and
          eng.stats["pattern_swaps"] == 0,
          f"autotune: a swap the check refuses raised and kept the old "
          f"operand ({refused})")
    panel = np.random.default_rng(9).normal(size=(k, 200)).astype(np.float32)
    req = A.E.SpMMRequest(0, panel)
    eng.submit(req)
    eng.run()
    want = inc.crs.to_dense().astype(np.float64) @ panel.astype(np.float64)
    err = float(np.abs(req.out - want).max())
    check(req.done and err <= SERVE_TOL * float(np.abs(want).max()),
          f"autotune: the old operand served after the refused swap, "
          f"{err}")
    return refused


def _occupancy_cases(stripes, docword4):
    """(wrapper, shape) of every instance of every wrapper at the shapes
    the port runs: ``stripes`` the prepped (M, n_sections, smax) of two
    Table II operands, ``docword4`` mesh-docword4's section stripes (rows
    padded to 8) and its round stripes at R = 128."""
    out = []
    for name in ("incrs-docword", "incrs-belcastro"):
        m, n_sec, smax = stripes[name]
        base = dict(m=m, n=512, n_sections=n_sec, smax=smax, section=256)
        out += [(k, base) for k in INCRS_KERNELS]
        out += [("incrs_spmm", dict(base, rows=r)) for r in (1, 2, 4)]
        out += [("incrs_spmm", dict(base, n=510))]       # the scalar form
        out += [("incrs_spmm_reuse", dict(base, n=n)) for n in (128, 256)]
        out += [("incrs_spmm_pipelined", dict(base, cluster=1,
                                              cols_per_lane=cpl, warps=8))
                for cpl in (1, 2)]
    out += [(k, dict(m=24576, n=512, n_sections=24, smax=51, section=256))
            for k in INCRS_KERNELS]
    (m8, n_sec, smax), (mp, n_rounds, rmax) = docword4
    out += [("incrs_gather", dict(m=m8, n_sections=n_sec, smax=smax,
                                  section=256, instance=i))
            for i in ("tile", "general")]
    for k in ("index_match_spmm", "spgemm_condense"):
        out += [(k, dict(m=mp, n=mp, n_rounds=n_rounds, rmax_a=rmax,
                         rmax_b=rmax, rounds=128, instance=i))
                for i in ("ring", "general")]
    out += [("spgemm_merge", dict(plane=1500 * 1500, n_rounds=n_rounds,
                                  instance=i)) for i in ("ring", "general")]
    for dt in ("float32", "bfloat16"):
        out += [("dense_mm", dict(m=24576, n=512, k=6144, dtype=dt)),
                ("dense_mm", dict(m=128, n=512, k=6144, dtype=dt)),
                ("dense_mm", dict(m=700, n=500, k=1203, dtype=dt)),
                ("bsr_spmm", dict(n_block_rows=192, bm=128, bk=128, n=512,
                                  nnz=2304, dtype=dt)),
                ("bsr_spmm", dict(n_block_rows=14, bm=50, bk=50, n=512,
                                  nnz=300, dtype=dt)),
                ("flash_attention", dict(batch=2, sq=8192, sk=8192, kv=1,
                                         g=48, hd=128, dtype=dt))]
    out += [("flash_attention", dict(batch=1, sq=2048, sk=2048, kv=2, g=4,
                                     hd=256, dtype="bfloat16"))]
    return out


def phase_autotune(torch, A, table2, crs4):
    """The tuning layer on the card (see the module docstring)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    winners = {}
    for wl_name, n in AUTOTUNE_CASES:
        inc = table2[wl_name]
        prep = A.ops.prepare_incrs(inc, device="cuda")
        b = torch.randn(inc.shape[1], n, generator=gen, device="cuda")
        # cold: auto launches the cost model's order at its own geometry
        pick = A.autotune.model_pick_variant(
            prep.padded_rows, -(-n // A.ops.default_bn(n)) *
            A.ops.default_bn(n), n_sections=prep.n_sections,
            smax=prep.idx.shape[2], section=prep.section)
        _auto_launch(torch, A, lambda b: A.ops.spmm(prep, b), b,
                     f"{wl_name} N={n} cold", (RAN_BY[pick], None))
        cfg = sweep_incrs(torch, A, prep.idx, prep.val, b, prep.section,
                          wl_name)
        winners[(wl_name, n)] = cfg
        _auto_launch(torch, A, lambda b: A.ops.spmm(prep, b), b,
                     f"{wl_name} N={n} tuned",
                     (RAN_BY[cfg.variant], cfg.geometry))
        del b
    # a plan of incrs-docword under tune="cache" and engines over it and
    # over the prepped operand: the N = 512 winner, one launch a wave
    inc = table2["incrs-docword"]
    cfg = winners[("incrs-docword", 512)]
    want = (RAN_BY[cfg.variant], cfg.geometry)
    a = inc.crs.to_dense()
    plan = A.api.plan(A.api.SparseSpec("incrs", mask=a.T != 0),
                      rhs_shape=(a.shape[1], 512), tune="cache",
                      device="cuda")
    check(plan.tuned == cfg, f"autotune: plan(tune='cache') attached "
          f"{plan.tuned}, the sweep's winner is {cfg}")
    bound = plan.bind(plan.pack(np.ascontiguousarray(a.T)), device="cuda")
    b = torch.randn(a.shape[1], 512, generator=gen, device="cuda")
    _auto_launch(torch, A, bound, b, "incrs-docword plan N=512", want)
    panels = [np.random.default_rng(20 + i).normal(
        size=(a.shape[1], 512)).astype(np.float32)
        for i in range(AUTOTUNE_ENGINE_WAVES)]
    ref = a.astype(np.float64) @ np.concatenate(panels, 1).astype(np.float64)
    engines = {}
    for label, op in (("plan", bound),
                      ("InCRS", A.ops.prepare_incrs(inc, device="cuda"))):
        eng = A.E.SpMMEngine(op, max_wave_cols=512, device="cuda")
        A.K.reset_launches()
        with _Recorder(A.K) as rec:
            for i, p in enumerate(panels):
                eng.submit(A.E.SpMMRequest(i, p))
            done = {r.rid: r for r in eng.run()}
        launches = {k: v for k, v in A.K.LAUNCHES.items() if v}
        check(eng.stats["waves"] == len(panels) and
              rec.seen == [want] * len(panels) and
              launches == {want[0]: len(panels)},
              f"autotune engine over the {label}: {rec.seen} in "
              f"{eng.stats['waves']} waves, want {want} each")
        for i, p in enumerate(panels):
            exp = ref[:, i * 512:(i + 1) * 512]
            err = float(np.abs(done[i].out - exp).max())
            check(err <= SERVE_TOL * float(np.abs(exp).max()),
                  f"autotune engine over the {label}: request {i} off "
                  f"float64 by {err}")
        engines[label] = {"waves": eng.stats["waves"], "launches": launches,
                          "cost_model": eng.stats_summary()["cost_model"]}
    del bound, plan
    # index matching at mesh-docword4
    c64 = _oracle(torch, crs4)
    scale = float(c64.abs().max())

    def verify(rounds, geo, out):
        err = float((out[:crs4.shape[0], :crs4.shape[0]].double() - c64)
                    .abs().max())
        check(err <= SERVE_TOL * scale, f"autotune mesh-docword4 R={rounds}"
              f" {geo[0]}: off float64 by {err}")
    mcfg = A.autotune.tune_index_match(crs4, crs4, device="cuda",
                                       reps=AUTOTUNE_REPS, top_k=None,
                                       verify=verify)
    rec = A.autotune.LAST_SWEEP
    emit({"phase": "autotune", "workload": "mesh-docword4",
          "kernel": "index_match_spmm", "prep": {
              r: _prep_shape(A.ops, crs4, r)
              for r in A.autotune.MATCHED_ROUNDS}, **rec.to_json(),
          "overhead_factor": mcfg.overhead_factor})
    A.IM.reset_launches()
    out = A.ops.spmm(crs4, crs4, variant="reference", device="cuda")
    torch.cuda.synchronize()
    inst = mcfg.launch_geometry.instance
    check(A.IM.LAUNCHES["index_match_spmm"] == 1 and
          A.IM.INSTANCE_LAUNCHES[f"index_match_spmm/{inst}"] == 1,
          f"autotune: ops.spmm at mesh-docword4 launched the winner "
          f"({inst}, R={mcfg.rounds}) once: {A.IM.INSTANCE_LAUNCHES}")
    err = float((out.double() - c64).abs().max())
    check(err <= SERVE_TOL * scale, f"autotune: the tuned index matching "
          f"off float64 by {err}")
    del out, c64
    # the occupancy rule on every instance of every wrapper
    occ = []
    shapes4 = (tuple(A.ops.prepare_incrs(A.InCRS.from_crs(crs4),
                                         pad_rows_to=8,
                                         device="cuda").idx.shape),
               _prep_shape(A.ops, crs4, 128))
    stripes2 = {n: tuple(A.ops.prepare_incrs(table2[n], device="cuda")
                         .idx.shape) for n in ("incrs-docword",
                                               "incrs-belcastro")}
    for kernel, shape in _occupancy_cases(stripes2, shapes4):
        shape = {k: getattr(torch, v) if k == "dtype" else v
                 for k, v in shape.items()}
        rep = A.L.launch_report(kernel, on_card=True, **shape)
        line = {"kernel": kernel, "shape": {k: str(v) for k, v in
                                            shape.items()},
                "instance": str(getattr(rep.launch.geometry, "instance",
                                        getattr(rep.launch.geometry,
                                                "route", "")))
                if rep.launch else None,
                "registers": rep.registers, "spill_bytes": rep.spill_bytes,
                "assumed_ctas": rep.assumed_ctas,
                "card_ctas": rep.card_ctas,
                "violations": [v.format() for v in rep.violations]}
        occ.append(line)
        check(not rep.violations and rep.card_ctas is not None and
              rep.card_ctas >= max(1, rep.assumed_ctas),
              f"autotune occupancy of {kernel} at {shape}: {line}")
    refused = _refused_swap(torch, A, table2["incrs-docword"],
                            A.ops.prepare_incrs(table2["incrs-docword"],
                                                device="cuda"))
    emit({"phase": "autotune_checks", "engines": engines,
          "occupancy": occ, "refused_swap": refused,
          "cache": A.autotune.cache_path(),
          "seconds": time.perf_counter() - t_phase})
    return winners


# ----------------------------------------------------------------------
# The sparse × sparse path: C = A @ Bt.T through index matching,
# condense + merge, and densify (gather, then the fused InCRS SpMM).
def _counters(P):
    return {**P.K.LAUNCHES, **P.G.LAUNCHES, **P.IM.LAUNCHES, **P.SK.LAUNCHES}


def _reset_counters(P):
    for mod in (P.K, P.G, P.IM, P.SK):
        mod.reset_launches()


def _instances(P):
    return {**P.IM.INSTANCE_LAUNCHES, **P.SK.MERGE_INSTANCE_LAUNCHES,
            **P.G.INSTANCE_LAUNCHES}


# The instances of the second designs, each of which must run on the
# spgemm path; and the caching allocator's counters read around each call
# of that path (cudaMalloc calls, cudaFree calls, retries after a failed
# cudaMalloc that first frees the cache).
NEW_INSTANCES = ("index_match_spmm/ring", "spgemm_condense/ring",
                 "spgemm_merge/ring", "incrs_gather/tile")
ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
               "num_sync_all_streams")


def _spgemm_edges():
    """(A, Bt) dense pairs that reach each masked edge of the kernels."""
    from repro_torch.analysis import cases
    return cases.edge_spgemm()


def _match_geo(P, ai, bi, rounds, kernel, **kw):
    m, n_rounds, rmax_a = ai.shape
    return P.IM.match_geometry(m, bi.shape[0], n_rounds, rmax_a,
                               bi.shape[2], rounds, kernel, **kw)


def _check_match(torch, P, ai, av, bi, bv, *, rounds, bm, label):
    """Index matching against its plain version, its repeat and the other
    instance (``match_geometry``: the ring and the general kernel);
    condense against the plain per-round partials and its repeat; merge
    against plain merge and condense + merge against index matching, bit
    for bit. Frees the stripes. Returns the errors and the instances."""
    kw = dict(rounds=rounds, bm=bm, bn=bm)
    geo = _match_geo(P, ai, bi, rounds, "index_match_spmm")
    other = _match_geo(P, ai, bi, rounds, "index_match_spmm",
                       instance=({"ring": "general", "general": "ring"}
                                 [geo.instance]))
    before = _counters(P)
    fused = P.IM.index_match_spmm(ai, av, bi, bv, **kw)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _counters(P).items()}
    again = P.IM.index_match_spmm(ai, av, bi, bv, **kw)
    cross = P.IM.index_match_spmm(ai, av, bi, bv, geometry=other, **kw)
    torch.cuda.synchronize()
    check(torch.equal(again, fused),
          f"index_match bitwise equal to its repeat on {label}")
    check(torch.equal(cross, fused), f"index_match {geo.instance} bitwise "
          f"equal to {other.instance} on {label}")
    del again, cross
    ref = P.IM.plain(ai, av, bi, bv, **kw)
    scale = max(float(ref.abs().max()), 1e-30)
    err7 = float((fused - ref).abs().max())
    check(bool(torch.isfinite(fused).all()), f"index_match finite on {label}")
    check(err7 <= KERNEL_TOL * scale, f"index_match on {label}: max|err| "
          f"{err7} > {KERNEL_TOL} * {scale}")
    del ref
    before_cm = _counters(P)
    stripes = P.SK.spgemm_condense(ai, av, bi, bv, **kw)
    merged = P.SK.spgemm_merge(stripes, bm=bm, bn=bm)
    torch.cuda.synchronize()
    moved.update({k: v - before_cm[k] for k, v in _counters(P).items()
                  if k != "index_match_spmm"})
    check(torch.equal(merged, fused),
          f"condense + merge bitwise equal to index_match on {label}")
    check(torch.equal(P.SK.spgemm_condense(ai, av, bi, bv, **kw), stripes),
          f"condense bitwise equal to its repeat on {label}")
    check(torch.equal(P.SK.plain_merge(stripes, bm=bm, bn=bm), merged),
          f"merge bitwise equal to its plain version on {label}")
    n_rounds, sm, sn = stripes.shape
    merge_geo = P.SK.merge_geometry(sm * sn, n_rounds)
    general = P.SK.merge_geometry(sm * sn, n_rounds, instance="general")
    check(torch.equal(P.SK.spgemm_merge(stripes, bm=bm, bn=bm,
                                        geometry=general), merged),
          f"merge {merge_geo.instance} bitwise equal to general on {label}")
    err8 = 0.0
    for t in range(stripes.shape[0]):
        part = P.IM.round_partial(ai, av, bi, bv, t, rounds)
        err8 = max(err8, float((stripes[t] - part).abs().max()))
    check(err8 <= KERNEL_TOL * scale, f"condense on {label}: max|err| "
          f"{err8} > {KERNEL_TOL} * {scale}")
    check(all(moved[k] == 1 for k in ("index_match_spmm", "spgemm_condense",
                                      "spgemm_merge")),
          f"index_match, condense and merge counted their launch on {label}")
    del stripes, merged
    cond = _match_geo(P, ai, bi, rounds, "spgemm_condense")
    return ({"index_match_spmm": err7, "spgemm_condense": err8,
             "spgemm_merge": 0.0},
            {"index_match_spmm": geo.instance,
             "spgemm_condense": cond.instance,
             "spgemm_merge": merge_geo.instance})


def _check_gather(torch, P, inc, label):
    """The gather against its plain version and its repeat, and the
    instance the rule picks against the other (the first design), bit for
    bit. Returns the error and the instance."""
    prep = P.ops.prepare_incrs(inc, pad_rows_to=8, device="cuda")
    geo = P.G.gather_geometry(*prep.idx.shape, prep.section)
    other = P.G.gather_geometry(*prep.idx.shape, prep.section,
                                instance="general")
    before = P.G.LAUNCHES["incrs_gather"]
    out = P.G.incrs_gather(prep.idx, prep.val, section=prep.section, bm=8)
    torch.cuda.synchronize()
    check(P.G.LAUNCHES["incrs_gather"] == before + 1,
          f"incrs_gather counted its launch on {label}")
    ref = P.G.plain(prep.idx, prep.val, section=prep.section, bm=8)
    check(torch.equal(out, ref),
          f"incrs_gather bitwise equal to its plain version on {label}")
    again = P.G.incrs_gather(prep.idx, prep.val, section=prep.section, bm=8)
    first = P.G.incrs_gather(prep.idx, prep.val, section=prep.section, bm=8,
                             geometry=other)
    check(torch.equal(again, out),
          f"incrs_gather bitwise equal to its repeat on {label}")
    check(torch.equal(first, out), f"incrs_gather {geo.instance} bitwise "
          f"equal to {other.instance} on {label}")
    return float((out - ref).abs().max()), geo.instance


def phase_spgemm_kernels(torch, P, table4):
    results = []
    errs_docword = None
    for wl_name, crs in table4.items():
        for rounds in (128, 32) if wl_name == "mesh-docword4" else (128,):
            ai, av = P.ops.prep_rounds(crs, rounds, device="cuda")
            bi, bv = P.ops.prep_rounds(crs, rounds, device="cuda")
            errs, inst = _check_match(torch, P, ai, av, bi, bv,
                                      rounds=rounds, bm=128,
                                      label=f"{wl_name} R={rounds}")
            if wl_name == "mesh-docword4" and rounds == 128:
                errs_docword = errs
            if rounds == 128:
                errs["incrs_gather"], inst["incrs_gather"] = _check_gather(
                    torch, P, P.InCRS.from_crs(crs), wl_name)
            results.append({"operand": wl_name, "rounds": rounds,
                            "prep": list(ai.shape), "instances": inst,
                            "max_abs_err": errs})
            del ai, av, bi, bv
    for label, (a, bt) in _spgemm_edges().items():
        ca, cb = P.CRS.from_dense(a), P.CRS.from_dense(bt)
        ai, av = P.ops.prep_rounds(ca, 128, pad_rows_to=8, device="cuda")
        bi, bv = P.ops.prep_rounds(cb, 128, pad_rows_to=8, device="cuda")
        ai, av, bi, bv = P.ops.pad_common_rmax(ai, av, bi, bv)
        errs, inst = _check_match(torch, P, ai, av, bi, bv, rounds=128,
                                  bm=8, label=label)
        errs["incrs_gather"], inst["incrs_gather"] = _check_gather(
            torch, P, P.InCRS.from_dense(a), label)
        results.append({"operand": label, "a": list(a.shape),
                        "bt": list(bt.shape), "prep": list(ai.shape),
                        "instances": inst, "max_abs_err": errs})
    emit({"phase": "spgemm_kernels",
          "tolerance": f"max|kernel-plain| <= {KERNEL_TOL} * max|C|; "
                       f"merge, condense+merge, the two instances of index "
                       f"matching, of merge and of the gather, every "
                       f"repeat and the gather bitwise",
          "checks": results})
    return errs_docword


def _oracle(torch, crs):
    """float64 C = A @ A.T on the host (scipy.sparse), moved to the card
    for the comparisons."""
    import scipy.sparse as sp
    a = sp.csr_matrix((crs.values.astype(np.float64), crs.col_idx,
                       crs.row_ptr), shape=crs.shape)
    return torch.from_numpy((a @ a.T).toarray()).to("cuda")


def _prep_shape(ops, crs, rounds, pad=128):
    """The shape ``ops.prep_rounds`` gives, without prepping."""
    counts = ops.round_groups(crs, rounds)[1]
    return [-(-crs.shape[0] // pad) * pad, counts.shape[1],
            max(1, int(counts.max(initial=0)))]


def _matched_pairs(crs):
    """Products of C = A @ A.T: sum over columns of (non-zeros in it)^2."""
    c = np.bincount(crs.col_idx, minlength=crs.shape[1]).astype(np.int64)
    return int((c * c).sum())


def _engine_launches(P, variant, crs, rounds):
    """The launches ``ops.spmm(crs, crs, variant=...)`` implies: ``auto``
    those of the engine the cost model picks at ``rounds``; densify's
    InCRS product one of the order ``auto`` picks for it."""
    if variant == "auto":
        variant = P.autotune.pick_spgemm_engine(
            P.mesh_sim.spgemm_cost_for(crs, crs, rounds=rounds))
    out = dict(ENGINE_LAUNCHES[variant])
    if variant == "densify":
        prep = P.ops.prepare_incrs(P.ops._incrs_of(crs), device="cuda")
        out[auto_kernel(P.ops, prep, crs.shape[0])] = 1
    return variant, out


def phase_spgemm(torch, P, table4):
    """The path, driven with every counter at 0 just before it. Returns
    the launches and each call's wall by (workload, entry, engine,
    rounds)."""
    _reset_counters(P)
    walls = {}
    for wl_name, crs in table4.items():
        ref = _oracle(torch, crs)
        scale = float(ref.abs().max())
        m = crs.shape[0]
        pairs = _matched_pairs(crs)
        calls = [(v, 128, "ops.spmm") for v in
                 ("reference", "condense_merge", "densify", "auto")]
        calls += [("auto", 128, "ops.spmm(InCRS rhs)"),
                  ("reference", 32, "ops.spmm")]
        mp, n_rounds, _ = _prep_shape(P.ops, crs, 32)
        if 4 * n_rounds * mp * mp < STRIPES_MAX_BYTES:
            calls.append(("condense_merge", 32, "ops.spmm"))
        calls.append(("condense_merge", 128, "spgemm.spgemm"))
        for variant, rounds, entry in calls:
            before = _counters(P)
            before_inst = _instances(P)
            mem0 = torch.cuda.memory_stats()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            cpu0 = time.process_time()
            t0 = time.perf_counter()
            ev0.record()
            if entry == "spgemm.spgemm":
                out, est = P.spgemm.spgemm(crs, crs, rounds=rounds)
            elif entry == "ops.spmm(InCRS rhs)":
                out = P.ops.spmm(crs, P.InCRS.from_crs(crs), rounds=rounds)
            else:
                out = P.ops.spmm(crs, crs, variant=variant, rounds=rounds,
                                 device="cuda")
            ev1.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            cpu_ms = (time.process_time() - cpu0) * 1e3
            wall_ms = (t2 - t0) * 1e3
            mem1 = torch.cuda.memory_stats()
            moved = {k: v - before[k] for k, v in _counters(P).items()
                     if v != before[k]}
            inst = {k: v - before_inst[k]
                    for k, v in _instances(P).items()
                    if v != before_inst[k]}
            picked, expect = _engine_launches(P, variant, crs, rounds)
            check(moved == expect,
                  f"{wl_name} {entry} {variant} R={rounds}: launches {moved}"
                  f" are {expect}")
            walls[(wl_name, entry, variant, rounds)] = (wall_ms, picked)
            line = {"phase": "spgemm", "workload": wl_name, "entry": entry,
                    "engine": variant, "picked": picked, "rounds": rounds,
                    "shape": [m, m], "nnz": crs.nnz, "matched_pairs": pairs,
                    "prep": _prep_shape(P.ops, crs, rounds), "launches": moved,
                    "instances": inst, "wall_ms": wall_ms,
                    # the wall split: the host until the call returned
                    # (its own waits on the card included), the card from
                    # before the call to its last launch's end, the host's
                    # wait for the card after the return, and the CPU time
                    # the process got (far under the wall: it was not
                    # running)
                    "host_ms": (t1 - t0) * 1e3,
                    "device_span_ms": ev0.elapsed_time(ev1),
                    "sync_wait_ms": (t2 - t1) * 1e3, "cpu_ms": cpu_ms,
                    "alloc": {k: mem1.get(k, 0) - mem0.get(k, 0) for k in
                              ALLOC_STATS}}
            if entry == "spgemm.spgemm":
                sparse_out = est < P.spgemm.SPARSE_OUTPUT_THRESHOLD
                check(isinstance(out, P.CRS) == sparse_out,
                      f"{wl_name}: spgemm returns CRS iff estimate {est} < "
                      f"{P.spgemm.SPARSE_OUTPUT_THRESHOLD}")
                line.update(estimate=est, output=type(out).__name__)
                if sparse_out:
                    out = torch.from_numpy(out.to_dense()).to("cuda")
            check(tuple(out.shape) == (m, m) and
                  bool(torch.isfinite(out).all()),
                  f"{wl_name} {entry} {variant}: finite ({m}, {m})")
            err = float((out.double() - ref).abs().max())
            check(err <= SERVE_TOL * scale,
                  f"{wl_name} {entry} {variant} R={rounds}: max|err| {err} "
                  f"> {SERVE_TOL} * {scale}")
            line["max_rel_err"] = err / scale
            emit(line)
            del out
        del ref
    launches = _counters(P)
    for name, _, _ in SPGEMM_KERNELS:
        check(launches[name] > 0, f"{name} ran on the spgemm path")
    instances = _instances(P)
    for name in NEW_INSTANCES:
        check(instances[name] > 0, f"{name} ran on the spgemm path")
    emit({"phase": "spgemm_instances", "launches": instances})
    return launches, walls


def phase_spgemm_auto(P, table4, walls):
    """At each Table IV workload: the engine ``auto`` picked at R = 128,
    each engine's predicted µs, and auto's wall against the fastest
    engine's wall in phase spgemm (a ratio, printed, not gated)."""
    for wl_name, crs in table4.items():
        cost = P.mesh_sim.spgemm_cost_for(crs, crs, rounds=128)
        auto_wall, picked = walls[(wl_name, "ops.spmm", "auto", 128)]
        by_engine = {v: walls[(wl_name, "ops.spmm", v, 128)][0]
                     for v in ("reference", "condense_merge", "densify")}
        fastest = min(by_engine, key=by_engine.get)
        emit({"phase": "spgemm_auto", "workload": wl_name, "picked": picked,
              "predicted_us": cost.predicted_us(),
              "auto_wall_ms": auto_wall, "walls_ms": by_engine,
              "fastest": fastest,
              "auto_over_fastest": auto_wall / by_engine[fastest]})


def phase_spgemm_alloc(torch, P, table4):
    """The sequence behind one slow call of an earlier run (mesh-bates,
    condense + merge at R = 32, 11 s of wall after mesh-mks4's 13.5 GB of
    stripes): mesh-mks4's condense + merge at R = 128, then mesh-bates' at
    R = 32, with the allocator's cache warm and after emptying it, each
    call's wall, CPU time and allocator counters; and one fresh cudaMalloc
    of bates' 3.6 GB stripe array alone."""
    lines = []
    for cache in ("warm", "emptied", "warm"):
        for wl_name, rounds in (("mesh-mks4", 128), ("mesh-bates", 32)):
            if cache == "emptied":
                torch.cuda.empty_cache()
            crs = table4[wl_name]
            mem0 = torch.cuda.memory_stats()
            cpu0, t0 = time.process_time(), time.perf_counter()
            out = P.ops.spmm(crs, crs, variant="condense_merge",
                             rounds=rounds, device="cuda")
            torch.cuda.synchronize()
            lines.append({
                "workload": wl_name, "rounds": rounds, "cache": cache,
                "wall_ms": (time.perf_counter() - t0) * 1e3,
                "cpu_ms": (time.process_time() - cpu0) * 1e3,
                "alloc": {k: torch.cuda.memory_stats().get(k, 0) -
                          mem0.get(k, 0) for k in ALLOC_STATS}})
            del out
    mp, n_rounds, _ = _prep_shape(P.ops, table4["mesh-bates"], 32)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    block = torch.empty((n_rounds, mp, mp), device="cuda")
    torch.cuda.synchronize()
    malloc_ms = (time.perf_counter() - t0) * 1e3
    del block
    torch.cuda.empty_cache()
    emit({"phase": "spgemm_alloc", "calls": lines,
          "fresh_stripes_malloc_ms": malloc_ms,
          "stripes_bytes": 4 * n_rounds * mp * mp})


def phase_spgemm_times(torch, P, crs, inc, errs, launches):
    rounds = 128
    ai, av = P.ops.prep_rounds(crs, rounds, device="cuda")
    bi, bv = P.ops.prep_rounds(crs, rounds, device="cuda")
    kw = dict(rounds=rounds, bm=128, bn=128)
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    mp, n_rounds, _ = ai.shape
    m = crs.shape[0]
    live = int((ai >= 0).sum()) + int((bi >= 0).sum())
    pairs = _matched_pairs(crs)
    idx_bytes = (ai.numel() + bi.numel()) * 4 + live * 4
    stripe_bytes = n_rounds * mp * mp * 4
    prep = P.ops.prepare_incrs(inc, pad_rows_to=8, device="cuda")
    n_live_g = int(((prep.idx >= 0) & (prep.idx < prep.section)).sum())
    gather_out = prep.padded_rows * prep.n_sections * prep.section * 4
    work = {  # name: (bytes, flops)
        "index_match_spmm": (idx_bytes + m * m * 4, 2 * pairs),
        "spgemm_condense": (idx_bytes + stripe_bytes, 2 * pairs),
        "spgemm_merge": (stripe_bytes + mp * mp * 4, n_rounds * mp * mp),
        "incrs_gather": (prep.idx.numel() * 4 + n_live_g * 4 + gather_out,
                         0),
    }
    stripes = P.SK.spgemm_condense(ai, av, bi, bv, **kw)
    runs = {
        "index_match_spmm": (lambda: P.IM.index_match_spmm(ai, av, bi, bv,
                                                           **kw),
                             lambda: P.IM.plain(ai, av, bi, bv, **kw)),
        "spgemm_condense": (lambda: P.SK.spgemm_condense(ai, av, bi, bv,
                                                         **kw),
                            lambda: P.SK.plain_condense(ai, av, bi, bv,
                                                        **kw)),
        "spgemm_merge": (lambda: P.SK.spgemm_merge(stripes, bm=128, bn=128),
                         lambda: P.SK.plain_merge(stripes, bm=128, bn=128)),
        "incrs_gather": (lambda: P.G.incrs_gather(prep.idx, prep.val,
                                                  section=prep.section,
                                                  bm=8),
                         lambda: P.G.plain(prep.idx, prep.val,
                                           section=prep.section, bm=8)),
    }
    a_csr = torch.sparse_csr_tensor(
        torch.from_numpy(crs.row_ptr), torch.from_numpy(
            crs.col_idx.astype(np.int64)),
        torch.from_numpy(crs.values), size=crs.shape,
        check_invariants=True).to("cuda")
    at_csr = a_csr.to_dense().T.contiguous().to_sparse_csr()
    a_dense = a_csr.to_dense()
    library = {
        "index_match_spmm": _time_ms(torch, lambda: torch.sparse.mm(
            a_csr, at_csr), flush, reps=10),
        "spgemm_condense": None,
        "spgemm_merge": _time_ms(torch, lambda: stripes.sum(0), flush),
        "incrs_gather": _time_ms(torch, lambda: a_csr.to_dense(), flush),
    }
    dense_mm_ms = _time_ms(torch, lambda: a_dense @ a_dense.T, flush)
    # the first designs, in the same run (general instances)
    first = {
        "spgemm_merge": P.SK.merge_geometry(mp * mp, n_rounds,
                                            instance="general"),
        "incrs_gather": P.G.gather_geometry(*prep.idx.shape, prep.section,
                                            instance="general"),
    }
    first_ms = {
        "spgemm_merge": _time_ms(torch, lambda: P.SK.spgemm_merge(
            stripes, geometry=first["spgemm_merge"]), flush),
        "incrs_gather": _time_ms(torch, lambda: P.G.incrs_gather(
            prep.idx, prep.val, section=prep.section,
            geometry=first["incrs_gather"]), flush),
    }
    rows, line = [], {}
    for name, source, replaces in SPGEMM_KERNELS:
        fn, plain = runs[name]
        ms = _time_ms(torch, fn, flush)
        plain_ms = _time_ms(torch, plain, flush, reps=5)
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "library_ms": library[name]})
        line[name] = {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                      "flops": flops, "bound_bytes_ms": t_bytes,
                      "bound_ops_ms": t_ops, "library_ms": library[name]}
        if name in first_ms:
            line[name]["first_design_ms"] = first_ms[name]
    emit({"phase": "spgemm_times", "workload": "mesh-docword4",
          "rounds": rounds, "prep": list(ai.shape),
          "gather_stripes": list(prep.idx.shape), "matched_pairs": pairs,
          "library": {"index_match_spmm": "torch.sparse.mm(A_csr, At_csr)",
                      "spgemm_merge": "stripes.sum(0)",
                      "incrs_gather": "A_csr.to_dense()"},
          "dense_mm_ms": dense_mm_ms, "kernels": line})
    return rows


def _match_work(ai, bi, pairs, m, stripes, n=None):
    """(bytes, flops) that index matching (``stripes`` False: C, m x n, n
    = m by default) or condense (the f32 stripes) must move and do: both
    idx arrays in full (pads are read to be skipped), the live values, the
    output once; 2 flops per matched pair."""
    live = int((ai >= 0).sum()) + int((bi >= 0).sum())
    nbytes = (ai.numel() + bi.numel()) * 4 + live * 4
    out = ai.shape[1] * ai.shape[0] * bi.shape[0] if stripes \
        else m * (m if n is None else n)
    return nbytes + out * 4, 2 * pairs


def _bound_ms(work):
    return max(work[0] / HBM_BYTES_PER_S, work[1] / F32_FLOP_PER_S) * 1e3


# Flushes queued ahead of each timed index-matching call in the operand
# and geometry phases: at mesh-arenas the kernels take 0.05 ms, less than
# the wrapper's host time, and one flush (0.08 ms) left the card idle.
MATCH_LEAD = 4


def _merge_work(stripes):
    """(bytes, flops) of merge: the stripes read once, C written once; a
    flop a stripe element."""
    n_rounds, m, n = stripes.shape
    return (n_rounds + 1) * m * n * 4, n_rounds * m * n


def _gather_work(prep):
    """(bytes, flops) of the gather: the idx stripes in full (pads are read
    to be skipped), the live values, the dense output once."""
    live = int(((prep.idx >= 0) & (prep.idx < prep.section)).sum())
    out = prep.idx.shape[0] * prep.idx.shape[1] * prep.section
    return prep.idx.numel() * 4 + live * 4 + out * 4, 0


def _stream_row(torch, run, geometry, library, work, flush, yardsticks):
    """One stream kernel on one operand: the instance its rule picks and
    each instance's median time (``run(geometry)``), the first design
    bitwise equal to the rule's launch, beside the library call, the
    bound, and ``yardsticks``: torch calls that move the same bytes with
    no arithmetic, what the card reaches on such traffic."""
    rule = run(None)
    row = {"picked": geometry(None).instance}
    for inst in ("general", row["picked"]):
        geo = geometry(inst)
        check(torch.equal(run(geo), rule),
              f"{inst} instance bitwise equal to the rule's launch")
        row[f"{inst}_ms"] = _time_ms(torch, lambda: run(geo), flush)
    row["library_ms"] = _time_ms(torch, library, flush)
    for name, fn in yardsticks.items():
        row[name] = _time_ms(torch, fn, flush)
    row["bytes"] = work[0]
    row["bound_ms"] = _bound_ms(work)
    return row


def phase_spgemm_operands(torch, P, table4):
    """Every Table IV operand at R = 128 (and at R = 32 where its stripes
    fit ``STRIPES_MAX_BYTES``): index matching and condense (R = 128, and
    mesh-docword4 at R = 32), each in the ring instance and in the general
    one (the first design, unchanged: the times before), beside
    torch.sparse.mm(A_csr, At_csr), the bound and the ring's packing
    pre-pass alone; merge on the condensed stripes (ring and general,
    beside stripes.sum(0)) and, at R = 128, the gather of the operand's
    section stripes (tile and general, beside A_csr.to_dense()); median
    of 30 launches with L2 flushed; the instance each rule picks."""
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    lines = []
    cases = [(name, 128) for name in table4]
    for name, crs in table4.items():
        mp, n_rounds, _ = _prep_shape(P.ops, crs, 32)
        if 4 * n_rounds * mp * mp < STRIPES_MAX_BYTES:
            cases.append((name, 32))
    for wl_name, rounds in cases:
        crs = table4[wl_name]
        ai, av = P.ops.prep_rounds(crs, rounds, device="cuda")
        bi, bv = P.ops.prep_rounds(crs, rounds, device="cuda")
        m = crs.shape[0]
        pairs = _matched_pairs(crs)
        line = {"phase": "spgemm_operand", "workload": wl_name,
                "rounds": rounds, "prep": list(ai.shape)}
        a_csr = torch.sparse_csr_tensor(
            torch.from_numpy(crs.row_ptr),
            torch.from_numpy(crs.col_idx.astype(np.int64)),
            torch.from_numpy(crs.values), size=crs.shape).to("cuda")
        if rounds == 128 or wl_name == "mesh-docword4":
            for kernel, fn in (("index_match_spmm", P.IM.index_match_spmm),
                               ("spgemm_condense", P.SK.spgemm_condense)):
                row = {"picked": _match_geo(P, ai, bi, rounds,
                                            kernel).instance}
                for inst in P.IM.INSTANCES:
                    geo = _match_geo(P, ai, bi, rounds, kernel,
                                     instance=inst)
                    row[f"{inst}_ms"] = _time_ms(torch, lambda: fn(
                        ai, av, bi, bv, rounds=rounds, geometry=geo), flush,
                        lead=MATCH_LEAD)
                row["bound_ms"] = _bound_ms(_match_work(
                    ai, bi, pairs, m, kernel == "spgemm_condense"))
                line[kernel] = row
            at_csr = a_csr.to_dense().T.contiguous().to_sparse_csr()
            line["sparse_mm_ms"] = _time_ms(
                torch, lambda: torch.sparse.mm(a_csr, at_csr), flush,
                reps=10, lead=MATCH_LEAD)
            del at_csr
            line["pack_ms"] = _time_ms(
                torch, lambda: P.IM.pack(ai, av, bi, bv, rounds), flush,
                lead=MATCH_LEAD)
        stripes = P.SK.spgemm_condense(ai, av, bi, bv, rounds=rounds)
        del ai, av, bi, bv
        n_rounds, sm, sn = stripes.shape
        line["spgemm_merge"] = _stream_row(
            torch, lambda geo: P.SK.spgemm_merge(stripes, geometry=geo),
            lambda inst: P.SK.merge_geometry(sm * sn, n_rounds,
                                             instance=inst),
            lambda: stripes.sum(0), _merge_work(stripes), flush,
            {"read_ms": lambda: stripes.sum()})     # the stripes, read
        line["spgemm_merge"]["geometry"] = \
            P.SK.merge_geometry(sm * sn, n_rounds)._asdict()
        del stripes
        torch.cuda.empty_cache()
        if rounds == 128:
            prep = P.ops.prepare_incrs(P.InCRS.from_crs(crs), pad_rows_to=8,
                                       device="cuda")
            shape = (*prep.idx.shape, prep.section)
            dense = torch.empty((shape[0], shape[1] * shape[3]),
                                device="cuda")
            line["incrs_gather"] = _stream_row(
                torch, lambda geo: P.G.incrs_gather(
                    prep.idx, prep.val, section=prep.section, geometry=geo),
                lambda inst: P.G.gather_geometry(*shape, instance=inst),
                lambda: a_csr.to_dense(), _gather_work(prep), flush,
                {"write_ms": dense.zero_,      # the dense output, written
                 # the stripes read and the dense output written: each
                 # (row, section) padded from smax to section columns
                 "pad_ms": lambda: torch.nn.functional.pad(
                     prep.val, (0, max(0, shape[3] - shape[2])))})
            line["incrs_gather"]["stripes"] = list(shape)
            line["incrs_gather"]["geometry"] = \
                P.G.gather_geometry(*shape)._asdict()
            del prep, dense
        emit(line)
        lines.append(line)
        del a_csr
        torch.cuda.empty_cache()
    return lines


# ----------------------------------------------------------------------
# The plan–execute path: bsr and dense operands behind plan_for_operand,
# on the BSR and the dense kernels (f32 FMA and bf16 wgmma instances of
# one GEMM core, and the general kernels for other shapes).
def _granite(Q):
    """The granite-34b MLP operand: the bsr Linear of W_up and its pruned
    dense A = W_up^T (host f32)."""
    g = GRANITE
    w = np.random.default_rng(g["seed"]).standard_normal(
        (g["d_model"], g["d_ff"]), dtype=np.float32)
    w *= g["scale"]
    lin = Q.api.Linear.from_dense(w, Q.api.SparseSpec(
        "bsr", density=g["density"], block=g["block"]), device="cuda")
    del w
    return lin, np.ascontiguousarray(lin.to_dense().T)


def _held(torch, Q, mod, kname, run, plain, want64, geo, label):
    """One kernel call on the card, twice: the two launches bitwise equal
    and counted on the instance ``geo`` names; against the plain version
    on the same inputs (f32: ``KERNEL_TOL * max|C|``; bf16: per row,
    ``BF16_TOL * `` that row's max|C|, as ``worst_row_error``) and, in
    f32, against the float64 product ``want64`` (``SERVE_TOL``)."""
    before = dict(mod.INSTANCE_LAUNCHES)
    n0 = mod.LAUNCHES[kname]
    out = run()
    again = run()
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in mod.INSTANCE_LAUNCHES.items()
             if v != before[k]}
    check(mod.LAUNCHES[kname] == n0 + 2 and moved == {geo.instance: 2},
          f"{kname} on {label}: two launches of {geo.instance}, got "
          f"{moved}")
    check(torch.equal(out, again), f"{kname} {geo.instance} (S = "
          f"{geo.splits}) on {label}: two launches bitwise equal")
    ref = plain()
    check(bool(torch.isfinite(out).all()) and out.shape == ref.shape and
          out.dtype == ref.dtype, f"{kname} finite, right shape and type "
          f"on {label}")
    err = float((out.float() - ref.float()).abs().max())
    line = {"instance": geo.instance, "splits": geo.splits,
            "dtype": str(out.dtype).replace("torch.", ""),
            "max_abs_err": err}
    scale = max(float(want64.abs().max()), 1e-30)
    err64 = float((out.double() - want64).abs().max())
    line["max_rel_err_f64"] = err64 / scale
    if out.dtype == torch.bfloat16:
        row = Q.F.worst_row_error(out, ref)
        line["worst_row_err"] = row
        check(row <= BF16_TOL, f"{kname} bf16 on {label}: worst row "
              f"{row} > {BF16_TOL}")
    else:
        check(err <= KERNEL_TOL * scale, f"{kname} on {label}: max|err| "
              f"{err} > {KERNEL_TOL} * {scale}")
        check(err64 <= SERVE_TOL * scale, f"{kname} on {label} vs float64: "
              f"{err64} > {SERVE_TOL} * {scale}")
    return line


def _bsr_check(torch, Q, row_of, col_of, slots, row_start, b, nbr, a64,
               label):
    """The BSR kernel against its plain version and the float64 product
    ``a64 @ b`` (``a64`` the operand in float64 on the card)."""
    geo = Q.KB.gemm_geometry(nbr, slots.shape[1], slots.shape[2],
                             b.shape[1], torch.promote_types(slots.dtype,
                                                             b.dtype),
                             nnz=slots.shape[0])
    return _held(
        torch, Q, Q.KB, "bsr_spmm",
        lambda: Q.KB.bsr_spmm(row_of, col_of, slots, b, n_block_rows=nbr,
                              row_start=row_start),
        lambda: Q.KB.plain(row_of, col_of, slots, b, n_block_rows=nbr),
        a64 @ b.double(), geo, label)


def _dense_check(torch, Q, a, b, label):
    geo = Q.KD.gemm_geometry(a.shape[0], b.shape[1], a.shape[1],
                             torch.promote_types(a.dtype, b.dtype))
    return _held(torch, Q, Q.KD, "dense_mm", lambda: Q.ops.dense_mm(a, b),
                 lambda: Q.KD.plain(a, b), a.double() @ b.double(), geo,
                 label)


def _bsr_edges():
    """(label, A, (bm, bk), N): operands that reach each masked edge."""
    from repro_torch.analysis import cases
    return cases.edge_bsr()


def phase_plan_kernels(torch, Q, table2, granite):
    gen = torch.Generator(device="cuda").manual_seed(3)
    results, errs = [], {}
    bf16 = torch.bfloat16
    for wl_name, block in TABLE2_BLOCK.items():
        a = table2[wl_name].crs.to_dense()
        bsr = Q.BSR.from_dense(a, (block, block))
        row_of, col_of, slots, rs = Q.ops.prep_bsr(bsr, device="cuda")
        b = torch.randn(a.shape[1], 512, generator=gen, device="cuda")
        a64 = torch.from_numpy(a).to("cuda").double()
        line = {"operand": wl_name, "kernel": "bsr_spmm", "shape":
                list(a.shape), "block": block, "live_blocks": bsr.nnz_blocks,
                "blocks": bsr.n_block_rows * bsr.n_block_cols, "n": 512,
                **_bsr_check(torch, Q, row_of, col_of, slots, rs, b,
                             bsr.n_block_rows, a64,
                             f"{wl_name} block {block}")}
        if wl_name == "incrs-docword":
            a_t = a64.float()
            for a_in, b_in in ((a_t, b), (a_t.to(bf16), b.to(bf16))):
                results.append({"operand": wl_name, "kernel": "dense_mm",
                                "shape": list(a.shape), "n": 512,
                                **_dense_check(torch, Q, a_in, b_in,
                                               "docword dense")})
            del a_t
        results.append(line)
        del a64, slots, b
    lin, a_g = granite
    meta = lin.meta
    row_of, col_of, row_start = meta.kernel_index(torch.device("cuda"))
    slots = Q.lin_mod._pad_slots(lin.values.detach(), meta)
    b = torch.randn(a_g.shape[1], 512, generator=gen, device="cuda")
    a_t = torch.from_numpy(a_g).to("cuda")
    a64 = a_t.double()
    blocks = meta.n_block_rows * meta.n_block_rows_t
    check(meta.nnz == round(GRANITE["density"] * blocks),
          f"granite operand keeps {GRANITE['density']} of {blocks} blocks, "
          f"got {meta.nnz}")
    # f32, then bf16 by casting the same device tensors
    for dt in (torch.float32, bf16):
        s_in, a_in, b_in = slots.to(dt), a_t.to(dt), b.to(dt)
        eb = _bsr_check(torch, Q, row_of, col_of, s_in, row_start, b_in,
                        meta.n_block_rows, a64, f"granite bsr {dt}")
        ed = _dense_check(torch, Q, a_in, b_in, f"granite dense {dt}")
        key = "" if dt == torch.float32 else "/bf16"
        errs["bsr_spmm" + key], errs["dense_mm" + key] = eb, ed
        for kname, e in (("bsr_spmm", eb), ("dense_mm", ed)):
            results.append({"operand": GRANITE_NAME, "kernel": kname,
                            "shape": list(a_g.shape), "block": 128,
                            "live_blocks": meta.nnz, "blocks": blocks,
                            "n": 512, **e})
        del s_in, a_in, b_in
    del a_t, a64, slots, b
    for label, a, blk, n in _bsr_edges():
        bsr = Q.BSR.from_dense(a, blk)
        row_of, col_of, slots, rs = Q.ops.prep_bsr(bsr, device="cuda")
        b = torch.randn(a.shape[1], n, generator=gen, device="cuda")
        a64 = torch.from_numpy(a).to("cuda").double()
        dts = (torch.float32, bf16) if label in ("n_129", "split_k",
                                                 "skewed") \
            else (torch.float32,)
        for dt in dts:
            results.append({"operand": label, "kernel": "bsr_spmm",
                            "shape": list(a.shape), "block": list(blk),
                            "live_blocks": bsr.nnz_blocks, "n": n,
                            **_bsr_check(torch, Q, row_of, col_of,
                                         slots.to(dt), rs, b.to(dt),
                                         bsr.n_block_rows, a64, label)})
    for m, k, n in ((1, 1, 1), (127, 129, 300), (300, 7, 129)):
        a = torch.randn(m, k, generator=gen, device="cuda")
        b = torch.randn(k, n, generator=gen, device="cuda")
        dts = (torch.float32, bf16) if (m, k, n) == (127, 129, 300) \
            else (torch.float32,)
        for dt in dts:
            results.append({"operand": f"ragged {m}x{k}x{n}",
                            "kernel": "dense_mm", "shape": [m, k], "n": n,
                            **_dense_check(torch, Q, a.to(dt), b.to(dt),
                                           f"{m}x{k}x{n} {dt}")})
    emit({"phase": "plan_kernels",
          "tolerance": f"f32: max|kernel-plain| <= {KERNEL_TOL} * max|C|, "
                       f"max|kernel-float64| <= {SERVE_TOL} * max|C|; bf16: "
                       f"per row, max|kernel-plain| <= {BF16_TOL} * the "
                       f"row's max|C|; every call twice, bitwise equal",
          "checks": results})
    torch.cuda.empty_cache()
    return errs


_LAUNCHER_NUMBERS = {   # the rates of two waves: printed, not a cell
    "waves_first": r"waves=(\d+)",
    "requests_per_s": r"([\d.]+) req/s",
    "latency_ms_p50": r"p50=([\d.]+)ms",
    "latency_ms_p99": r"p99=([\d.]+)ms",
    "max_rel_err": r"float64 oracle: ([\d.e+-]+)",
    "plan_host_ms": r"on the host: ([\d.]+) ms",
    "max_rel_err_swapped": r"max \|err\| / max\|C\|: ([\d.e+-]+)",
    "waves": r"waves total (\d+)",
}


SERIAL = False      # ``chip_smoke.py --serial``: _concurrently in turn


def _concurrently(fn, arg_lists, workers=4, beside=None):
    """``fn(*args)`` for each of ``arg_lists`` on ``workers`` threads (each
    call runs a subprocess and waits on it), results in the given order,
    while ``beside()``, if given, runs in this thread (it may redirect
    stdout: the threads' calls print nothing); a call's exception is
    raised when its result is read. Returns the results, then
    ``beside()``'s when given. Under ``--serial`` every call runs in this
    thread in turn, ``beside`` last: the smoke without its concurrency."""
    if SERIAL:
        results = [fn(*args) for args in arg_lists]
        return results if beside is None else (results, beside())
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(fn, *args) for args in arg_lists]
        extra = None if beside is None else beside()
        results = [f.result() for f in futures]
    return results if beside is None else (results, extra)


def _run_launcher(args):
    """The launcher as a subprocess: a check of its exit code, its error
    against float64 and its launches. Its rate and latency are printed
    as it reports them, but two waves of requests measure no rate (and
    phase plan_serve runs its launchers 8 at a time): the engine runs of
    phase plan_serve do."""
    import re
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--spmm",
           "--device", "cuda", "--n-requests", "16", *args]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    line = {"phase": "plan_serve", "entry": "launcher",
            "cmd": " ".join(cmd[3:]), "rc": proc.returncode}
    if proc.returncode != 0:
        emit({**line, "stdout": proc.stdout[-2000:],
              "stderr": proc.stderr[-2000:]})
    check(proc.returncode == 0, f"launcher {' '.join(args)} exited 0")
    for key, pat in _LAUNCHER_NUMBERS.items():
        m = re.search(pat, proc.stdout)
        if m:
            line[key] = float(m.group(1))
    m = re.search(r"kernel launches (\{.*\})", proc.stdout)
    check(m is not None, "launcher printed its kernel launches")
    line["launches"] = json.loads(m.group(1))
    return line


def _engine_run(torch, Q, bound, panels, ref, label):
    """One SpMMEngine run over ``bound``; every request against the float64
    product ``ref`` on the card."""
    eng = Q.engine.SpMMEngine(bound, max_wave_cols=512)
    reqs = [Q.engine.SpMMRequest(i, p) for i, p in enumerate(panels)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    check(len(done) == len(reqs) and all(r.done for r in reqs),
          f"{label}: every request served")
    off, worst = 0, 0.0
    for r in reqs:
        want = ref[:, off:off + r.b.shape[1]]
        off += r.b.shape[1]
        got = torch.from_numpy(r.out).to("cuda")
        check(tuple(got.shape) == tuple(want.shape) and
              bool(torch.isfinite(got).all()),
              f"{label} request {r.rid} finite, right shape")
        cmax = max(float(want.abs().max()), 1e-30)
        err = float((got.double() - want).abs().max())
        check(err <= SERVE_TOL * cmax, f"{label} request {r.rid}: {err} > "
              f"{SERVE_TOL} * {cmax}")
        worst = max(worst, err / cmax)
    return eng, worst


def _plan_counters(Q):
    return {**Q.K.LAUNCHES, **Q.KB.LAUNCHES, **Q.KD.LAUNCHES}


def _plan_operands(table2, granite):
    """(label, dense A, bsr block) of the plan path, one at a time."""
    for name, block in TABLE2_BLOCK.items():
        yield name, table2[name].crs.to_dense(), block
    yield GRANITE_NAME, granite[1], GRANITE["block"]


def phase_plan_serve(torch, Q, table2, granite):
    """The path, driven with the counters at 0 just before it:
    ``SpMMEngine(plan_for_operand(A, spec))`` as bsr and as dense on the
    five Table II operands and the granite operand, each with the
    mixed-width trace of phase serve. Then the launcher as a subprocess
    (--format bsr|dense on the Table II workloads, once --spmm-swap),
    checked for its exit code, its error and its launches."""
    Q.KB.reset_launches()
    Q.KD.reset_launches()
    kept = {}
    for label, a, block in _plan_operands(table2, granite):
        panels = _trace(a.shape[1], seed=1)
        a64 = torch.from_numpy(a).to("cuda").double()
        ref = a64 @ torch.from_numpy(np.concatenate(panels, axis=1)).to(
            "cuda").double()
        del a64
        for fmt in ("bsr", "dense"):
            spec = Q.api.SparseSpec(fmt, block=block if fmt == "bsr"
                                    else None)
            t0 = time.perf_counter()
            bound = Q.api.plan_for_operand(a, spec, device="cuda")
            torch.cuda.synchronize()
            plan_ms = (time.perf_counter() - t0) * 1e3
            before = _plan_counters(Q)
            eng, worst = _engine_run(torch, Q, bound, panels, ref,
                                     f"{label} {fmt}")
            moved = {k: v - before[k] for k, v in _plan_counters(Q).items()
                     if v != before[k]}
            kname = "bsr_spmm" if fmt == "bsr" else "dense_mm"
            check(moved == {kname: eng.stats["waves"]},
                  f"{label} {fmt}: launches {moved} are one {kname} per "
                  f"wave")
            s = eng.stats_summary()
            emit({"phase": "plan_serve",
                  "entry": "SpMMEngine(plan_for_operand)",
                  "operand": label, "format": fmt,
                  "block": block if fmt == "bsr" else None,
                  "a_shape": list(a.shape), "plan_host_ms": plan_ms,
                  "requests": s["requests"], "waves": s["waves"],
                  "split_requests": int(eng.stats["split_requests"]),
                  "launches": moved, "requests_per_s": s["requests_per_s"],
                  "latency_ms_p50": s["latency_ms"]["p50"],
                  "latency_ms_p99": s["latency_ms"]["p99"],
                  "wave_ms_p50": s["wave_ms"]["p50"],
                  "prep_overlap_fraction": s["prep_overlap_fraction"],
                  "max_rel_err": worst})
            if (label, fmt) in PROFILED:
                kept[(label, fmt)] = bound
            del bound, eng
        del ref
        torch.cuda.empty_cache()
    for fmt in ("bsr", "dense"):
        emit(_serve_bf16(torch, Q, table2, fmt))
    launches = {**Q.KB.LAUNCHES, **Q.KD.LAUNCHES}
    check(all(v > 0 for v in launches.values()),
          f"both plan kernels ran on the plan path: {launches}")
    by_launcher = {"bsr_spmm": 0, "dense_mm": 0}
    runs = [["--workload", name, "--format", fmt] +
            (["--spmm-block", str(block)] if fmt == "bsr" else [])
            for name, block in TABLE2_BLOCK.items()
            for fmt in ("bsr", "dense")]
    runs.append(["--workload", "incrs-docword", "--format", "bsr",
                  "--spmm-block", "50", "--spmm-swap"])
    for args, line in zip(runs, _concurrently(_run_launcher,
                                              [(a,) for a in runs],
                                              workers=8)):
        kname = "bsr_spmm" if "bsr" in args else "dense_mm"
        moved = {k: v for k, v in line["launches"].items() if v}
        check(moved == {kname: int(line["waves"])},
              f"launcher {' '.join(args)}: launches {moved} are one "
              f"{kname} per wave ({line['waves']})")
        by_launcher[kname] += moved[kname]
        emit(line)
    return launches, by_launcher, kept




def _serve_bf16(torch, Q, table2, fmt):
    """A bf16 plan of the docword operand (``Linear.from_dense(...,
    dtype=bfloat16)``, as bsr with block 50 or as dense) served by
    ``SpMMEngine`` with bf16 requests (CPU tensors) on the mixed-width
    trace: every wave launches the bf16 instance its shape takes, once,
    and each request is held per row against the float64 product of the
    bf16 values (``BF16_TOL`` of the row's max|C|)."""
    a = table2["incrs-docword"].crs.to_dense()
    block = TABLE2_BLOCK["incrs-docword"] if fmt == "bsr" else None
    spec = Q.api.SparseSpec(fmt, block=block, mask=np.ascontiguousarray(
        a != 0).T if fmt == "bsr" else None)
    lin = Q.api.Linear.from_dense(np.ascontiguousarray(a.T), spec,
                                  dtype=torch.bfloat16, device="cuda")
    bound = lin.bound()
    check(bound.values.dtype == torch.bfloat16, f"docword {fmt}: bf16 plan")
    a16 = torch.from_numpy(np.ascontiguousarray(lin.to_dense().T)).to(
        "cuda").double()
    panels = [torch.from_numpy(p).to(torch.bfloat16)
              for p in _trace(a.shape[1], seed=2)]
    ref = a16 @ torch.cat(panels, dim=1).to("cuda").double()
    mod, kname = (Q.KB, "bsr_spmm") if fmt == "bsr" else (Q.KD, "dense_mm")
    if fmt == "bsr":
        want = Q.KB.gemm_geometry(a.shape[0] // block, block, block, 128,
                                  torch.bfloat16, nnz=1).instance
    else:
        want = Q.KD.gemm_geometry(a.shape[0], 128, a.shape[1],
                                  torch.bfloat16).instance
    before, n0 = dict(mod.INSTANCE_LAUNCHES), mod.LAUNCHES[kname]
    eng = Q.engine.SpMMEngine(bound, max_wave_cols=512)
    reqs = [Q.engine.SpMMRequest(i, p) for i, p in enumerate(panels)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    moved = {k: v - before[k] for k, v in mod.INSTANCE_LAUNCHES.items()
             if v != before[k]}
    waves = int(eng.stats["waves"])
    check(moved == {want: waves} and mod.LAUNCHES[kname] - n0 == waves,
          f"docword bf16 {fmt}: launches {moved} are one {want} per wave "
          f"({waves})")
    off, worst = 0, 0.0
    for r in reqs:
        width = r.b.shape[1]
        check(r.done and isinstance(r.out, torch.Tensor) and
              r.out.dtype == torch.bfloat16 and
              tuple(r.out.shape) == (a.shape[0], width),
              f"docword bf16 {fmt} request {r.rid}: a bf16 panel")
        worst = max(worst, Q.F.worst_row_error(
            r.out.to("cuda"), ref[:, off:off + width]))
        off += width
    check(worst <= BF16_TOL, f"docword bf16 {fmt}: worst row {worst} > "
          f"{BF16_TOL}")
    s = eng.stats_summary()
    return {"phase": "plan_serve",
            "entry": "SpMMEngine(Linear.from_dense(dtype=bfloat16).bound())",
            "operand": "incrs-docword", "format": fmt, "block": block,
            "dtype": "bfloat16", "instance": want, "requests": s["requests"],
            "waves": waves, "launches": moved,
            "requests_per_s": s["requests_per_s"],
            "latency_ms_p50": s["latency_ms"]["p50"],
            "latency_ms_p99": s["latency_ms"]["p99"],
            "worst_row_err": worst}


def _plan_work(kname, a_shape, n, elem, nnz=None, block=None,
               live_cols=None):
    """(bytes, flops) the function needs with ``elem``-byte operands and
    C: each input read once (for BSR the stored values, the B block-rows
    some block references, the block lists), C written once; 2 flops per
    useful multiply-add."""
    m, k = a_shape
    if kname == "dense_mm":
        return (m * k + k * n + m * n) * elem, 2 * m * n * k
    bm, bk = block
    nbytes = (nnz * bm * bk + live_cols * bk * n + m * n) * elem + \
        (2 * nnz + m // bm + 2) * 4
    return nbytes, 2 * nnz * bm * bk * n


# The dense geometries timed beside the picked one, as overrides of
# gemm_geometry. f32: other K splits (fewer CTAs than slots, or a second
# wave) and deeper B rings; bf16: the other tile width and ring depths.
GEMM_SWEEP = {
    ("granite", "float32"): [{"stages": 3}, {"stages": 4}, {"splits": 2}],
    ("docword", "float32"): [{"splits": 1}, {"splits": 5}, {"splits": 22},
                             {"stages": 3}],
    ("granite", "bfloat16"): [{"tile_n": 128}, {"stages": 3},
                              {"stages": 2}],
    ("docword", "bfloat16"): [{"tile_n": 256}, {"splits": 1},
                              {"splits": 11}]}


def _plan_operands_timed(torch, Q, table2, granite, gen, n):
    """where -> (A on the card (f32), the block lists, block, nnz, live
    block columns, B (f32))."""
    lin, a_g = granite
    meta = lin.meta
    row_of, col_of, row_start = meta.kernel_index(torch.device("cuda"))
    slots = Q.lin_mod._pad_slots(lin.values.detach(), meta)
    out = {"granite": (torch.from_numpy(a_g).to("cuda"),
                       (row_of, col_of, slots, row_start, meta.n_block_rows),
                       (128, 128), meta.nnz,
                       int(np.unique(np.asarray(meta.col_of)).size),
                       torch.randn(a_g.shape[1], n, generator=gen,
                                   device="cuda"))}
    a_dw = table2["incrs-docword"].crs.to_dense()
    blk = TABLE2_BLOCK["incrs-docword"]
    bsr_dw = Q.BSR.from_dense(a_dw, (blk, blk))
    d_row_of, d_col_of, d_slots, d_rs = Q.ops.prep_bsr(bsr_dw, device="cuda")
    out["docword"] = (torch.from_numpy(a_dw).to("cuda"),
                      (d_row_of, d_col_of, d_slots, d_rs,
                       bsr_dw.n_block_rows), (blk, blk), bsr_dw.nnz_blocks,
                      int(np.unique(bsr_dw.col_idx).size),
                      torch.randn(a_dw.shape[1], n, generator=gen,
                                  device="cuda"))
    return out


def phase_plan_times(torch, Q, table2, granite, errs, launches,
                     by_launcher):
    """Both kernels at the granite operand and at docword, N = 512, in
    f32 and in bf16: median time, plain version, library call, bound;
    then the f32 dense geometry sweep (``plan_geometries``)."""
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 512
    line, rows = {}, {}
    operands = _plan_operands_timed(torch, Q, table2, granite, gen, n)
    for where, (a_t, lists, blk, nnz, live_cols, b32) in operands.items():
        row_of, col_of, slots32, rs, nbr = lists
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            a_in, b, slots = a_t.to(dt), b32.to(dt), slots32.to(dt)
            elem, peak = (4, F32_FLOP_PER_S) if f32 else \
                (2, BF16_TC_FLOP_PER_S)
            kernels = {
                "bsr_spmm": (
                    lambda: Q.KB.bsr_spmm(row_of, col_of, slots, b,
                                          n_block_rows=nbr, row_start=rs),
                    lambda: Q.KB.plain(row_of, col_of, slots, b,
                                       n_block_rows=nbr),
                    Q.KB.gemm_geometry(nbr, blk[0], blk[1], n, dt,
                                       nnz=slots.shape[0])),
                "dense_mm": (
                    lambda: Q.KD.dense_mm(a_in, b),
                    lambda: Q.KD.plain(a_in, b),
                    Q.KD.gemm_geometry(a_t.shape[0], n, a_t.shape[1], dt))}
            for kname, (fn, plain, geo) in kernels.items():
                nbytes, flops = _plan_work(kname, tuple(a_t.shape), n, elem,
                                           nnz, blk, live_cols)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / peak * 1e3
                ms = _time_ms(torch, fn, flush)
                plain_ms = _time_ms(torch, plain, flush, reps=10)
                library, why = None, None
                try:
                    if kname == "dense_mm":
                        library = _time_ms(torch,
                                           lambda: torch.matmul(a_in, b),
                                           flush)
                    else:
                        a_bsr = a_in.to_sparse_bsr(blk)
                        library = _time_ms(torch, lambda: a_bsr @ b, flush,
                                           reps=10)
                        del a_bsr
                except (RuntimeError, NotImplementedError) as exc:
                    why = f"{type(exc).__name__}: {str(exc)[:300]}"
                key = f"{where}/{kname}/{str(dt).replace('torch.', '')}"
                line[key] = {
                    "instance": geo.instance, "splits": geo.splits,
                    "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                    "flops": flops, "bound_bytes_ms": t_bytes,
                    "bound_ops_ms": t_ops, "library_ms": library,
                    "library_refused": why,
                    "achieved_tflops": flops / ms / 1e9}
                if where == "granite":
                    rows[(kname, f32)] = {
                        "instance": geo.instance, "ms": ms,
                        "plain_ms": plain_ms,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations", "library_ms": library}
            del a_in, b, slots
    emit({"phase": "plan_times", "n": n,
          "library": {"dense_mm": "torch.matmul (f32 with TF32 off; bf16)",
                      "bsr_spmm": "A.to_sparse_bsr(block) @ B"},
          "bound_rates": {"float32": "f32 outside the tensor cores, 67 "
                                     "TFLOP/s", "bfloat16":
                          "bf16 tensor cores, 989 TFLOP/s"},
          "kernels": line})
    a_g, _, _, _, _, b_g = operands["granite"]
    emit({"phase": "plan_clocks", "operand": "granite", "n": n,
          "dense_f32_kernel": _clocks_under(
              torch, lambda: Q.KD.dense_mm(a_g, b_g)),
          "torch_matmul_f32": _clocks_under(
              torch, lambda: torch.matmul(a_g, b_g))})
    _gemm_sweep(torch, Q, operands, flush, n)
    out = []
    for kname in ("bsr_spmm", "dense_mm"):
        _, source, replaces = next(r for r in PLAN_KERNELS if r[0] == kname)
        r32, r16 = rows[(kname, True)], rows[(kname, False)]
        out.append({"name": kname, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[kname],
                    "launches_by_path": {
                        "engine": launches[kname],
                        "launcher_subprocesses": by_launcher[kname]},
                    "max_abs_err": errs[kname]["max_abs_err"], **r32,
                    "bf16": {**r16, "worst_row_err":
                             errs[kname + "/bf16"]["worst_row_err"]}})
    return out


def _clocks_under(torch, fn, seconds=2.0):
    """nvidia-smi's SM clock, power draw and limit, sampled every 0.25 s
    while ``fn`` runs back to back for ``seconds``."""
    import threading
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip())
            stop.wait(0.25)
    th = threading.Thread(target=sample)
    th.start()
    t_end = time.perf_counter() + seconds
    try:
        while time.perf_counter() < t_end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        stop.set()
        th.join()
    return samples


def _gemm_sweep(torch, Q, operands, flush, n):
    """The dense instances at granite and at docword: the picked geometry
    and those of GEMM_SWEEP, each held against the plain version (f32
    within KERNEL_TOL of max|C|, bf16 row by row)."""
    for (where, dname), changes in GEMM_SWEEP.items():
        a32, _, _, _, _, b32 = operands[where]
        dt = getattr(torch, dname)
        a_t, b = a32.to(dt), b32.to(dt)
        m, k = a_t.shape
        picked = Q.KD.gemm_geometry(m, n, k, dt)
        ref = Q.KD.plain(a_t, b)
        scale = float(ref.abs().max())
        out = []
        for change in [{}] + changes:
            geo = Q.KD.gemm_geometry(m, n, k, dt, **change)

            def fn(geo=geo):
                return Q.KD._launch(a_t, b, geometry=geo)
            got = fn()
            err = float((got.float() - ref.float()).abs().max())
            if dt == torch.float32:
                check(err <= KERNEL_TOL * scale, f"dense at {where}, "
                      f"{change}: {err} > {KERNEL_TOL} * {scale}")
            else:
                check(Q.F.worst_row_error(got, ref) <= BF16_TOL,
                      f"dense bf16 at {where}, {change}")
            out.append({"change": change, "tile_n": geo.tile_n,
                        "splits": geo.splits, "stages": geo.stages,
                        "ctas": geo.tiles * geo.splits, "smem": geo.smem,
                        "ms": _time_ms(torch, fn, flush),
                        "max_abs_err": err})
        emit({"phase": "plan_geometries", "kernel": "dense_mm",
              "dtype": dname, "operand": where, "shape": [m, k], "n": n,
              "picked": picked._asdict(), "geometries": out})
        del a_t, b


def plan_path(torch, K, ops, engine_mod, table2, profile_first=()):
    """Phases 9-11 and the profiles of the plan path, after
    ``profile_first``'s in the same fresh process (phase 4's); the
    kernels' rows, and the operands phase profile_in_process plans
    again."""
    from repro_torch.core.bsr import BSR
    from repro_torch.kernels import bsr_spmm as KB
    from repro_torch.kernels import dense_mm as KD
    from repro_torch.kernels import flash_attention as F
    from repro_torch.sparse import api
    from repro_torch.sparse import linear as lin_mod
    Q = types.SimpleNamespace(K=K, KB=KB, KD=KD, F=F, ops=ops, api=api,
                              lin_mod=lin_mod, BSR=BSR, engine=engine_mod)
    t0 = time.perf_counter()
    granite = _granite(Q)
    emit({"phase": "plan_granite", "linear_from_dense_host_s":
          time.perf_counter() - t0, "a_shape": list(granite[1].shape),
          "live_blocks": granite[0].meta.nnz})
    errs = phase_plan_kernels(torch, Q, table2, granite)
    launches, by_launcher, kept = phase_plan_serve(torch, Q, table2,
                                                   granite)
    # the general kernels' symbols, and the GEMM core's by its source
    jobs = list(profile_first) + [
        profile_job(bound, bound.shape[1], workload=label, fmt=fmt,
                    kernel_keys=(f"{fmt}_kernel", f"{fmt}src"))
        for (label, fmt), bound in sorted(kept.items())]
    phase_profile(torch, jobs)
    del jobs
    del kept
    torch.cuda.empty_cache()
    # phase profile_in_process's operands, planned again last
    dense = {"incrs-docword": (table2["incrs-docword"].crs.to_dense(),
                               TABLE2_BLOCK["incrs-docword"]),
             GRANITE_NAME: (granite[1], GRANITE["block"])}
    late = [(label, fmt, dense[label][0],
             dense[label][1] if fmt == "bsr" else None)
            for label, fmt in sorted(PROFILED)]
    return phase_plan_times(torch, Q, table2, granite, errs, launches,
                            by_launcher), late


# ----------------------------------------------------------------------
# Multi-tenant serving (the eighth path): one TenantPool over the five
# Table II operands as raw InCRS, docword as a bsr plan (block 50) and as a
# dense plan, and granite-34b's W_up^T (24576 x 6144, GRANITE's W) as two
# raw-InCRS checkpoints of one host W pruned by magnitude to density 0.1
# and 0.05 (section 256, block 32, phase train's incrs spec). The budget is
# one byte below the two granite tenants together, so the interleaved
# trace evicts and revives each of them.
TENANCY_DENSITIES = (0.1, 0.05)
TENANCY_KERNEL = {"bsr": "bsr_spmm", "dense": "dense_mm"}  # incrs: auto


def _granite_checkpoints(T):
    """{density: (InCRS, dense f32 A)} of W_up^T pruned by magnitude, and
    the host seconds that took."""
    t0 = time.perf_counter()
    g = GRANITE
    w = np.random.default_rng(g["seed"]).standard_normal(
        (g["d_model"], g["d_ff"]), dtype=np.float32)
    w *= g["scale"]
    a = np.ascontiguousarray(w.T)
    del w
    mag = np.abs(a).ravel()
    keep = [int(round(d * mag.size)) for d in TENANCY_DENSITIES]
    part = np.partition(mag, [mag.size - k for k in keep])
    out = {}
    for d, k in zip(TENANCY_DENSITIES, keep):
        mask = np.abs(a) >= part[mag.size - k]
        out[d] = (T.InCRS.from_crs(T.CRS.from_mask(a, mask), 256, 32),
                  np.where(mask, a, np.float32(0.0)))
    return out, time.perf_counter() - t0


def _freed_by_evict(torch, pool, name):
    """(device bytes the pool counts for ``name``, bytes
    memory_allocated() fell by when it was evicted), after reviving it."""
    pool.engine(name)
    counted = pool._tenants[name].resident_bytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    pool.evict(name)
    torch.cuda.synchronize()
    return counted, before - torch.cuda.memory_allocated()


def phase_tenancy(torch, T, table2):
    """The pool's tenants, the budget, then phase 3's mixed-width trace
    interleaved across the tenants, each request submitted (a revival
    timed on the host) and drained before the next, counters zeroed just
    before the trace; every request within SERVE_TOL * max|C| of float64
    on the card, one launch a wave of the tenant's kernel. Then evictions
    with the memory they free, the pool's stats, each tenant's latency and
    revivals, the shared memory a launch needs, and the serve bench
    (--smoke) and the spmm_serve example as two subprocesses at once
    (exit-code checks: the bench's printed rates are not kept)."""
    granite, build_s = _granite_checkpoints(T)
    docword = table2["incrs-docword"].crs.to_dense()
    tenants = {name: ("incrs", table2[name], table2[name].crs.to_dense())
               for name in TABLE2}
    for fmt in ("bsr", "dense"):
        spec = T.api.SparseSpec(fmt, block=50 if fmt == "bsr" else None)
        tenants[f"docword/{fmt}"] = (
            fmt, T.api.plan_for_operand(docword, spec, device="cuda"),
            docword)
    for d, (inc, a) in granite.items():
        tenants[f"granite/{d}"] = ("incrs", inc, a)
    del granite
    pool = T.TenantPool(hbm_budget_bytes=2 ** 62, max_wave_cols=512)
    t0 = time.perf_counter()
    for name, (_, op, _) in tenants.items():
        pool.add(name, op)
    add_s = time.perf_counter() - t0
    nbytes = {n: t.resident_bytes for n, t in pool._tenants.items()}
    smem = pool.smem_report()
    check(all(0 < r["smem_bytes"] <= smem["limit_bytes"]
              for r in smem["tenants"].values()),
          f"every tenant's launch fits shared memory: {smem}")
    # a CUDA engine's seed: the tuner's points for its stripes first (phase
    # autotune swept incrs-docword), else the bench record in the root
    src = pool.engine("incrs-docword").stats_summary()["cost_model"]
    check(src["source"].startswith("autotune["),
          f"the incrs-docword engine seeds from the tuner's sweeps: {src}")
    src_plan = pool.engine("docword/bsr").stats_summary()["cost_model"]
    if os.path.abspath(os.getcwd()) == ROOT:
        check(src_plan["source"] == "bench[BENCH_torch_serve.json]",
              f"a CUDA engine without tuned stripes, in the root, seeds "
              f"from the record: {src_plan}")
    g1, g2 = (nbytes[f"granite/{d}"] for d in TENANCY_DENSITIES)
    pool.hbm_budget_bytes = g1 + g2 - 1
    emit({"phase": "tenancy", "entry": "TenantPool",
          "tenants": {n: {"format": f, "shape": list(op.shape),
                          "device_bytes": nbytes[n]}
                      for n, (f, op, _) in tenants.items()},
          "granite_build_host_s": build_s, "add_host_s": add_s,
          "budget_bytes": pool.hbm_budget_bytes,
          "all_bytes": sum(nbytes.values()), "smem_report": smem,
          "cost_model": src, "cost_model_bsr_plan": src_plan})

    names = list(tenants)
    widths = [(256, 128, 64, 384)[r % 4] for r in range(32)] + [1200]
    a64 = {}
    for K in (T.K, T.KB, T.KD):
        K.reset_launches()
    revive_ms = {n: [] for n in names}
    latency = {n: [] for n in names}
    worst = {n: 0.0 for n in names}
    waves = {n: 0 for n in names}
    t_trace = time.perf_counter()
    for r, width in enumerate(widths):
        name = names[r % len(names)]
        fmt, _, a = tenants[name]
        if name not in a64:
            a64[name] = torch.from_numpy(a).to("cuda").double()
        panel = np.random.default_rng(100 + r).normal(
            size=(a.shape[1], width)).astype(np.float32)
        req = T.E.SpMMRequest(r, panel)
        revived = not pool._tenants[name].resident
        t0 = time.perf_counter()
        pool.submit(name, req)
        if revived:
            revive_ms[name].append((time.perf_counter() - t0) * 1e3)
        eng = pool.engine(name)
        before = {**T.K.LAUNCHES, **T.KB.LAUNCHES, **T.KD.LAUNCHES}
        w0 = eng.stats["waves"]
        pool.run()
        moved = {k: v - before[k] for k, v in
                 {**T.K.LAUNCHES, **T.KB.LAUNCHES, **T.KD.LAUNCHES}.items()
                 if v != before[k]}
        waves[name] += eng.stats["waves"] - w0
        if fmt == "incrs":              # each wave: the order auto picks
            want = {}
            for w in wave_widths(width):
                k = auto_kernel(T.ops, eng.prep, w)
                want[k] = want.get(k, 0) + 1
        else:
            want = {TENANCY_KERNEL[fmt]: eng.stats["waves"] - w0}
        check(req.done and moved == want and
              sum(want.values()) == eng.stats["waves"] - w0,
              f"tenancy {name} request {r}: launches {moved} are {want}, "
              f"one a wave")
        want = a64[name] @ torch.from_numpy(panel).to("cuda").double()
        got = torch.from_numpy(req.out).to("cuda").double()
        cmax = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max())
        check(tuple(got.shape) == tuple(want.shape) and
              bool(torch.isfinite(got).all()) and err <= SERVE_TOL * cmax,
              f"tenancy {name} request {r}: {err} > {SERVE_TOL} * {cmax}")
        worst[name] = max(worst[name], err / cmax)
        latency[name].append((req.t_done - req.t_submit) * 1e3)
    trace_s = time.perf_counter() - t_trace
    del a64
    launches = {k: v for k, v in {**T.K.LAUNCHES, **T.KB.LAUNCHES,
                                  **T.KD.LAUNCHES}.items() if v}
    stats = pool.summary()["stats"]
    per = {}
    for n in names:
        lat = sorted(latency[n])
        t = pool._tenants[n]
        per[n] = {"requests": len(lat), "waves": waves[n],
                  "latency_ms_p50": lat[len(lat) // 2] if lat else None,
                  "latency_ms_p99": lat[-1] if lat else None,
                  "evictions": t.evictions, "revive_host_ms": revive_ms[n],
                  "max_rel_err": worst[n]}
    for d in TENANCY_DENSITIES:
        t = per[f"granite/{d}"]
        check(t["evictions"] >= 1 and len(t["revive_host_ms"]) >= 1,
              f"granite/{d} was evicted and revived: {t}")
    freed = {n: _freed_by_evict(torch, pool, n)
             for n in ("granite/0.1", "incrs-docword", "docword/bsr",
                       "docword/dense")}
    for n in ("granite/0.1", "incrs-docword"):
        check(freed[n][1] >= freed[n][0], f"evicting {n} freed "
              f"{freed[n][1]} bytes of its {freed[n][0]}")
    emit({"phase": "tenancy", "entry": "trace",
          "requests": len(widths), "trace_host_s": trace_s,
          "launches": launches, "stats": stats, "tenants": per,
          "evict_freed_bytes": {n: {"counted": c, "freed": f}
                                for n, (c, f) in freed.items()},
          "tolerance": f"max|C - C64| <= {SERVE_TOL} * max|C64|"})
    del pool, tenants
    torch.cuda.empty_cache()
    return launches


# tenancy's exit-code subprocesses (run in ``late_checks``)
TENANCY_JOBS = (("repro_torch.benchmarks.serve_bench", "--smoke"),
                ("repro_torch.examples.spmm_serve",))


def report_tenancy_jobs(results):
    """The serve bench's and the example's lines and checks."""
    for job, (rc, wall, out, err) in zip(TENANCY_JOBS, results):
        emit({"phase": "tenancy", "entry": job[0], "args": list(job[1:]),
              "rc": rc, "wall_s": wall, "stdout": out.strip()[-3000:],
              "stderr": err.strip()[-2000:]})
        check(rc == 0, f"{job[0]} exited 0")
    check("crosscheck,ok" in results[0][2],
          "the serve bench's cross-check passed")
    check("max rel err" in results[1][2],
          "the example checked every request")


def tenancy_path(torch, K, ops, table2):
    """Phase tenancy; the launches of its trace by kernel."""
    from repro_torch.core.crs import CRS
    from repro_torch.core.incrs import InCRS
    from repro_torch.kernels import bsr_spmm as KB
    from repro_torch.kernels import dense_mm as KD
    from repro_torch.serve import TenantPool
    from repro_torch.serve import engine as E
    from repro_torch.sparse import api
    T = types.SimpleNamespace(K=K, KB=KB, KD=KD, ops=ops, api=api, E=E,
                              CRS=CRS, InCRS=InCRS, TenantPool=TenantPool)
    return phase_tenancy(torch, T, table2)


# ----------------------------------------------------------------------
# Training: granite-34b's MLP (src/repro/configs/granite_34b.py: d_model
# 6144, d_ff 24576) as the student of the port's training example, W_up
# 6144 -> 24576, tanh, W_down 24576 -> 6144, at full width, once per
# format: incrs at density 0.1, section 256 and block 32 (S_DEFAULT /
# B_DEFAULT), bsr at block 128 and density 0.25 (BlockSparsity's
# default, the GRANITE operand above). A dense teacher seeded normal with
# scale 0.02; T = 512 token rows; 8 AdamW steps with the example's
# settings (lr 3e-3, no weight decay, 2 warmup steps).
TRAIN = {"d_model": 6144, "d_ff": 24576, "tokens": 512, "steps": 8,
         "scale": 0.02, "seed": 11}
TRAIN_SPECS = {"incrs": {"density": 0.1, "section": 256, "block": 32},
               "bsr": {"density": 0.25, "block": 128}}
TRAIN_KERNEL = {"incrs": "incrs_spmm", "bsr": "bsr_spmm"}
GRAD_TOL = 1e-4          # step 0: max|g - g64| <= GRAD_TOL * max|g64|
TRAIN_LAUNCHES = 3       # a step: two forwards and l2's dx (x needs none)


def _train_modules():
    from repro_torch.core.crs import CRS
    from repro_torch.core.incrs import InCRS
    from repro_torch.examples import train_unstructured as ex
    from repro_torch.kernels import bsr_spmm as KB
    from repro_torch.kernels import dense_mm as KD
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import incrs_gather as G
    from repro_torch.kernels import autotune
    from repro_torch.kernels import incrs_spmm as K
    from repro_torch.kernels import index_match_spmm as IM
    from repro_torch.kernels import ops
    from repro_torch.serve import engine
    from repro_torch.sparse import api
    from repro_torch.sparse import linear as lin_mod
    from repro_torch.sparse import pattern
    from repro_torch.spgemm import kernels as SK
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer
    return types.SimpleNamespace(ex=ex, K=K, KB=KB, KD=KD, F=F, G=G, IM=IM,
                                 SK=SK, ops=ops, api=api, lin_mod=lin_mod,
                                 O=O, CRS=CRS, InCRS=InCRS, engine=engine,
                                 pattern=pattern, trainer=trainer,
                                 autotune=autotune)


def _step_products(torch, R, model):
    """The three InCRS products of a step, as ``ops.spmm`` gets them:
    (name, idx, values, section, rows of B) of l1's and l2's forward
    stripes and l2's transposed stripes (dx)."""
    l1, l2 = model["l1"], model["l2"]
    m1, m2 = l1.meta, l2.meta
    v2 = l2.values.detach()
    flat = torch.cat([v2.reshape(-1), v2.new_zeros(1)])
    tvals = flat.index_select(0, m2.t_gather).view(m2.bwd_idx.shape)
    return [("fwd_l1", m1.fwd_idx, l1.values.detach(), m1.section,
             m1.d_in),
            ("fwd_l2", m2.fwd_idx, v2, m2.section, m2.d_in),
            ("dx_l2", m2.bwd_idx, tvals, m2.section, m2.d_out)]


def _step_kernels(torch, R, model, steps):
    """The InCRS kernel launches ``steps`` steps take: each product's
    ``auto`` order, once a step."""
    want = {}
    for _, idx, val, section, k in _step_products(torch, R, model):
        kname = auto_kernel(R.ops, R.ops.PreparedOperand(
            idx, val, (idx.shape[0], k), section), TRAIN["tokens"])
        want[kname] = want.get(kname, 0) + steps
    return want


def _train_sweeps(torch, R, model):
    """Phase autotune's sweep on each of a step's InCRS products at
    T = 512 (B random: the values of B do not change which slots a
    launch reads)."""
    gen = torch.Generator(device="cuda").manual_seed(TRAIN["seed"] + 7)
    out = {}
    for name, idx, val, section, k in _step_products(torch, R, model):
        b = torch.randn(k, TRAIN["tokens"], generator=gen, device="cuda")
        cfg = sweep_incrs(torch, R, idx, val, b, section,
                          f"granite-34b MLP {name}", {"product": name})
        out[name] = {"variant": cfg.variant, "geometry": cfg.geometry,
                     "us": cfg.measured_us, "predicted_us": cfg.predicted_us}
        del b
    return out


def _incrs_count(R):
    return sum(R.K.LAUNCHES.values())


def _zero_every_count(R):
    for mod in (R.K, R.G, R.IM, R.SK, R.KB, R.KD, R.F):
        mod.reset_launches()


def _every_count(R):
    return {**R.K.LAUNCHES, **R.G.LAUNCHES, **R.IM.LAUNCHES,
            **R.SK.LAUNCHES, **R.KB.LAUNCHES, **R.KD.LAUNCHES,
            **R.F.LAUNCHES}


def _train_data(torch):
    """The teacher's batch on the card: x (T, d_model) and y = tanh(x @
    W1) @ W2, both teacher weights seeded normal with scale 0.02."""
    g = TRAIN
    gen = torch.Generator(device="cuda").manual_seed(g["seed"])
    x = torch.randn(g["tokens"], g["d_model"], generator=gen, device="cuda")
    w1 = torch.randn(g["d_model"], g["d_ff"], generator=gen,
                     device="cuda") * g["scale"]
    w2 = torch.randn(g["d_ff"], g["d_model"], generator=gen,
                     device="cuda") * g["scale"]
    y = torch.tanh(x @ w1) @ w2
    return x, y


def _train_student(torch, R, fmt):
    """The two layers packed under the format's spec (weights drawn on the
    host from a seed, as ``Linear.init`` draws them); the packing's host
    seconds."""
    g = TRAIN
    spec = R.api.SparseSpec(fmt, **TRAIN_SPECS[fmt])
    layers, pack_s = {}, 0.0
    for i, (name, shape) in enumerate((("l1", (g["d_model"], g["d_ff"])),
                                       ("l2", (g["d_ff"], g["d_model"])))):
        w = (torch.randn(shape, generator=torch.Generator().manual_seed(
            g["seed"] + 1 + i)) * g["scale"]).numpy()
        t0 = time.perf_counter()
        layers[name] = R.api.Linear.from_dense(w, spec, device="cuda")
        torch.cuda.synchronize()
        pack_s += time.perf_counter() - t0
        del w
    return torch.nn.ModuleDict(layers), pack_s


def _dx_l2(R, fmt, lin, dyt):
    vals = lin.values.detach()
    if fmt == "incrs":
        return R.lin_mod._incrs_dx(lin.meta, vals, dyt)
    return R.lin_mod._bsr_dx(lin.meta, vals, dyt)


def _train_products(torch, R, fmt, model, x, y):
    """Each product of one step alone, on the operands the main path
    gives it: the two forwards, l2's dx, both layers' dW; the plain
    version of l2's dx on the same transposed operand; each kernel
    product's (bytes, flops) as this run's data needs them; and the
    operands themselves."""
    lm, l1, l2 = R.lin_mod, model["l1"], model["l2"]
    v1, v2 = l1.values.detach(), l2.values.detach()
    m1, m2 = l1.meta, l2.meta
    n = x.shape[0]
    with torch.no_grad():
        h = torch.tanh(R.api.apply(l1, x))
        out = R.api.apply(l2, h)
        dout = 2.0 * (out - y) / out.numel()
        dyt = dout.T.contiguous()
        dpre = _dx_l2(R, fmt, l2, dyt).T * (1 - h * h)
    if fmt == "incrs":
        def fwd(m, v, b):
            return lm._incrs_product(m.fwd_idx, v, (m.d_out, m.d_in),
                                     m.section, b)

        def dw(m, a, d):
            return lm._stripe_dw(m.fwd_idx, m.section, a, d)
        flat = torch.cat([v2.reshape(-1), v2.new_zeros(1)])
        tvals = flat.index_select(0, m2.t_gather).view(m2.bwd_idx.shape)
        bn = R.ops.default_bn(n)
        kp = m2.bwd_idx.shape[1] * m2.section
        b_pad = torch.nn.functional.pad(dyt, (0, -(-n // bn) * bn - n, 0,
                                              kp - dyt.shape[0]))

        def plain_dx():
            return R.K.plain("incrs_spmm", m2.bwd_idx, tvals, b_pad,
                             section=m2.section, bm=128, bn=bn)[:m2.d_in, :n]
        P = R.ops.PreparedOperand
        work = {k: _incrs_bound(torch, p, n)[:2] for k, p in (
            ("fwd_l1", P(m1.fwd_idx, v1, (m1.d_out, m1.d_in), m1.section)),
            ("fwd_l2", P(m2.fwd_idx, v2, (m2.d_out, m2.d_in), m2.section)),
            ("dx_l2", P(m2.bwd_idx, tvals, (m2.d_in, m2.d_out),
                        m2.section)))}
    else:
        def fwd(m, v, b):
            return lm._bsr_forward(m, lm._pad_slots(v, m), b)

        def dw(m, a, d):
            return lm._bsr_dw(m, a, d.T.contiguous())
        gi = m2.grad_index(v2.device)
        tslots = lm._scatter_slots(v2.index_select(0, gi.t_perm).transpose(
            1, 2), gi.t_vpos, len(m2.t_col_of))
        t_row_of, t_col_of, _ = m2.kernel_index_t(v2.device)

        def plain_dx():
            return R.KB.plain(t_row_of, t_col_of, tslots, dyt,
                              n_block_rows=m2.n_block_rows_t)
        blk = (m1.block, m1.block)
        work = {k: _plan_work("bsr_spmm", shape, n, 4, len(cols), blk,
                              int(np.unique(np.asarray(cols)).size))
                for k, shape, cols in (
                    ("fwd_l1", (m1.d_out, m1.d_in), m1.col_of),
                    ("fwd_l2", (m2.d_out, m2.d_in), m2.col_of),
                    ("dx_l2", (m2.d_in, m2.d_out), m2.t_col_of))}
    prods = {"fwd_l1": lambda: fwd(m1, v1, x.T),
             "fwd_l2": lambda: fwd(m2, v2, h.T),
             "dx_l2": lambda: _dx_l2(R, fmt, l2, dyt),
             "dw_l1": lambda: dw(m1, x, dpre),
             "dw_l2": lambda: dw(m2, h, dout)}
    return prods, plain_dx, work, (h, dout, dyt, dpre)


def _dx_library(torch, R, fmt, l2, dyt, flush):
    """One PyTorch call for l2's dx^T = W2 @ dy^T on the same values:
    ``torch.sparse.mm`` of W2 as CSR (incrs) or W2 as BSR @ dy^T (bsr)."""
    w2 = torch.from_numpy(np.ascontiguousarray(l2.to_dense())).to("cuda")
    try:
        if fmt == "incrs":
            a = w2.to_sparse_csr()
            return _time_ms(torch, lambda: torch.sparse.mm(a, dyt), flush,
                            reps=10), None
        a = w2.to_sparse_bsr((l2.meta.block, l2.meta.block))
        return _time_ms(torch, lambda: a @ dyt, flush, reps=3), None
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"{type(exc).__name__}: {str(exc)[:300]}"


def _frozen_slots(torch, R, fmt, model):
    """Check that every pad slot (incrs) and zero tile (bsr) of the
    model's layers is exactly 0.0; returns how many there are."""
    frozen = 0
    for lin in model.values():
        vals = lin.values.detach()
        if fmt == "incrs":
            pad = lin.meta.fwd_idx < 0
        else:
            vals = R.lin_mod._pad_slots(vals, lin.meta)
            pad = torch.ones(vals.shape[0], dtype=torch.bool, device="cuda")
            pad[list(lin.meta.vpos)] = False
        frozen += int(pad.sum())
        check(bool((vals[pad] == 0).all()), f"{fmt}: pad slots and zero "
              f"tiles still 0.0")
    return frozen


def _timed_steps(torch, R, cfg, model, state, x, y, steps):
    """``steps`` AdamW steps, each split by CUDA events into forward,
    backward and optimizer; the parameters are taken from the model each
    step. Returns (losses, timings, state)."""
    timing = {k: [] for k in ("fwd_ms", "bwd_ms", "opt_ms", "step_ms",
                              "wall_ms")}
    losses = []
    for _ in range(steps):
        params = dict(model.named_parameters())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        loss = R.ex.mlp_loss(model, x, y)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(params.values()))
        ev[2].record()
        _, state, _ = R.O.adamw_update(cfg, dict(zip(params, grads)), state,
                                       params)
        ev[3].record()
        losses.append(float(loss.detach()))
        timing["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        for key, (a, b) in (("fwd_ms", (0, 1)), ("bwd_ms", (1, 2)),
                            ("opt_ms", (2, 3)), ("step_ms", (0, 3))):
            timing[key].append(ev[a].elapsed_time(ev[b]))
        del loss, grads
    torch.cuda.synchronize()
    return losses, timing, state


def phase_train(torch, R, fmt):
    """One format: pack, hold step 0's gradients against float64 and l2's
    dx kernel against its plain version, time each product, take the
    counted steps, check the loss and the frozen slots, serve the trained
    l1 (``train_path`` runs the example). Returns the kernel's row
    additions and the trained student, its AdamW state and data (phase
    lifecycle takes them over)."""
    g = TRAIN
    kname = TRAIN_KERNEL[fmt]
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    x, y = _train_data(torch)
    model, pack_s = _train_student(torch, R, fmt)
    sweeps = _train_sweeps(torch, R, model) if fmt == "incrs" else None
    shapes = {k: list(lin.values.shape) for k, lin in model.items()}
    if fmt == "incrs":
        shapes.update({f"{k}_bwd_idx": list(lin.meta.bwd_idx.shape)
                       for k, lin in model.items()})
    t0 = time.perf_counter()
    grad_err = R.ex.grad_errors(model, x, y)        # float64, dense
    oracle_s = time.perf_counter() - t0
    for k, err in grad_err.items():
        check(err <= GRAD_TOL, f"train {fmt}: {k} off float64 by {err} > "
              f"{GRAD_TOL} of its max")
    prods, plain_dx, work, (h, dout, dyt, dpre) = _train_products(
        torch, R, fmt, model, x, y)
    got, ref = prods["dx_l2"](), plain_dx()
    torch.cuda.synchronize()
    scale = max(float(ref.abs().max()), 1e-30)
    dx_err = float((got - ref).abs().max())
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"train {fmt}: dx kernel finite, of the plain version's shape")
    check(dx_err <= KERNEL_TOL * scale, f"train {fmt}: dx kernel off its "
          f"plain version by {dx_err} > {KERNEL_TOL} * {scale}")
    del got, ref
    parts = {}
    for name, fn in prods.items():
        parts[name] = {"ms": _time_ms(torch, fn, flush, reps=10)}
        if name in work:
            nbytes, flops = work[name]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOP_PER_S * 1e3
            parts[name].update(bytes=nbytes, flops=flops,
                               bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops
                               else "operations")
    parts["dx_l2"]["plain_ms"] = _time_ms(torch, plain_dx, flush, reps=3)
    parts["dx_l2"]["library_ms"], parts["dx_l2"]["library_refused"] = \
        _dx_library(torch, R, fmt, model["l2"], dyt, flush)
    parts["dx_l2"]["max_abs_err"] = dx_err
    # the dense outer products the live-slot dW avoids, as yardsticks
    parts["dw_l1"]["dense_matmul_ms"] = _time_ms(
        torch, lambda: x.T @ dpre, flush, reps=10)
    parts["dw_l2"]["dense_matmul_ms"] = _time_ms(
        torch, lambda: h.T @ dout, flush, reps=10)
    del h, dout, dyt, dpre, prods, plain_dx
    torch.cuda.empty_cache()

    cfg = R.O.AdamWConfig(lr=3e-3, weight_decay=0.0,
                          warmup_steps=max(2, g["steps"] // 10),
                          total_steps=g["steps"])
    state = R.O.adamw_init(cfg, dict(model.named_parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_every_count(R)
    losses, timing, state = _timed_steps(torch, R, cfg, model, state, x, y,
                                         g["steps"])
    counts = {k: v for k, v in _every_count(R).items() if v}
    peak = torch.cuda.max_memory_allocated()
    want = _step_kernels(torch, R, model, g["steps"]) if fmt == "incrs" \
        else {kname: TRAIN_LAUNCHES * g["steps"]}
    check(counts == want and sum(want.values()) ==
          TRAIN_LAUNCHES * g["steps"],
          f"train {fmt}: {TRAIN_LAUNCHES} launches a step, {want}, and "
          f"no other kernel, got {counts} in {g['steps']} steps")
    with torch.no_grad():
        final = float(R.ex.mlp_loss(model, x, y))
    check(final < losses[0], f"train {fmt}: loss {losses[0]} -> {final} "
          f"did not fall")
    frozen = _frozen_slots(torch, R, fmt, model)

    def fmt_count():
        return _incrs_count(R) if fmt == "incrs" else _every_count(R)[kname]
    before = fmt_count()
    eng, served_err = R.ex.serve_check(model["l1"],
                                       np.random.default_rng(g["seed"]),
                                       n=3, cols=192, max_wave_cols=512)
    served_launches = fmt_count() - before
    check(served_err <= SERVE_TOL, f"train {fmt}: served l1 off float64 by "
          f"{served_err} > {SERVE_TOL} of max|C|")
    check(served_launches == eng.stats["waves"], f"train {fmt}: one "
          f"launch a wave, {served_launches} for {eng.stats['waves']}")
    served = {"requests": eng.stats["requests"], "waves": eng.stats["waves"],
              "launches": served_launches, "max_rel_err": served_err}
    del eng, flush
    torch.cuda.empty_cache()
    emit({"phase": "train", "format": fmt, "model": "granite-34b MLP",
          "tokens": g["tokens"], "steps": g["steps"],
          "spec": TRAIN_SPECS[fmt], "values_shapes": shapes,
          "pack_s": pack_s, "oracle_s": oracle_s, "grad_err_f64": grad_err,
          "products": parts, "step_median": {
              k: statistics.median(v) for k, v in timing.items()},
          "step_times": timing, "peak_memory_bytes": peak,
          "launches": counts, "launches_per_step":
              sum(counts.values()) / g["steps"], "sweeps": sweeps,
          "losses": losses,
          "final_loss": final, "frozen_slots": frozen,
          "served": served})
    dx = parts["dx_l2"]
    handoff = {"model": model, "state": state, "cfg": cfg, "x": x, "y": y,
               "final_loss": final, "step_median": {
                   k: statistics.median(v) for k, v in timing.items()},
               "peak_memory_bytes": peak}
    dx_kernel = kname if fmt != "incrs" else RAN_BY[sweeps["dx_l2"][
        "variant"]]
    return (counts, dx_kernel, {
        k: dx[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms", "max_abs_err")}), handoff


def train_path(torch):
    """Phases train and lifecycle, one format after the other (phase
    lifecycle takes over the student phase train trained), with phase
    sharded between incrs's two: each format's training row additions and
    its lifecycle launches, and the sharded path's launches."""
    R = _train_modules()
    out = {}
    for fmt in ("incrs", "bsr"):
        row, handoff = phase_train(torch, R, fmt)
        torch.cuda.empty_cache()
        if fmt == "incrs":
            out["sharded"] = phase_sharded(torch, R, handoff)
            torch.cuda.empty_cache()
        out[fmt] = row, phase_lifecycle(torch, R, fmt, handoff)
        del handoff
        torch.cuda.empty_cache()
    return out


# the training and lifecycle examples: exit-code subprocesses (run in
# ``late_checks``)
TRAIN_EXAMPLES = (("repro_torch.examples.train_unstructured", "--format",
                   "incrs"),
                  ("repro_torch.examples.train_unstructured", "--format",
                   "bsr"),
                  ("repro_torch.examples.train_reprune", "--device",
                   "cuda"))


def report_train_examples(results):
    for args, (rc, wall, stdout, stderr) in zip(TRAIN_EXAMPLES, results):
        emit({"phase": "lifecycle_example" if "train_reprune" in args[0]
              else "train_example", "cmd": " ".join(args), "rc": rc,
              "wall_s": wall, "stdout": stdout.strip()[-1500:],
              "stderr": stderr.strip()[-1500:]})
        check(rc == 0, f"{' '.join(args)} exited 0")


def _run_example(*args):
    """``python -m`` ``args`` from the root: (exit code, wall s, stdout,
    stderr)."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    return (proc.returncode, time.perf_counter() - t0, proc.stdout,
            proc.stderr)


# ----------------------------------------------------------------------
# Row-sharded InCRS: phase train's incrs student's l1 (granite-34b's W_up,
# so A = W_up^T, 24576 x 6144 at density 0.1) cut into SHARDS row panels
# of 3072 rows on one card named SHARDS times (``make_mesh(SHARDS,
# "cuda:0")``), each panel its own launch of the InCRS kernels; and on
# every visible card where there are more than one.
SHARDS = 8
SHARD_N = 512
SWAP_DENSITY = 0.05          # the sharded layer re-pruned 0.1 -> 0.05
SHARD_STEPS = 2


def _sharded_product(torch, R, label, single, sharded, b, c64, flush):
    """``ops.spmm`` of the single-device and the sharded operand at each
    order and ``auto``: C bitwise equal (each shard's rows the
    single-device kernel's), within SERVE_TOL of float64; each shard's
    launch of ``auto``'s order against its plain version; the shard's
    kernel, the single-device kernel and both ``spmm`` calls timed."""
    ops, K = R.ops, R.K
    scale = max(float(c64.abs().max()), 1e-30)
    orders = {}
    for variant in ("expand", "reuse", "pipelined", "auto"):
        want = ops.spmm(single, b, variant=variant)
        got = ops.spmm(sharded, b, variant=variant)
        err = float((got.double() - c64).abs().max())
        check(torch.equal(got, want), f"sharded {label} {variant}: each "
              f"shard's rows bitwise equal to the single-device kernel's")
        check(err <= SERVE_TOL * scale, f"sharded {label} {variant}: "
              f"{err} > {SERVE_TOL} * {scale} off float64")
        orders[variant] = {"max_abs_err_f64": err}
    kname = auto_kernel(ops, sharded.shard(0), b.shape[1])
    kname_single = auto_kernel(ops, single, b.shape[1])
    variant = {v: k for k, v in RAN_BY.items()}[kname]
    kp = sharded.n_sections * sharded.section
    bn = ops.default_bn(b.shape[1])
    bp = torch.nn.functional.pad(b, (0, -(-b.shape[1] // bn) * bn -
                                     b.shape[1], 0, kp - b.shape[0]))
    shard_err = 0.0
    for s in range(sharded.n_shards):
        out = ops._INCRS_KERNELS[variant](sharded.idx[s], sharded.val[s], bp,
                                          section=sharded.section, bn=bn)
        ref = K.plain(kname, sharded.idx[s], sharded.val[s], bp,
                      section=sharded.section, bn=bn)
        err = float((out - ref).abs().max())
        check(err <= KERNEL_TOL * max(float(ref.abs().max()), 1e-30),
              f"sharded {label} shard {s}: {kname} off its plain version "
              f"by {err}")
        shard_err = max(shard_err, err)
    del out, ref
    run_shard = lambda: ops._INCRS_KERNELS[variant](  # noqa: E731
        sharded.idx[0], sharded.val[0], bp, section=sharded.section, bn=bn)
    bp1 = torch.nn.functional.pad(b, (0, bp.shape[1] - b.shape[1], 0,
                                      single.n_sections * single.section -
                                      b.shape[0]))
    run_single = lambda: ops._INCRS_KERNELS[variant](  # noqa: E731
        single.idx, single.val, bp1, section=single.section, bn=bn)
    nbytes, flops, t_bytes, t_ops, _ = _incrs_bound(torch, sharded.shard(0),
                                                    b.shape[1])
    return {"a_shape": list(single.shape), "n": b.shape[1],
            "rows_per_shard": sharded.rows_per_shard,
            "shard_stripes": list(sharded.idx[0].shape),
            "single_stripes": list(single.idx.shape), "orders": orders,
            "auto": {"shard": kname, "single": kname_single},
            "shard_plain_max_abs_err": shard_err,
            "shard_kernel_ms": _time_ms(torch, run_shard, flush),
            "shard_bound_ms": max(t_bytes, t_ops),
            "shard_plain_ms": _time_ms(
                torch, lambda: K.plain(kname, sharded.idx[0], sharded.val[0],
                                       bp, section=sharded.section, bn=bn),
                flush, reps=3),
            "single_kernel_ms": _time_ms(torch, run_single, flush),
            "sharded_spmm_ms": _time_ms(
                torch, lambda: ops.spmm(sharded, b), flush, reps=10),
            "single_spmm_ms": _time_ms(
                torch, lambda: ops.spmm(single, b), flush, reps=10)}


def _sharded_serve(torch, R, op, panels, label):
    """Serve ``panels`` through a fresh engine on ``op``, counters zeroed
    just before: (engine, results by rid, launches by kernel)."""
    _zero_every_count(R)
    eng = R.engine.SpMMEngine(op, max_wave_cols=512, device="cuda")
    for i, p in enumerate(panels):
        eng.submit(R.engine.SpMMRequest(i, p))
    done = eng.run()
    torch.cuda.synchronize()
    counts = {k: v for k, v in _every_count(R).items() if v}
    check(len(done) == len(panels), f"sharded {label}: every request "
          f"served")
    return eng, {r.rid: r.out for r in done}, counts


def _check_wave_launches(R, eng, counts, per_wave, label):
    orders = auto_orders(R.ops, [eng.prep.shard(0) if eng.sharded
                                 else eng.prep])
    check(sum(counts.values()) == eng.stats["waves"] * per_wave and
          all(k in orders for k in counts),
          f"sharded {label}: {per_wave} launches a wave of "
          f"{sorted(orders)}, got {counts} for {eng.stats['waves']} waves")


def phase_sharded(torch, R, handoff):
    """The ninth path, on phase train's incrs student (before phase
    lifecycle re-prunes it): the product, the engine, two training steps
    and a swap, each through the sharded entry points and against the
    single-device path. Returns the sharded launches by kernel (engine
    waves, training steps and the swapped engine's waves)."""
    import dataclasses
    from repro_torch.configs.paper_spmm import WORKLOADS
    from repro_torch.data import datasets
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import tenancy
    t_phase = time.perf_counter()
    smi = smi_line()
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    model = handoff["model"]
    l1, l2 = model["l1"], model["l2"]
    mesh = make_mesh(SHARDS, "cuda:0")
    t0 = time.perf_counter()
    ls = l1.shard(mesh)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    m1 = l1.meta
    single = R.ops.PreparedOperand(m1.fwd_idx, l1.values.detach(),
                                   (m1.d_out, m1.d_in), m1.section)
    sharded = ls.inner.prep
    op_bytes = {"single": tenancy.operand_bytes(single),
                "sharded": tenancy.operand_bytes(sharded),
                "single_smax": int(single.idx.shape[2]),
                "shard_smax": int(sharded.idx[0].shape[2])}
    op_bytes["ratio"] = op_bytes["sharded"] / op_bytes["single"]

    # the product: granite's W_up^T, then incrs-docword
    gen = torch.Generator(device="cuda").manual_seed(TRAIN["seed"] + 21)
    b = torch.randn(m1.d_in, SHARD_N, generator=gen, device="cuda")
    w64 = torch.from_numpy(l1.to_dense()).to("cuda", torch.float64)
    products = {GRANITE_NAME: _sharded_product(
        torch, R, "granite", single, sharded, b, w64.T @ b.double(), flush)}
    del w64
    wl = WORKLOADS["incrs-docword"]
    inc = R.InCRS.from_crs(datasets.synthesize(wl.dataset, seed=0),
                           wl.section, wl.block)
    bd = torch.randn(inc.shape[1], SHARD_N, generator=gen, device="cuda")
    d64 = torch.from_numpy(inc.crs.to_dense()).to("cuda", torch.float64)
    products["incrs-docword"] = _sharded_product(
        torch, R, "docword", R.ops.prepare_incrs(inc, device="cuda"),
        R.ops.prepare_incrs_sharded(inc, mesh), bd, d64 @ bd.double(), flush)
    del d64, bd, inc

    # the engine: the mixed-width trace through the single-device and the
    # sharded engine on granite, equal results
    panels = _trace(m1.d_in, seed=1)
    eng1, out1, counts1 = _sharded_serve(torch, R, single, panels, "single")
    engs, outs, counts_engine = _sharded_serve(torch, R, sharded, panels,
                                               "engine")
    _check_wave_launches(R, eng1, counts1, 1, "single engine")
    _check_wave_launches(R, engs, counts_engine, SHARDS, "engine")
    check(engs.sharded and all(np.array_equal(outs[i], out1[i])
                               for i in out1),
          "sharded engine: results equal to the single-device engine's")
    s1, ss = eng1.stats_summary(), engs.stats_summary()
    engine = {"requests": ss["requests"], "waves": ss["waves"],
              "launches": counts_engine,
              "wave_ms_p50": {"single": s1["wave_ms"]["p50"],
                              "sharded": ss["wave_ms"]["p50"]},
              "requests_per_s": {"single": s1["requests_per_s"],
                                 "sharded": ss["requests_per_s"]},
              "cost_model": {"single": s1["cost_model"]["source"],
                             "sharded": ss["cost_model"]["source"]}}
    del eng1, out1, outs

    # training: step 0's forward and dW equal to the single-device layer,
    # dx within bound; then SHARD_STEPS AdamW steps of l1 sharded with a
    # copy of l2
    dy = torch.randn(TRAIN["tokens"], m1.d_out, generator=gen,
                     device="cuda")
    grads = []
    for layer in (l1, ls):
        xr = handoff["x"].clone().requires_grad_(True)
        params = list(layer.parameters())
        y = layer(xr)
        g = torch.autograd.grad(y, [xr] + params, grad_outputs=dy)
        grads.append((y.detach(), g[0], g[1:]))
        del y
    (y1, dx1, (dw1,)), (ys, dxs, dws) = grads
    check(torch.equal(y1, ys), "sharded train: forward bitwise equal to "
          "the single-device layer")
    sw = ls.meta.shard_width
    check(all(torch.equal(dws[s][:sw], dw1[s * sw:(s + 1) * sw]) and
              not bool(dws[s][sw:].any()) for s in range(SHARDS)),
          "sharded train: dW bitwise equal to the single-device layer")
    dx_scale = max(float(dx1.abs().max()), 1e-30)
    dx_err = float((dxs - dx1).abs().max())
    check(dx_err <= SERVE_TOL * dx_scale, f"sharded train: dx off the "
          f"single-device dx by {dx_err} > {SERVE_TOL} * {dx_scale}")
    vals = [v.detach() for v in ls.values]
    dyt = R.lin_mod._split_rows(dy.T, ls.meta)
    parts = [R.lin_mod._incrs_product(
        ls.meta.bwd_idx[s], torch.cat([vals[s].reshape(-1),
                                       vals[s].new_zeros(1)]).index_select(
            0, ls.meta.t_gather[s]).view(ls.meta.bwd_idx[s].shape),
        (m1.d_in, sw), m1.section, dyt[s]) for s in range(SHARDS)]

    def reduce():
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc
    check(torch.equal(reduce().T, dxs), "sharded train: the dx reduction "
          "is the partials summed in shard order")
    dx_times = {
        "sharded_dx_ms": _time_ms(torch, lambda: R.lin_mod._sharded_dx(
            ls.meta, vals, dyt, dy.device), flush, reps=10),
        "reduction_ms": _time_ms(torch, reduce, flush, reps=10),
        "single_dx_ms": _time_ms(torch, lambda: R.lin_mod._incrs_dx(
            m1, l1.values.detach(), dy.T), flush, reps=10)}
    del grads, dx1, dxs, dws, dw1, parts, dyt, y1, ys
    l2c = R.api.Linear(dataclasses.replace(
        l2.inner, values=l2.values.detach().clone()))
    smodel = torch.nn.ModuleDict({"l1": ls, "l2": l2c})
    cfg = handoff["cfg"]
    state = R.O.adamw_init(cfg, dict(smodel.named_parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_every_count(R)
    losses, timing, state = _timed_steps(torch, R, cfg, smodel, state,
                                         handoff["x"], handoff["y"],
                                         SHARD_STEPS)
    counts_train = {k: v for k, v in _every_count(R).items() if v}
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        final = float(R.ex.mlp_loss(smodel, handoff["x"], handoff["y"]))
    check(final < losses[0], f"sharded train: loss {losses[0]} -> {final} "
          f"did not fall")
    want_steps = SHARD_STEPS * (SHARDS + 2)   # l1's shards, l2, l2's dx
    check(sum(counts_train.values()) == want_steps and
          set(counts_train) <= set(INCRS_KERNELS),
          f"sharded train: {want_steps} InCRS launches in {SHARD_STEPS} "
          f"steps, got {counts_train}")
    check(all(not bool(v.detach()[i < 0].any()) for v, i in
              zip(ls.values, ls.meta.fwd_idx)),
          "sharded train: pad slots still 0.0")
    train = {"steps": SHARD_STEPS, "losses": losses, "final_loss": final,
             "step_ms": timing["step_ms"], "fwd_ms": timing["fwd_ms"],
             "bwd_ms": timing["bwd_ms"], "opt_ms": timing["opt_ms"],
             "peak_memory_bytes": peak, "launches": counts_train,
             "dx_max_abs_err": dx_err, "dx_max_abs": dx_scale,
             "dx_bitwise": dx_err == 0.0, **dx_times}
    del state, l2c

    # the swap: the trained sharded layer re-pruned to SWAP_DENSITY and
    # swapped into the running sharded engine
    t0 = time.perf_counter()
    node2 = R.pattern.magnitude_repack(ls.inner, SWAP_DENSITY)
    torch.cuda.synchronize()
    repack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engs.swap_pattern(node2)
    swap_ms = (time.perf_counter() - t0) * 1e3
    check(engs.sharded and engs.pattern_version == 1,
          f"sharded swap: the engine serves pattern v1, got "
          f"{engs.pattern_version}")
    half = panels[:len(panels) // 2]
    _zero_every_count(R)
    before = engs.stats["waves"]
    for i, p in enumerate(half):
        engs.submit(R.engine.SpMMRequest(100 + i, p))
    done = [r for r in engs.run() if r.rid >= 100]
    torch.cuda.synchronize()
    counts_swap = {k: v for k, v in _every_count(R).items() if v}
    waves = engs.stats["waves"] - before
    check(sum(counts_swap.values()) == waves * SHARDS, f"sharded swap: "
          f"{SHARDS} launches a wave, {counts_swap} for {waves} waves")
    w2 = torch.from_numpy(R.lin_mod.incrs_sharded_to_dense_weight(
        node2)).to("cuda", torch.float64)
    worst = 0.0
    for r in done:
        want = w2.T @ torch.from_numpy(r.b).to("cuda", torch.float64)
        err = float((torch.from_numpy(r.out).to("cuda").double() -
                     want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        check(rel <= SERVE_TOL, f"sharded swap request {r.rid}: {rel} > "
              f"{SERVE_TOL} of max|C| off the repacked float64 oracle")
        worst = max(worst, rel)
    swap = {"density": SWAP_DENSITY, "nnz": node2.nnz, "repack_s": repack_s,
            "swap_ms": swap_ms, "requests": len(done), "waves": waves,
            "launches": counts_swap, "max_rel_err": worst,
            "operand_bytes": tenancy.operand_bytes(engs.prep)}
    del w2, engs, node2

    # on every visible card, where there are more than one
    n_cards = torch.cuda.device_count()
    multi = {"cards": n_cards, "run": False}
    if n_cards > 1 and m1.d_out % n_cards == 0 and \
            (m1.d_out // n_cards) % m1.section == 0:
        lm = l1.shard(make_mesh(n_cards, "cuda"))
        prep_m = lm.inner.prep
        check(len(set(prep_m.devices)) == n_cards, "multi-card mesh: one "
              "shard a card")
        check(torch.equal(R.ops.spmm(prep_m, b), R.ops.spmm(single, b)),
              "multi-card mesh: each card's rows the single-device rows")
        multi.update(run=True, ms=_time_ms(
            torch, lambda: R.ops.spmm(prep_m, b), flush, reps=10))
        del lm, prep_m
    counts = {}
    for part in (counts_engine, counts_train, counts_swap):
        for k, v in part.items():
            counts[k] = counts.get(k, 0) + v
    emit({"phase": "sharded", "card": smi, "shards": SHARDS,
          "mesh": f"cuda:0 x {SHARDS}", "cards_visible": n_cards,
          "shard_s": shard_s, "operand_bytes": op_bytes,
          "products": products, "engine": engine, "train": train,
          "swap": swap, "multi_card": multi, "launches": counts,
          "phase_s": time.perf_counter() - t_phase})
    del flush, ls, smodel, sharded, single, b
    return counts


# ----------------------------------------------------------------------
# The lifecycle: phase train's trained student is served, re-pruned by the
# prune callback at one due step, hot-swapped into the running engine and
# trained on.
LIFECYCLE_DENSITY = {"incrs": 0.05, "bsr": 0.125}   # the due step's target
LIFECYCLE_STEPS = 2


def _latency_ms(reqs):
    lat = sorted((r.t_done - r.t_submit) * 1e3 for r in reqs)
    return {"p50": statistics.median(lat),
            "p99": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]}


def _operand_plain(torch, R, fmt, op, panel):
    """The plain version of the kernel a bound ``incrs`` or ``bsr`` plan
    launches, on that plan's own device operands and ``panel``."""
    if fmt == "incrs":
        prep = op._ready
        n = panel.shape[1]
        bn = R.ops.default_bn(n)
        b = torch.nn.functional.pad(panel, (
            0, -(-n // bn) * bn - n,
            0, prep.n_sections * prep.section - panel.shape[0]))
        return R.K.plain("incrs_spmm", prep.idx, prep.val, b,
                         section=prep.section, bm=128,
                         bn=bn)[:prep.shape[0], :n]
    meta = op.plan.meta
    row_of, col_of, _ = meta.kernel_index(panel.device)
    return R.KB.plain(row_of, col_of, op._ready, panel,
                      n_block_rows=meta.n_block_rows)


def _operand_work(torch, R, fmt, op, n):
    """(bytes, flops) of a bound ``incrs`` or ``bsr`` plan's kernel at
    ``n`` columns, as this operand's data needs them."""
    if fmt == "incrs":
        return _incrs_bound(torch, op._ready, n)[:2]
    meta = op.plan.meta
    return _plan_work("bsr_spmm", (meta.d_out, meta.d_in), n, 4,
                      len(meta.col_of), (meta.block, meta.block),
                      int(np.unique(np.asarray(meta.col_of)).size))


def _served_operands(torch, R, fmt, ops_by_side, dense_by_side, panel,
                     flush):
    """The engine's operand before and after the swap (the trained
    pattern, and the repacked stripes or block lists), each launched once
    on ``panel`` and held against its plain version on the same inputs,
    then timed with the plain version, its bound and one library call
    beside it: ``torch.sparse.mm`` of the operand's dense A
    (``dense_by_side``) as CSR (incrs), or A as BSR of its blocks times B
    (bsr, phase plan_times' yardstick)."""
    out = {}
    for side, op in ops_by_side.items():
        kname = auto_kernel(R.ops, op._ready, panel.shape[1]) \
            if fmt == "incrs" else TRAIN_KERNEL[fmt]
        n0 = _every_count(R)[kname]
        got = op(panel)
        torch.cuda.synchronize()
        check(_every_count(R)[kname] == n0 + 1, f"lifecycle {fmt}: the "
              f"{side} operand launches {kname} once")
        ref = _operand_plain(torch, R, fmt, op, panel)
        check(tuple(got.shape) == tuple(ref.shape) and
              bool(torch.isfinite(got).all()), f"lifecycle {fmt}: {side} "
              f"operand's kernel finite, of the plain version's shape")
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got - ref).abs().max())
        check(err <= KERNEL_TOL * scale, f"lifecycle {fmt}: {side} "
              f"operand's kernel off its plain version by {err} > "
              f"{KERNEL_TOL} * {scale}")
        del got, ref
        nbytes, flops = _operand_work(torch, R, fmt, op, panel.shape[1])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        out[side] = {"kernel": kname, "max_abs_err": err, "bytes": nbytes,
                     "flops": flops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "ms": _time_ms(torch, lambda: op(panel), flush),
                     "plain_ms": _time_ms(
                         torch, lambda: _operand_plain(torch, R, fmt, op,
                                                       panel), flush,
                         reps=3)}
        dense = dense_by_side[side]
        lib = dense.to_sparse_csr() if fmt == "incrs" else \
            dense.to_sparse_bsr((op.plan.meta.block, op.plan.meta.block))
        del dense
        out[side]["library"] = "torch.sparse.mm (CSR)" if fmt == "incrs" \
            else "BSR @ B (to_sparse_bsr, as row 5)"
        out[side]["library_ms"] = _time_ms(
            torch, (lambda: torch.sparse.mm(lib, panel)) if fmt == "incrs"
            else (lambda: lib @ panel), flush, reps=10)
        del lib
    return out


def phase_lifecycle(torch, R, fmt, h):
    """Serve the trained l1 (W_up) with the first half of phase 3's
    mixed-width trace; re-prune l1 through ``make_prune_callback`` at one
    due step; launch one wave, then ``swap_pattern`` the repacked layer
    into the running engine and serve the second half; each request
    against float64 of the weight in force when its wave launched. The
    engine's operand before and after the swap against the kernel's plain
    version. Then the float64 gradient check on the new live set and 2
    AdamW steps on the repacked moments. Returns the format kernel's
    name, its launches on this path and the two operands' checks."""
    kname = TRAIN_KERNEL[fmt]
    model, state, cfg, x, y = (h[k] for k in ("model", "state", "cfg", "x",
                                              "y"))
    l1 = model["l1"]
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        loss_before = float(R.ex.mlp_loss(model, x, y))
    w_old = torch.from_numpy(l1.to_dense()).to("cuda").double()
    mask_old = torch.from_numpy(l1.pattern.mask).to("cuda")
    version_old, nnz_old = l1.pattern.version, l1.nnz
    panels = _trace(l1.d_in, seed=3)
    small, big = panels[:-1], panels[-1]
    half = len(small) // 2
    # Like traffic on both sides of the swap: the two halves of the
    # mixed widths (the width cycle repeats, so their widths match), each
    # closed by the 1,200-column request the engine splits across waves.
    sides = {"before": small[:half] + [big], "after": small[half:] + [big]}
    reqs_before = [R.engine.SpMMRequest(i, p)
                   for i, p in enumerate(sides["before"])]
    req_inflight = R.engine.SpMMRequest(len(reqs_before), small[0])
    reqs_after = [R.engine.SpMMRequest(len(reqs_before) + 1 + i, p)
                  for i, p in enumerate(sides["after"])]
    reqs = reqs_before + [req_inflight] + reqs_after

    _zero_every_count(R)
    eng = R.engine.SpMMEngine(l1, max_wave_cols=512)
    for r in reqs_before:
        eng.submit(r)
    eng.run()
    waves_before = eng.stats["waves"]
    # the due step of a schedule that lands on the target at once
    cb = R.trainer.make_prune_callback(R.pattern.PruneSchedule(
        LIFECYCLE_DENSITY[fmt], 1, warmup_frac=0.0))
    t0 = time.perf_counter()
    info = cb(1, torch.nn.ModuleDict({"l1": l1}), state)
    torch.cuda.synchronize()
    repack_s = time.perf_counter() - t0
    check(info is not None and info["layers"] == 1 and
          l1.pattern.version == version_old + 1,
          f"lifecycle {fmt}: one effective repack of l1, got {info}")
    # a wave launched before the swap keeps the operand it launched with
    eng.submit(req_inflight)
    eng.step(retire=False)
    inflight = {r.rid for r in eng._inflight.items}
    check(inflight == {req_inflight.rid}, f"lifecycle {fmt}: request "
          f"{req_inflight.rid} in flight at the swap, got {inflight}")
    old_op = eng.prep
    t0 = time.perf_counter()
    eng.swap_pattern(l1)
    swap_ms = (time.perf_counter() - t0) * 1e3
    check(eng.pattern_version == l1.pattern.version and
          eng.stats["pattern_swaps"] == 1,
          f"lifecycle {fmt}: the engine records pattern "
          f"v{l1.pattern.version}, has v{eng.pattern_version}")
    for r in reqs_after:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    serve_counts = {k: v for k, v in _every_count(R).items() if v}
    check(len(eng.finished) == len(reqs) and all(r.done for r in reqs),
          f"lifecycle {fmt}: every request served")
    ran = auto_orders(R.ops, [old_op._ready, eng.prep._ready]) \
        if fmt == "incrs" \
        else {kname}
    check(sum(serve_counts.values()) == eng.stats["waves"] and
          set(serve_counts) <= ran, f"lifecycle {fmt}: one launch a wave "
          f"of {sorted(ran)}, {serve_counts} for {eng.stats['waves']} "
          f"waves")
    w_new = torch.from_numpy(l1.to_dense()).to("cuda").double()
    mask_new = torch.from_numpy(l1.pattern.mask).to("cuda")
    worst = {"old": 0.0, "new": 0.0}
    for r in reqs:
        which = "old" if r.rid <= req_inflight.rid else "new"
        want = (w_old if which == "old" else w_new).T @ torch.from_numpy(
            r.b).to("cuda").double()
        got = torch.from_numpy(r.out).to("cuda")
        check(tuple(got.shape) == tuple(want.shape) and
              bool(torch.isfinite(got).all()),
              f"lifecycle {fmt} request {r.rid} finite, right shape")
        cmax = max(float(want.abs().max()), 1e-30)
        err = float((got.double() - want).abs().max())
        check(err <= SERVE_TOL * cmax, f"lifecycle {fmt} request {r.rid} "
              f"({which} weight): {err} > {SERVE_TOL} * {cmax}")
        worst[which] = max(worst[which], err / cmax)
    # the repack: survivors carried over exactly, pruned slots gone
    check(bool((mask_new <= mask_old).all()) and
          bool((w_new[mask_new] == w_old[mask_new]).all()) and
          bool((w_new[~mask_new] == 0).all()),
          f"lifecycle {fmt}: surviving values carried over, pruned slots "
          f"absent from the new values")
    pruned = int((mask_old & ~mask_new).sum())
    dense_by_side = {"before": w_old.T.float().contiguous(),
                     "after": w_new.T.float().contiguous()}
    del w_old, w_new, mask_old, mask_new
    check(eng.stats["waves"] - waves_before - 1 == waves_before,
          f"lifecycle {fmt}: like traffic packs into as many waves on both "
          f"sides of the swap, {waves_before} and "
          f"{eng.stats['waves'] - waves_before - 1}")
    lat = {"before": _latency_ms(reqs_before),
           "after": _latency_ms(reqs_after)}
    walls = [w * 1e3 for w in eng._wave_wall_s]
    wave_ms = {"before": statistics.median(walls[:waves_before]),
               "after": statistics.median(walls[waves_before + 1:])}
    # The kernel on the operands the swap moved between (the repacked
    # ones no earlier phase gave it) against its plain version on one
    # 512-column panel, and timed; the training steps below run l1's
    # forward on the repacked operand too. These launches are outside
    # the counted path.
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    panel = torch.from_numpy(np.concatenate(small, axis=1)[:, :512]).to(
        "cuda")
    operands = _served_operands(torch, R, fmt,
                                {"before": old_op, "after": eng.prep},
                                dense_by_side, panel, flush)
    del flush, panel, dense_by_side
    # where a wave's time goes on either side of the swap: the same
    # traffic served by a fresh engine over each side's operand
    keys = INCRS_SYMBOLS if fmt == "incrs" else ("bsr_kernel", "bsrsrc")
    phase_profile(torch, [
        profile_job(op, l1.d_in, fmt=fmt, kernel_keys=keys,
                    workload=f"lifecycle granite W_up, {side} the swap")
        for side, op in (("before", old_op), ("after", eng.prep))])
    del old_op

    t0 = time.perf_counter()
    grad_err = R.ex.grad_errors(model, x, y)        # float64, new live set
    oracle_s = time.perf_counter() - t0
    for k, err in grad_err.items():
        check(err <= GRAD_TOL, f"lifecycle {fmt}: {k} off float64 by {err} "
              f"> {GRAD_TOL} of its max")
    _zero_every_count(R)
    losses, timing, state = _timed_steps(torch, R, cfg, model, state, x, y,
                                         LIFECYCLE_STEPS)
    step_counts = {k: v for k, v in _every_count(R).items() if v}
    want = _step_kernels(torch, R, model, LIFECYCLE_STEPS) \
        if fmt == "incrs" else {kname: TRAIN_LAUNCHES * LIFECYCLE_STEPS}
    check(step_counts == want, f"lifecycle {fmt}: {TRAIN_LAUNCHES} "
          f"launches a step, {want}, and no other kernel, got "
          f"{step_counts}")
    with torch.no_grad():
        final = float(R.ex.mlp_loss(model, x, y))
    check(all(np.isfinite(losses)) and np.isfinite(final),
          f"lifecycle {fmt}: finite losses {losses} -> {final}")
    if fmt == "incrs":
        check(final <= loss_before, f"lifecycle {fmt}: loss {final} after "
              f"the repack and {LIFECYCLE_STEPS} steps above its value "
              f"{loss_before} before the repack")
    else:
        # Halving the live blocks of a trained bsr layer costs more loss
        # than 2 steps win back, so it is held to training on: the loss
        # falls from its value just after the repack.
        check(final < losses[0], f"lifecycle {fmt}: loss not falling on "
              f"the new pattern, {losses} -> {final}")
    frozen = _frozen_slots(torch, R, fmt, model)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(serve_counts)
    for k, v in step_counts.items():
        launches[k] = launches.get(k, 0) + v
    emit({"phase": "lifecycle", "format": fmt, "model": "granite-34b MLP",
          "layer": "l1 (W_up)", "density": [nnz_old / (l1.d_in * l1.d_out),
                                            l1.density],
          "nnz": [nnz_old, l1.nnz], "pruned": pruned,
          "version": l1.pattern.version, "repack_s": repack_s,
          "swap_ms": swap_ms, "repack_info": info,
          "values_shape": list(l1.values.shape),
          "requests": [len(reqs_before), len(reqs_after)],
          "columns": [sum(p.shape[1] for p in sides[k])
                      for k in ("before", "after")],
          "waves": [waves_before, eng.stats["waves"] - waves_before - 1],
          "inflight_at_swap": sorted(inflight),
          "latency_ms": lat, "wave_ms_p50": wave_ms, "wave_ms": walls,
          "operands_512": operands, "max_rel_err": worst,
          "serve_launches": serve_counts, "oracle_s": oracle_s,
          "grad_err_f64": grad_err, "loss_before_repack": loss_before,
          "losses": losses, "final_loss": final,
          "step_median_before": h["step_median"],
          "step_median_after": {k: statistics.median(v)
                                for k, v in timing.items()},
          "step_times": timing, "step_launches": step_counts,
          "frozen_slots": frozen, "peak_memory_bytes": peak,
          "train_peak_memory_bytes": h["peak_memory_bytes"]})
    del eng
    return launches, {k: {f: v[f] for f in (
        "kernel", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library", "library_ms")} for k, v in operands.items()}


# ----------------------------------------------------------------------
# The crs plan: granite-34b's W_up^T at phase train's density times top-5 %
# activations (the regime of examples/spgemm_activations.py), through each
# route; then mesh-docword4's bound plan beside ops.spmm(A, A).
CRS_PLAN = {"density": 0.1, "rounds": 128, "tokens": 512, "keep": 307,
            "seed": 21}
CRS_ROUTES = {None: {"index_match_spmm": 1},
              "crs": {"spgemm_condense": 1, "spgemm_merge": 1},
              "incrs": {"spgemm_condense": 1, "spgemm_merge": 1}}
CRS_CALLS = 2            # the first call preps the RHS; the second hits
CRS_TOL = 1e-4           # |C - C64| <= CRS_TOL * (1 + |C64|) elementwise
DOCWORD_CALLS = 5


def _top_k_rows(R, x, k):
    """CRS of x (T, K) keeping each row's k largest |x|: top-k
    activations as a sparse B^T."""
    t, kk = x.shape
    keep = np.sort(np.argpartition(-np.abs(x), k - 1, axis=1)[:, :k],
                   axis=1)
    vals = np.take_along_axis(x, keep, axis=1)
    return R.CRS(vals.reshape(-1).astype(np.float32),
                 keep.reshape(-1).astype(np.int32),
                 np.arange(t + 1, dtype=np.int64) * k, (t, kk))


def _timed_call(torch, fn):
    """``fn()`` with its wall split: the host until it returned, the card
    from before the call to its last launch's end, the CPU time."""
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    ev0.record()
    out = fn()
    ev1.record()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, {"wall_ms": (t2 - t0) * 1e3, "host_ms": (t1 - t0) * 1e3,
                 "device_span_ms": ev0.elapsed_time(ev1),
                 "cpu_ms": (time.process_time() - cpu0) * 1e3}


def _c64_host(pattern, values, bt):
    """float64 C = A @ Bt^T on the host (scipy.sparse), A's values at the
    plan's slots in row-major order; and A's CSR row pointer and column
    indices."""
    import scipy.sparse as sp
    mask_a = np.ascontiguousarray(pattern.mask.T)
    m, k = mask_a.shape
    indptr = np.zeros(m + 1, np.int64)
    indptr[1:] = np.cumsum(mask_a.sum(axis=1))
    cols = np.nonzero(mask_a)[1]
    a64 = sp.csr_matrix((values.astype(np.float64), cols, indptr),
                        shape=(m, k))
    b64 = sp.csr_matrix((bt.values.astype(np.float64), bt.col_idx,
                         bt.row_ptr), shape=bt.shape)
    return (a64 @ b64.T).toarray(), indptr, cols


def phase_crs_plan(torch, R):
    """granite-34b's W_up^T (24576 x 6144, density 0.1) planned once by
    ``plan_for_operand(..., SparseSpec("crs", ...))``, times B^T = top-5 %
    activations over 512 token rows: the plan's host time, then each route
    (index matching; condense + merge for a crs and an InCRS B^T) called
    twice, the second a memo hit of the RHS prep, every C against float64
    on the host and condense + merge bitwise equal to index matching;
    counters zeroed just before and read just after. Then each kernel on
    the plan's operands against its plain version, and timed beside the
    bound and a library call. Returns the rows' additions."""
    g, t = CRS_PLAN, TRAIN
    a = (torch.randn((t["d_ff"], t["d_model"]), generator=torch.Generator()
                     .manual_seed(g["seed"])) * t["scale"]).numpy()
    x = np.random.default_rng(g["seed"]).standard_normal(
        (g["tokens"], t["d_model"])).astype(np.float32)
    bt = _top_k_rows(R, x, g["keep"])
    inc_bt = R.InCRS.from_crs(bt)
    host = {}
    t0 = time.perf_counter()
    base = R.api.plan_for_operand(a, R.api.SparseSpec(
        "crs", density=g["density"], rounds=g["rounds"]), device="cuda")
    torch.cuda.synchronize()
    host["plan_for_operand_ms"] = (time.perf_counter() - t0) * 1e3
    del a
    pat = base.pattern
    t0 = time.perf_counter()
    R.api._crs_plan_meta(pat, g["rounds"])
    host["crs_plan_meta_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    base.plan.bind(base.values)
    torch.cuda.synchronize()
    host["bind_ms"] = (time.perf_counter() - t0) * 1e3
    plans = {None: base}
    for f in ("crs", "incrs"):
        t0 = time.perf_counter()
        plans[f] = R.api.plan(R.api.SparseSpec(
            "crs", pattern=pat, rounds=g["rounds"], rhs_format=f)).bind(
                base.values)
        torch.cuda.synchronize()
        host[f"plan_and_bind_{f}_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    c64, indptr, cols = _c64_host(pat, base.values.cpu().numpy(), bt)
    oracle_s = time.perf_counter() - t0
    ref = torch.from_numpy(c64).to("cuda")
    del c64
    m, n = t["d_ff"], g["tokens"]

    _zero_every_count(R)
    outs, calls, errs = {}, {}, {}
    for f, bound in plans.items():
        rhs = inc_bt if f == "incrs" else bt
        before = _every_count(R)
        runs = []
        for _ in range(CRS_CALLS):
            out, timing = _timed_call(torch, lambda: bound(rhs))
            runs.append(timing)
        moved = {k: v - before[k] for k, v in _every_count(R).items()
                 if v != before[k]}
        want = {k: CRS_CALLS * v for k, v in CRS_ROUTES[f].items()}
        check(moved == want, f"crs plan rhs_format={f}: launches {moved} "
              f"are {want}")
        check(tuple(out.shape) == (m, n) and out.dtype == torch.float32 and
              bool(torch.isfinite(out).all()),
              f"crs plan rhs_format={f}: finite f32 ({m}, {n})")
        diff = (out.double() - ref).abs()
        check(bool((diff <= CRS_TOL * (1 + ref.abs())).all()),
              f"crs plan rhs_format={f}: max|C - C64| {float(diff.max())} "
              f"over {CRS_TOL} (rtol = atol)")
        errs[str(f)] = float(diff.max())
        outs[f] = out
        calls[str(f)] = runs
    counts = {k: v for k, v in _every_count(R).items() if v}
    for f in ("crs", "incrs"):
        check(torch.equal(outs[f], outs[None]), f"crs plan: condense + merge "
              f"(rhs_format={f}) bitwise equal to index matching")
    c_max = float(ref.abs().max())
    del outs, ref

    # each kernel on the plan's operands, as the plan launches them
    ai, av = base._ready
    bi, bv = R.api._rhs_rounds_prep(base.plan.meta, bt, ai.device)
    ai, av, bi, bv = R.ops.pad_common_rmax(ai, av, bi, bv)
    kerr, instances = _check_match(torch, R, ai, av, bi, bv,
                                   rounds=g["rounds"], bm=128,
                                   label="granite W_up^T crs plan")
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    kw = dict(rounds=g["rounds"], bm=128, bn=128)
    pairs = int((np.bincount(cols, minlength=t["d_model"]) *
                 np.bincount(bt.col_idx, minlength=t["d_model"])).sum())
    stripe_bytes = 4 * ai.shape[1] * ai.shape[0] * bi.shape[0]
    stripes = R.SK.spgemm_condense(ai, av, bi, bv, **kw)
    work = {"index_match_spmm": _match_work(ai, bi, pairs, m, False, n=n),
            "spgemm_condense": _match_work(ai, bi, pairs, m, True),
            "spgemm_merge": _merge_work(stripes)}
    runs = {
        "index_match_spmm": (
            lambda: R.IM.index_match_spmm(ai, av, bi, bv, **kw),
            lambda: R.IM.plain(ai, av, bi, bv, **kw)),
        "spgemm_condense": (
            lambda: R.SK.spgemm_condense(ai, av, bi, bv, **kw),
            lambda: R.SK.plain_condense(ai, av, bi, bv, **kw)),
        "spgemm_merge": (
            lambda: R.SK.spgemm_merge(stripes, bm=128, bn=128),
            lambda: R.SK.plain_merge(stripes, bm=128, bn=128))}
    a_csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr), torch.from_numpy(cols.astype(np.int64)),
        base.values.cpu(), size=(m, t["d_model"])).to("cuda")
    b_dense = torch.from_numpy(bt.to_dense().T.copy()).to("cuda")
    library = {"index_match_spmm": _time_ms(
        torch, lambda: torch.sparse.mm(a_csr, b_dense), flush, reps=10),
        "spgemm_condense": None,
        "spgemm_merge": _time_ms(torch, lambda: stripes.sum(0), flush)}
    del a_csr, b_dense
    rows, line = {}, {}
    for name, (fn, plain) in runs.items():
        ms = _time_ms(torch, fn, flush, reps=10)
        plain_ms = _time_ms(torch, plain, flush, reps=3)
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        rows[name] = {"launches": counts.get(name, 0), "ms": ms,
                      "plain_ms": plain_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "library_ms": library[name],
                      "max_abs_err": kerr[name], "instance": instances[name]}
        line[name] = dict(rows[name], bytes=nbytes, flops=flops)
    del stripes, flush
    emit({"phase": "crs_plan", "workload": "granite-34b W_up^T x top-5% "
          "activations", "a_shape": [m, t["d_model"]], "nnz": pat.nnz,
          "rhs_shape": list(bt.shape), "rhs_nnz": bt.nnz,
          "rounds": g["rounds"], "prep": {"a": list(ai.shape),
                                          "b": list(bi.shape)},
          "matched_pairs": pairs, "stripe_bytes": stripe_bytes,
          "host": host, "oracle_s": oracle_s, "calls": calls,
          "max_abs_err_f64": errs, "c_max": c_max, "launches": counts,
          "library": {"index_match_spmm": "torch.sparse.mm(A_csr, B)",
                      "spgemm_merge": "stripes.sum(0)"},
          "kernels": line})
    return rows


def phase_crs_plan_docword(torch, R, crs):
    """mesh-docword4 (Table IV), C = A @ A^T at R = 128 and 32: a bound crs
    plan's calls (the first preps the RHS, the rest hit its memo) beside
    ``ops.spmm(A, A)`` through the same engine on the same operands, each
    bitwise equal to it; walls split as in phase spgemm."""
    for rounds in (128, 32):
        t0 = time.perf_counter()
        ref_plan = R.api.plan_for_operand(crs, R.api.SparseSpec(
            "crs", rounds=rounds), device="cuda")
        torch.cuda.synchronize()
        plan_ms = (time.perf_counter() - t0) * 1e3
        cm_plan = R.api.plan(R.api.SparseSpec(
            "crs", pattern=ref_plan.pattern, rounds=rounds,
            rhs_format="crs")).bind(ref_plan.values)
        for engine, bound in (("reference", ref_plan),
                              ("condense_merge", cm_plan)):
            spmm, plan = [], []
            for _ in range(DOCWORD_CALLS):
                want, timing = _timed_call(torch, lambda: R.ops.spmm(
                    crs, crs, variant=engine, rounds=rounds, device="cuda"))
                spmm.append(timing)
            before = _every_count(R)
            for _ in range(DOCWORD_CALLS):
                got, timing = _timed_call(torch, lambda: bound(crs))
                plan.append(timing)
            moved = {k: v - before[k] for k, v in _every_count(R).items()
                     if v != before[k]}
            check(moved == {k: DOCWORD_CALLS for k in
                            ENGINE_LAUNCHES[engine]},
                  f"mesh-docword4 crs plan {engine} R={rounds}: launches "
                  f"{moved}")
            check(torch.equal(got, want), f"mesh-docword4 crs plan {engine} "
                  f"R={rounds}: bitwise equal to ops.spmm(A, A)")

            def med(runs, key):
                return statistics.median(r[key] for r in runs)
            emit({"phase": "crs_plan_docword", "workload": "mesh-docword4",
                  "engine": engine, "rounds": rounds, "shape": list(
                      got.shape), "nnz": crs.nnz, "plan_host_ms": plan_ms,
                  "plan_first_call": plan[0], "plan_calls": plan,
                  "spmm_calls": spmm,
                  "plan_memo_hit_wall_ms_median": med(plan[1:], "wall_ms"),
                  "spmm_wall_ms_median": med(spmm, "wall_ms"),
                  "plan_memo_hit_cpu_ms_median": med(plan[1:], "cpu_ms"),
                  "spmm_cpu_ms_median": med(spmm, "cpu_ms")})
            del want, got
        del ref_plan, cm_plan
        torch.cuda.empty_cache()


def crs_plan_path(torch):
    """Phase crs_plan at granite and at mesh-docword4: the rows'
    additions."""
    from repro_torch.configs.paper_spmm import WORKLOADS
    from repro_torch.data import datasets
    R = _train_modules()
    rows = phase_crs_plan(torch, R)
    torch.cuda.empty_cache()
    phase_crs_plan_docword(torch, R, datasets.synthesize(
        WORKLOADS["mesh-docword4"].dataset, seed=0))
    return rows


# ----------------------------------------------------------------------
# LM serving: granite-34b through ServeEngine, prompts of FLASH_THRESHOLD
# tokens or more prefilling through the flash-attention kernel.
LM_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
LM_REPLACES = "src/repro/kernels/flash_attention.py:38"
# Against plain f32 on the same inputs: f32 max|kernel - plain| <= tol *
# max|out| over the whole output; bf16 the same bound on every query row,
# with that row's max|out| (F.worst_row_error), since the whole output's
# max comes from the first rows, which average a few keys.
LM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
LM_FAULT_ROW = 4096           # the planted fault: key tile 0 dropped from
                              # granite's query rows at and past this one
LM_DEPTH = 4                  # granite-34b cut from 88 layers, widths kept
LM_LOGIT_TOL = 1e-3           # f32 decode logits vs teacher-forced prefill
# (label, B, S, KV, G, hd, window, soft cap): granite-34b's prefill wave,
# its 24 heads a coordinate of model 2 (phase lm_dist's prefill),
# mixtral-8x7b's and recurrentgemma-2b's attention shapes, edge shapes.
LM_KERNEL_CASES = [
    ("granite", 2, 8192, 1, 48, 128, None, None),
    ("granite_rank", 1, 8192, 1, 24, 128, None, None),
    ("mixtral", 1, 8192, 8, 4, 128, 4096, None),
    ("recurrentgemma", 1, 4096, 1, 10, 256, 2048, 30.0),
    # phase lm_families' prefill shapes (mixtral's is the one above)
    ("qwen2-moe", 1, 8192, 16, 1, 128, None, None),
    ("musicgen", 1, 8192, 24, 1, 64, None, None),
    ("internvl2", 1, 8192, 2, 7, 64, None, None),
] + [(f"edge_s{s}_hd{hd}", 2, s, 2, 3, hd, None, None)
     for s in (1, 63, 65, 200, 1000) for hd in (16, 64)] + [
    ("edge_window_cap", 2, 200, 2, 3, 64, 37, 6.0),
    ("edge_window", 1, 1000, 1, 4, 16, 100, None),
]


def _causal_pairs(sq, sk, window, q_offset=0):
    """Number of (query, key) pairs the mask keeps: the work of the call
    (query row r at position r + ``q_offset``)."""
    i = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1)
    lo = np.zeros_like(i) if window is None else np.maximum(0, i - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _drop_first_key_tile(torch, q, k, v, row0):
    """Causal attention of q's rows row0.. (B, S, 1, G, hd) over k, v
    without the keys of the first 64-key tile, in f32: what a kernel that
    skipped that tile for those rows would return."""
    b, s, _, g, hd = q.shape
    out = torch.empty(b, s - row0, g, hd, device=q.device)
    i = torch.arange(row0, s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    keep = (j <= i) & (j >= 64)
    for bi in range(b):
        kk, vv = k[bi, :, 0].float(), v[bi, :, 0].float()
        for g0 in range(0, g, 8):
            qq = q[bi, row0:, 0, g0:g0 + 8].float().transpose(0, 1)
            sc = (qq @ kk.T / hd ** 0.5).masked_fill(~keep, float("-inf"))
            out[bi, :, g0:g0 + 8] = (torch.softmax(sc, -1) @ vv).transpose(
                0, 1)
            del sc
    return out


def phase_lm_kernels(torch, F):
    """The flash kernel against its plain version on the card, f32 and
    bf16, at the model shapes and edge shapes; the worst error of each.
    At granite's wave the bf16 check is also shown a planted fault (key
    tile 0 dropped from the rows past LM_FAULT_ROW) and must reject it."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs, cases = {}, []
    for label, b, s, kv, g, hd, window, cap in LM_KERNEL_CASES:
        q32 = torch.randn(b, s, kv, g, hd, generator=gen, device="cuda")
        k32 = torch.randn(b, s, kv, hd, generator=gen, device="cuda")
        v32 = torch.randn(b, s, kv, hd, generator=gen, device="cuda")
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            route = F.ROUTES[dt]
            before = dict(F.ROUTE_LAUNCHES)
            out = F.flash_attention(q, k, v, window=window, soft_cap=cap)
            torch.cuda.synchronize()
            check({r: F.ROUTE_LAUNCHES[r] - before[r] for r in before} ==
                  {r: int(r == route) for r in before},
                  f"flash {label} {dname} launched the {route} kernel once "
                  f"and no other")
            want = F.plain(q.float(), k.float(), v.float(), window=window,
                           soft_cap=cap)
            scale = float(want.abs().max())
            err = float((out.float() - want).abs().max())
            row_err = F.worst_row_error(out, want)
            within = (row_err <= LM_TOL[dname] if dt == torch.bfloat16
                      else err <= LM_TOL[dname] * scale)
            ok = (out.dtype == dt and tuple(out.shape) == tuple(q.shape) and
                  bool(torch.isfinite(out).all()) and within)
            case = {"case": label, "dtype": dname, "kernel": route,
                    "shape": [b, s, kv, g, hd], "window": window,
                    "soft_cap": cap, "max_abs_err": err,
                    "max_abs_out": scale, "worst_row_error": row_err,
                    "ok": ok}
            check(ok, f"flash kernel {label} {dname}: err {err} (worst "
                  f"row {row_err}) over {LM_TOL[dname]} (max|out| {scale})")
            if label == "granite" and dt == torch.bfloat16:
                bad = out.clone()
                bad[:, LM_FAULT_ROW:, 0] = _drop_first_key_tile(
                    torch, q, k, v, LM_FAULT_ROW).to(dt)
                fault = {"what": f"key tile 0 dropped from query rows >= "
                                 f"{LM_FAULT_ROW}",
                         "worst_row_error": F.worst_row_error(bad, want),
                         "whole_output_error": float(
                             (bad.float() - want).abs().max()) / scale}
                fault["rejected"] = fault["worst_row_error"] > LM_TOL[dname]
                case["planted_fault"] = fault
                check(fault["rejected"], f"the bf16 check let a planted "
                      f"fault through: {fault}")
                del bad
            cases.append(case)
            errs[f"{label}/{dname}"] = err
            del out, want
    emit({"phase": "lm_kernels", "tolerance": {
        "float32": f"max|err| <= {LM_TOL['float32']} * max|out| against "
                   f"plain f32 on the same inputs",
        "bfloat16": f"on every query row, max|err| <= "
                    f"{LM_TOL['bfloat16']} * that row's max|out|, against "
                    f"plain f32 on the same inputs"}, "cases": cases})
    return errs


def _lm_requests(E, vocab, n, length, max_new, rid0, seed):
    rng = np.random.default_rng(seed)
    return [E.Request(rid0 + i, rng.integers(0, vocab, length).astype(
        np.int32), max_new=max_new) for i in range(n)]


def _serve_lm(torch, E, model, reqs):
    eng = E.ServeEngine(model, n_slots=4, cache_dtype=torch.bfloat16, seed=0)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def phase_lm_serve(torch, F, L):
    """granite-34b at full width, depth cut to LM_DEPTH, weights seeded on
    the card: ServeEngine(n_slots=4) serves 2 requests of 8,192 tokens (one
    flash wave) then 4 of 512 (a dense-branch wave), 16 new tokens each,
    with the flash counter at 0 just before and read after each set. Then
    the long wave under torch.profiler for the idle share, an f32 check of
    the decode logits against a teacher-forced prefill, and the launcher
    as a subprocess."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    full = L.configs.get("granite-34b")
    cfg = dataclasses.replace(full, n_layers=LM_DEPTH)
    t0 = time.perf_counter()
    model = L.M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    v, max_new = cfg.vocab_size, 16
    long_reqs = _lm_requests(L.E, v, 2, 8192, max_new, 0, seed=1)
    short_reqs = _lm_requests(L.E, v, 4, 512, max_new, 10, seed=2)
    F.reset_launches()
    eng_l, wall_l = _serve_lm(torch, L.E, model, long_reqs)
    launches_long = F.LAUNCHES["flash_attention"]
    check(F.ROUTE_LAUNCHES["bf16_wgmma"] == launches_long,
          f"the bf16 wave ran only the bf16 kernel: {F.ROUTE_LAUNCHES}")
    eng_s, wall_s = _serve_lm(torch, L.E, model, short_reqs)
    launches = F.LAUNCHES["flash_attention"]
    for r in long_reqs + short_reqs:
        check(r.done and len(r.out) == max_new and
              all(0 <= t < cfg.padded_vocab() for t in r.out),
              f"lm request {r.rid} returned {max_new} tokens")
    check(launches_long == LM_DEPTH, f"long wave launched the flash kernel "
          f"{launches_long} times, not {LM_DEPTH} (one per layer)")
    check(launches == launches_long, f"the 512-token wave launched the "
          f"flash kernel {launches - launches_long} times, not 0")
    new_tokens = sum(len(r.out) for r in long_reqs + short_reqs)

    # Both sets again, warm (the counted run was the process's first, with
    # cuBLAS's and the allocator's first calls in it); then the long wave
    # profiled: device busy time against the warm wall (the profiler slows
    # the host).
    warm_l, warm_wall_l = _serve_lm(torch, L.E, model, _lm_requests(
        L.E, v, 2, 8192, max_new, 0, seed=1))
    warm_s, warm_wall_s = _serve_lm(torch, L.E, model, _lm_requests(
        L.E, v, 4, 512, max_new, 10, seed=2))
    F.reset_launches()
    # Kineto's lines of dropped or discarded records kept (P4)
    with _Stderr() as err, profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) \
            as prof:
        _, wall_prof = _serve_lm(torch, L.E, model, _lm_requests(
            L.E, v, 2, 8192, max_new, 0, seed=1))
    by_kind, by_route, records = lm_profile_tally(torch, F, prof)
    records["flash_launches"] = F.LAUNCHES["flash_attention"]
    records["kineto_lines"] = err.p4
    in_process = dict(records, wall_ms_profiled=wall_prof * 1e3)
    complete = records["flash_records"] == records["flash_launches"] and \
        records["kernel_records"] >= records["launch_calls"]
    fresh = None
    if not complete:
        # records lost in this long process (P4): the same wave profiled in
        # a fresh process, repeated until one run records every launch
        fresh = lm_profile_fresh(torch)
        by_kind, by_route = fresh["device_ms_by_kind"], fresh[
            "flash_ms_by_kernel"]
        wall_prof = fresh["wall_ms_profiled"] / 1e3
    busy_ms = sum(by_kind.values())
    check(busy_ms > 0, "the profiler recorded device time on the long wave")
    check(by_route["bf16_wgmma"] > 0 and by_route["f32_fma"] == 0,
          f"the profiled bf16 wave's flash time is the bf16 kernel's: "
          f"{by_route}")

    # f32: the same weights, decode logits against a teacher-forced
    # prefill over prompt + generated tokens (which runs the kernel again)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = L.M.Model(cfg32, device="meta")
    model32.load_state_dict(model.state_dict(), assign=True)
    prompts = np.stack([r.prompt for r in long_reqs])
    logits, cache = L.M.prefill_step(model32, prompts, alloc_seq=8192 + 80,
                                     cache_dtype=torch.float32)
    steps = [logits.float()]
    toks = []
    for step in range(max_new - 1):
        tok = steps[-1].argmax(-1, keepdim=True)
        toks.append(tok)
        logits, cache = L.M.decode_step(model32, tok, cache,
                                        pos=8192 + step)
        steps.append(logits.float())
    del cache
    fed = torch.cat([torch.from_numpy(prompts).to("cuda").long()] + toks, 1)
    F.reset_launches()
    with torch.no_grad():   # a prefill: train mode never runs the kernel
        tf = model32(fed, mode="prefill")[0][:, 8191:].float()
    tf_launches = F.LAUNCHES["flash_attention"]
    dec = torch.stack(steps, 1)
    scale = float(tf.abs().max())
    logit_err = float((dec - tf).abs().max())
    check(tuple(dec.shape) == tuple(tf.shape) and
          bool(torch.isfinite(dec).all()), "f32 logits finite, right shape")
    check(logit_err <= LM_LOGIT_TOL * scale, f"f32 decode logits vs "
          f"teacher-forced prefill: {logit_err} > {LM_LOGIT_TOL} * {scale}")
    check(tf_launches == LM_DEPTH, "teacher-forced prefill ran the kernel")
    del tf, dec, steps, model32, model
    torch.cuda.empty_cache()

    line = _run_lm_launcher(["--arch", "granite-34b", "--smoke",
                             "--prompt-len", "8192", "--n-requests", "2",
                             "--max-new", "4"], expect_launches=2)
    def wave(eng, n, prompt, wall_s):
        return {"requests": n, "prompt": prompt, "prefill_ms": eng.prefill_ms,
                "decode_ms_median": statistics.median(eng.decode_ms),
                "wall_s": wall_s}

    emit({"phase": "lm_serve", "arch": cfg.name,
          "cut": f"n_layers {full.n_layers} -> {LM_DEPTH}; widths as "
                 f"published", "params": n_params, "param_dtype":
          cfg.param_dtype, "dtype": cfg.dtype, "init_s": init_s,
          "counted_run": {
              "long": wave(eng_l, 2, 8192, wall_l),
              "short": wave(eng_s, 4, 512, wall_s),
              "new_tokens_per_s": new_tokens / (wall_l + wall_s)},
          "warm_run": {
              "long": wave(warm_l, 2, 8192, warm_wall_l),
              "short": wave(warm_s, 4, 512, warm_wall_s),
              "new_tokens_per_s": new_tokens / (warm_wall_l + warm_wall_s)},
          "new_tokens": new_tokens,
          "flash_launches": {"long_wave": launches_long,
                             "short_wave": launches - launches_long},
          "profile_long_wave": {"wall_ms": warm_wall_l * 1e3,
                                "wall_ms_profiled": wall_prof * 1e3,
                                "in_process_records": in_process,
                                "in_process_complete": complete,
                                "fresh_process": fresh,
                                "device_ms_by_kind": by_kind,
                                "flash_ms_by_kernel": by_route,
                                "device_busy_ms": busy_ms,
                                "device_idle_share": 1.0 - busy_ms /
                                (warm_wall_l * 1e3)},
          "f32_check": {"max_abs_err": logit_err, "max_abs_logit": scale,
                        "tolerance": f"{LM_LOGIT_TOL} * max|logit|",
                        "teacher_forced_launches": tf_launches},
          "launcher": line})
    return launches, line["launches"]


# Host ops that launch one library GEMM each (aten::matmul and
# aten::linear call these), and the host calls that launch any kernel.
LM_GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
LAUNCH_CALLS = ("cudalaunchkernel", "culaunchkernel", "cudalaunchkernelexc",
                "culaunchkernelex", "cudalaunchcooperativekernel")


def lm_profile_tally(torch, F, prof):
    """One profiled long wave's device ms by kind (the flash kernels by
    the names the wrapper exports, tested first since a library GEMM's
    name may hold any word; then the library GEMMs; then the rest) and by
    flash route, and its record counts: the flash kernels' device records
    (held against the flash counter by the caller), the GEMMs' device
    records beside the host's GEMM ops, and every kernel's device records
    beside the host's launch calls. A device record missing where its
    host call is present is a lost record (ROADMAP P4)."""
    by_kind = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    by_route = {r: 0.0 for r in F.KERNEL_SYMBOLS}
    rec = {"flash_records": 0, "gemm_records": 0, "host_gemm_ops": 0,
           "kernel_records": 0, "memcpy_records": 0, "launch_calls": 0}
    for ev in prof.key_averages():
        key = ev.key.lower()
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.key in LM_GEMM_OPS:
                rec["host_gemm_ops"] += ev.count
            elif key in LAUNCH_CALLS:
                rec["launch_calls"] += ev.count
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        route = next((r for r, sym in F.KERNEL_SYMBOLS.items()
                      if sym.lower() in key), None)
        kind = ("flash_attention" if route else
                "gemm" if any(w in key for w in ("gemm", "nvjet", "xmma",
                                                 "cutlass")) else "other")
        by_kind[kind] += us / 1e3
        if route:
            by_route[route] += us / 1e3
            rec["flash_records"] += ev.count
        if kind == "gemm":
            rec["gemm_records"] += ev.count
        if "memcpy" in key or "memset" in key:
            rec["memcpy_records"] += ev.count
        else:
            rec["kernel_records"] += ev.count
    return by_kind, by_route, rec


def lm_profile_fresh(torch):
    """Phase lm_serve's long wave profiled in a fresh process
    (``chip_smoke.py --lm-profile``): its device ms by kind and by flash
    route from the fullest of up to ``PROFILE_TRIES`` runs, and each run's
    record counts."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--lm-profile"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"lm profile child exited "
          f"{proc.returncode}: {proc.stderr.strip()[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(any(r["flash_records"] == r["flash_launches"]
              for r in out["records_by_run"]),
          f"lm profile child: no run recorded every flash launch: "
          f"{out['records_by_run']}")
    return out


def lm_profile_child(sessions=None) -> int:
    """The fresh process of ``lm_profile_fresh``: granite-34b cut to
    LM_DEPTH layers, seeded as phase lm_serve seeds it, serves the long
    wave twice warm, then under torch.profiler until a run records every
    flash launch (at most ``PROFILE_TRIES``); prints one JSON line. With
    ``sessions`` (``chip_smoke.py --lm-profile SESSIONS``) it profiles
    that many runs one after another, none skipped, and first prints the
    card's line and a line a run (ROADMAP P4: whether a loss follows the
    sessions before it in the process)."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, SRC)
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as F
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    cfg = dataclasses.replace(configs.get("granite-34b"), n_layers=LM_DEPTH)
    model = M.init(cfg, seed=0, device="cuda")
    reqs = lambda: _lm_requests(E, cfg.vocab_size, 2, 8192, 16, 0, seed=1)
    for _ in range(2):
        _serve_lm(torch, E, model, reqs())
    if sessions:
        print(smi_line(), flush=True)
    runs, best = [], None
    for _ in range(sessions or PROFILE_TRIES):
        F.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = _serve_lm(torch, E, model, reqs())
        by_kind, by_route, rec = lm_profile_tally(torch, F, prof)
        rec["flash_launches"] = F.LAUNCHES["flash_attention"]
        rec["wall_ms_profiled"] = wall * 1e3
        rec["lost_kernel_records"] = rec["launch_calls"] - \
            rec["kernel_records"]
        runs.append(rec)
        if sessions:
            print(json.dumps({"session": len(runs), **rec}), flush=True)
        if best is None or rec["kernel_records"] > best[2]["kernel_records"]:
            best = (by_kind, by_route, rec)
        if not sessions and rec["flash_records"] == rec["flash_launches"]:
            break
    print(json.dumps({"records_by_run": runs, "device_ms_by_kind": best[0],
                      "flash_ms_by_kernel": best[1],
                      "wall_ms_profiled": best[2]["wall_ms_profiled"]}),
          flush=True)
    return 0


def _run_lm_launcher(args, expect_launches):
    import re
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    line = {"cmd": " ".join(cmd[3:]), "rc": proc.returncode,
            "wall_s": time.perf_counter() - t0}
    # the output's tails go into the failure itself: this may run on a
    # thread while another redirects stdout
    check(proc.returncode == 0, f"launcher {' '.join(args)} exited 0, not "
          f"{proc.returncode}; stdout {proc.stdout[-2000:]!r}, stderr "
          f"{proc.stderr[-2000:]!r}")
    m = re.search(r"kernel launches (\{.*\})", proc.stdout)
    check(m is not None, "launcher printed its kernel launches")
    line["launches"] = json.loads(m.group(1))["flash_attention"]
    check(line["launches"] == expect_launches,
          f"launcher launched the flash kernel {line['launches']} times, "
          f"not {expect_launches}")
    return line


def phase_lm_times(torch, F, errs, launches, by_launcher):
    """granite-34b's prefill wave in bf16: the kernel's median time beside
    its plain version, scaled_dot_product_attention and the bound."""
    b, s, kv, g, hd = 2, 8192, 1, 48, 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b, s, kv, g, hd), (b, s, kv, hd),
                                      (b, s, kv, hd)))
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    before = dict(F.ROUTE_LAUNCHES)
    ms = _time_ms(torch, lambda: F.flash_attention(q, k, v), flush)
    check(F.ROUTE_LAUNCHES["f32_fma"] == before["f32_fma"],
          "the timed bf16 calls ran the bf16 kernel only")
    q32, k32, v32 = q.float(), k.float(), v.float()
    ms_f32 = _time_ms(torch, lambda: F.flash_attention(q32, k32, v32), flush)
    del q32, k32, v32
    plain_ms = _time_ms(torch, lambda: F.plain(q, k, v), flush, reps=10)
    # SDPA in its (B, H, S, hd) layout on the same values, copied once
    fn = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(b, s, kv * g, hd).transpose(1, 2).contiguous()
    ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
    try:
        sdpa = lambda: fn(qs, ks, vs, is_causal=True, enable_gqa=True)  # noqa: E731
        got = sdpa()
        how = "enable_gqa=True"
    except TypeError:
        ks, vs = (t.repeat_interleave(g, dim=1) for t in (ks, vs))
        sdpa = lambda: fn(qs, ks, vs, is_causal=True)  # noqa: E731
        got = sdpa()
        how = "k/v expanded by repeat_interleave"
    ours = F.flash_attention(q, k, v).float().reshape(b, s, kv * g, hd)
    sdpa_err = float((got.float().transpose(1, 2) - ours).abs().max())
    check(sdpa_err <= 2e-2 * float(ours.abs().max()),
          f"SDPA and the kernel disagree by {sdpa_err}")
    del got, ours
    library_ms = _time_ms(torch, sdpa, flush)
    ke, ve = (t.repeat_interleave(g, dim=1) for t in (ks, vs)) \
        if ks.shape[1] != qs.shape[1] else (ks, vs)
    expanded_ms = _time_ms(torch, lambda: fn(qs, ke, ve, is_causal=True),
                           flush)
    del ke, ve
    flops = 4 * hd * b * kv * g * _causal_pairs(s, s, None)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, out, k, v
    t_ops = flops / BF16_TC_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "lm_times", "shape": [b, s, kv, g, hd],
          "dtype": "bfloat16", "ms": ms, "ms_f32_inputs": ms_f32,
          "plain_ms": plain_ms, "library": f"scaled_dot_product_attention"
          f"(is_causal=True), {how}", "library_ms": library_ms,
          "library_kv_expanded_ms": expanded_ms,
          "library_vs_kernel_max_abs_diff": sdpa_err, "flops": flops,
          "bytes": nbytes, "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
          "bound_share": max(t_ops, t_bytes) / ms,
          "kernel": F.KERNEL_SYMBOLS["bf16_wgmma"],
          "kernel_f32_inputs": F.KERNEL_SYMBOLS["f32_fma"],
          "achieved_tflops": flops / ms / 1e9,
          "achieved_tflops_f32_inputs": flops / ms_f32 / 1e9})
    return [{"name": "flash_attention", "route": "cuda", "source": LM_SOURCE,
             "replaces": LM_REPLACES, "launches": launches,
             "launches_by_path": {"lm_serve": launches,
                                  "launcher_subprocess": by_launcher},
             "max_abs_err": errs["granite/bfloat16"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}]


def lm_path(torch):
    """Phases 15-17: the LM serving path and the flash kernel's rows."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as F
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    L = types.SimpleNamespace(configs=configs, M=M, E=E)
    errs = phase_lm_kernels(torch, F)
    torch.cuda.empty_cache()
    launches, by_launcher = phase_lm_serve(torch, F, L)
    return phase_lm_times(torch, F, errs, launches, by_launcher)


# ----------------------------------------------------------------------
# LM training: granite-34b at full width, depth cut to LM_DEPTH, trained
# by the port's trainer (remat "dots", bf16 compute, f32 params, AdamW);
# a one-layer f32 step held against float64; the train-mode attention
# repair at S = 8192; GPipe stages over InCRS; the training launcher.
LM_TRAIN = {"batch": 4, "seq": 2048, "steps": 8, "lr": 1e-4, "seed": 21}
LM_TRAIN_GRAD_TOL = 1e-4   # f32 step 0: max|g - g64| <= tol * max|g64|
LM_TRAIN_LOSS_RTOL = 2e-2  # bf16 step-0 loss against the f32 one
# bf16 step 0, per tensor r = max|g16 - g64| / max|g64|: the worst tensor
# must read at least the floor (a run that silently stays in f32 reads
# as the f32 run does) and at most the limit (a planted fault, the
# attention cut to a window of LM_TRAIN_FAULT_WINDOW keys, must read
# above it). Both lie between those readings and the sound bf16 one.
LM_TRAIN_BF16_BAND = (1e-4, 1e-1)
LM_TRAIN_FAULT_WINDOW = 16
LM_CHECK = {"batch": 2, "seq": 1024}  # the one-layer float64 check's batch
REPAIR = {"seq": 8192, "d_model": 64, "n_heads": 4, "d_ff": 128,
          "vocab": 512, "seed": 22}
REPAIR_TOL = 1e-4          # card grads: max|g - g_cpu| <= tol * max|g_cpu|
PIPE = {"stages": 4, "d": 6144, "density": 0.1, "section": 256,
        "block": 32, "n_micro": 8, "rows": 512, "steps": 2, "seed": 23}
PIPE_TOL = 1e-4            # step 0: max|g - g64| <= tol * max|g64|, live


def _lm_train_modules():
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import specs
    from repro_torch.kernels import incrs_spmm as K
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.sparse import api
    from repro_torch.sparse import linear as lin
    from repro_torch.train import optimizer as O
    from repro_torch.train import pipeline as P
    from repro_torch.train import trainer
    return types.SimpleNamespace(configs=configs, Tokens=SyntheticTokens,
                                 F=F, K=K, ops=ops, make_mesh=make_mesh,
                                 M=M, api=api, lin=lin, O=O, P=P,
                                 trainer=trainer, specs=specs)


def _rel_errs(got, want):
    """{name: max|got - want| / max|want|} over two name -> tensor maps."""
    out = {}
    for k, w in want.items():
        w = w.double()
        scale = max(float(w.abs().max()), 1e-300)
        out[k] = float((got[k].double() - w).abs().max()) / scale
    return out


def phase_lm_train_check(torch, T):
    """One granite-34b layer at full width on one batch, against a
    float64 run on the card: step 0's f32 grads (TF32 off), and the bf16
    run's grads per tensor inside LM_TRAIN_BF16_BAND with its loss near
    the f32 one; a planted fault (a bf16 run whose attention sees only
    LM_TRAIN_FAULT_WINDOW keys) and the f32 run itself must fall outside
    the band, so the band can tell a wrong or a non-bf16 run."""
    import dataclasses
    base = dataclasses.replace(T.configs.get("granite-34b"), n_layers=1,
                               dtype="float32")
    batch = T.Tokens(base.vocab_size, LM_CHECK["batch"], LM_CHECK["seq"],
                     seed=LM_TRAIN["seed"]).batch_at(0)
    m32 = T.M.init(base, seed=LM_TRAIN["seed"], device="cuda")
    l32, g32 = T.trainer.loss_and_grads(m32, batch)
    m64 = T.M.Model(dataclasses.replace(base, dtype="float64",
                                        param_dtype="float64"),
                    device="cuda")
    m64.load_state_dict(m32.state_dict())
    l64, g64 = T.trainer.loss_and_grads(m64, batch)
    del m64
    errs = _rel_errs(g32, g64)
    del g32
    runs = {}
    for name, cfg in (
            ("bf16", dataclasses.replace(base, dtype="bfloat16")),
            ("fault", dataclasses.replace(
                base, dtype="bfloat16",
                sliding_window=LM_TRAIN_FAULT_WINDOW))):
        m = T.M.Model(cfg, device="cuda")
        m.load_state_dict(m32.state_dict())
        loss, g = T.trainer.loss_and_grads(m, batch)
        runs[name] = (float(loss), _rel_errs(g, g64))
        del m, g
    del g64, m32
    torch.cuda.empty_cache()
    worst = max(errs, key=errs.get)
    l16, e16 = runs["bf16"]
    lf, ef = runs["fault"]
    w16, wf = max(e16, key=e16.get), max(ef, key=ef.get)
    lo, hi = LM_TRAIN_BF16_BAND
    loss_rel = abs(l16 - float(l32)) / abs(float(l32))
    fault_loss_rel = abs(lf - float(l32)) / abs(float(l32))
    emit({"phase": "lm_train_check", "layers": 1, "batch": LM_CHECK,
          "loss_f32": float(l32), "loss_f64": float(l64),
          "loss_bf16": l16, "bf16_loss_rel": loss_rel,
          "grad_rel_err_f32_vs_f64": errs, "worst": [worst, errs[worst]],
          "grad_rel_err_bf16_vs_f64": e16, "worst_bf16": [w16, e16[w16]],
          "fault": {"sliding_window": LM_TRAIN_FAULT_WINDOW,
                    "loss": lf, "loss_rel": fault_loss_rel,
                    "grad_rel_err_vs_f64": ef, "worst": [wf, ef[wf]]},
          "tolerance": f"per tensor max|g32 - g64| <= {LM_TRAIN_GRAD_TOL} "
                       f"* max|g64|; bf16 worst tensor's max|g16 - g64| / "
                       f"max|g64| in [{lo}, {hi}], the f32 run below and "
                       f"the fault above; |loss16 - loss32| <= "
                       f"{LM_TRAIN_LOSS_RTOL} * |loss32|"})
    check(errs[worst] <= LM_TRAIN_GRAD_TOL, f"lm_train: f32 grad {worst} "
          f"off float64 by {errs[worst]} of its max")
    check(lo <= e16[w16] <= hi, f"lm_train: bf16 grads' worst tensor {w16} "
          f"off float64 by {e16[w16]} of its max, outside [{lo}, {hi}]")
    check(errs[worst] < lo and ef[wf] > hi, f"lm_train: the band [{lo}, "
          f"{hi}] does not part the f32 run ({errs[worst]}) and the planted "
          f"fault ({ef[wf]}) from the bf16 run")
    check(loss_rel <= LM_TRAIN_LOSS_RTOL, f"lm_train: bf16 loss {l16}"
          f" off the f32 loss {float(l32)} by {loss_rel}")


def _lm_train_steps(torch, T, cfg, label, one_batch=False, n_micro=1):
    """LM_TRAIN["steps"] AdamW steps of a model of ``cfg`` seeded on the
    card, on SyntheticTokens batches (with their prefix embeds for an
    embeds config; with ``one_batch`` every step on step 0's batch), each
    batch in ``n_micro`` microbatches, each step
    split by CUDA events into forward + backward and
    the optimizer; tokens/s, loss, grad norm and peak memory a step. With
    ``one_batch`` also the loss of the step-0 weights on each of the
    batches that fresh-batch steps would take: their spread. Also step
    0's grads: the parameters whose grad is not finite or all zero, and
    the experts whose grad is zero (no token reached them), counted by
    layer, where an MoE layer's expert tensors must agree on which."""
    g = LM_TRAIN
    t0 = time.perf_counter()
    model = T.M.init(cfg, seed=g["seed"], device="cuda")
    opt = T.O.AdamWConfig(lr=g["lr"], warmup_steps=2,
                          total_steps=g["steps"])
    state = T.O.adamw_init(opt, dict(model.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    card_bytes = {"params": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
                  "opt": T.specs.tree_bytes(state)}
    npfx = cfg.n_prefix_embeds if cfg.input_mode == "embeds" else 0
    src = T.Tokens(cfg.vocab_size, g["batch"], g["seq"], seed=g["seed"],
                   n_prefix=npfx, d_model=cfg.d_model)
    tokens = g["batch"] * g["seq"]
    spread = None
    if one_batch:
        with torch.no_grad():
            spread = [float(T.M.loss_fn(model, {
                k: torch.as_tensor(v, device="cuda")
                for k, v in src.batch_at(step).items()}))
                for step in range(g["steps"])]
    torch.cuda.reset_peak_memory_stats()
    T.F.reset_launches()
    steps, missing, idle = [], [], {}
    for step in range(g["steps"]):
        batch = src.batch_at(0 if one_batch else step)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        w0 = time.perf_counter()
        ev[0].record()
        loss, grads = T.trainer.loss_and_grads(model, batch,
                                               n_micro=n_micro)
        ev[1].record()
        if step == 0:
            for n, gr in grads.items():
                if not bool(torch.isfinite(gr).all()) or \
                        not bool((gr != 0).any()):
                    missing.append(n)
                if gr.ndim == 3:            # (E, ., .): one slice a expert
                    idle.setdefault(n.rsplit(".ffn.", 1)[0], {})[n] = \
                        (gr.flatten(1) == 0).all(1).cpu()
            for layer, by_name in idle.items():
                first = next(iter(by_name.values()))
                if any(not torch.equal(z, first) for z in by_name.values()):
                    missing.append(f"{layer}: idle experts by tensor " + str(
                        {n: z.nonzero().flatten().tolist()
                         for n, z in by_name.items()}))
        params = dict(model.named_parameters())
        _, state, m = T.O.adamw_update(opt, grads, state, params)
        ev[2].record()
        del grads, params
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        fb, om = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        row = {"step": step + 1, "step_ms": fb + om, "fwd_bwd_ms": fb,
               "opt_ms": om, "wall_ms": wall * 1e3,
               "tokens_per_s": tokens / ((fb + om) / 1e3),
               "loss": float(loss), "grad_norm": float(m["grad_norm"]),
               "lr": float(m["lr"]),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        steps.append(row)
        print(f"{label} step {row['step']}: {row['step_ms']:.1f} ms "
              f"(fwd+bwd {fb:.1f}, opt {om:.1f}), {row['tokens_per_s']:,.0f}"
              f" tok/s, loss {row['loss']:.4f}, gnorm "
              f"{row['grad_norm']:.4f}, peak {row['peak_gb']:.2f} GB",
              flush=True)
    flash = T.F.LAUNCHES["flash_attention"]
    del model, state
    torch.cuda.empty_cache()
    warm = steps[1:]
    return {"params": n_params, "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype, "remat": cfg.remat_policy,
            "batch": [g["batch"], g["seq"]], "n_micro": n_micro,
            "prefix_embeds": npfx,
            "one_batch": one_batch, "step0_loss_on_each_batch": spread,
            "init_s": init_s, "steps": steps, "median_warm": {
                k: statistics.median(r[k] for r in warm)
                for k in ("step_ms", "fwd_bwd_ms", "opt_ms",
                          "tokens_per_s")},
            "peak_gb": max(r["peak_gb"] for r in steps),
            "card_bytes": card_bytes,
            "flash_launches": flash, "params_without_grad": missing,
            "idle_experts": {k: int(next(iter(v.values())).sum())
                             for k, v in idle.items()}}


def _check_lm_train(run, label):
    check(run["params_without_grad"] == [], f"{label}: parameters without "
          f"a finite nonzero grad at step 0, or expert tensors disagreeing "
          f"on the idle experts: {run['params_without_grad']}")
    check(all(np.isfinite(r["grad_norm"]) for r in run["steps"]),
          f"{label}: every grad norm finite")
    first, last = run["steps"][0]["loss"], run["steps"][-1]["loss"]
    check(last < first, f"{label}: the loss {first} -> {last} did not fall")
    check(run["flash_launches"] == 0, f"{label}: train mode launched the "
          f"flash kernel {run['flash_launches']} times")


def phase_lm_train_full(torch, T):
    """granite-34b, LM_DEPTH layers at full width, bf16 compute, f32
    params, remat "dots": ``_lm_train_steps``."""
    import dataclasses
    cfg = dataclasses.replace(T.configs.get("granite-34b"),
                              n_layers=LM_DEPTH)
    run = _lm_train_steps(torch, T, cfg, "lm_train")
    for k in ("idle_experts", "prefix_embeds", "one_batch",
              "step0_loss_on_each_batch"):
        run.pop(k)
    emit({"phase": "lm_train", "model": f"granite-34b, {LM_DEPTH} of 88 "
          f"layers, full width", **run})
    _check_lm_train(run, "lm_train")
    return cfg, run


def phase_lm_train_repair(torch, T):
    """One narrow layer at S = 8192 (FLASH_THRESHOLD) in train mode, f32:
    no flash launch, wq/wk/wv gradients nonzero and equal to the same
    model's CPU gradients; ``ops.flash_mha`` refuses inputs that require
    grad."""
    import dataclasses
    r = REPAIR
    cfg = dataclasses.replace(
        T.configs.get_smoke("granite-34b"), n_layers=1, d_model=r["d_model"],
        n_heads=r["n_heads"], n_kv_heads=1, d_ff=r["d_ff"],
        vocab_size=r["vocab"])
    batch = T.Tokens(cfg.vocab_size, 1, r["seq"], seed=r["seed"]).batch_at(0)
    cpu = T.M.init(cfg, seed=r["seed"], device="cpu")
    card = T.M.init(cfg, seed=r["seed"], device="cpu").to("cuda")
    T.F.reset_launches()
    t0 = time.perf_counter()
    _, gd = T.trainer.loss_and_grads(card, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = T.F.LAUNCHES["flash_attention"]
    t0 = time.perf_counter()
    _, gc = T.trainer.loss_and_grads(cpu, batch)
    cpu_s = time.perf_counter() - t0
    errs = _rel_errs({k: v.cpu() for k, v in gd.items()}, gc)
    qkv = {n: float(gd[f"blocks.0.mixer.{n}"].abs().max())
           for n in ("wq", "wk", "wv")}
    q = torch.randn(1, 256, 1, 4, 64, device="cuda", requires_grad=True)
    k, v = (torch.randn(1, 256, 1, 64, device="cuda") for _ in range(2))
    try:
        T.ops.flash_mha(q, k, v)
        refused = None
    except ValueError as e:
        refused = str(e)
    emit({"phase": "lm_train_repair", "seq": r["seq"], "cfg": {
        "d_model": cfg.d_model, "heads": cfg.n_heads, "head_dim":
        cfg.head_dim, "flash_chunk": cfg.flash_chunk}, "card_s": card_s,
        "cpu_s": cpu_s, "flash_launches": launches,
        "qkv_grad_max": qkv, "grad_rel_err_card_vs_cpu": errs,
        "flash_mha_on_grad_inputs": refused})
    check(launches == 0, f"lm_train_repair: {launches} flash launches")
    check(all(x > 0 for x in qkv.values()), f"lm_train_repair: a zero "
          f"wq/wk/wv gradient: {qkv}")
    worst = max(errs, key=errs.get)
    check(errs[worst] <= REPAIR_TOL, f"lm_train_repair: {worst} off the "
          f"CPU by {errs[worst]} of its max")
    check(refused is not None and "P5" in refused,
          "lm_train_repair: flash_mha refused inputs that require grad")


def _dense_stage_weights(torch, stack):
    """Each stage's dense W (d_in, d_out) in float64 on the card, and the
    (rows, cols) of W^T every live slot holds."""
    meta = stack.meta
    idx = meta.fwd_idx.long()
    live = idx >= 0
    r, s, _ = torch.nonzero(live, as_tuple=True)
    cols = idx[live] + s * meta.section
    ws = []
    for i in range(stack.values.shape[0]):
        wt = torch.zeros(idx.shape[0], idx.shape[1] * meta.section,
                         dtype=torch.float64, device=idx.device)
        wt[r, cols] = stack.values.detach()[i][live].double()
        ws.append(wt[:meta.d_out, :meta.d_in].T.contiguous())
    return ws, live, r, cols


def phase_lm_train_pipeline(torch, T):
    """GPipe over PIPE["stages"] stages of 6144 x 6144 InCRS (density 0.1,
    one shared pattern, ``stack_init``) on cuda:0 named as many times:
    the forward bitwise equal to the stages applied one microbatch at a
    time; step 0's value gradients within PIPE_TOL of a float64 dense
    oracle on the live slots, pad slots 0.0; n_stages * n_micro forward
    and as many dx launches a step; then PIPE["steps"] AdamW steps timed
    beside the stages run one after another on the whole batch."""
    p = PIPE
    spec = T.api.SparseSpec("incrs", density=p["density"],
                            section=p["section"], block=p["block"])
    t0 = time.perf_counter()
    stack = T.api.stack_init(p["stages"], p["d"], p["d"], spec,
                             generator=torch.Generator().manual_seed(
                                 p["seed"]), device="cuda")
    pack_s = time.perf_counter() - t0
    mesh = T.make_mesh(p["stages"], "cuda:0", axis="pipe")
    gen = torch.Generator(device="cuda").manual_seed(p["seed"])
    x = torch.randn(p["n_micro"], p["rows"], p["d"], generator=gen,
                    device="cuda")
    y = torch.randn(x.shape, generator=gen, device="cuda") * 0.5
    stage = T.P.incrs_stage_fn()
    run = (lambda xx: T.P.pipeline_apply(
        stage, stack, xx, n_stages=p["stages"], n_micro=p["n_micro"],
        mesh=mesh))
    per = p["stages"] * p["n_micro"]

    def one(i):
        return T.lin.InCRSLinearParams(stack.values[i], stack.meta)
    with torch.no_grad():
        out = run(x)
        bitwise = True
        for m in range(p["n_micro"]):
            h = x[m]
            for i in range(p["stages"]):
                h = stage(one(i), h)
            bitwise &= bool(torch.equal(out[m], h))
    check(bitwise, "pipeline: the forward differs from the stages applied "
          "one microbatch at a time")
    # step 0's gradient against float64
    ws, live, rows_, cols = _dense_stage_weights(torch, stack)
    xg = x.clone().requires_grad_()
    T.K.reset_launches()
    out = run(xg)
    fwd = dict(T.K.LAUNCHES)
    loss = (out - y).square().mean()
    grad, = torch.autograd.grad(loss, [stack.values])
    launches = dict(T.K.LAUNCHES)
    ws = [w.requires_grad_() for w in ws]
    h64 = x.double()
    for w in ws:
        h64 = torch.tanh(h64 @ w)
    loss64 = (h64 - y.double()).square().mean()
    g64 = torch.autograd.grad(loss64, ws)
    errs, pad_max = [], float(grad[:, ~live].abs().max())
    for i in range(p["stages"]):
        want = g64[i][cols, rows_]          # dW[c, r] of W^T[r, c]
        got = grad[i][live].double()
        errs.append(float((got - want).abs().max()) /
                    max(float(want.abs().max()), 1e-300))
    del ws, h64, g64, grad, out, xg
    kernel_fwd = {k: v for k, v in fwd.items() if v}
    kernel_all = {k: v for k, v in launches.items() if v}
    check(sum(fwd.values()) == per and sum(launches.values()) == 2 * per,
          f"pipeline: {per} forward and {per} dx launches, got {kernel_fwd}"
          f" then {kernel_all}")
    check(max(errs) <= PIPE_TOL, f"pipeline: stage grads off float64 by "
          f"{errs}")
    check(pad_max == 0.0, f"pipeline: pad-slot grads {pad_max}")
    # the timed steps: the schedule, then the stages one after another
    opt = T.O.AdamWConfig(lr=1e-3, weight_decay=0.0, warmup_steps=1,
                          total_steps=p["steps"])
    state = T.O.adamw_init(opt, {"values": stack.values})
    steps, T_counts = [], {}
    T.K.reset_launches()
    for _ in range(p["steps"]):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        xg = x.clone().requires_grad_()
        loss = (run(xg) - y).square().mean()
        grad, = torch.autograd.grad(loss, [stack.values])
        ev[1].record()
        _, state, _ = T.O.adamw_update(opt, {"values": grad}, state,
                                       {"values": stack.values})
        ev[2].record()
        torch.cuda.synchronize()
        steps.append({"loss": float(loss.detach()),
                      "fwd_bwd_ms": ev[0].elapsed_time(ev[1]),
                      "opt_ms": ev[1].elapsed_time(ev[2])})
        del grad, xg, loss
    T_counts = {k: v for k, v in T.K.LAUNCHES.items() if v}
    check(sum(T_counts.values()) == 2 * per * p["steps"], f"pipeline: "
          f"{2 * per} launches a step, got {T_counts}")
    flat = x.reshape(-1, p["d"])
    yf = y.reshape(-1, p["d"])
    seq_ms = []
    for _ in range(p["steps"]):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        h = flat.clone().requires_grad_()
        for i in range(p["stages"]):
            h = stage(one(i), h)
        loss = (h - yf).square().mean()
        torch.autograd.grad(loss, [stack.values])
        ev[1].record()
        torch.cuda.synchronize()
        seq_ms.append(ev[0].elapsed_time(ev[1]))
    emit({"phase": "lm_train_pipeline", "stages": p["stages"],
          "shape": [p["d"], p["d"]], "density": p["density"],
          "values_shape": list(stack.values.shape), "pack_s": pack_s,
          "n_micro": p["n_micro"], "rows": p["rows"],
          "mesh": repr(mesh), "forward_bitwise": bitwise,
          "grad_rel_err_f64": errs, "pad_grad_max": pad_max,
          "launches_step0": {"forward": kernel_fwd, "all": kernel_all},
          "steps": steps, "launches_steps": T_counts,
          "pipeline_fwd_bwd_ms": [s["fwd_bwd_ms"] for s in steps],
          "stages_in_turn_fwd_bwd_ms": seq_ms})
    total = dict(launches)
    for k, v in T_counts.items():
        total[k] = total.get(k, 0) + v
    return {k: v for k, v in total.items() if v}


def phase_lm_train_launcher(torch):
    """The training launcher as subprocesses: 8 smoke steps on the card
    checkpointing every 4, then a second run resumed from the step-4
    checkpoint alone, whose steps 5-8 losses must equal the first's."""
    report_lm_train_launcher(lm_train_launcher_runs())


def lm_train_launcher_runs():
    """``phase_lm_train_launcher``'s two subprocesses (printing nothing):
    their lines and both runs' losses, or the failed run's stderr."""
    import shutil
    import tempfile
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lm_train_", dir=base)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "granite-34b", "--smoke", "--steps", "8", "--log-every", "1"]
    full_ck, part_ck = os.path.join(tmp, "full"), os.path.join(tmp, "part")
    runs = []
    for args in (["--ckpt-dir", full_ck, "--ckpt-every", "4",
                  "--losses-out", os.path.join(tmp, "full.json")],
                 ["--ckpt-dir", part_ck, "--resume", "--losses-out",
                  os.path.join(tmp, "resumed.json")]):
        if "--resume" in args:
            os.makedirs(part_ck)
            shutil.copy(os.path.join(full_ck, "step_00000004.npz"), part_ck)
            with open(os.path.join(part_ck, "manifest.json"), "w") as f:
                json.dump({"steps": [4]}, f)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + args, cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        runs.append({"cmd": " ".join(cmd[3:] + args).replace(tmp, "<tmp>"),
                     "rc": proc.returncode,
                     "wall_s": time.perf_counter() - t0,
                     "tail": proc.stdout.strip().splitlines()[-3:]})
        if proc.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            return {"runs": runs, "stderr": proc.stderr[-2000:]}
    with open(os.path.join(tmp, "full.json")) as f:
        full = {int(k): v for k, v in json.load(f).items()}
    with open(os.path.join(tmp, "resumed.json")) as f:
        resumed = {int(k): v for k, v in json.load(f).items()}
    shutil.rmtree(tmp, ignore_errors=True)
    return {"runs": runs, "full": full, "resumed": resumed}


def report_lm_train_launcher(res):
    """The launcher runs' line and checks."""
    runs = res["runs"]
    if "stderr" in res:
        emit({"phase": "lm_train_launcher", "runs": runs,
              "stderr": res["stderr"]})
    check(all(r["rc"] == 0 for r in runs) and len(runs) == 2,
          "the training launcher exited 0")
    full, resumed = res["full"], res["resumed"]
    diff = {s: resumed[s] - full[s] for s in resumed}
    emit({"phase": "lm_train_launcher", "runs": runs, "losses": full,
          "resumed_losses": resumed, "resumed_minus_full": diff,
          "bitwise": all(d == 0.0 for d in diff.values())})
    check(sorted(resumed) == [5, 6, 7, 8], f"the resumed run ran steps "
          f"{sorted(resumed)}")
    check(full[8] < full[1], f"launcher: the loss {full[1]} -> {full[8]} "
          f"did not fall")
    check(all(d == 0.0 for d in diff.values()), f"launcher: the resumed "
          f"steps' losses differ from the uninterrupted run's: {diff}")


def lm_train_path(torch, launcher=True):
    """Phase lm_train: the check at one layer, the full-width steps, the
    repaired attention, the pipeline and the launcher. Returns the
    pipeline's InCRS launches by kernel, and the full-width run's config
    and result (phase dryrun holds the dry run against them)."""
    T = _lm_train_modules()
    phase_lm_train_check(torch, T)
    torch.cuda.empty_cache()
    granite = phase_lm_train_full(torch, T)
    torch.cuda.empty_cache()
    phase_lm_train_repair(torch, T)
    torch.cuda.empty_cache()
    counts = phase_lm_train_pipeline(torch, T)
    torch.cuda.empty_cache()
    if launcher:            # else in late_checks, beside the others
        phase_lm_train_launcher(torch)
    return counts, granite


# ----------------------------------------------------------------------
# The MoE and embeds families (slice 11): mixtral-8x7b and qwen2-moe-a2.7b
# (the MoE FFN), musicgen-medium and internvl2-1b (the embeds front end)
# at full width, each served, checked against float64 and trained.
LM_FAMILIES = (  # (arch, layers served, layers trained; None = all)
    # cut in depth to keep the smoke's time (mixtral was served at 4,
    # musicgen and internvl2 whole, then at 12 until the sharded LM's
    # phase joined); widths as published
    # mixtral 2 and qwen2-moe 4 until the serve overrides' phases joined
    ("mixtral-8x7b", 1, 1),
    ("qwen2-moe-a2.7b", 2, 2),
    ("musicgen-medium", 6, 6),
    ("internvl2-1b", 6, 6),
)
FAM = {"positions": 8192, "short": 512, "max_new": 8, "seed": 31,
       "tie_rows": 512}
# the serving launcher's runs: (smoke arch, flash launches = its layers)
FAM_LAUNCHERS = (("qwen2-moe-a2.7b", 2), ("internvl2-1b", 2))
FAM_RESUME_ARCH = "qwen2-moe-a2.7b"    # the training launcher's resume


def _fam_cfg(T, arch, n_layers, **over):
    """``arch``'s full config cut to its first ``n_layers`` layers (None:
    all), widths kept. A cut that does not tile the block pattern takes
    the first ``n_layers`` kinds as its pattern, so each layer keeps the
    kind it has in the full model."""
    import dataclasses
    full = T.configs.get(arch)
    n = n_layers or full.n_layers
    pattern = full.block_pattern
    if n % len(pattern):
        over = {"block_pattern": tuple(pattern[i % len(pattern)]
                                       for i in range(n)), **over}
    return dataclasses.replace(full, n_layers=n, **over)


def _npfx(cfg):
    return cfg.n_prefix_embeds if cfg.input_mode == "embeds" else 0


def _moes(T, model):
    return [b.ffn for b in model.blocks if isinstance(b.ffn, T.layers.MoE)]


def _hold(T, model, routes):
    """Give ``model``'s MoE layers ``routes`` (one a layer)."""
    for m, r in zip(_moes(T, model), routes):
        m.held_route = r


def _log(T, model):
    """``model``'s MoE layers, each with an empty route log."""
    moes = _moes(T, model)
    for m in moes:
        m.route_log = []
    return moes


def _fam_serve(torch, T, E, cfg, want_long=None):
    """ServeEngine on ``cfg`` seeded on the card: 2 requests of
    FAM["positions"] positions (prefix included: one wave, one flash launch
    an attention layer, ``want_long`` in all, default every layer), then 4
    of FAM["short"] (no launch); the counters zeroed just before each.
    The long wave's capacity routes are logged: its dropped (token,
    expert) assignments. Then, in f32 on the same weights (an MoE
    at capacity_factor E / k, so that no token drops and the capacity
    path computes what decode's all-experts path does; the SSD and RG-LRU
    leaves redrawn by ``_carry_recurrence``), the first long prompt's
    decode logits against a teacher-forced prefill."""
    import dataclasses
    t0 = time.perf_counter()
    model = T.M.init(cfg, seed=FAM["seed"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    npfx, n = _npfx(cfg), FAM["positions"]
    v, max_new = cfg.vocab_size, FAM["max_new"]
    long_reqs = _lm_requests(E, v, 2, n - npfx, max_new, 0, seed=1)
    short_reqs = _lm_requests(E, v, 4, FAM["short"] - npfx, max_new, 10,
                              seed=2)
    moes = _log(T, model)
    T.F.reset_launches()
    eng_l, wall_l = _serve_lm(torch, E, model, long_reqs)
    launches_long = T.F.LAUNCHES["flash_attention"]
    bf16_long = T.F.ROUTE_LAUNCHES["bf16_wgmma"]
    routes = [r for m in moes for r in m.route_log if r.rows is not None]
    for m in moes:
        m.route_log = None
    dropped = sum(r.dropped() for r in routes)
    assigned = sum(r.topi.numel() for r in routes)
    T.F.reset_launches()
    eng_s, wall_s = _serve_lm(torch, E, model, short_reqs)
    launches_short = T.F.LAUNCHES["flash_attention"]
    # both again, warm (the counted run holds the shapes' first calls)
    warm = [(_lm_requests(E, v, 2, n - npfx, max_new, 0, seed=1)),
            _lm_requests(E, v, 4, FAM["short"] - npfx, max_new, 10, seed=2)]
    warm = [(reqs,) + _serve_lm(torch, E, model, reqs) for reqs in warm]
    for r in long_reqs + short_reqs:
        check(r.done and len(r.out) == max_new and
              all(0 <= t < cfg.padded_vocab() for t in r.out),
              f"{cfg.name}: request {r.rid} returned {max_new} tokens")
    want_long = cfg.n_layers if want_long is None else want_long
    check(launches_long == want_long and bf16_long == launches_long,
          f"{cfg.name}: the long wave launched the flash kernel "
          f"{launches_long} times (bf16 {bf16_long}), not {want_long}")
    check(launches_short == 0, f"{cfg.name}: the {FAM['short']}-position "
          f"wave launched the flash kernel {launches_short} times")
    check(len(routes) == len(moes), f"{cfg.name}: {len(routes)} capacity "
          f"routes in the long wave's prefill, {len(moes)} MoE layers")

    over = {"dtype": "float32"}
    if cfg.is_moe:
        over["capacity_factor"] = cfg.n_experts / cfg.n_experts_per_tok
    cfg32 = dataclasses.replace(cfg, **over)
    model32 = T.M.Model(cfg32, device="meta")
    model32.load_state_dict(model.state_dict(), assign=True)
    del model
    carried = _carry_recurrence(torch, model32, FAM["seed"])
    prompt = torch.from_numpy(long_reqs[0].prompt[None]).to("cuda").long()
    pfx = (torch.zeros(1, npfx, cfg.d_model, device="cuda") if npfx
           else None)
    logits, cache = T.M.prefill_step(model32, prompt, prefix_embeds=pfx,
                                     alloc_seq=n + max_new,
                                     cache_dtype=torch.float32)
    steps, toks = [logits.float()], []
    for step in range(max_new - 1):
        tok = steps[-1].argmax(-1, keepdim=True)
        toks.append(tok)
        logits, cache = T.M.decode_step(model32, tok, cache, pos=n + step)
        steps.append(logits.float())
    del cache
    fed = torch.cat([prompt] + toks, 1)
    with torch.no_grad():
        tf = model32(fed, prefix_embeds=pfx, mode="prefill")[0][
            :, n - 1:].float()
    dec = torch.stack(steps, 1)
    scale = float(tf.abs().max())
    err = float((dec - tf).abs().max())
    check(tuple(dec.shape) == tuple(tf.shape) and
          bool(torch.isfinite(dec).all()),
          f"{cfg.name}: f32 logits finite, right shape")
    check(err <= LM_LOGIT_TOL * scale, f"{cfg.name}: f32 decode logits vs "
          f"teacher-forced prefill: {err} > {LM_LOGIT_TOL} * {scale}")
    del tf, dec, steps, model32
    torch.cuda.empty_cache()

    def wave(eng, reqs, wall):
        return {"requests": len(reqs), "positions": npfx + len(
            reqs[0].prompt), "prefill_ms": eng.prefill_ms,
            "decode_ms_median": statistics.median(eng.decode_ms),
            "wall_s": wall}
    new_tokens = sum(len(r.out) for r in long_reqs + short_reqs)
    return {"init_s": init_s, "long": wave(eng_l, long_reqs, wall_l),
            "short": wave(eng_s, short_reqs, wall_s),
            "new_tokens_per_s": new_tokens / (wall_l + wall_s),
            "warm": {"long": wave(warm[0][1], warm[0][0], warm[0][2]),
                     "short": wave(warm[1][1], warm[1][0], warm[1][2]),
                     "new_tokens_per_s": new_tokens / (
                         warm[0][2] + warm[1][2])},
            "flash_launches": {"long_wave": launches_long,
                               "short_wave": launches_short},
            "dropped_at_capacity": None if not cfg.is_moe else {
                "capacity_factor": cfg.capacity_factor,
                "capacity": routes[0].capacity, "dropped": dropped,
                "assigned": assigned},
            "f32_check": {"capacity_factor": cfg32.capacity_factor,
                          "recurrent_leaves_redrawn": carried,
                          "max_abs_err": err, "max_abs_logit": scale,
                          "tolerance": f"{LM_LOGIT_TOL} * max|logit|"}}


# a recurrent mixer's decay parameters: uniform ranges that keep about
# 0.9-0.99 of the state a step (tests/_recurrent_draw.py gives the sums)
CARRY_RANGES = {"dt_bias": (-3.0, -1.0), "a_log": (-3.0, -1.5),
                "a_param": (-6.0, -3.5)}


def _carry_recurrence(torch, model, seed):
    """Redraw ``model``'s SSD and RG-LRU leaves so that the state carries
    the output, as the CPU tests draw them: matrices (``conv_w`` included)
    normal(0, 1/sqrt(fan_in)), the decay parameters in CARRY_RANGES,
    ``d_skip`` 0. At the init (matrices at 0.02, a_log = a_param = 0) the
    SSD's state term is about 1e-3 of its skip term and the RG-LRU keeps
    about 0.02 of its state a step, so a decode that dropped its state's
    input term would pass a check of 1e-3 * max|logit|. Returns the count
    of leaves redrawn (0 for a model with no recurrent block)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    n = 0
    with torch.no_grad():
        for blk in model.blocks:
            if blk.kind not in ("ssd", "rglru"):
                continue
            for leaf, p in blk.mixer.named_parameters():
                if leaf in CARRY_RANGES:
                    p.uniform_(*CARRY_RANGES[leaf], generator=gen)
                elif leaf == "d_skip":
                    p.zero_()
                else:
                    p.normal_(0.0, p.shape[-2] ** -0.5, generator=gen)
                n += 1
    return n


def _hold_routes(T, model, held):
    """Give ``model``'s MoE layers the routes of ``held`` (one a layer);
    returns a list that a hook fills with, per layer, the tokens whose
    experts ``model``'s own router would choose otherwise."""
    flips = []
    _hold(T, model, held)
    for m, route in zip(_moes(T, model), held):
        def own(mod, args, route=route):
            x = args[0]
            logits = x.detach() @ mod.router.detach().to(x.dtype)
            mine = T.layers.moe_route(logits, mod.cfg, dense=False)
            a = mine.topi.sort(-1).values
            b = route.topi.sort(-1).values
            flips.append(int((a != b).any(-1).sum()))
        m.register_forward_pre_hook(own)
    return flips


def _logged_grads(T, model, batch):
    """Loss and grads of one run (no remat), with each MoE layer's
    route."""
    moes = _log(T, model)
    loss, grads = T.trainer.loss_and_grads(model, batch, remat=False)
    routes = [m.route_log[0] for m in moes]
    for m in moes:
        m.route_log = None
    return loss, grads, routes


def _fam_grads(torch, T, arch):
    """One layer of ``arch`` at full width on 2 x 1,024 tokens: step 0's
    f32 loss and grads (TF32 off) against float64, and the bf16 run's
    grads inside LM_TRAIN_BF16_BAND against float64. For an MoE the
    float64 run takes the routing of the run it checks (a near-tie that
    flips is no numeric error) and counts the tokens whose experts its own
    router would choose otherwise. An MoE layer's bf16 loss and grads are
    then run again, and again under remat "dots": both bitwise equal to
    the first run's; and its router zeroed, every token takes experts
    0..k-1 on the card (ties to the lower index)."""
    import dataclasses
    base = _fam_cfg(T, arch, 1, dtype="float32")
    c64 = dataclasses.replace(base, dtype="float64", param_dtype="float64")
    batch = T.Tokens(base.vocab_size, LM_CHECK["batch"], LM_CHECK["seq"],
                     seed=LM_TRAIN["seed"], n_prefix=_npfx(base),
                     d_model=base.d_model).batch_at(0)
    m32 = T.M.init(base, seed=LM_TRAIN["seed"], device="cuda")
    l32, g, routes32 = _logged_grads(T, m32, batch)
    m64 = T.M.Model(c64, device="cuda")
    m64.load_state_dict(m32.state_dict())
    flips32 = _hold_routes(T, m64, routes32)
    l64, g64, _ = _logged_grads(T, m64, batch)
    errs = _rel_errs(g, g64)
    del g
    m16 = T.M.Model(dataclasses.replace(base, dtype="bfloat16",
                                        remat_policy="dots"), device="cuda")
    m16.load_state_dict(m32.state_dict())
    del m32
    l16, g16, routes16 = _logged_grads(T, m16, batch)
    flips16 = []
    if base.is_moe:     # float64 again, on the bf16 run's routing
        del g64, m64
        m64 = T.M.Model(c64, device="cuda")
        m64.load_state_dict(m16.state_dict())
        flips16 = _hold_routes(T, m64, routes16)
        _, g64, _ = _logged_grads(T, m64, batch)
    e16 = _rel_errs(g16, g64)
    del m64, g64
    torch.cuda.empty_cache()
    worst, w16 = max(errs, key=errs.get), max(e16, key=e16.get)
    lo, hi = LM_TRAIN_BF16_BAND
    loss_rel = abs(float(l16) - float(l32)) / abs(float(l32))
    out = {"layers": 1, "batch": LM_CHECK, "loss_f32": float(l32),
           "loss_f64": float(l64), "loss_bf16": float(l16),
           "bf16_loss_rel": loss_rel, "worst_f32": [worst, errs[worst]],
           "worst_bf16": [w16, e16[w16]],
           "grad_rel_err_f32_vs_f64": errs,
           "grad_rel_err_bf16_vs_f64": e16}
    check(errs[worst] <= LM_TRAIN_GRAD_TOL, f"{arch}: f32 grad {worst} off "
          f"float64 by {errs[worst]} of its max")
    check(lo <= e16[w16] <= hi, f"{arch}: bf16 grads' worst tensor {w16} "
          f"off float64 by {e16[w16]} of its max, outside [{lo}, {hi}]")
    check(loss_rel <= LM_TRAIN_LOSS_RTOL, f"{arch}: bf16 loss {float(l16)} "
          f"off the f32 loss {float(l32)} by {loss_rel}")
    if base.is_moe:
        # the bf16 layer's loss and grads again: the same bits
        l16b, g16b = T.trainer.loss_and_grads(m16, batch, remat=False)
        bitwise = torch.equal(l16b, l16) and all(
            torch.equal(g16b[k], g16[k]) for k in g16)
        del g16b
        # under remat "dots": the recomputed forward routes as the first
        l16r, g16r = T.trainer.loss_and_grads(m16, batch, remat=True)
        remat_bitwise = torch.equal(l16r, l16) and all(
            torch.equal(g16r[k], g16[k]) for k in g16)
        del g16r
        moe = _moes(T, m16)[0]
        saved = moe.router.detach().clone()
        with torch.no_grad():
            moe.router.zero_()
            moe.route_log = []
            x = torch.randn(1, FAM["tie_rows"], base.d_model, device="cuda",
                            dtype=torch.bfloat16)
            moe(x, mode="prefill")
            moe.router.copy_(saved)
        k = base.n_experts_per_tok
        topi = moe.route_log[0].topi
        ties_low = bool((topi == torch.arange(k, device="cuda")).all())
        moe.route_log = None
        out.update(repeat_bitwise=bitwise, remat_dots_bitwise=remat_bitwise,
                   ties_to_lower_index=ties_low,
                   route_flips_f64_vs_f32=flips32,
                   route_flips_f64_vs_bf16=flips16,
                   tokens_routed=LM_CHECK["batch"] * (
                       LM_CHECK["seq"] + _npfx(base)))
        check(bitwise, f"{arch}: a repeated MoE layer's bf16 loss and grads "
              f"differ")
        check(remat_bitwise, f"{arch}: an MoE layer's bf16 loss and grads "
              f"under remat \"dots\" differ from those without remat")
        check(ties_low, f"{arch}: a zero router did not route every token "
              f"to experts 0..{k - 1}")
    del m16, g16
    torch.cuda.empty_cache()
    return out


def phase_lm_family(torch, T, E, arch, serve_layers, train_layers):
    """Phase lm_families for one architecture: ``_fam_serve`` at
    ``serve_layers``, ``_fam_grads`` at one layer, then
    ``_lm_train_steps`` at ``train_layers`` (bf16 compute, f32 params,
    remat "dots") on one batch: on fresh random tokens at LM_TRAIN's lr
    a fall in 8 steps can be smaller than the batches' spread (the step-0
    weights' loss on each batch is printed beside the steps), while on
    one batch a right gradient must lower the loss. Returns the long
    wave's flash launches."""
    t0 = time.perf_counter()
    cfg = _fam_cfg(T, arch, serve_layers)
    served = _fam_serve(torch, T, E, cfg)
    t_serve = time.perf_counter() - t0
    grads = _fam_grads(torch, T, arch)
    t_grads = time.perf_counter() - t0 - t_serve
    tcfg = _fam_cfg(T, arch, train_layers, remat_policy="dots")
    run = _lm_train_steps(torch, T, tcfg, f"lm_families {arch}",
                          one_batch=True)
    full = T.configs.get(arch)
    emit({"phase": "lm_families", "arch": arch,
          "cut": {"served_layers": cfg.n_layers, "trained_layers":
                  tcfg.n_layers, "of": full.n_layers,
                  "widths": "as published"},
          "params_served": sum(p.numel() for p in T.M.Model(
              cfg, device="meta").parameters()),
          "serve": served, "grads": grads, "train": run,
          "seconds": {"serve": t_serve, "grads": t_grads,
                      "train": time.perf_counter() - t0 - t_serve
                      - t_grads}})
    _check_lm_train(run, f"lm_families {arch}")
    return served["flash_launches"]["long_wave"]


def _train_launcher_resumed(arch, label):
    """The training launcher on ``arch``'s smoke config, in this process,
    8 steps checkpointing every 4, then resumed from the step-4 checkpoint
    alone: steps 5-8's losses must equal the first run's, bit for bit.
    Returns the runs' logs and both runs' losses."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.launch import train
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{label}_", dir=base)
    full_ck, part_ck = os.path.join(tmp, "full"), os.path.join(tmp, "part")
    argv = ["--arch", arch, "--smoke", "--steps", "8", "--log-every", "1"]
    logs = []
    for args in (["--ckpt-dir", full_ck, "--ckpt-every", "4",
                  "--losses-out", os.path.join(tmp, "full.json")],
                 ["--ckpt-dir", part_ck, "--resume", "--losses-out",
                  os.path.join(tmp, "resumed.json")]):
        if "--resume" in args:
            os.makedirs(part_ck)
            shutil.copy(os.path.join(full_ck, "step_00000004.npz"), part_ck)
            with open(os.path.join(part_ck, "manifest.json"), "w") as f:
                json.dump({"steps": [4]}, f)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train.main(argv + args)
        logs.append({"args": " ".join(argv + args).replace(tmp, "<tmp>"),
                     "wall_s": time.perf_counter() - t0,
                     "tail": out.getvalue().strip().splitlines()[-2:]})
    with open(os.path.join(tmp, "full.json")) as f:
        full = {int(k): v for k, v in json.load(f).items()}
    with open(os.path.join(tmp, "resumed.json")) as f:
        resumed = {int(k): v for k, v in json.load(f).items()}
    shutil.rmtree(tmp, ignore_errors=True)
    diff = {s: resumed[s] - full[s] for s in resumed}
    check(sorted(resumed) == [5, 6, 7, 8], f"{label}: the resumed run "
          f"ran steps {sorted(resumed)}")
    check(all(d == 0.0 for d in diff.values()), f"{label}: the resumed "
          f"steps' losses differ from the uninterrupted run's: {diff}")
    return logs, full, resumed


def phase_lm_family_launchers(torch):
    """The serving launcher as a subprocess for an MoE and an embeds smoke
    config (8,192 positions: one flash launch a layer), both while the
    training launcher runs on FAM_RESUME_ARCH's smoke config, resumed
    from its step-4 checkpoint (``_train_launcher_resumed``)."""
    from repro_torch import configs
    lines, (logs, full, resumed) = _concurrently(
        _run_lm_launcher, [(["--arch", arch, "--smoke", "--prompt-len",
                             str(FAM["positions"]
                                 - _npfx(configs.get_smoke(arch))),
                             "--n-requests", "2", "--max-new", "4"],
                            launches) for arch, launches in FAM_LAUNCHERS],
        workers=len(FAM_LAUNCHERS), beside=lambda: _train_launcher_resumed(
            FAM_RESUME_ARCH, "lm_families"))
    emit({"phase": "lm_families_launchers", "serve": lines,
          "train_runs": logs, "losses": full, "resumed_losses": resumed,
          "bitwise": True})
    return sum(line["launches"] for line in lines)


def lm_families_path(torch, launchers=True):
    """Phase lm_families: each architecture of LM_FAMILIES, then the
    launchers. Returns the served long waves' flash launches by arch and
    the launchers' total."""
    from repro_torch.models import layers
    from repro_torch.serve import engine as E
    T = _lm_train_modules()
    T.layers = layers
    t0 = time.perf_counter()
    launches = {}
    for arch, serve_layers, train_layers in LM_FAMILIES:
        launches[arch] = phase_lm_family(torch, T, E, arch, serve_layers,
                                         train_layers)
        torch.cuda.empty_cache()
    by_launcher = phase_lm_family_launchers(torch) if launchers else None
    emit({"phase": "lm_families_done", "seconds":
          time.perf_counter() - t0, "flash_launches": launches,
          "launcher_flash_launches": by_launcher})
    return launches, by_launcher


# ----------------------------------------------------------------------
# The recurrent mixers (slice 12): mamba2-370m (the SSD) and
# recurrentgemma-2b (the RG-LRU beside local attention) at full width, each
# served, held against float64 and trained.
LM_RECURRENT = (  # (arch, layers served, layers trained (None = all),
    #                microbatches a training step)
    # an eighth of its 48 layers, served and trained (it was whole, then
    # at 24 until the sharded LM's phase joined, then 12 until the serve
    # overrides' phases joined)
    ("mamba2-370m", 6, 6, 1),
    # served and trained at 7 layers (13, one repetition of its pattern,
    # until the serve overrides' phases joined; it was served whole
    # before), in 4 microbatches of 1 x 2,048: at 13 layers 2.43 G
    # parameters' f32 AdamW state is 39 GB, and one batch of 4 x 2,048
    # tokens' 256,000-word f32 logits 8.4 GB, their gradient as much
    # again. In 2 microbatches the phase alone peaked at 67.11 GB, and
    # after the smoke's earlier phases step 2 found no 3.91 GiB block free
    ("recurrentgemma-2b", 7, 7, 4),
)
# the serving launcher's run: (smoke arch, flash launches = its local
# attention layers) at FAM["positions"]; the training launcher's resume
REC_LAUNCHER = ("recurrentgemma-2b", 1)
REC_RESUME_ARCH = "mamba2-370m"
REC_LONG = 524_288                 # long_500k's positions


def _attention_layers(cfg):
    pattern = cfg.block_pattern
    return sum(pattern[i % len(pattern)] in ("attn", "local_attn")
               for i in range(cfg.n_layers))


def _cache_bytes(torch, T, cfg, alloc):
    """The served (bf16) decode cache's bytes a sequence at ``alloc``
    positions, by leaf: allocated on the meta device, so nothing is
    held. After prefill the recurrent state and conv tail are in the
    compute dtype (bf16), as allocated here."""
    out = {}
    pattern = cfg.block_pattern
    for i, c in enumerate(T.M.init_cache(cfg, 1, alloc, torch.bfloat16,
                                         "meta")):
        kind = pattern[i % len(pattern)]
        for k, v in c.items():
            if isinstance(v, torch.Tensor):
                key = f"{kind}.{k}"
                out[key] = out.get(key, 0) + v.numel() * v.element_size()
    return out


def phase_lm_recurrent(torch, T, E, arch, serve_layers, train_layers,
                       n_micro):
    """Phase lm_recurrent for one architecture: ``_fam_serve`` (the long
    wave launches flash once a local-attention layer, none for mamba2;
    the short wave none; the f32 decode logits against a teacher-forced
    prefill), the decode cache's bytes a sequence at 8,192 and at
    long_500k's 524,288 positions (equal: nothing grows with the
    position), ``_fam_grads`` at one layer (step 0's f32 grads against
    float64, the bf16 grads in lm_train's band, every grad finite at the
    published chunk), then ``_lm_train_steps`` at ``train_layers`` (bf16
    compute, f32 params, remat "dots") on one batch in ``n_micro``
    microbatches. Returns the long wave's flash launches."""
    t0 = time.perf_counter()
    cfg = _fam_cfg(T, arch, serve_layers)
    served = _fam_serve(torch, T, E, cfg, want_long=_attention_layers(cfg))
    t_serve = time.perf_counter() - t0
    alloc = FAM["positions"] + FAM["max_new"]
    cache = {n: _cache_bytes(torch, T, cfg, n) for n in (alloc, REC_LONG)}
    check(cache[alloc] == cache[REC_LONG], f"{arch}: the decode cache "
          f"grows with the position: {cache}")
    grads = _fam_grads(torch, T, arch)
    t_grads = time.perf_counter() - t0 - t_serve
    errs = [*grads["grad_rel_err_f32_vs_f64"].values(),
            *grads["grad_rel_err_bf16_vs_f64"].values()]
    check(all(np.isfinite(e) for e in errs), f"{arch}: a step-0 grad is "
          f"not finite at chunk {cfg.ssm_chunk}")
    tcfg = _fam_cfg(T, arch, train_layers, remat_policy="dots")
    run = _lm_train_steps(torch, T, tcfg, f"lm_recurrent {arch}",
                          one_batch=True, n_micro=n_micro)
    full = T.configs.get(arch)
    emit({"phase": "lm_recurrent", "arch": arch, "card": smi_line(),
          "cut": {"served_layers": cfg.n_layers, "trained_layers":
                  tcfg.n_layers, "of": full.n_layers,
                  "widths": "as published"},
          "params_served": sum(p.numel() for p in T.M.Model(
              cfg, device="meta").parameters()),
          "serve": served,
          "cache_bytes_per_seq": {"total": sum(cache[alloc].values()),
                                  "by_leaf": cache[alloc],
                                  "at_positions": [alloc, REC_LONG]},
          "grads": grads, "train": run,
          "seconds": {"serve": t_serve, "grads": t_grads,
                      "train": time.perf_counter() - t0 - t_serve
                      - t_grads}})
    _check_lm_train(run, f"lm_recurrent {arch}")
    return served["flash_launches"]["long_wave"]


def phase_lm_recurrent_launchers(torch):
    """The serving launcher as a subprocess on REC_LAUNCHER's smoke config
    at FAM["positions"] (one flash launch a local-attention layer), while
    the training launcher runs on REC_RESUME_ARCH's smoke config, resumed
    from its step-4 checkpoint, steps 5-8 bitwise."""
    arch, launches = REC_LAUNCHER
    [line], (logs, full, resumed) = _concurrently(
        _run_lm_launcher, [(["--arch", arch, "--smoke", "--prompt-len",
                             str(FAM["positions"]), "--n-requests", "2",
                             "--max-new", "4"], launches)],
        workers=1, beside=lambda: _train_launcher_resumed(
            REC_RESUME_ARCH, "lm_recurrent"))
    emit({"phase": "lm_recurrent_launchers", "serve": [line],
          "train_runs": logs, "losses": full, "resumed_losses": resumed,
          "bitwise": True})
    return line["launches"]


def lm_recurrent_path(torch, launchers=True):
    """Phase lm_recurrent: each architecture of LM_RECURRENT, then the
    launchers. Returns the served long waves' flash launches by arch and
    the launcher's."""
    from repro_torch.models import layers
    from repro_torch.serve import engine as E
    T = _lm_train_modules()
    T.layers = layers
    t0 = time.perf_counter()
    launches = {}
    for arch, serve_layers, train_layers, n_micro in LM_RECURRENT:
        launches[arch] = phase_lm_recurrent(torch, T, E, arch, serve_layers,
                                            train_layers, n_micro)
        torch.cuda.empty_cache()
    by_launcher = phase_lm_recurrent_launchers(torch) if launchers \
        else None
    emit({"phase": "lm_recurrent_done", "seconds":
          time.perf_counter() - t0, "flash_launches": launches,
          "launcher_flash_launches": by_launcher})
    return launches, by_launcher


# ----------------------------------------------------------------------
# Slice 13: the kernel proofs (``python -m repro_torch.analysis --check``),
# the one-card dry run and the two ported examples, as subprocesses at once.
# ----------------------------------------------------------------------
# The dense LM over a (data, model) mesh (slice 14): granite-34b at full
# width (d 6,144, 48 heads on one kv head, d_ff 24,576, vocab 49,152) cut
# to 1 layer (2 until phase lm_dist came), f32, on one card named 8 times
# as a (data 2, model 4) mesh.
LM_SHARDED = {"arch": "granite-34b", "layers": 1, "mesh": (2, 4),
              "batch": 4, "seq": 1024, "prefill": (2, 8192), "decode": 4,
              "seed": 41}
LM_SHARDED_LOSS_RTOL = 1e-5  # the sharded step's loss against one device's
LM_SHARDED_TOL = 1e-4        # per tensor of max|ref|: grads, first moments;
                             # logits of max|logit|


def _lm_sharded_modules():
    import numpy as np_
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models import spmd
    from repro_torch.train.zero import FSDP_OVERRIDES
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models import layers
    from repro_torch.launch.dryrun import cell_overrides
    T = _lm_train_modules()
    T.ShapeSpec, T.layers = ShapeSpec, layers
    g = LM_SHARDED
    mesh = Mesh(np_.full(g["mesh"], "cuda:0", dtype=object),
                ("data", "model"))
    return T, types.SimpleNamespace(Mesh=Mesh, sh=sh, spmd=spmd, mesh=mesh,
                                    FSDP=FSDP_OVERRIDES,
                                    cell_overrides=cell_overrides)


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _coll(mesh):
    return _coll_of(mesh.collectives)


def _coll_of(rec):
    return {k: {"count": v["count"], "wire_gb": v["wire_bytes"] / 1e9}
            for k, v in rec.items() if v["count"]}


# Phase lm_sharded_families: the MoE, SSD and RG-LRU families over the same
# mesh, each at full width cut to its depth (layers, train batch: sequences
# x tokens), f32; recurrentgemma's batch keeps its sharded step under 70 GB.
# Each serves under JAX's serve overrides (``dryrun.cell_overrides`` of the
# prefill cell: a context-parallel KV cache, and recurrentgemma's 10 heads
# sequence-parallel). Cut for the serve overrides' phases: qwen2-moe from
# 2 layers, mamba2 from 12, recurrentgemma from 13 to 7, the sparse FFN
# from 12; and for phase lm_dist recurrentgemma from 7 to 4 (one local
# attention layer, its third).
LM_FAMILIES_SHARDED = {"mixtral-8x7b": (1, (4, 1024)),
                       "qwen2-moe-a2.7b": (1, (4, 1024)),
                       "mamba2-370m": (6, (4, 1024)),
                       "recurrentgemma-2b": (4, (2, 1024))}
# examples/train_sparse_lm.py's ~100M block-sparse configuration (d 768,
# blocks of 32) at 6 of its 12 layers, half of each mask's blocks zeroed;
# one step.
LM_SPARSE_SHARDED = {"d_model": 768, "layers": 6, "vocab": 512,
                     "block": 32, "batch": (8, 512)}
# The serve overrides' full-width path: phi3-medium-14b (d 5,120,
# 40 heads on 10 kv heads: 16 does not divide them, so JAX shards the
# query sequence) at 2 of 40 layers, f32, under its prefill cell's
# overrides, on LM_SHARDED's mesh: a prefill of 2 x 8,192, 4 decode steps.
LM_PHI3 = {"arch": "phi3-medium-14b", "layers": 2}
# internvl2-1b's train cell's overrides (FSDP and attn_q_seq): one step of
# 4 x 1,024 at 2 of 24 layers
LM_INTERNVL2 = {"arch": "internvl2-1b", "layers": 2, "batch": (4, 1024)}
# The checkpoint round trip: mamba2-370m at full width, 4 of 48 layers (so
# that 2 and 4 data coordinates own whole layers), ZeRO-1 without FSDP
LM_CKPT = {"arch": "mamba2-370m", "layers": 4, "batch": (4, 512),
           "meshes": ((2, 4), (4, 2))}


def _exact_coll(mesh):
    return {k: dict(v) for k, v in mesh.collectives.items()}


def _meta_collectives(T, S, cfg, rules, run):
    """The collectives ``run(sm, mesh)`` counts on a (data 2, model 4) mesh
    of ``meta`` devices: shapes alone, coordinate 0's program (the dry
    run's count), to hold the card's count against."""
    mesh = S.Mesh(np.full(LM_SHARDED["mesh"], "meta", dtype=object),
                  ("data", "model"))
    sm = S.spmd.shard_model(T.M.Model(cfg, device="meta"), mesh, rules)
    mesh.reset_collectives()
    run(sm, mesh)
    return _exact_coll(mesh)


def _flips(mine, theirs):
    """Per logged MoE call, the tokens whose experts differ."""
    return [int((a.topi.sort(-1).values != b.topi.to(
        a.topi.device).sort(-1).values).any(-1).sum())
        for a, b in zip(mine, theirs)]


def _ref_step(torch, T, cfg, batch, opt, seed, held=None):
    """The one-device AdamW step from ``seed``'s weights (MoE layers on
    ``held`` routes where given): loss, grads and first moments on the
    host, each MoE layer's route, ms, peak GB; the model freed."""
    model = T.M.init(cfg, seed=seed, device="cuda")
    moes = _log(T, model)
    if held:
        _hold(T, model, [r.to("cuda") for r in held])
    params = dict(model.named_parameters())
    state = T.O.adamw_init(opt, params)
    torch.cuda.reset_peak_memory_stats()

    def one():
        loss, grads = T.trainer.loss_and_grads(model, batch)
        T.O.adamw_update(opt, grads, state, params)
        return loss, grads
    (loss, g), ms = _timed(torch, one)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ref = {"grads": {k: v.to("cpu", copy=True) for k, v in g.items()},
           "m": {k: v.to("cpu", copy=True) for k, v in state["m"].items()}}
    routes = [m.route_log[0].to("cpu") for m in moes]
    del model, params, state, g, moes
    torch.cuda.empty_cache()
    return float(loss), ref, routes, ms, peak


def _worst_errs(torch, got, ref):
    """Worst (name, error / max) of each of "grads" and "m": ``got``
    {kind: {name: callable giving the tensor}}, the reference on the host
    brought to the card a tensor at a time."""
    out = {}
    for kind in ("grads", "m"):
        errs = {k: _rel_errs({k: got[kind][k]()}, {k: w.cuda()})[k]
                for k, w in ref[kind].items()}
        worst = max(errs, key=errs.get)
        out[kind] = [worst, errs[worst]]
    return out


def _sharded_step(torch, T, sh, mesh, sm, batch, opt, rules):
    """One AdamW step of ``sm`` on ``batch`` under ``rules``, the mesh's
    collectives zeroed just before: the loss, the reduced gradients, the
    optimizer state, the moments' specs and the step's ms
    (CUDA-synchronized host clock)."""
    with sh.axis_rules(mesh, rules):
        ms = T.trainer.moment_specs(opt, sm)
        st = T.trainer.init_sharded_opt_state(opt, sm)
        mesh.reset_collectives()

        def step():
            loss, parts = T.trainer.sharded_loss_and_grads(sm, batch)
            red = T.trainer.reduce_grads(sm, parts, ms)
            del parts
            T.O.sharded_adamw_update(opt, red, st, sm, ms)
            return loss, red
        (loss, red), step_ms = _timed(torch, step)
    return loss, red, st, ms, step_ms


def phase_lm_sharded_train(torch, T, S, cfg, batch, opt, seed, rules=None):
    """One AdamW step with FSDP and ZeRO-1 (``rules``, default
    ``S.FSDP``) on ``batch``, the one-device
    reference first (its grads and first moments to the host, the model
    freed), then sharded from the same seeded weights; where an MoE route
    differs, the reference again on the sharded routes
    (``MoE.held_route``) before the comparison. The loss within
    LM_SHARDED_LOSS_RTOL, each gathered gradient and first moment within
    LM_SHARDED_TOL of the tensor's max (checked by ``_check_sharded``);
    step ms of both (CUDA-synchronized host clock), peak GB, and the
    sharded step's collectives against the meta run's."""
    rules = S.FSDP if rules is None else rules
    loss1, ref, routes1, one_ms, one_peak = _ref_step(
        torch, T, cfg, batch, opt, seed)
    sm = S.spmd.shard_model(T.M.init(cfg, seed=seed, device="cuda"),
                            S.mesh, rules)
    sm.route_log = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = len(batch["tokens"])
    loss2, red, st, ms, sh_ms = _sharded_step(torch, T, S.sh, S.mesh, sm,
                                              batch, opt, rules)
    peak = torch.cuda.max_memory_allocated() / 1e9
    coll = _exact_coll(S.mesh)
    routes2 = [r.to("cpu") for _, r in sm.joined_routes(n)]
    flips = _flips(routes2, routes1)
    got = {"grads": {k: (lambda k=k: T.O.moment_sharded(
        sm, k, ms[k], red[k]).full()) for k in ref["grads"]},
           "m": {k: (lambda k=k: st["m"][k].full()) for k in ref["m"]}}
    if any(flips):      # the sharded run's state to the host, then held
        got = {kind: {k: (lambda t=fn().cpu(): t.cuda())
                      for k, fn in d.items()} for kind, d in got.items()}
        del sm, st, red
        torch.cuda.empty_cache()
        loss1, ref, _, _, _ = _ref_step(torch, T, cfg, batch, opt, seed,
                                        held=routes2)
    errs = _worst_errs(torch, got, ref)
    del got, ref
    sm = st = red = None
    torch.cuda.empty_cache()
    meta_batch = T.specs.batch_specs(cfg, T.ShapeSpec(
        "b", batch["tokens"].shape[1], n, "train"))

    def meta_run(msm, mesh):
        with S.sh.axis_rules(mesh, rules):
            mms = T.trainer.moment_specs(opt, msm)
            mst = T.trainer.init_sharded_opt_state(opt, msm)
            mesh.reset_collectives()
            _, parts = T.trainer.sharded_loss_and_grads(msm, meta_batch)
            T.O.sharded_adamw_update(
                opt, T.trainer.reduce_grads(msm, parts, mms), mst, msm, mms)
    meta = _meta_collectives(T, S, cfg, rules, meta_run)
    return {"loss": [loss1, float(loss2)],
            "loss_rel_err": abs(float(loss2) / loss1 - 1),
            "grad_worst": errs["grads"], "moment_worst": errs["m"],
            "route_flips": flips, "routes_held": any(flips),
            "step_ms": {"one_device": one_ms, "sharded": sh_ms},
            "peak_gb": {"one_device": one_peak, "sharded": peak},
            "collectives": _coll(S.mesh), "collectives_equal_meta":
            coll == meta, "tokens": n * batch["tokens"].shape[1]}


def _attn_cache_spec(T, S, sm, b, alloc):
    """The spec of the first attention layer's KV cache on ``sm`` (its
    slots over "model" under ``cache_seq``), or None where it has none."""
    cfg = sm.cfg
    for li, axes in enumerate(T.M.init_cache_axes(cfg)):
        kind = cfg.block_pattern[li % len(cfg.block_pattern)]
        if kind in ("attn", "local_attn"):
            win = cfg.sliding_window if kind == "attn" else cfg.local_window
            n = min(alloc, win) if win else alloc
            return list(S.sh.resolve_with(
                sm.rules, S.mesh.shape, axes["k"],
                (b, n, cfg.n_kv_heads, cfg.head_dim)))
    return None


def _serve_run(torch, T, m, tok, nxt, alloc, held=None):
    """Prefill then decode steps on ``m``: the logits of each on the host,
    and each call's MoE routes (``held``: one per call, held in turn on a
    one-device model)."""
    s = tok.shape[1]
    calls = [lambda c: T.M.prefill_step(m, tok, alloc_seq=alloc,
                                        cache_dtype=torch.float32)]
    calls += [lambda c, t=t: T.M.decode_step(m, nxt[:, t:t + 1], c,
                                             pos=s + t)
              for t in range(nxt.shape[1])]
    cache, logits, ms, routes = None, [], [], []
    sharded = isinstance(m, T.M.ShardedModel)
    for j, call in enumerate(calls):
        if sharded:
            m.route_log = []
        else:
            moes = _log(T, m)
            if held:
                _hold(T, m, [r.to("cuda") for r in held[j]])
        (lg, cache), t_ms = _timed(torch, lambda: call(cache))
        logits.append((lg.full() if sharded else lg).cpu())
        ms.append(t_ms)
        routes.append([r.to("cpu") for _, r in m.joined_routes(
            tok.shape[0])] if sharded else [x.route_log[0].to("cpu")
                                            for x in moes])
    return logits, ms, routes


def phase_lm_sharded_serve(torch, T, S, cfg, seed, rules=None):
    """A prefill of LM_SHARDED's 2 x 8,192 tokens (one sequence a data
    shard) and 4 decode steps, f32 cache, under ``rules`` (default: the
    default rules): the one-device
    run first (its logits to the host), then sharded from the same
    weights (the one-device model freed); where an MoE route differs, the
    one-device run again on the sharded routes. Logits within
    LM_SHARDED_TOL of max|logit| at every step (``_check_sharded``), the
    flash launches of the sharded run (counters zeroed just before), ms
    of both, the collectives against the meta run's."""
    g = LM_SHARDED
    b, s = g["prefill"]
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (b, g["decode"]), generator=gen)
    alloc = s + g["decode"]
    model = T.M.init(cfg, seed=seed + 1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    T.F.reset_launches()
    ref, one_ms, routes1 = _serve_run(torch, T, model, tok, nxt, alloc)
    one_launches = T.F.LAUNCHES["flash_attention"]
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    sm = S.spmd.shard_model(model, S.mesh, rules)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    S.mesh.reset_collectives()
    T.F.reset_launches()
    got, sh_ms, routes2 = _serve_run(torch, T, sm, tok, nxt, alloc)
    cache_spec = _attn_cache_spec(T, S, sm, b, alloc)
    launches = T.F.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    coll = _exact_coll(S.mesh)
    flips = [_flips(a, b_) for a, b_ in zip(routes2, routes1)]
    if any(map(any, flips)):
        model = S.spmd.gather_model(sm)
        del sm
        torch.cuda.empty_cache()
        ref, _, _ = _serve_run(torch, T, model, tok, nxt, alloc,
                               held=routes2)
        del model
    else:
        del sm
    torch.cuda.empty_cache()
    errs = [_rel_errs({"l": x.cuda()}, {"l": r.cuda()})["l"]
            for x, r in zip(got, ref)]

    def meta_run(msm, mesh):
        cache = None
        _, cache = T.M.prefill_step(
            msm, torch.empty((b, s), dtype=torch.int32, device="meta"),
            alloc_seq=alloc, cache_dtype=torch.float32)
        for t in range(g["decode"]):
            _, cache = T.M.decode_step(msm, torch.empty(
                (b, 1), dtype=torch.int32, device="meta"), cache, pos=s + t)
    meta = _meta_collectives(T, S, cfg, rules, meta_run)
    return {"prefill": [b, s], "decode_steps": g["decode"],
            "rules": rules or {}, "attention_cache_spec": cache_spec,
            "logit_rel_err": errs, "route_flips": flips,
            "routes_held": any(map(any, flips)),
            "flash_launches": launches,
            "flash_launches_one_device": one_launches,
            "prefill_ms": {"one_device": one_ms[0], "sharded": sh_ms[0]},
            "decode_ms": {"one_device": one_ms[1:], "sharded": sh_ms[1:]},
            "peak_gb": {"one_device": one_peak, "sharded": peak},
            "collectives": _coll(S.mesh), "collectives_equal_meta":
            coll == meta}


def _sharded_arch(torch, T, S, arch, layers, batch_shape, phase,
                  serve_rules=None):
    """``arch`` at full width cut to ``layers`` layers, f32, on
    LM_SHARDED's mesh: ``phase_lm_sharded_train`` and
    ``phase_lm_sharded_serve`` (under ``serve_rules``), emitted under
    ``phase`` and checked. Returns the sharded prefill's flash launches
    (coordinates x attention layers)."""
    t0 = time.perf_counter()
    seed = LM_SHARDED["seed"]
    cfg = _fam_cfg(T, arch, layers, dtype="float32")
    batch = T.Tokens(cfg.vocab_size, *batch_shape, seed=seed).batch_at(0)
    opt = T.O.AdamWConfig(lr=1e-4, warmup_steps=0)
    train = phase_lm_sharded_train(torch, T, S, cfg, batch, opt, seed)
    serve = phase_lm_sharded_serve(torch, T, S, cfg, seed, serve_rules)
    want = S.mesh.size * _attention_layers(cfg)
    full = T.configs.get(arch)
    emit({"phase": phase, "arch": arch,
          "model": f"{arch}, {layers} of {full.n_layers} layers, full "
          f"width, f32", "params": sum(
              p.numel() for p in T.M.Model(cfg, device="meta").parameters()),
          "mesh": S.mesh.shape,
          "devices": sorted({str(d) for d in S.mesh.device_list}),
          "seconds": time.perf_counter() - t0, "train": train,
          "serve": serve})
    check(train["loss_rel_err"] <= LM_SHARDED_LOSS_RTOL,
          f"{arch}: sharded loss off by {train['loss_rel_err']}")
    for what in ("grad_worst", "moment_worst"):
        name, err = train[what]
        check(err <= LM_SHARDED_TOL, f"{arch}: {what} {name} off by "
              f"{err} of its max")
    check(max(serve["logit_rel_err"]) <= LM_SHARDED_TOL,
          f"{arch}: sharded logits off by {serve['logit_rel_err']}")
    check(serve["flash_launches"] == want, f"{arch}: "
          f"{serve['flash_launches']} flash launches, want {want}")
    for run in (train, serve):
        check(run["collectives_equal_meta"], f"{arch}: the card's "
              f"collectives are not the meta run's")
        check(max(run["peak_gb"].values()) < 70,
              f"{arch}: peak {run['peak_gb']} GB")
    return serve["flash_launches"]


def lm_sharded_path(torch):
    """Phase lm_sharded: granite-34b at full width, LM_SHARDED["layers"]
    layers, f32, on a (data 2, model 4) mesh of one card: the train step
    and the serve path held against one device (``_sharded_arch``).
    Returns the sharded prefill's flash launches (its coordinates x
    layers)."""
    T, S = _lm_sharded_modules()
    g = LM_SHARDED
    return _sharded_arch(torch, T, S, g["arch"], g["layers"],
                         (g["batch"], g["seq"]), "lm_sharded")


def phase_lm_sharded_sparse(torch, T, S):
    """One sharded AdamW step (FSDP, ZeRO-1) of examples/train_sparse_lm.py's
    block-sparse configuration, half of each mask's blocks zeroed, held to
    one device as the families' steps are."""
    from repro_torch.examples import train_sparse_lm
    c = LM_SPARSE_SHARDED
    cfg = train_sparse_lm.build("sparse-lm", c["d_model"], c["layers"],
                                c["vocab"], True, c["block"])
    seed = LM_SHARDED["seed"]
    batch = T.Tokens(cfg.vocab_size, *c["batch"], seed=seed).batch_at(0)
    opt = T.O.AdamWConfig(lr=1e-4, warmup_steps=0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = T.M.init(cfg, seed=seed, device="cuda")
    with torch.no_grad():
        for _, m in model.named_buffers():
            m.copy_(torch.rand(m.shape, generator=gen, device="cuda") < 0.5)
    masks = {k: v.clone() for k, v in model.named_buffers()}
    sm = S.spmd.shard_model(model, S.mesh, S.FSDP)
    loss1, g1 = T.trainer.loss_and_grads(model, batch)
    st1 = T.O.adamw_init(opt, dict(model.named_parameters()))
    T.O.adamw_update(opt, g1, st1, dict(model.named_parameters()))
    with S.sh.axis_rules(S.mesh, S.FSDP):
        ms = T.trainer.moment_specs(opt, sm)
        st2 = T.trainer.init_sharded_opt_state(opt, sm)
        S.mesh.reset_collectives()
        (loss2, parts), step_ms = _timed(
            torch, lambda: T.trainer.sharded_loss_and_grads(sm, batch))
        red = T.trainer.reduce_grads(sm, parts, ms)
        T.O.sharded_adamw_update(opt, red, st2, sm, ms)
    gsh = {k: T.O.moment_sharded(sm, k, ms[k], red[k]).full()
           for k in g1}
    gerr = _rel_errs(gsh, g1)
    merr = _rel_errs({k: st2["m"][k].full() for k in st1["m"]}, st1["m"])
    blk = cfg.sparsity.block
    zero_ok = all(
        float(gsh[k.replace("mask_", "")][m.repeat_interleave(blk, 0)
              .repeat_interleave(blk, 1) == 0].abs().max()) == 0.0
        for k, m in masks.items())
    wg, wm = max(gerr, key=gerr.get), max(merr, key=merr.get)
    out = {"config": f"{cfg.name}, d {cfg.d_model}, {cfg.n_layers} layers, "
           f"d_ff {cfg.d_ff}, blocks of {cfg.sparsity.block}",
           "params": sum(p.numel() for p in model.parameters()),
           "mask_density": float(sum(m.sum() for m in masks.values()) /
                                 sum(m.numel() for m in masks.values())),
           "loss_rel_err": abs(float(loss2) / float(loss1) - 1),
           "grad_worst": [wg, gerr[wg]], "moment_worst": [wm, merr[wm]],
           "zeroed_blocks_no_grad": zero_ok, "sharded_grads_ms": step_ms,
           "collectives": _coll(S.mesh)}
    del model, sm, g1, gsh, st1, st2, red, parts
    torch.cuda.empty_cache()
    return out


def _flash_offset_times(torch, F):
    """The flash kernels at LM_PHI3's last coordinate's span: 2,048 queries
    of 40 heads (10 kv x 4) at q_offset 6,144 against keys 0..8,191, hd
    128, bf16 and f32; each against its plain version, their medians beside
    the plain version's, SDPA with the same mask (a boolean (Sq, Sk) mask:
    row r sees keys <= r + 6,144) and the bound of the pairs the mask
    keeps."""
    b, sq, off, kv, g, hd = 1, 2048, 6144, 10, 4, 128
    sk = sq + off
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b, sq, kv, g, hd), (b, sk, kv, hd),
                                      (b, sk, kv, hd)))
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    out = {}
    with torch.no_grad():
        want = F.plain(q.float(), k.float(), v.float(), q_offset=off)
        got = F.flash_attention(q, k, v, q_offset=off)
        out["bf16_row_err"] = F.worst_row_error(got, want)
        q32, k32, v32 = q.float(), k.float(), v.float()
        got32 = F.flash_attention(q32, k32, v32, q_offset=off)
        out["f32_max_abs_err"] = float((got32 - want).abs().max())
        out["f32_rel_err"] = out["f32_max_abs_err"] / float(
            want.abs().max())
        out["ms"] = _time_ms(torch, lambda: F.flash_attention(
            q, k, v, q_offset=off), flush)
        out["ms_f32_inputs"] = _time_ms(torch, lambda: F.flash_attention(
            q32, k32, v32, q_offset=off), flush)
        out["plain_ms"] = _time_ms(torch, lambda: F.plain(
            q, k, v, q_offset=off), flush, reps=5)
        fn = torch.nn.functional.scaled_dot_product_attention
        qs = q.reshape(b, sq, kv * g, hd).transpose(1, 2).contiguous()
        ks, vs = (t.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
                  for t in (k, v))
        mask = (torch.arange(sk, device="cuda")[None, :] <=
                off + torch.arange(sq, device="cuda")[:, None])
        sdpa = lambda: fn(qs, ks, vs, attn_mask=mask)  # noqa: E731
        lib = sdpa().transpose(1, 2).reshape(b, sq, kv, g, hd)
        out["library_vs_kernel_max_abs_diff"] = float(
            (lib.float() - got.float()).abs().max())
        out["library_ms"] = _time_ms(torch, sdpa, flush)
        del qs, ks, vs, mask, lib, got, got32, want, q32, k32, v32
    flops = 4 * hd * b * kv * g * _causal_pairs(sq, sk, None, off)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops = flops / BF16_TC_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out.update(shape=[b, sq, kv, g, hd], q_offset=off, sk=sk,
               kernel=F.KERNEL_SYMBOLS["bf16_wgmma"], flops=flops,
               bytes=nbytes, bound_ms=max(t_ops, t_bytes),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library="scaled_dot_product_attention(attn_mask), k/v "
               "expanded by repeat_interleave")
    emit({"phase": "lm_times_offset", **out})
    check(out["bf16_row_err"] <= 1e-2 and out["f32_rel_err"] <= 1e-5,
          f"the flash kernels at a query offset disagree with the plain "
          f"version: {out['bf16_row_err']}, {out['f32_rel_err']}")
    return out


def phase_lm_sharded_phi3(torch, T, S):
    """Phase lm_sharded_phi3: LM_PHI3 at full width, f32, under its prefill
    cell's overrides (``attn_q_seq`` and ``cache_seq`` over "model") on
    LM_SHARDED's mesh, held to one device (``phase_lm_sharded_serve``):
    the logits within LM_SHARDED_TOL, 8 coordinates x 2 layers of flash
    launches, each at its span's q_offset, the collectives the meta run's,
    the cache's slots over "model"; then the kernel at the last span's
    shape (``_flash_offset_times``). Returns (flash launches, the
    timing)."""
    t0 = time.perf_counter()
    g = LM_PHI3
    cfg = _fam_cfg(T, g["arch"], g["layers"], dtype="float32")
    rules = S.cell_overrides(T.configs.get(g["arch"]), "prefill")
    from repro_torch.kernels import ops
    real, calls = ops._flash_kernel, []

    def logged(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
        return real(q, k, v, **kw)
    ops._flash_kernel = logged
    try:
        serve = phase_lm_sharded_serve(torch, T, S, cfg, LM_SHARDED["seed"],
                                       rules)
    finally:
        ops._flash_kernel = real
    sharded = calls[cfg.n_layers:]      # after the one-device prefill's
    want = S.mesh.size * _attention_layers(cfg)
    emit({"phase": "lm_sharded_phi3", "arch": g["arch"],
          "model": f"{g['arch']}, {g['layers']} of "
          f"{T.configs.get(g['arch']).n_layers} layers, full width, f32",
          "params": sum(p.numel() for p in
                        T.M.Model(cfg, device="meta").parameters()),
          "mesh": S.mesh.shape, "seconds": time.perf_counter() - t0,
          "flash_calls_q_len_k_len_offset": sorted(set(sharded)),
          "serve": serve})
    check(max(serve["logit_rel_err"]) <= LM_SHARDED_TOL,
          f"phi3: sharded logits off by {serve['logit_rel_err']}")
    check(serve["flash_launches"] == want and
          {c[2] for c in sharded} == {0, 2048, 4096, 6144},
          f"phi3: {serve['flash_launches']} flash launches at offsets "
          f"{sorted({c[2] for c in sharded})}, want {want}")
    check(serve["collectives_equal_meta"],
          "phi3: the card's collectives are not the meta run's")
    check(serve["attention_cache_spec"][1] == "model",
          f"phi3: the cache is not context-parallel: "
          f"{serve['attention_cache_spec']}")
    check(max(serve["peak_gb"].values()) < 70,
          f"phi3: peak {serve['peak_gb']} GB")
    torch.cuda.empty_cache()
    return serve["flash_launches"], _flash_offset_times(torch, T.F)


def phase_lm_sharded_internvl2(torch, T, S):
    """Phase lm_sharded_internvl2: LM_INTERNVL2's FSDP + ZeRO-1 step under
    its train cell's overrides (``attn_q_seq`` over "model"), held to one
    device as the families' steps are."""
    t0 = time.perf_counter()
    g = LM_INTERNVL2
    seed = LM_SHARDED["seed"]
    cfg = _fam_cfg(T, g["arch"], g["layers"], dtype="float32")
    rules = S.cell_overrides(T.configs.get(g["arch"]), "train")
    batch = T.Tokens(cfg.vocab_size, *g["batch"], seed=seed).batch_at(0)
    # its image front end's 256 embeddings a sequence (the meta run's
    # batch has them too): 1,280 positions, 320 a model coordinate
    batch["prefix_embeds"] = np.random.default_rng(seed).normal(
        size=(g["batch"][0], cfg.n_prefix_embeds, cfg.d_model)
    ).astype(np.float32)
    opt = T.O.AdamWConfig(lr=1e-4, warmup_steps=0)
    train = phase_lm_sharded_train(torch, T, S, cfg, batch, opt, seed, rules)
    emit({"phase": "lm_sharded_internvl2", "arch": g["arch"],
          "model": f"{g['arch']}, {g['layers']} of "
          f"{T.configs.get(g['arch']).n_layers} layers, full width, f32",
          "rules": rules, "seconds": time.perf_counter() - t0,
          "train": train})
    check(train["loss_rel_err"] <= LM_SHARDED_LOSS_RTOL,
          f"internvl2: sharded loss off by {train['loss_rel_err']}")
    for what in ("grad_worst", "moment_worst"):
        check(train[what][1] <= LM_SHARDED_TOL,
              f"internvl2: {what} {train[what]}")
    check(train["collectives_equal_meta"] and
          train["collectives"].get("all-to-all", {}).get("count", 0) > 0,
          "internvl2: the step's collectives are not the meta run's, or "
          "no all-to-all ran")
    torch.cuda.empty_cache()


def phase_lm_sharded_checkpoint(torch, T, S):
    """Phase lm_sharded_checkpoint: LM_CKPT at full width, f32, ZeRO-1
    without FSDP on LM_SHARDED's mesh (every block leaf's moments owned by
    layer: each coordinate's moment bytes the dry run's, a non-owner
    holding none); a step, a save, a second step; then the saved state
    restored onto (data 2, model 4), (data 4, model 2) and one device, the
    second step taken from each: the same mesh's loss bit for bit, the
    others within LM_SHARDED_LOSS_RTOL. Save and restore seconds
    (synchronized host clock; the restores read a file just written, so
    the page cache is warm), the file's bytes."""
    import shutil
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    g = LM_CKPT
    seed = LM_SHARDED["seed"]
    cfg = _fam_cfg(T, g["arch"], g["layers"], dtype="float32")
    opt = T.O.AdamWConfig(lr=1e-4, warmup_steps=0)
    batches = [T.Tokens(cfg.vocab_size, *g["batch"], seed=seed + i)
               .batch_at(0) for i in range(2)]
    d = os.path.join(ROOT, "build", f"ckpt-{os.getpid()}")
    shutil.rmtree(d, ignore_errors=True)
    ck = CheckpointManager(d, async_write=False)
    sm = S.spmd.shard_model(T.M.init(cfg, seed=seed, device="cuda"), S.mesh)
    with S.sh.axis_rules(S.mesh):
        ms = T.trainer.moment_specs(opt, sm)
        stacks = T.O.layer_stacks(sm, ms)
        st = T.trainer.init_sharded_opt_state(opt, sm)
        priced = dryrun.mesh_bytes(cfg, SHAPES["train_4k"], S.mesh.shape,
                                   sm.rules)["opt"]
        held = [4 + sum(t.shards[i].numel() * 4 for kind in ("m", "v")
                        for t in st[kind].values()
                        if t.shards[i] is not None)
                for i in range(S.mesh.size)]
        none_held = all(sum(t is None for t in st["m"][nm].shards) ==
                        S.mesh.size // 2 for _, names in stacks
                        for nm in names)
        step = T.trainer.build_train_step(cfg, opt)
        sm, st, m1 = step(sm, st, batches[0])
        torch.cuda.synchronize()
        ts = time.perf_counter()
        ck.save(1, {"params": sm, "opt": st})
        save_s = time.perf_counter() - ts
        _, _, m2 = step(sm, st, batches[1])
    want = float(m2["loss"])
    path = os.path.join(d, "step_00000001.npz")
    nbytes = os.path.getsize(path)
    del sm, st
    torch.cuda.empty_cache()
    runs = {}
    for shape in g["meshes"]:
        mh = S.Mesh(np.full(shape, "cuda:0", dtype=object),
                    ("data", "model"))
        tmpl = S.spmd.shard_model(T.M.init(cfg, seed=seed + 7,
                                           device="cuda"), mh)
        with S.sh.axis_rules(mh):
            st2 = T.trainer.init_sharded_opt_state(opt, tmpl)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            tree = ck.restore(1, {"params": tmpl, "opt": st2})
            torch.cuda.synchronize()
            rs = time.perf_counter() - ts
            _, _, m3 = T.trainer.build_train_step(cfg, opt)(
                tmpl, tree["opt"], batches[1])
        runs["x".join(map(str, shape))] = {"loss": float(m3["loss"]),
                                            "restore_s": rs}
        del tmpl, st2, tree
        torch.cuda.empty_cache()
    model = T.M.init(cfg, seed=seed + 7, device="cuda")
    st0 = T.O.adamw_init(opt, dict(model.named_parameters()))
    torch.cuda.synchronize()
    ts = time.perf_counter()
    tree = ck.restore(1, {"params": model, "opt": st0})
    torch.cuda.synchronize()
    rs = time.perf_counter() - ts
    _, _, m4 = T.trainer.make_step_fn(cfg, opt)(model, tree["opt"],
                                                batches[1])
    runs["one device"] = {"loss": float(m4["loss"]), "restore_s": rs}
    del model, st0, tree
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    out = {"model": f"{g['arch']}, {g['layers']} of "
           f"{T.configs.get(g['arch']).n_layers} layers, full width, f32",
           "owned_stacks": len(stacks), "moment_bytes": held,
           "moment_bytes_priced": priced, "non_owners_hold_none": none_held,
           "loss_uninterrupted": want, "save_s": save_s,
           "file_bytes": nbytes, "restores": runs,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_sharded_checkpoint", **out})
    check(stacks and none_held and all(h == priced for h in held),
          f"checkpoint: moments not owned by layer as priced: {held} vs "
          f"{priced}")
    check(runs["2x4"]["loss"] == want, f"checkpoint: the same mesh's "
          f"resumed loss {runs['2x4']['loss']} is not {want}")
    for k, r in runs.items():
        check(abs(r["loss"] / want - 1) <= LM_SHARDED_LOSS_RTOL,
              f"checkpoint: the resumed loss on {k} is {r['loss']}, "
              f"want {want}")
    return out


def lm_sharded_families_path(torch):
    """Phase lm_sharded_families: mixtral-8x7b, qwen2-moe-a2.7b,
    mamba2-370m and recurrentgemma-2b at full width cut to
    LM_FAMILIES_SHARDED's depths, f32, on LM_SHARDED's (data 2, model 4)
    mesh of one card: a step and the serve path (under JAX's serve
    overrides) each held to one device, then the block-sparse FFN's step;
    then phi3-medium-14b's serve under its overrides, internvl2-1b's step
    under its train override and the checkpoint round trip. Returns the
    flash launches of the sharded prefills by arch (coordinates x
    attention layers) and the kernel's times at an offset span."""
    T, S = _lm_sharded_modules()
    t_all = time.perf_counter()
    launches = {arch: _sharded_arch(
        torch, T, S, arch, layers, batch_shape, "lm_sharded_families",
        serve_rules=S.cell_overrides(T.configs.get(arch), "prefill"))
        for arch, (layers, batch_shape) in LM_FAMILIES_SHARDED.items()}
    sparse = phase_lm_sharded_sparse(torch, T, S)
    emit({"phase": "lm_sharded_families", "arch": "block-sparse FFN",
          **sparse, "seconds_all": time.perf_counter() - t_all})
    check(sparse["loss_rel_err"] <= LM_SHARDED_LOSS_RTOL and
          sparse["grad_worst"][1] <= LM_SHARDED_TOL and
          sparse["moment_worst"][1] <= LM_SHARDED_TOL,
          f"block-sparse FFN: sharded step off: {sparse}")
    check(sparse["zeroed_blocks_no_grad"] and
          0 < sparse["mask_density"] < 1,
          "block-sparse FFN: a zeroed block took a gradient")
    torch.cuda.empty_cache()
    launches[LM_PHI3["arch"]], offset = phase_lm_sharded_phi3(torch, T, S)
    phase_lm_sharded_internvl2(torch, T, S)
    phase_lm_sharded_checkpoint(torch, T, S)
    return launches, offset


# ----------------------------------------------------------------------
# The mesh across processes (slice 17): granite-34b at full width (d
# 6,144, 48 heads on one kv head, d_ff 24,576, vocab 49,152) cut to 1 of
# 88 layers, f32, TF32 off, on a (data 2, model 2) mesh of cuda:0 named
# four times, one process a coordinate joined by a gloo process group
# (CUDA tensors staged through host memory): a step of 2 x 1,024 tokens
# (FSDP and ZeRO-1), then from fresh weights a prefill of 1 x 8,192 (the
# flash kernel's threshold, so that each rank launches it on its 24
# heads) and 4 decode steps under the default rules; held to the
# one-process path on the same mesh shape.
LM_DIST = {"arch": "granite-34b", "layers": 1, "mesh": (2, 2),
           "batch": (2, 1024), "prefill": (1, 8192), "decode": 4,
           "seed": 47, "timeout": 480}


def _dist_run(torch, mesh, keep):
    """LM_DIST's step (``_sharded_step``) and serve (``_serve_run``) on
    ``mesh``: in one process every coordinate, under a process group the
    rank's. The loss, each coordinate's reduced gradients and first
    moments through ``keep`` (to the host, or kept on the card), each
    call's logits on the host; the step, prefill and decode ms, the
    collectives and their transport, flash launches and peak GB of each
    run. A rank's step is the first f32 step of a fresh process, its
    one-time set-up included."""
    from repro_torch.models import sharding as sh
    from repro_torch.models import spmd
    from repro_torch.train.zero import FSDP_OVERRIDES
    T = _lm_train_modules()
    g, seed = LM_DIST, LM_DIST["seed"]
    cfg = _fam_cfg(T, g["arch"], g["layers"], dtype="float32")
    batch = T.Tokens(cfg.vocab_size, *g["batch"], seed=seed).batch_at(0)
    opt = T.O.AdamWConfig(lr=1e-4, warmup_steps=0)

    def stats():
        return {"collectives": _exact_coll(mesh),
                "transport": dict(mesh.transport),
                "flash_launches": T.F.LAUNCHES["flash_attention"],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    sm = spmd.shard_model(T.M.init(cfg, seed=seed, device="cuda"), mesh,
                          FSDP_OVERRIDES)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    T.F.reset_launches()
    loss, red, st, _, step_ms = _sharded_step(torch, T, sh, mesh, sm, batch,
                                              opt, FSDP_OVERRIDES)
    out = {"train": {"step_ms": step_ms, **stats()}}
    own = range(len(spmd.local_coords(mesh)))
    kept = {"loss": float(loss),
            "grads": [{k: None if v[i] is None else keep(v[i])
                       for k, v in red.items()} for i in own],
            "m": [{k: None if x.shards[i] is None else keep(x.shards[i])
                   for k, x in st["m"].items()} for i in own]}
    del sm, st, red, loss
    torch.cuda.empty_cache()
    b, s = g["prefill"]
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (b, g["decode"]), generator=gen)
    sm = spmd.shard_model(T.M.init(cfg, seed=seed + 1, device="cuda"), mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh.reset_collectives()
    T.F.reset_launches()
    kept["logits"], ms, _ = _serve_run(torch, T, sm, tok, nxt,
                                       s + g["decode"])
    out["serve"] = {"prefill_ms": ms[0], "decode_ms": ms[1:], **stats()}
    del sm
    torch.cuda.empty_cache()
    return out, kept


def lm_dist_rank(rank):
    """Rank ``rank`` of phase lm_dist (``launch.ranks.spawn``): its
    coordinate of LM_DIST on a mesh bound to the process group."""
    import torch
    from repro_torch.launch.mesh import make_process_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh = make_process_mesh(LM_DIST["mesh"], ("data", "model"),
                             device="cuda:0")
    out, kept = _dist_run(torch, mesh, lambda t: t.cpu())
    out.update(rank=mesh.rank, backend=mesh.backend,
               stage_on_host=mesh.stage_on_host)
    return out, kept


def phase_lm_dist(torch):
    """Phase lm_dist: LM_DIST's four ranks (``launch.ranks.spawn``, a
    ``file://`` rendezvous under build/, every rank joined by the phase's
    timeout: a rank that raises, exits non-zero or runs past it fails the
    smoke), then the one-process path on a mesh of cuda:0 named four times
    from the same seeds, in this process. Each rank's loss within
    LM_SHARDED_LOSS_RTOL of the one-process run's, its reduced gradients,
    first moments and every call's logits within LM_SHARDED_TOL of their
    max, its collectives' counts and bytes the one-process run's, its
    flash launches the one-process run's a coordinate (at least one).
    Returns the flash launches of the ranks' and of the one-process
    prefill."""
    import shutil
    from repro_torch.kernels import _build
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import Mesh
    t0 = time.perf_counter()
    g = LM_DIST
    _build.build_all()          # the ranks load the libraries, build none
    torch.cuda.empty_cache()
    work = os.path.join(ROOT, "build", f"lm_dist-{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    n = int(np.prod(g["mesh"]))
    try:
        res = ranks.spawn(lm_dist_rank, n, backend="gloo", workdir=work,
                          timeout=g["timeout"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ranks_s = time.perf_counter() - t0
    mesh = Mesh(np.full(g["mesh"], "cuda:0", dtype=object),
                ("data", "model"))
    one, ref = _dist_run(torch, mesh, lambda t: t)
    got = {r["rank"]: h for r, h in res}
    kinds = ("grads", "m")
    mine = {kind: [got[c][kind][0] for c in range(n)] for kind in kinds}
    for kind in kinds:
        for c, (x, want) in enumerate(zip(mine[kind], ref[kind])):
            check({k for k, t in x.items() if t is None} ==
                  {k for k, t in want.items() if t is None},
                  f"lm_dist: coordinate {c}'s {kind} held where the "
                  f"one-process run's are not")

    def joined(parts, name):    # every coordinate's shard, flat, in order
        return torch.cat([p[name].reshape(-1).cuda() for p in parts
                          if p[name] is not None])
    worst = _worst_errs(
        torch, {kind: {k: (lambda kind=kind, k=k: joined(mine[kind], k))
                       for k in ref[kind][0]} for kind in kinds},
        {kind: {k: joined(ref[kind], k) for k in ref[kind][0]}
         for kind in kinds})
    errs = {"loss_rel_err": max(abs(h["loss"] / ref["loss"] - 1)
                                for h in got.values()),
            "grad_worst": worst["grads"], "moment_worst": worst["m"],
            "logit_worst": [max(_rel_errs({"l": h["logits"][t]},
                                          {"l": ref["logits"][t]})["l"]
                                for h in got.values())
                            for t in range(g["decode"] + 1)]}
    del got, mine, ref, worst
    per_rank = [r for r, _ in res]
    del res
    launches = [r["serve"]["flash_launches"] for r in per_rank]
    emit({"phase": "lm_dist", "nvidia_smi": smi_line(),
          "model": f"{g['arch']}, {g['layers']} of "
          f"{_lm_train_modules().configs.get(g['arch']).n_layers} layers, "
          f"full width, f32", "mesh": {"data": g["mesh"][0],
                                       "model": g["mesh"][1]},
          "backend": per_rank[0]["backend"], "ranks": n,
          "devices": sorted({str(d) for d in mesh.device_list}),
          "transport": "staged through host memory" if all(
              r["stage_on_host"] for r in per_rank) else "device",
          "train_tokens": g["batch"][0] * g["batch"][1],
          "prefill": list(g["prefill"]), "decode_steps": g["decode"],
          "step_ms": {"one_process": one["train"]["step_ms"],
                      "ranks": [r["train"]["step_ms"] for r in per_rank]},
          "prefill_ms": {"one_process": one["serve"]["prefill_ms"],
                         "ranks": [r["serve"]["prefill_ms"]
                                   for r in per_rank]},
          "decode_ms": {"one_process": one["serve"]["decode_ms"],
                        "ranks": [r["serve"]["decode_ms"]
                                  for r in per_rank]},
          "transport_s": {k: [r[k]["transport"] for r in per_rank]
                          for k in ("train", "serve")},
          "collectives": {"train": _coll_of(one["train"]["collectives"]),
                          "serve": _coll_of(one["serve"]["collectives"])},
          "peak_gb": {"one_process": [one["train"]["peak_gb"],
                                      one["serve"]["peak_gb"]],
                      "ranks": [[r["train"]["peak_gb"],
                                 r["serve"]["peak_gb"]] for r in per_rank]},
          "flash_launches": {"ranks": launches,
                             "one_process": one["serve"]["flash_launches"]},
          **errs, "ranks_s": ranks_s,
          "seconds": time.perf_counter() - t0})
    check(all(r["backend"] == "gloo" and r["stage_on_host"]
              for r in per_rank), "lm_dist: a rank did not stage gloo's "
          "CUDA tensors through the host")
    check(sorted(r["rank"] for r in per_rank) == list(range(n)),
          "lm_dist: a rank is missing")
    check(errs["loss_rel_err"] <= LM_SHARDED_LOSS_RTOL,
          f"lm_dist: a rank's loss off by {errs['loss_rel_err']}")
    for what in ("grad_worst", "moment_worst"):
        name, err = errs[what]
        check(err <= LM_SHARDED_TOL, f"lm_dist: {what} {name} off by {err} "
              f"of its max")
    check(max(errs["logit_worst"]) <= LM_SHARDED_TOL,
          f"lm_dist: logits off by {errs['logit_worst']}")
    for kind in ("train", "serve"):
        for r in per_rank:
            check(r[kind]["collectives"] == one[kind]["collectives"],
                  f"lm_dist: rank {r['rank']}'s {kind} collectives are not "
                  f"the one-process run's")
    want = one["serve"]["flash_launches"] // n
    check(want >= 1 and one["serve"]["flash_launches"] == want * n and
          launches == [want] * n, f"lm_dist: flash launches {launches} a "
          f"rank, the one-process run {one['serve']['flash_launches']}")
    return sum(launches), one["serve"]["flash_launches"]


DRYRUN_MESH_JSON = os.path.join("build", "dryrun_mesh.json")
DRYRUN_MESH_JOB = ("repro_torch.launch.dryrun", "--all", "--single-pod",
                   "--json", DRYRUN_MESH_JSON)


def phase_dryrun_mesh(rc, wall, err):
    """The mesh dry run on JAX's 16 x 16 mesh (every applicable cell): a
    row a cell with its per-device bytes and the collectives of its step,
    prefill or decode, every family's, granite-34b's train_4k among them.
    (Both meshes' table: ``python -m repro_torch.launch.dryrun --all
    --both-meshes``.)"""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES, applicable
    check(rc == 0, f"the mesh dry run exited {rc}: {err.strip()[-2000:]}")
    with open(os.path.join(ROOT, DRYRUN_MESH_JSON)) as fh:
        rows = json.load(fh)["cells"]
    want = [("16x16", a, s) for a in configs.ARCH_NAMES for s in SHAPES
            if applicable(configs.get(a), SHAPES[s])[0]]
    check([(r["mesh"], r["arch"], r["shape"]) for r in rows] == want,
          "the mesh dry run has one row per applicable cell")
    cells = []
    for r in rows:
        cells.append({k: r[k] for k in ("mesh", "arch", "shape", "fits")} |
                     {"total_gb": r["total_bytes"] / 1e9,
                      "wire_gb": r["wire_bytes_per_device"] / 1e9})
        check(isinstance(r["total_bytes"], int) and r["total_bytes"] > 0,
              f"the mesh dry run priced {r['arch']} x {r['shape']}")
    granite = next(r for r in rows if r["mesh"] == "16x16" and
                   r["arch"] == "granite-34b" and r["shape"] == "train_4k")
    check(isinstance(granite["collectives"], dict) and
          granite["collectives"]["all-reduce"]["count"] > 0,
          "the mesh dry run ran granite-34b train_4k's collectives")
    check(all(isinstance(r["collectives"], dict) and
              r["wire_bytes_per_device"] > 0 for r in rows),
          "every row of the mesh dry run, the MoE and recurrent families' "
          "included, has its collectives")
    emit({"phase": "dryrun_mesh", "rc": rc, "wall_s": wall,
          "card": rows[0]["card"], "card_bytes": rows[0]["card_bytes"],
          "cells": cells, "granite_train_4k_16x16": {
              k: granite[k] for k in ("params_bytes", "grads_bytes",
                                      "opt_bytes", "collectives")}})


PROOFS_JSON = os.path.join("build", "proofs.json")
DRYRUN_JSON = os.path.join("build", "dryrun.json")
PROOF_JOBS = (("repro_torch.analysis", "--check", "--json", PROOFS_JSON),
              ("repro_torch.launch.dryrun", "--all", "--json", DRYRUN_JSON),
              ("repro_torch.examples.quickstart",),
              ("repro_torch.examples.lm_serve",))


def phase_proofs(rc, wall, out, err):
    """The proofs' matrix printed on lines of its own, its findings and
    cases: every cell proved or n/a, exit 0."""
    print(out.strip(), flush=True)
    with open(os.path.join(ROOT, PROOFS_JSON)) as fh:
        report = json.load(fh)
    cells = report["proof_matrix"]
    emit({"phase": "proofs", "rc": rc, "wall_s": wall,
          "device": report["device"], "cases": len(report["cases"]),
          "ring_cases": sum(1 for c in report["cases"] if c["trips"]),
          "findings": report["findings"][:20], "proof_matrix": cells,
          "case_seconds": sum(c["seconds"] for c in report["cases"]),
          "stderr": err.strip()[-1000:]})
    check(rc == 0 and report["count"] == 0,
          f"the proofs found {report['count']} faults (exit {rc})")
    check(all(v == "proved" or v.startswith("n/a")
              for row in cells.values() for v in row.values()),
          f"a cell of the proof matrix is not proved: {cells}")


def phase_dryrun(torch, rc, wall, err, granite):
    """The dry run's table of every applicable cell; its parameter and
    optimizer-state bytes of lm_train's granite-34b (LM_DEPTH layers)
    against what the card held for them, equal; its peak beside the
    measured one (printed, no gate)."""
    from repro_torch.configs.shapes import SHAPES, applicable
    from repro_torch import configs
    from repro_torch.launch import dryrun, specs
    from repro_torch.train.optimizer import AdamWConfig
    check(rc == 0, f"the dry run exited {rc}: {err.strip()[-2000:]}")
    with open(os.path.join(ROOT, DRYRUN_JSON)) as fh:
        rows = json.load(fh)["cells"]
    want = [(a, s) for a in configs.ARCH_NAMES for s in SHAPES
            if applicable(configs.get(a), SHAPES[s])[0]]
    check([(r["arch"], r["shape"]) for r in rows] == want,
          "the dry run has one row per applicable cell")
    cfg, run = granite
    params = specs.params_specs(cfg)
    predicted = {"params": specs.tree_bytes(params),
                 "opt": specs.tree_bytes(specs.opt_specs(AdamWConfig(),
                                                         params))}
    g = LM_TRAIN
    acts = dryrun.saved_bytes(cfg, g["batch"], g["seq"])
    peak = predicted["params"] * 2 + predicted["opt"] + acts
    emit({"phase": "dryrun", "rc": rc, "wall_s": wall,
          "card": rows[0]["card"], "card_bytes": rows[0]["card_bytes"],
          "cells": [{k: r[k] for k in ("arch", "shape", "total_bytes",
                                       "fits", "max_layers", "n_layers")}
                    for r in rows],
          "granite_lm_train": {
              "layers": cfg.n_layers, "batch": [g["batch"], g["seq"]],
              "predicted_bytes": predicted, "card_bytes": run["card_bytes"],
              "predicted_peak_gb": peak / 1e9,
              "predicted_acts_gb": acts / 1e9,
              "measured_peak_gb": run["peak_gb"]}})
    check(predicted == run["card_bytes"],
          f"the dry run's parameter and AdamW bytes {predicted} are not the "
          f"card's {run['card_bytes']}")


def _call(fn, *args):
    return fn(*args)


def late_checks(torch, granite):
    """The smoke's exit-code subprocesses at once, in one pool: phases
    proofs, dryrun and examples (slice 13), phase serve's launcher,
    tenancy's serve bench and example, the training and lifecycle
    examples, and the LM training launcher's resumed pair; beside them, in this thread, the LM serving
    launchers with their in-process training resumes (lm_families' and
    lm_recurrent's). None of them is timed. Then each group's lines and
    checks. Returns the two serving launcher groups' flash launches."""
    jobs = [(_run_example, *job) for job in
            PROOF_JOBS + TENANCY_JOBS + TRAIN_EXAMPLES + (SERVE_LAUNCHER,
                                                          DRYRUN_MESH_JOB)]
    jobs.append((lm_train_launcher_runs,))
    results, (fam, rec) = _concurrently(
        _call, jobs, workers=8, beside=lambda: (
            phase_lm_family_launchers(torch),
            phase_lm_recurrent_launchers(torch)))
    a, b = len(PROOF_JOBS), len(PROOF_JOBS) + len(TENANCY_JOBS)
    proofs, tenancy, train, launcher = (results[:a], results[a:b],
                                        results[b:-3], results[-1])
    report_serve_launcher(results[-3])
    rc_m, wall_m, _, err_m = results[-2]
    phase_dryrun_mesh(rc_m, wall_m, err_m)
    report_tenancy_jobs(tenancy)
    report_train_examples(train)
    report_lm_train_launcher(launcher)
    (rc_p, wall_p, out_p, err_p), (rc_d, wall_d, _, err_d) = proofs[:2]
    phase_proofs(rc_p, wall_p, out_p, err_p)
    phase_dryrun(torch, rc_d, wall_d, err_d, granite)
    for job, (rc, wall, out, err) in zip(PROOF_JOBS[2:], proofs[2:]):
        emit({"phase": "examples", "module": job[0], "rc": rc,
              "wall_s": wall, "stdout": out.strip()[-1500:],
              "stderr": err.strip()[-1000:]})
        check(rc == 0, f"{job[0]} exited 0")
    check("quickstart OK" in proofs[2][2], "the quickstart finished")
    return fam, rec


def lm_recurrent_only() -> int:
    """``python3 chip_smoke.py --lm-recurrent``: the build and phase
    lm_recurrent alone (a quick loop on that path; not the smoke run)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_env(torch, _build)
    launches, by_launcher = lm_recurrent_path(torch)
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "flash_launches": launches, "launcher": by_launcher})
    print(smi_line(), flush=True)
    return 0


def _profiled_run(torch, F, fn):
    """``fn()`` once for its shapes' first calls, then once under
    torch.profiler: the host wall, the device ms by kind and the record
    counts (``lm_profile_tally``), and the ten costliest kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    F.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind, _, rec = lm_profile_tally(torch, F, prof)
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + getattr(
                ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall * 1e3, "busy_ms": sum(by_kind.values()),
            "device_ms_by_kind": by_kind, "records": rec,
            "flash_launches": F.LAUNCHES["flash_attention"],
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def lm_recurrent_profile() -> int:
    """``python3 chip_smoke.py --lm-recurrent-profile``: where the
    recurrent models' card time goes, in a process of its own. Each arch
    of LM_RECURRENT at its served and its trained cut (``_fam_cfg``),
    seeded: one long prefill (2 x FAM["positions"] tokens, bf16) and one
    training step's forward and backward (LM_TRAIN's 4 x 2,048 tokens in
    the phase's microbatches, bf16 compute, f32 parameters, remat
    "dots"), each profiled by ``_profiled_run``; one JSON line a run after
    the card's line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    T = _lm_train_modules()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi_line(), flush=True)
    g = LM_TRAIN
    for arch, serve_layers, train_layers, n_micro in LM_RECURRENT:
        cfg = _fam_cfg(T, arch, serve_layers)
        model = T.M.init(cfg, seed=FAM["seed"], device="cuda")
        prompt = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, FAM["positions"])), device="cuda")
        res = _profiled_run(torch, T.F, lambda: T.M.prefill_step(
            model, prompt, alloc_seq=FAM["positions"] + FAM["max_new"]))
        print(json.dumps({"arch": arch, "layers": cfg.n_layers,
                          "run": f"prefill 2 x {FAM['positions']}", **res}),
              flush=True)
        del model
        torch.cuda.empty_cache()
        cfg = _fam_cfg(T, arch, train_layers, remat_policy="dots")
        model = T.M.init(cfg, seed=g["seed"], device="cuda")
        batch = T.Tokens(cfg.vocab_size, g["batch"], g["seq"],
                         seed=g["seed"]).batch_at(0)
        res = _profiled_run(torch, T.F, lambda: T.trainer.loss_and_grads(
            model, batch, n_micro=n_micro))
        print(json.dumps({"arch": arch, "layers": cfg.n_layers,
                          "run": f"train step forward + backward, "
                          f"{g['batch']} x {g['seq']} in {n_micro}", **res}),
              flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


def lm_sharded_only() -> int:
    """``python3 chip_smoke.py --lm-sharded``: the build and phases
    lm_sharded and lm_sharded_families alone (the latter with the serve
    overrides' phases: phi3-medium-14b, internvl2-1b's step, the
    checkpoint round trip, the kernel at an offset), then the mesh dry run
    (a quick loop on that path; not the smoke run)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_env(torch, _build)
    launches = lm_sharded_path(torch)
    torch.cuda.empty_cache()
    families, _ = lm_sharded_families_path(torch)
    rc, wall, _, err = _run_example(*DRYRUN_MESH_JOB)
    phase_dryrun_mesh(rc, wall, err)
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "flash_launches": launches, "families": families})
    print(smi_line(), flush=True)
    return 0


def lm_dist_only() -> int:
    """``python3 chip_smoke.py --lm-dist``: the build and phase lm_dist
    alone (a quick loop on the process-group path; not the smoke run)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_env(torch, _build)
    launches = phase_lm_dist(torch)
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "flash_launches": launches})
    print(smi_line(), flush=True)
    return 0


def lm_families_only() -> int:
    """``python3 chip_smoke.py --lm-families``: the build and phase
    lm_families alone (a quick loop on that path; not the smoke run)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_env(torch, _build)
    launches, by_launcher = lm_families_path(torch)
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "flash_launches": launches, "launcher": by_launcher})
    return 0


def lm_train_only() -> int:
    """``python3 chip_smoke.py --lm-train``: the build and phase lm_train
    alone (a quick loop on the training path; not the smoke run)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_env(torch, _build)
    counts, _ = lm_train_path(torch)
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "pipeline_launches": counts})
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # every run tunes from cold: the tuning cache a fresh file of its own
    cache = os.path.join(ROOT, "build", f"autotune-{os.getpid()}.json")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        os.remove(cache)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
    from repro_torch import spgemm
    from repro_torch.configs.paper_spmm import WORKLOADS
    from repro_torch.core.crs import CRS
    from repro_torch.core.incrs import InCRS
    from repro_torch.data import datasets
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import incrs_gather as G
    from repro_torch.kernels import incrs_spmm as K
    from repro_torch.kernels import index_match_spmm as IM
    from repro_torch.serve import engine as engine_mod
    from repro_torch.spgemm import kernels as SK

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_env(torch, _build)
    from repro_torch.analysis import launch_check as L
    from repro_torch.core import mesh_sim
    from repro_torch.kernels import autotune
    from repro_torch.sparse import api
    table2 = {}
    for name in TABLE2:
        wl = WORKLOADS[name]
        table2[name] = InCRS.from_crs(datasets.synthesize(wl.dataset, seed=0),
                                      wl.section, wl.block)
    docword = table2["incrs-docword"]
    errs_512 = phase_kernels(torch, K, ops, InCRS, table2)
    launches = phase_serve(K, engine_mod, table2)
    rows = phase_times(torch, K, ops, table2, errs_512, launches)
    table4 = {name: datasets.synthesize(WORKLOADS[name].dataset, seed=0)
              for name in TABLE4}
    A = types.SimpleNamespace(K=K, IM=IM, ops=ops, api=api, E=engine_mod,
                              L=L, autotune=autotune, InCRS=InCRS)
    phase_autotune(torch, A, table2, table4["mesh-docword4"])
    P = types.SimpleNamespace(K=K, G=G, IM=IM, SK=SK, ops=ops, spgemm=spgemm,
                              CRS=CRS, InCRS=InCRS, autotune=autotune,
                              mesh_sim=mesh_sim)
    errs_dw = phase_spgemm_kernels(torch, P, table4)
    spgemm_launches, spgemm_walls = phase_spgemm(torch, P, table4)
    phase_spgemm_auto(P, table4, spgemm_walls)
    phase_spgemm_alloc(torch, P, table4)
    for r in rows:              # densify reaches the fused InCRS kernel too
        r["launches_by_path"] = {"serve": r["launches"],
                                 "spgemm": spgemm_launches[r["name"]]}
        r["launches"] += spgemm_launches[r["name"]]
    docword4 = table4["mesh-docword4"]
    rows += phase_spgemm_times(torch, P, docword4, InCRS.from_crs(docword4),
                               errs_dw, spgemm_launches)
    phase_spgemm_operands(torch, P, table4)
    del table4, P
    # phase 4's profile: docword served in the plan path's fresh process
    plan_rows, late_profile = plan_path(
        torch, K, ops, engine_mod, table2,
        [profile_job(docword, docword.shape[1])])
    rows += plan_rows
    for kname, n in tenancy_path(torch, K, ops, table2).items():
        r = next(r for r in rows if r["name"] == kname)
        r["launches_by_path"]["tenancy"] = n
        r["launches"] += n
    del table2, docword
    torch.cuda.empty_cache()
    paths = train_path(torch)
    for kname, n in paths.pop("sharded").items():
        r = next(r for r in rows if r["name"] == kname)
        r["launches_by_path"]["sharded"] = n
        r["launches"] += n
    for (train_counts, dx_kernel, dx), (life_counts, operands) in \
            paths.values():
        for path, counts in (("train", train_counts),
                             ("lifecycle", life_counts)):
            for kname, n in counts.items():
                r = next(r for r in rows if r["name"] == kname)
                r["launches_by_path"][path] = \
                    r["launches_by_path"].get(path, 0) + n
                r["launches"] += n
        next(r for r in rows if r["name"] == dx_kernel)["train_dx"] = dx
        for side, op in operands.items():
            next(r for r in rows if r["name"] == op["kernel"]).setdefault(
                "lifecycle_512", {})[side] = op
    for kname, add in crs_plan_path(torch).items():
        r = next(r for r in rows if r["name"] == kname)
        r.setdefault("launches_by_path", {"spgemm": r["launches"]})[
            "crs_plan"] = add["launches"]
        r["launches"] += add["launches"]
        r["crs_plan"] = {k: v for k, v in add.items() if k != "launches"}
    torch.cuda.empty_cache()
    rows += lm_path(torch)
    torch.cuda.empty_cache()
    counts, granite = lm_train_path(torch, launcher=False)
    for kname, n in counts.items():
        r = next(r for r in rows if r["name"] == kname)
        r["launches_by_path"]["lm_train"] = n
        r["launches"] += n
    torch.cuda.empty_cache()
    fam, _ = lm_families_path(torch, launchers=False)
    r = next(r for r in rows if r["name"] == "flash_attention")
    r["launches_by_path"]["lm_families"] = fam
    r["launches"] += sum(fam.values())
    torch.cuda.empty_cache()
    rec, _ = lm_recurrent_path(torch, launchers=False)
    r["launches_by_path"]["lm_recurrent"] = rec
    r["launches"] += sum(rec.values())
    torch.cuda.empty_cache()
    r["launches_by_path"]["lm_sharded"] = lm_sharded_path(torch)
    r["launches"] += r["launches_by_path"]["lm_sharded"]
    torch.cuda.empty_cache()
    fam_sharded, offset = lm_sharded_families_path(torch)
    r["launches_by_path"]["lm_sharded_families"] = fam_sharded
    r["launches"] += sum(fam_sharded.values())
    r["offset_span"] = {k: offset[k] for k in (
        "shape", "q_offset", "sk", "ms", "ms_f32_inputs", "plain_ms",
        "bound_ms", "bound_by", "library_ms")}
    torch.cuda.empty_cache()
    dist_ranks, dist_one = phase_lm_dist(torch)
    r["launches_by_path"]["lm_dist"] = dist_ranks
    r["launches_by_path"]["lm_dist_one_process"] = dist_one
    r["launches"] += dist_ranks + dist_one
    torch.cuda.empty_cache()
    fam_launcher, rec_launcher = late_checks(torch, granite)
    r["launches_by_path"]["lm_families_launchers"] = fam_launcher
    r["launches_by_path"]["lm_recurrent_launchers"] = rec_launcher
    phase_profile_in_process(torch, engine_mod, api, late_profile)
    del late_profile
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi_line(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    # Kineto's log at INFO, read at its first use (ROADMAP P4's probe)
    os.environ.setdefault("KINETO_LOG_LEVEL", "1")
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        sys.exit(profile_child(sys.argv[2]))
    if len(sys.argv) in (2, 3) and sys.argv[1] == "--lm-profile":
        sys.exit(lm_profile_child(*(int(a) for a in sys.argv[2:])))
    if len(sys.argv) == 2 and sys.argv[1] == "--lm-train":
        sys.exit(lm_train_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--lm-families":
        sys.exit(lm_families_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--lm-recurrent":
        sys.exit(lm_recurrent_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--lm-sharded":
        sys.exit(lm_sharded_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--lm-dist":
        sys.exit(lm_dist_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--lm-recurrent-profile":
        sys.exit(lm_recurrent_profile())
    if len(sys.argv) == 2 and sys.argv[1] == "--serial":
        SERIAL = True
    sys.exit(main())
