"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-turn [ROOT] [-DNAME=VALUE ...]
    python3 chip_smoke.py --s1

Run from the repository root (``src/`` is put on ``sys.path`` here).
The second form is one turn of a comparison call on the flash routes,
bf16 and float32 (``flash_turn``), for the package under ``ROOT/src`` (a
``git archive`` of another commit; this checkout by default), its flash
source built with the nvcc defines given.  The third tells a kernel
fault from rounding in recurrentgemma-9b's served error at 20 of its 38
layers (``s1_check``: the residual stream layer by layer on the kernel,
oracle and plain paths and with the local layers' attention on its
plain version, and in float32).
Phases, each fatal on failure, run in the order 1, 2 (the builds
started), 16 (it trains while they build: it needs none of them), 2
(joined), 3-14, 20, 15, 17-19; the CPU-only work of phases 7 and 15 runs
beside them from the start in a process of its own (``host_work``):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: all seven CUDA kernels from ``src/repro_torch/kernels/csrc/``
   for ``sm_90a``, one ``nvcc`` per source, started together; ``ptxas``'s
   registers and spills of the attention and RWKV-6 kernels are reported;
   the Hopper flash kernels (``flash_sm90``, bf16, at head sizes 64, 80,
   128 and 256, and ``flash_sm90_f32``, float32, at the same four) must hold
   ``wgmma`` (HGMMA) instructions in their SASS and spill nothing, and
   ``flash_sm90`` TMA (UTMALDG) ones;
3. kernels: each kernel against its plain PyTorch version on the card
   (attention: float32 at atol = rtol = 2e-5, bfloat16 at 2e-2, the
   tolerances of ``tests/test_kernels.py``; PCCS slowdown: float64 at
   atol = rtol = 1e-12, float32 at 5e-6; annealing select and the
   streaming antagonist: bit for bit, with poisoned lanes, special values
   and offset views, the duty-cycled antagonist included (the select
   kernel out of place and in place, at row lengths 3, 6, 64 and 130,
   and on rows off a 16-byte boundary); the RG-LRU scan
   bit for bit (at every served prefill length, a ragged D, and inputs
   one element off a 16-byte boundary, which take its element copies)
   and the RWKV-6 scan: its decode (T = 1) and its sequential prefill
   (``rwkv6.sequential_scan``, the parent design) bit for bit, its
   chunked prefill at ``tests/test_kernels.py``'s 1e-4 / 5e-2 against the
   plain version and within ``rwkv6.TWIN_TOL`` of its chunked twin, each
   with and without its initial state, at lengths 1, odd and full width,
   cut in two with the state carried, and a head's bits the same among
   64 heads or 32 (RWKV-6 also at T of 1-65 around its 16-step chunks,
   head sizes 16, 40, 64 and (20, 18), which no block divides, decays of
   exactly 0 and 1, steep and in rwkv6-7b's own range); attention at
   every
   head size the kernels are built for (16, 32, 64, 80, 128, 256) and at
   40, which the wrappers pad,
   recurrentgemma-9b's MQA at 256, hubert-xlarge's 16 heads of 80, flash
   at q-tile edges (Sq of 1, 63, 65, 127, 128, 129) and Sq < Skv, decode
   with one
   sequence over 8192 slots (the most splits), lengths 0, 1, S and on
   split boundaries, groups of 1, 3, 6, 8 and 16; the MoE models' 48/8
   and 64/4 heads of 128), then timed (CUDA events,
   L2 flushed before each call, median) beside its plain version, its
   roofline bound and a library yardstick where one PyTorch call computes
   the same function (``F.scaled_dot_product_attention`` for attention,
   ``torch.add(y, x, alpha=c)`` for the stream; none for the other four),
   beside the timer's launch floor (a one-element ``add_`` timed the same
   way): flash in bf16 and in float32 (``flash_sm90_f32``, an entry of
   its own: the characterization's shape, phase 5's 1000-token prefill,
   dbrx-132b's 48/8 heads of 128 at 513 and 2048, hubert-xlarge's 16/16
   of 80 over 1000 frames and recurrentgemma-9b's local layer (16/1 of
   256, 2300 tokens, window 2048), each held to its bound at three TF32
   products' rate, with the CUDA cores' float32 bound beside it, and,
   with its plain version, against a float64 reference), the reduced
   configs' layer (4/2 heads of 16, a 513-token prompt) in float32 on
   ``flash_kernel`` and in bf16 on ``flash_mma``, an entry each with the
   launch floor beside it, decode in
   float32 at the characterization's decode group,
   both attention kernels also at llama3.2-3b's 24/8 heads of 128,
   dbrx-132b's 48/8, qwen3-moe-235b-a22b's 64/4 and qwen1.5-32b's
   40/40 (flash also at internvl2-2b's 16/8 over 1100 tokens, at
   hubert-xlarge's 16 heads of 80 over 1000 frames, bidirectional, at
   llama3.2-3b's other prompt lengths, at 4096 tokens and at a
   tensor-parallel rank's 12/4 heads; each flash row names the kernel
   that served it), the
   scans at a prefill's and at a decode step's shape (both at every
   served prompt length, RWKV-6's chunked prefill beside its sequential
   form, the parent design, and in float32 too), the select
   kernel out of place and in place, the stream at
   32 MB, 256
   MB and the card's 1 GB calibration pass, whose rate past the L2 must
   not exceed 105% of the card's memory rate;
4. serve: full-width stablelm-1.6b with random weights from a seeded
   generator, 4 requests through ``ServingEngine``, its decode step a
   CUDA graph; every request must get its 16 tokens, both kernels must
   have launched (24 flash launches per prefill, 24 decode launches per
   decode step, replays counted), and each prompt's prefill through the
   kernels must match the plain path (same argmax, relative logits error
   <= 2e-2); the 1000-token prefill is profiled (device ms of the
   prefill and of its attention; ``flash_sm90`` must run and
   ``flash_mma`` must not); then an engine that steps eagerly must give
   the same tokens;
   the step ms and busy share of both are reported;
5. float32 end to end: the same prefills on full-width stablelm-1.6b with
   float32 weights, activations and KV cache, kernel path against plain
   path (same argmax, relative logits error <= E2E_F32_REL_TOL), one
   flash launch a layer a prefill (counted; the gateway's llama3.2-3b
   and phase 14's MoE checks count theirs too); one more float32 prefill
   is profiled (stablelm-1.6b and llama3.2-3b): ``flash_sm90_f32`` must
   run and ``flash_kernel`` must not.  With no
   bf16 rounding to amplify, this is the check that can tell a kernel
   fault from rounding;
6. reduced configs (head size 16, float32): the serve CLI with
   ``--reduced`` on the card (stablelm-1.6b, dbrx-132b, and the gateway
   of both with ``--trace-out`` and ``--metrics-out``, whose files must
   parse), then reduced stablelm-1.6b, recurrentgemma-9b, dbrx-132b and
   qwen3-moe-235b-a22b (the MoE models at capacity factors 8.0 and 1.25)
   through the graph engine (exact launches, the same tokens as the
   eager engine), each prompt's prefill and a decode step through the
   kernels against the plain path (<= E2E_F32_REL_TOL); then reduced
   stablelm-1.6b in bf16 (``flash_mma``'s path) the same way, within
   E2E_REL_TOL, the argmax reported;
7. search: the schedule search of ``repro_torch.core`` on the card under
   the paper's PCCS surface, ``Scheduler(..., evaluator="torch").solve(
   ..., solver="anneal")``, each step replayed as CUDA graphs, on the
   three golden Table-6 fixtures.  The orin fixture in float64 at
   population 4096 must give on the card the incumbent the same search
   gives on the CPU (where the plain versions run), and its device
   objective must match the scalar re-simulation; every fixture at
   population 1024 (128 steps) must be no worse than greedy; both search
   kernels must have launched in each solve (the select kernel once a
   step plus its warm-up before capture); the graphs' wave budget W and
   overflow replays are reported; the orin fixture under §4.4's
   ``ScaledContentionModel(pccs, 1.5)`` in float64 at population 1024
   must give the CPU's incumbent too, and a plan ``reschedule_plan``
   rescaled must load back with its model, factor and request hash; one
   16-step solve is profiled: the card's busy share, the device kernels
   of the whole solve and the slowdown and select kernels' summed device
   time over its eager evaluation and graph replays;
8. characterize: the port's profiling CLI (``repro_torch.launch.profile
   --executor torch --arch stablelm-1.6b --fit piecewise --solve --solver
   anneal``) measures the 8 layer groups of full-width stablelm-1.6b
   through the flash kernel (3 x (warmup + repeats) launches in each),
   calibrates PCCS from co-runs of 1 GB stream passes against the
   duty-cycled antagonist on a quarter of the SMs (one launch at full
   duty alone; at each demand level a standalone and a co-run timing and
   one antagonist launch; every launch counted), writes a bundle that
   must round-trip, and solves from it; the samples must rise with the
   demand within 5%, and so must three repeats of the sweep (repeated at
   half of the SMs too, reported); then
   ``Scheduler.from_bundle(bundle, evaluator="torch")`` must solve on the
   card through both search kernels, no worse than greedy; the samples
   and the fit's error against its 5% gate are reported; then the same
   with ``--kind decode``: the groups a decode step through the decode
   kernel (exact launches, no flash launch), a bundle that round-trips
   and a solve from it no worse than greedy;
9. serve the recurrent families: full-width rwkv6-7b (4 prompts; 16 of
   its 32 layers, SERVED_RECURRENT_LAYERS) and recurrentgemma-9b (5, one
   of 2300 tokens past its 2048 window; all 38 layers), seeded
   random weights with the PERTURBED parameters filled, through
   ``ServingEngine`` with graph steps; every request gets its 16 tokens,
   every kernel of the path launches exactly layers x prefills or steps
   times, each prompt's prefill through the kernels matches the plain
   path by ``argmax_verdict``: against the correct paths (the oracle; for
   rwkv6-7b also the plain path through the chunked kernel's float32
   order), the kernel path's argmax must lie within
   FLOOR_MARGIN x their largest |Δ logit| of the plain path's maximum,
   and its relative error within max(E2E_REL_TOL, FLOOR_MARGIN x theirs);
   the same verdict must refuse rwkv6-7b's plain path with its scan's
   state reset every RWKV_FAULT_EVERY steps at every prompt of 100 tokens
   or more; zeroing the RG-LRU scan's output on the plain path must move
   recurrentgemma-9b's logits by FAULT_MIN_REL or more, and an eager
   engine must give the same tokens; each prefill's device ms (all
   kernels and the scan's, by the profiler) and each verdict's spread,
   margins and limits are reported;
10. float32 end to end on both recurrent models at full width, cut to
   F32_RECURRENT_LAYERS (8 of rwkv6-7b's 32 layers, 9 of
   recurrentgemma-9b's 38: its pattern three times): kernel path against
   plain path, and prefill(n) plus one decode step against prefill(n +
   1), each within E2E_F32_REL_TOL with the same argmax; the flash
   launches counted (local layers x kernel-path prefills) and one
   recurrentgemma-9b prefill profiled: ``flash_sm90_f32`` must run (head
   size 256) and ``flash_kernel`` must not;
11. gateway: full-width stablelm-1.6b and llama3.2-3b served together
   through ``MultiTenantGateway`` on the card (planned on the reference's
   ``v5e-4x12-split``, each engine's decode step its own CUDA graph),
   4 prompts each of 8/100/513/1000 tokens, 16 new tokens, 1040 slots:
   each tenant's greedy tokens must equal a standalone engine's over the
   same model; the kernels must launch exactly (flash: attention layers x
   prefills; decode: attention layers x steps, replays counted);
   llama3.2-3b's prefills through the kernels must match the plain path
   (same argmax, <= E2E_REL_TOL in bf16, and <= E2E_F32_REL_TOL in float32
   end to end); under a shared KV budget of GW_BUDGET_SLOTS slots the KV
   in use never passes it, admissions are deferred and every request
   completes; step times injected at GW_INJECTED x each tenant's floor
   must re-schedule (§4.4) without worsening the objective; and the
   serve CLI's ``--gateway --plan-only --save-plan`` then ``--plan`` must
   boot with zero solves.  Reported: each tenant's decode step in the
   gateway against its standalone engine's, steps that followed an
   admission against the others, the monitors' highest ratio and the
   re-schedules the card's own step times fired, the gateway's wall ms a
   multiplexed step, the device ms and busy share of profiled steps, and
   the plan on phase 8's measured bundle (``--profile-bundle``);
12. fleet: the serve CLI's ``--fleet`` over the README's bursty trace
   (10,000 requests, 100 tenants) with ``--solver anneal --evaluator
   torch``, its three pool plans solved on the card: as the README runs
   it (the pod split's proportional-share model: the select kernel must
   launch), then priced under phase 8's measured PCCS surface
   (``--profile-bundle``: both search kernels must launch), then that pool
   booted again with ``--expect-cached`` (zero solves); every replay must
   conserve requests (completed + shed = n) and print the same trace
   hash.  Reported: the pool's solve seconds and p50, p99
   and sustained req/s;
13. serve the MoE models: full-width dbrx-132b (8 of 40 layers) and
   qwen3-moe-235b-a22b (10 of 94), one after the other, seeded random
   weights, 4 prompts of 8/100/513/1000 tokens through ``ServingEngine``
   with graph steps: every request its 16 tokens, flash launches layers
   x prefills, decode launches layers x steps, an eager engine's tokens
   (fatal: this is what shows the dispatch deterministic); each prompt's
   bf16 prefill through the kernels against the plain path with the
   plain path's experts pinned in every layer, held to phase 9's rule
   (same argmax, E2E_REL_TOL or FLOOR_MARGIN x the pinned oracle-vs-plain
   floor), and unpinned with its router flips, drops on each path and
   smallest top-k margin reported (``serve_moe`` says why); each
   prefill's and step's device ms and the busy share;
14. MoE in float32: one full-width block of each model over 513 tokens
   at capacity factor 1.25 against a per-expert oracle (MOE_ORACLE_TOL,
   drops equal, a planted fault caught), and each model at 2 layers end
   to end, kernel path against plain path (<= E2E_F32_REL_TOL, same
   argmax; router flips and the smallest margin reported);
15. dry run: ``repro_torch.launch.dryrun`` over every architecture and
   shape (bytes, the fit verdict on 80 GB, the deepest depth and largest
   batch that fit, FLOPs, roofline terms; no kernel runs).  Phase 13
   serves each MoE model at the dry run's deepest depth for its load (4
   slots of 2048; MOE_LAYERS_PR21 beside it), and every model run of
   phases 4, 9, 11, 13 and 16 prints the dry run's predicted peak beside
   ``torch.cuda.max_memory_allocated()`` reset before the run: a run the
   dry run says does not fit is fatal (it completed), and so is phase
   16's stablelm-1.6b training peak off its prediction by more than
   TRAIN_PEAK_TOL;
16. train, through ``repro_torch.train`` on the ``torch`` backend (the
   kernels have no backward): a. full-width stablelm-1.6b (float32 master
   leaves, bf16 compute, remat, AdamW at a constant 3e-4) on
   ``SyntheticLM`` (seq 1024, batch 8) for 10 steps: every gradient leaf
   finite and nonzero, the mean loss of the last 5 steps below the first
   step's, no flash or decode launch, the kernel path refusing a
   gradient; step ms, tokens/s and MFU on PEAK_BF16_FLOPS reported;
   b. full-width stablelm-1.6b cut to 2 layers in float32, one step on the
   card and on the CPU from the same weights and optimizer state (loss
   1e-5, gradient norm and every gradient and updated leaf 1e-4,
   relative); c. the same cut in bf16 saved at step 2 and restored into a
   fresh ``Trainer``: the state bit for bit, and the next loss equal to
   the uninterrupted run's under ``torch.use_deterministic_algorithms``;
   d. full-width dbrx-132b at the dry run's training depth, Adafactor,
   16 microbatches of one 256-token sequence, 3 steps: finite losses, the
   MoE losses in them; e. ``python -m repro_torch.launch.train --arch
   stablelm-1.6b --steps 20`` (started beside a-d) exits 0;
17. several ranks sharing the card (``torch.distributed`` over ``gloo``,
   helper ranks of ``repro_torch.ranks.RankPool``; the pool of 2 ranks
   that 17a starts last serves 17b-d and phases 18 and 19): a. phase 7's
   orin fixture in float64 at MD_POPULATION chains and SEARCH_STEPS steps
   with the ring on 1, 2 and 4 ranks, and on one rank on the CPU (a
   subprocess run alongside): assignment, objective and chain equal bit
   for bit, both search kernels launched in every rank (the select
   kernel once a step plus its warm-up); each run's wall seconds and
   the seam's host ms per exchange (the first apart: it also waits out
   the ranks' set-up skew); b. the expert-parallel MoE block on 2
   ranks (mesh (data=1, model=2)): full-width dbrx-132b in bf16 over
   EP_TOKENS tokens, each rank holding 8 of the 16 experts (finite,
   equal on both ranks, the path taken); in float32 at capacity factor
   E / k against the plain one-device block (EP_F32_TOL); the reduced
   block against the CPU's one-device block (EP_REDUCED_TOL), and the
   same block on 16 tokens (below the expert-parallel path: its own
   experts, the ranks' combines summed) against the CPU's; a float32
   2-layer cut's prefill of EP_TOKENS tokens through the flash kernel on
   each rank against the plain path (same argmax, <= E2E_F32_REL_TOL); c. the
   gateway CLI at full width with ``--solver anneal --devices 2`` exits
   0 and plans what ``--devices 1`` plans; d. phase 16's 2-layer cut
   (its float32 leaves) saved, then restored onto the 2-rank mesh, each
   rank's blocks bit for bit against its rows of the file's arrays.
18. tensor-parallel serving on 2 ranks sharing the card (a (data 1,
   model 2) mesh over ``gloo``): llama3.2-3b, recurrentgemma-9b and
   rwkv6-7b at full width, their depths cut to TP_DEPTHS, and dbrx-132b
   at the mesh dry run's depth for half the card, each built on the mesh
   under
   ``cfg.serve_rules`` (``Model(mesh=, rules=)``), serve 4 prompts in 4
   slots and MAX_NEW tokens a request through eager decode steps: the
   tokens equal on both ranks, every kernel's launches exact per rank
   (flash on each rank's heads, the decode kernel's split pass and
   combine, RG-LRU on d_rnn / 2 channels, RWKV-6 on 32 heads a rank),
   the collectives' op counts and operand bytes equal to the mesh dry
   run's plan, a rank's KV bytes half the one-device cache's, each
   rank's peak within the mesh dry run's; float32 cuts on the mesh
   against the one-device plain path and prefill(n) + decode against
   prefill(n + 1) (E2E_F32_REL_TOL, same argmax; llama's step lands in
   rank 1's chunk); dbrx-132b's float32 block at 4 tokens against the
   one-device block (MOE_ORACLE_TOL); reported: bf16 against the
   one-device kernel path, the eager step's ms, busy share and the
   collectives' host ms, and the mesh dry run's (1, 2) records.  Phase
   3 also holds the decode kernel's split pass and combine, as entries
   of their own, to their plain twins and times them.
19. training on 2 ranks sharing the card (the same mesh), each model
   built on it under ``cfg.rules`` (``Model(layout="train", mesh=)``)
   and trained through ``Trainer`` on the ``torch`` backend: a. full-width
   stablelm-1.6b (MT_DEPTH of its 24 layers, ZeRO-3: every weight
   gathered at use and its gradient reduce-scattered), AdamW, batch 8 x 1024 (4 rows a rank), a
   step and a profiled one: the batch's loss and gradient norm equal on
   both ranks bit for bit, finite, every gradient block finite and
   nonzero, each rank's peak within the mesh dry run's
   (``mesh_train_memory``); step ms, busy share and the collectives'
   host ms reported; b. its 2-layer cut in float32, one step on the mesh
   against the one-device step on the card from the same seeded leaves
   and moment (CPU_LOSS_RTOL, CPU_GRAD_RTOL, CPU_LEAF_RTOL), the
   collectives' op counts and operand bytes equal to the mesh dry run's
   plan (``mesh_train_step``); c. a checkpoint of the reduced
   stablelm-1.6b saved from the ranks (whole leaves, written once),
   restored into a one-device trainer and saved again, restored onto the
   mesh: the state bit for bit both ways and the next loss the
   uninterrupted trainer's under deterministic algorithms; d. full-width
   dbrx-132b (FSDP-TP: heads, experts and vocabulary split over the model
   axis) at the mesh train dry run's deepest depth for 45% of the card,
   Adafactor, 16 microbatches of one 256-token sequence, MT_MOE_STEPS
   steps: finite, equal on both ranks, peaks within the plan; and the
   reduced dbrx-132b in float32 on the mesh against one device, as b;
   e. a preemption: c's trainer, whose rank 1 alone sends itself a
   SIGTERM during step 2; both ranks must raise ``KeyboardInterrupt``
   after step 2, the one checkpoint must be c's uninterrupted state at
   step 2 bit for bit, and a mesh trainer restored from it must take
   step 3 with the uninterrupted loss; then the 2-layer cut (float32,
   AdamW) saved from the mesh and restored onto it: the host growth
   (``/proc/self/statm``, sampled) of the rank that does not write
   during the save, and of each rank during the restore, within 2 x
   the largest whole array + MT_HOST_SLACK (the writer's save growth
   reported: it keeps its host copies).
20. (run after phase 14, before the dry run) the configurations no
   earlier phase ran, at published widths and the dry run's deepest
   depth for 4 slots of 2048 (each model's own), seeded weights:
   qwen1.5-32b (64 layers, int8 KV cache, QKV bias, 40/40 heads of 128),
   nemotron-4-15b (squared ReLU, 48/8 of 128, a 256,000-token
   vocabulary) and internvl2-2b (16/8 of 128) served through
   ``ServingEngine`` with graph steps as phase 4 serves stablelm-1.6b:
   every request its 16 tokens, flash launches layers x prefills, decode
   launches layers x steps, each run's peak against the dry run's, each
   prompt's bf16 prefill through the kernels against the plain path in
   the engine's slot-0 cache views (<= E2E_REL_TOL, same argmax; where
   rounding through the layers carries the oracle path as far from the
   plain path, phase 9's ``argmax_verdict`` with the oracle its correct
   path); qwen1.5-32b's int8 cache after a 1000-token prefill within
   |x|max / 254 a row plus the bf16 rounding of the prompt's unquantized
   k and v, and its dequantization's device ms in a decode step;
   internvl2-2b's 1100-token prefill with 1024 seeded patch embeddings
   (held as a prompt is; ``mm_proj`` zeroed moves the logits by
   FAULT_MIN_REL or more); an eager engine's tokens (not qwen1.5-32b's:
   a second cache does not fit beside the first); each model at 2 layers
   in float32 with a float32 cache, kernel path against plain path (the
   prefix prefill too) and prefill(n) + decode against prefill(n + 1)
   (E2E_F32_REL_TOL, same argmax); hubert-xlarge's 48-layer encoder over
   1000 seeded frames: 48 ``flash_sm90`` launches (head size 80), the
   whole output within
   E2E_REL_TOL of the plain path (the share of frames whose argmax
   differs reported), float32 at 2 layers within E2E_F32_REL_TOL with
   every frame's argmax the same (profiled: ``flash_sm90_f32`` at head
   size 80 must run and ``flash_kernel`` must not); the serve CLI: ``--arch
   hubert-xlarge`` exits 1 with the reference's message, ``--arch
   internvl2-2b --requests 4`` serves at full width and exits 0.

Each phase prints its seconds.  The last line is the contract line
``{"ok": true, "device": {...}}``; before it come the ``{"phase_s": ...}``,
``{"timer": ...}``, ``{"serve": ...}``, ``{"serve_reduced": ...}``,
``{"search": ...}``,
``{"characterize": ...}``, ``{"serve_recurrent": ...}``,
``{"gateway": ...}``, ``{"fleet": ...}``, ``{"serve_moe": ...}``,
``{"serve_slice": ...}``, ``{"dryrun": ...}``, ``{"train": ...}``,
``{"multidevice": ...}``,
``{"tensor_parallel": ...}``, ``{"mesh_train": ...}`` and
``{"memory": ...}`` lines,
one
``{"kernels": [...]}`` line and the card's ``nvidia-smi`` name and power
limit.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # H100 SXM dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bytes/s
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
#: PCCS slowdown kernel vs plain version (tests/test_kernels.py:185 for
#: float32; float64 differs only in summation order)
SLOWDOWN_TOL = {torch.float64: 1e-12, torch.float32: 5e-6}
KERNEL_SOURCES = ("flash_attention", "decode_attention", "slowdown",
                  "search", "stream", "rglru", "rwkv6")
#: RWKV-6 kernel vs plain version: tests/test_kernels.py:136-140
RWKV_TOL = {torch.float32: dict(atol=1e-4, rtol=5e-2),
            torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
#: stream kernel checks: lengths, the last a 1 GB operand
STREAM_NS = (1, 3, 4097, (1 << 20) + 3, 1 << 28)
#: the reference's peak pass (repro/profiling/probes.py:95), a pass five
#: times the 50 MB L2, and the card's calibration pass (probe_sizes): the
#: kernel and torch.add are timed at each
STREAM_TIMED_MB = (32.0, 256.0, 1000.0)
#: the reference's antagonist and co-run target pass (probes.py:121),
#: checked bitwise with the timed passes
STREAM_CORUN_MB = 8.0
#: head sizes the attention kernels are checked at: every instantiated
#: one (16: every reduced config; 80: hubert-xlarge) and 40, which the
#: wrappers zero-pad to 64
CHECK_HEAD_DIMS = (16, 32, 40, 64, 80, 128, 256)
E2E_REL_TOL = 2e-2
E2E_F32_REL_TOL = 1e-4
PROMPT_LENS = (8, 100, 513, 1000)
MAX_NEW = 16
#: recurrentgemma-9b also serves a prompt past its 2048-token window, so
#: the window mask and the ring cache both run
RG_PROMPT_LENS = PROMPT_LENS + (2300,)
RG_CAPACITY = 2400
#: the recurrent parameters init leaves at zero (so every RG-LRU layer
#: passes its input through and RWKV-6's decay is one constant) get
#: seeded values drawn as the reference's dense_init draws a tensor of
#: that shape, N(0, 1 / fan_in) with fan_in its first axis, as the CPU
#: tests give them
PERTURBED = ("conv_w", "conv_b", "u", "w_lora_b")
#: the bf16 kernel-vs-plain logits limit of a recurrent model's prefill is
#: E2E_REL_TOL, or, on a prompt where two correct implementations (the
#: oracle path and the plain path) already differ by more, FLOOR_MARGIN
#: times their difference: once two bf16 paths differ in one bit, every
#: later rounding of the residual stream differs, and at recurrentgemma-
#: 9b's 38 layers that alone separates them by 2.3-3.8e-2 (with or without
#: the perturbed parameters).  The float32 phase (E2E_F32_REL_TOL) is the
#: check that tells a kernel fault from rounding.  Phase 9's argmax is
#: held the same way (``argmax_verdict``): the kernel path's argmax may
#: differ from the plain path's only among tokens whose plain logits lie
#: within FLOOR_MARGIN times the largest |Δ logit| of a correct path
#: against the plain path.
FLOOR_MARGIN = 1.25
#: phase 9's planted RWKV-6 fault, the one a chunked kernel is most likely
#: to have: the scan's state reset to state0 every this many steps (a
#: state that does not cross a chunk boundary), on the plain path
RWKV_FAULT_EVERY = 64
#: the planted fault (RG-LRU scan output zeroed on the plain path) must
#: move the logits by at least this much
FAULT_MIN_REL = 10 * 2e-2
#: the calibration's fit gate (repro_torch.launch.profile.FIT_GATE), a
#: warning there and here
FIT_GATE = 0.05
#: the calibration's repeatability check: the co-run sweep repeated in
#: one process with the antagonist on each share of the SMs
SPREAD_SHARES = (0.25, 0.5)
SPREAD_REPEATS = 3
PHASES = 20
#: phase 16a: full-width stablelm-1.6b training
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 1024, 8, 10, 3e-4
#: the measured peak of that run against the dry run's prediction (fatal)
TRAIN_PEAK_TOL = 0.15
#: phase 16b-c: the same widths cut to 2 layers; its batch
CUT_LAYERS, CUT_SEQ, CUT_BATCH = 2, 128, 2
CPU_LOSS_RTOL, CPU_GRAD_RTOL, CPU_LEAF_RTOL = 1e-5, 1e-4, 1e-4
RESTART_AT = 2
#: phase 16d: dbrx-132b's 16 microbatches of one 256-token sequence
MOE_TRAIN_ARCH = "dbrx-132b"
MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 256, 16, 3
#: every model run's predicted and measured peak (phases 4-16)
MEMORY = []


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def memory_row(run: str, predicted: dict, measured: int) -> dict:
    """The dry run's predicted peak of a run once its model is built
    (``run_bytes``) beside the measured one (``max_memory_allocated``
    reset after the build, before the run).  The run completed, so a
    prediction that it (or its build) does not fit one card is fatal."""
    from repro_torch.analysis.roofline import HBM_BYTES

    pred = predicted["run_bytes"]
    row = dict(run=run, predicted_bytes=pred, measured_bytes=measured,
               measured_over_predicted=measured / pred,
               predicted_peak_bytes=predicted["peak_bytes"],
               fits=predicted["peak_bytes"] <= HBM_BYTES)
    print(f"  memory, {run}: dry run {pred / 1e9:.3f} GB, "
          f"max_memory_allocated {measured / 1e9:.3f} GB (x"
          f"{row['measured_over_predicted']:.3f}); with the build "
          f"{predicted['peak_bytes'] / 1e9:.3f} GB, which the dry run says "
          f"{'fits' if row['fits'] else 'does not fit'} "
          f"{HBM_BYTES / 1e9:.0f} GB")
    require(row["fits"], f"{run} completed, yet the dry run says it does "
            f"not fit ({predicted['peak_bytes'] / 1e9:.1f} GB)")
    MEMORY.append(row)
    return row


def serve_peak(cfg, slots: int, capacity: int, prompt_lens) -> dict:
    """The dry run's bytes for an engine of ``slots`` x ``capacity``
    whose longest prefill is ``max(prompt_lens)`` tokens."""
    from repro_torch.launch import dryrun
    return dryrun.serve_memory(cfg, slots, capacity, 1, max(prompt_lens))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
class Timer:
    """Median device time of one call, L2 flushed before each call.

    The flush (a 256 MB memset) and then the calibration timer's spin
    (``harness.SPIN_CYCLES``) are queued before the start event, so the
    card is busy while the host queues the timed call: the events
    bracket the call's device time, not the host's launch latency.  (The
    flush alone, ~0.08 ms, did not cover a wrapper's host work on a busy
    host: the select kernel read 0.0099-0.0456 ms over five runs of one
    build.)"""

    def __init__(self, device, reps: int = 15, warmup: int = 3):
        from repro_torch.profiling.harness import SPIN_CYCLES

        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device=device)
        self.reps, self.warmup, self.spin = reps, warmup, SPIN_CYCLES

    def __call__(self, fn, before=None) -> float:
        """``before``, if given, runs ahead of each call, untimed (to
        restore the state an in-place call changed)."""
        for _ in range(self.warmup):
            if before is not None:
                before()
            fn()
        times = []
        for _ in range(self.reps):
            if before is not None:
                before()
            self.flush.zero_()
            torch.cuda._sleep(self.spin)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def launch_floor(timer, dev) -> float:
    """The timer's floor: a one-element ``add_`` (one launch, 4 bytes
    loaded and stored) timed as every kernel is, L2 flushed and the spin
    queued.  A launch-bound kernel is read against it."""
    x = torch.zeros(1, device=dev)
    return timer(lambda: x.add_(1.0))


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


#: the kernels ``ptxas_rows`` reports (demangled, shortened)
PTXAS_KEEP = ("flash_sm90<", "flash_sm90_f32<", "flash_mma<",
              "flash_kernel<float",
              "split_mma<", "combine<",
              "split_simt<bf16, bf16, 64, 1>",
              "split_simt<bf16, bf16, 256, 1>",
              "split_simt<float, float, 64, 1>",
              "split_simt<float, float, 256, 8>",
              "rwkv6_prefill<", "rwkv6_decode<", "rwkv6_chunked_",
              "rglru_prefill<",
              "rglru_decode<", "slowdown_kernel<")


def ptxas_rows(build, name: str) -> dict:
    """Registers and spilled bytes ``ptxas -v`` reported for the main
    kernels of ``csrc/<name>.cu`` in this run's build."""
    report = build.ptxas_report(name)
    mangled = list(report)
    try:
        pretty = subprocess.run(
            [str(Path(build.nvcc_path()).with_name("cu++filt"))],
            input="\n".join(mangled), capture_output=True, text=True,
            check=True).stdout.split("\n")
    except (OSError, subprocess.CalledProcessError):
        pretty = mangled
    rows = {}
    for key, full in zip(mangled, pretty):
        short = (re.sub(r"\(.*", "", full.replace("(int)", ""))
                 .removeprefix("void ")
                 .replace("<unnamed>::", "")
                 .replace("(anonymous namespace)::", "")
                 .replace("__nv_bfloat16", "bf16"))
        if short.startswith(PTXAS_KEEP):
            r = report[key]
            rows[short] = (f"{r.get('registers')} registers, "
                           f"{r.get('spill_stores')} B spill stores")
    return rows


def sm90_sass(build) -> dict:
    """The Hopper flash kernels' SASS in this run's build (``cuobjdump
    -sass``): HGMMA (``wgmma``), UTMALDG and UTMASTG (TMA load and store)
    instructions of ``flash_sm90`` and ``flash_sm90_f32`` by head size,
    and their spills (``ptxas -v``).  Fatal unless every instantiation
    holds HGMMA and spills nothing, and ``flash_sm90``'s hold UTMALDG
    (``flash_sm90_f32`` loads its tiles through registers)."""
    lib = build.library_path("flash_attention")
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).with_name("cuobjdump")), "-sass",
         str(lib)], capture_output=True, text=True, check=True).stdout

    def key(name):
        m = re.search(r"(flash_sm90(?:_f32)?)ILi(\d+)E", name)
        return f"{m.group(1)} D={m.group(2)}" if m else None

    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = key(m.group(1))
            if fn:
                counts[fn] = dict.fromkeys(("HGMMA", "UTMALDG", "UTMASTG"),
                                           0)
        elif fn:
            for op in counts[fn]:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    spills = {key(k): v.get("spill_stores", 0) + v.get("spill_loads", 0)
              for k, v in build.ptxas_report("flash_attention").items()
              if key(k)}
    want = ({f"flash_sm90 D={d}" for d in (64, 80, 128, 256)}
            | {f"flash_sm90_f32 D={d}" for d in (64, 80, 128, 256)})
    require(set(counts) == want and all(
        c["HGMMA"] and (c["UTMALDG"] or "f32" in k)
        for k, c in counts.items()),
        f"the Hopper flash kernels' SASS lacks wgmma or TMA: {counts}")
    require(set(spills) == want and not any(spills.values()),
            f"the Hopper flash kernels spill: {spills}")
    return {k: dict(c, spilled_bytes=spills[k]) for k, c in counts.items()}


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------
def within(got, want, tol) -> tuple[bool, float]:
    """Whether every element has |got - want| <= atol + rtol |want|, and
    the largest |got - want|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return bool((err <= tol["atol"] + tol["rtol"] * w.abs()).all()), \
        float(err.max())


def compare(name, got, want, dtype, tol=None) -> float:
    tol = tol or TOL[dtype]
    require(bool(torch.isfinite(got.float()).all()),
            f"{name}: non-finite output")
    ok, mae = within(got, want, tol)
    print(f"  {name}: max_abs_err={mae:.3e} (atol={tol['atol']:g}, "
          f"rtol={tol['rtol']:g}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return mae


def flash_checks(fa, gen, dev) -> int:
    # (B, Sq, Skv, Hq, Hkv, D, causal, window)
    cases = []
    for s in (8, 100, 513, 1000, 1024):      # the served prompts + 1024
        cases.append((1, s, s, 32, 32, 64, True, None))
    cases += [(1, 100, 513, 32, 32, 64, True, None),     # Sq < Skv offset
              (1, 513, 513, 24, 8, 128, True, None),     # GQA, D = 128
              (2, 300, 300, 8, 2, 64, True, 100),        # local window
              (1, 513, 513, 32, 32, 64, False, None),    # bidirectional
              # long prefills, where O accumulated in place by the tensor
              # cores would drift (flash_sm90_f32 adds each turn's P.V in
              # f32)
              (1, 2048, 2048, 48, 8, 128, True, None),
              (1, 4096, 4096, 32, 32, 64, True, None),
              # recurrentgemma-9b's local layers: MQA, D = 256, past the
              # 2048 window, and an odd size
              (1, 2300, 2300, 16, 1, 256, True, None),
              (1, 2300, 2300, 16, 1, 256, True, 2048),
              (2, 77, 77, 16, 1, 256, True, 48),
              (2, 8, 8, 16, 1, 256, True, 2048),         # its 8-token prompt
              # hubert-xlarge's encoder: 16 heads of 80, bidirectional
              (1, 500, 500, 16, 16, 80, False, None),
              (1, 1000, 1000, 16, 16, 80, False, None),
              (1, 300, 300, 16, 1, 80, True, 100),       # D 80 at MQA 16
              # a reduced config's layers: 4/2 and 4/1 heads of 16
              (2, 100, 100, 4, 2, 16, True, None),
              (1, 100, 100, 4, 1, 16, True, 32)]
    # dbrx-132b's 48/8 and qwen3-moe-235b-a22b's 64/4 of 128 at every
    # served prompt length
    for s in PROMPT_LENS:
        cases += [(1, s, s, 48, 8, 128, True, None),
                  (1, s, s, 64, 4, 128, True, None)]
    # q-tile edges (Sq of 1, 63, 65; 127, 128, 129 around flash_sm90's
    # 128-row tile) and Sq < Skv at every head size: one query row, a
    # tile one row short, a tile spilling one row over
    for D in CHECK_HEAD_DIMS:
        cases += [(1, 1, 129, 4, 2, D, True, None),
                  (2, 63, 63, 4, 1, D, True, None),
                  (1, 65, 200, 4, 4, D, True, 48),
                  (1, 65, 130, 4, 2, D, False, None),
                  (1, 127, 127, 4, 2, D, True, None),
                  (2, 128, 300, 6, 1, D, True, 100),
                  (1, 129, 129, 4, 4, D, False, None)]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, Hq, Hkv, D, causal, window in cases:
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                     (B, Skv, Hkv, D)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.attention_torch(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            compare(f"flash {str(dtype)[6:]} B{B} Sq{Sq} Skv{Skv} "
                    f"H{Hq}/{Hkv} D{D} causal={causal} window={window}",
                    got, want, dtype)
            n += 1
    return n


def decode_checks(da, gen, dev) -> int:
    cases = [(4, 2048, 32, 32, 64, (9, 200, 514, 2047)),
             (4, 2048, 24, 8, 128, (0, 1, 513, 2048)),
             # recurrentgemma-9b's ring cache: lengths past the window
             (4, 2048, 16, 1, 256, (9, 2048, 2301, 4000)),
             # one sequence over an 8192-slot cache: the most splits
             (1, 8192, 32, 32, 64, (1,)), (1, 8192, 32, 32, 64, (8192,)),
             (1, 8192, 16, 1, 256, (1,)), (1, 8192, 16, 1, 256, (8192,)),
             # lengths on split boundaries and one row either side (at
             # B = 4 on 132 SMs these shapes split every 192 and 64 rows)
             (4, 2048, 32, 32, 64, (384, 385, 383, 768)),
             (4, 2048, 16, 1, 256, (64, 65, 63, 128)),
             # a 16-head group at B = 1; groups of 3 at D = 128
             (1, 2048, 16, 1, 256, (2000,)), (1, 2048, 16, 1, 128, (777,)),
             (2, 1024, 24, 8, 128, (700, 1024)),
             # dbrx-132b's groups of 6 (the CUDA-core pass 1) and
             # qwen3-moe-235b-a22b's of 16 (the tensor-core pass) at D 128
             (4, 2048, 48, 8, 128, (0, 1, 513, 2048)),
             (4, 2048, 64, 4, 128, (0, 1, 513, 2048))]
    # the other head sizes, a group of 1 and one of 8 (the tensor-core
    # pass in bf16), lengths 0, 1 and S
    for D in (16, 40, 80):
        cases += [(3, 300, 4, 4, D, (0, 1, 300)),
                  (3, 300, 16, 2, D, (0, 1, 300))]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, Hq, Hkv, D, lens in cases:
            q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = da.decode_attention(q, k, v, lengths)
            want = da.decode_attention_torch(q, k, v, lengths)
            torch.cuda.synchronize()
            compare(f"decode {str(dtype)[6:]} B{B} S{S} H{Hq}/{Hkv} D{D} "
                    f"lengths={list(lens)}", got, want, dtype)
            n += 1
    return n


def split_pass_checks(da, gen, dev) -> int:
    """The decode kernel's split pass and combine pass as entries of their
    own (a cache split by sequence over the ranks of a mesh): each
    chunk's partials through the kernel's combine against the plain
    one-pass version over the whole cache, and the kernel's combine of
    the plain twin's partials against the plain combine.  Chunks at
    offsets, chunks past the length (empty), length 0, ring chunks
    (lengths clamped to the capacity), groups of 1/3/6/8/16; then a
    head-narrowed view of a wider cache through the one-pass kernel (the
    replicated cache of a rank that attends for its own heads only)."""
    # (B, S, Hq, Hkv, D, chunks, lengths)
    cases = [(4, 1040, 24, 8, 128, 2, (8, 100, 513, 1000)),      # llama
             (4, 1040, 24, 8, 128, 2, (0, 1, 520, 521)),
             (4, 2048, 16, 1, 256, 2, (9, 1024, 2048, 2048)),    # the ring
             (3, 768, 8, 8, 64, 3, (0, 256, 257)),               # G 1
             (2, 1024, 48, 8, 128, 4, (1, 700)),                 # G 6
             (2, 512, 64, 8, 64, 2, (300, 512)),                 # G 8
             (4, 1040, 64, 4, 128, 2, (0, 1, 519, 1040))]        # G 16
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, Hq, Hkv, D, tp, lens in cases:
            q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            c = S // tp
            got = [da.decode_attention_partials(
                q, k[:, r * c:(r + 1) * c].contiguous(),
                v[:, r * c:(r + 1) * c].contiguous(), lengths, r * c)
                for r in range(tp)]
            out = da.decode_attention_combine(
                torch.cat([g[0] for g in got], 2),
                torch.cat([g[1] for g in got], 2), dtype)
            want = da.decode_attention_torch(q, k, v, lengths)
            torch.cuda.synchronize()
            label = (f"split pass {str(dtype)[6:]} B{B} S{S} H{Hq}/{Hkv} "
                     f"D{D} over {tp} chunks lengths={list(lens)}")
            compare(label + ", combined", out, want, dtype)
            plain = [da.decode_attention_partials_torch(
                q, k[:, r * c:(r + 1) * c], v[:, r * c:(r + 1) * c],
                lengths, r * c) for r in range(tp)]
            ml, acc = (torch.cat([p[i] for p in plain], 2) for i in (0, 1))
            compare(label + ", combine of the plain partials",
                    da.decode_attention_combine(ml, acc, dtype),
                    da.decode_attention_combine_torch(ml, acc, dtype), dtype)
            n += 2
            if Hkv > 1:             # this rank's heads of a whole cache
                h = Hq // 2
                kv_hi = (h - 1) // (Hq // Hkv) + 1
                qh = q[:, :, :h].contiguous()
                compare(label + f", heads 0-{h - 1} of a wider cache",
                        da.decode_attention(qh, k[:, :, :kv_hi],
                                            v[:, :, :kv_hi], lengths),
                        da.decode_attention_torch(qh, k[:, :, :kv_hi],
                                                  v[:, :, :kv_hi], lengths),
                        dtype)
                n += 1
    return n


def time_split_pass(da, timer, gen, dev) -> list:
    """The two new entries at llama3.2-3b's per-rank shape on 2 ranks: the
    split pass over one rank's chunk (520 of 1040 slots, all 24 query
    heads over 8 kv heads of 128, bf16) at phase 18's prompt lengths,
    beside the one-pass kernel on the same chunk; the combine of 2 ranks'
    partials for the rank's 12 heads."""
    B, S, Hq, Hkv, D, tp = 4, 1040, 24, 8, 128, 2
    lens = tuple(n + MAX_NEW for n in PROMPT_LENS)
    c = S // tp
    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, c, Hkv, D, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    ml, acc = da.decode_attention_partials(q, k, v, lengths, 0)
    pml, pacc = da.decode_attention_partials_torch(q, k, v, lengths, 0)
    err = compare("split pass timed shape, combined",
                  da.decode_attention_combine(ml, acc, torch.bfloat16),
                  da.decode_attention_combine_torch(pml, pacc,
                                                    torch.bfloat16),
                  torch.bfloat16)
    live = sum(min(n, c) for n in lens)
    J = acc.shape[2]
    part_bytes = B * Hq * J * (D + 2) * 4
    flops = 4 * Hq * D * live
    b_ms, b_by = bound(flops, 2 * live * Hkv * D * 2 + B * Hq * D * 2
                       + B * 4 + part_bytes)
    shape = (f"B{B} chunk {c} of {S} H{Hq}/{Hkv} D{D} bf16 lengths="
             f"{list(lens)} (rank 0), {J} splits")
    partials = dict(
        name="decode_attention_partials", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:72",
        shape=shape, max_abs_err=err,
        ms=timer(lambda: da.decode_attention_partials(q, k, v, lengths, 0)),
        plain_ms=timer(lambda: da.decode_attention_partials_torch(
            q, k, v, lengths, 0)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        one_pass_ms=timer(lambda: da.decode_attention(q, k, v, lengths)))
    # the combine of a rank's 12 heads over both ranks' partials
    h = Hq // tp
    ml2 = torch.cat([ml[:, :h]] * tp, 2).contiguous()
    acc2 = torch.cat([acc[:, :h]] * tp, 2).contiguous()
    err = compare("combine timed shape",
                  da.decode_attention_combine(ml2, acc2, torch.bfloat16),
                  da.decode_attention_combine_torch(ml2, acc2,
                                                    torch.bfloat16),
                  torch.bfloat16)
    nbytes = B * h * tp * J * (D + 2) * 4 + B * h * D * 2
    b_ms, b_by = bound(3 * B * h * tp * J * D, nbytes, PEAK_F32_FLOPS)
    combine = dict(
        name="decode_attention_combine", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:72",
        shape=f"B{B} H{h} D{D}, {tp} ranks x {J} splits, bf16 out",
        max_abs_err=err,
        ms=timer(lambda: da.decode_attention_combine(ml2, acc2,
                                                     torch.bfloat16)),
        plain_ms=timer(lambda: da.decode_attention_combine_torch(
            ml2, acc2, torch.bfloat16)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return [partials, combine]


def attention_f64(q, k, v, window=None, causal=True):
    """Attention in float64 (causal unless ``causal`` is False), a head
    at a time (GQA expanded): the yardstick of the float32 rows' errors."""
    B, S, Hq, D = q.shape
    group = Hq // k.shape[2]
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None] if causal
            else torch.ones(S, S, dtype=torch.bool, device=q.device))
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for b in range(B):
        for h in range(Hq):
            s = (q[b, :, h].double() / math.sqrt(D)) @ k[b, :, h // group
                                                          ].double().T
            out[b, :, h] = (torch.softmax(s.masked_fill(~mask, -math.inf),
                                          -1) @ v[b, :, h // group].double())
    return out


def flash_timing(fa, timer, gen, dev, B, S, Hq, Hkv, D, window=None,
                 dtype=torch.bfloat16, causal=True) -> dict:
    """Time one prefill's attention (causal unless ``causal`` is False:
    an encoder's), beside its plain version, its
    bound and ``F.scaled_dot_product_attention`` (GQA expanded).
    ``kernel`` names the kernel that served it (``fa.kernel_for``), and
    ``bound_ms`` is held to that kernel's hardware path: bf16 to the
    tensor cores' rate; float32 on ``flash_sm90_f32`` to three TF32
    products on the tensor cores, with the CUDA cores' float32 rate
    beside it as ``bound_cuda_cores_ms``; float32 on ``flash_kernel`` to
    the CUDA cores' rate.  For float32 the kernel's and the plain
    version's largest error against float64 (``attention_f64``) are
    reported."""
    q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    plain = fa.attention_torch(q, k, v, causal=causal, window=window)
    err = compare(f"flash timed shape D{D} {str(dtype)[6:]}", got, plain,
                  dtype)
    f64 = {}
    if dtype == torch.float32:
        ref = attention_f64(q, k, v, window, causal)
        f64 = dict(f64_err=float((got.double() - ref).abs().max()),
                   plain_f64_err=float((plain.double() - ref).abs().max()))
        del ref
    del got, plain
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
              for x in (k, v))
    w = S if window is None else window
    pairs = (sum(min(i + 1, w) for i in range(S)) if causal
             else S * S)                                # live (q, k) pairs
    flops = 4 * B * Hq * D * pairs
    size = dtype.itemsize
    nbytes = 2 * B * S * (Hq + Hkv) * D * size     # q, k, v read; o written
    kernel = fa.kernel_for(dtype, D)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS
                       if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
    cores = {}
    if dtype == torch.float32:
        cores = dict(bound_cuda_cores_ms=b_ms, bound_cuda_cores_by=b_by)
    if kernel == "flash_sm90_f32":
        b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    if window is None:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
    else:
        pos = torch.arange(S, device=dev)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    return dict(
        shape=f"B{B} S{S} H{Hq}/{Hkv} D{D} {str(dtype)[6:]} "
              + ("causal" if causal else "bidirectional")
              + ("" if window is None else f" window {window}"),
        kernel=kernel, max_abs_err=err,
        ms=timer(lambda: fa.flash_attention(q, k, v, causal=causal,
                                            window=window)),
        plain_ms=timer(lambda: fa.attention_torch(q, k, v, causal=causal,
                                                  window=window)),
        bound_ms=b_ms, bound_by=b_by, library_ms=timer(library), **cores,
        **f64)


#: the causal bf16 layers ``flash_sm90`` is timed at, (B, S, Hq, Hkv, D)
#: by row: stablelm-1.6b's 32 heads of 64 at 1024 tokens (the kernel's
#: own row); llama3.2-3b's 24 query heads over 8 kv heads of 128 (the
#: gateway's second tenant) at 1024 tokens, at the other served prompt
#: lengths, at 4096 (where attention's share of a prefill grows) and on
#: a tensor-parallel rank of 2 (12/4 heads); the MoE models' layers at
#: 1024 tokens: dbrx-132b's 48 over 8 and qwen3-moe-235b-a22b's 64 over 4;
#: phase 20's models: qwen1.5-32b's 40 over 40 (groups of 1) at its
#: 1000-token prompt, internvl2-2b's 16 over 8 at its 1100-token prefix
#: prefill (nemotron-4-15b's 48 over 8 is dbrx-132b's layout)
SM90_ROWS = {
    "": (1, 1024, 32, 32, 64),
    "at_llama": (1, 1024, 24, 8, 128),
    "at_llama_8": (1, 8, 24, 8, 128),
    "at_llama_100": (1, 100, 24, 8, 128),
    "at_llama_513": (1, 513, 24, 8, 128),
    "at_llama_4096": (1, 4096, 24, 8, 128),
    "at_llama_rank": (1, 1024, 12, 4, 128),
    "at_dbrx": (1, 1024, 48, 8, 128),
    "at_qwen3_moe": (1, 1024, 64, 4, 128),
    "at_qwen1_5": (1, 1000, 40, 40, 128),
    "at_internvl2": (1, 1100, 16, 8, 128)}
#: the bf16 layers at the other head sizes ``flash_sm90`` serves, (B, S,
#: Hq, Hkv, D, window): recurrentgemma-9b's local layer at its 2300-token
#: prompt (16 query heads and one kv head of 256, window 2048), and
#: hubert-xlarge's encoder layer (16 heads of 80 over its 1000 frames,
#: bidirectional, ``causal`` False)
WIDE_ROWS = {
    "at_d256": (1, 2300, 16, 1, 256, 2048),
    "at_hubert": (1, 1000, 16, 16, 80, None, torch.bfloat16, False)}


def time_flash(fa, timer, gen, dev) -> dict:
    """Slice shapes: SM90_ROWS and WIDE_ROWS (bf16, on ``flash_sm90``).
    ``kernel`` names the kernel that served each row."""
    rows = {k: flash_timing(fa, timer, gen, dev, *shape)
            for k, shape in {**SM90_ROWS, **WIDE_ROWS}.items()}
    require(all(r["kernel"] == "flash_sm90" for r in rows.values()),
            f"flash rows not on their kernels: {rows}")
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:113",
        **rows.pop(""), **rows)


#: the float32 layers ``flash_sm90_f32`` is timed at, (B, S, Hq, Hkv, D,
#: window, dtype[, causal]) by row: the characterization's attention
#: group (stablelm-1.6b, batch 2, seq 256; the kernel's own row), phase
#: 5's stablelm-1.6b prefill at 1000 tokens, dbrx-132b's 48 over 8 heads
#: of 128 at phase 14's 513 and phase 17's 2048, and the float32 cuts of
#: hubert-xlarge (16 heads of 80 over 1000 frames, bidirectional) and of
#: recurrentgemma-9b's local layer (16 over 1 of 256 at 2300 tokens,
#: window 2048)
F32_ROWS = {
    "": (2, 256, 32, 32, 64, None, torch.float32),
    "at_f32_stablelm_1000": (1, 1000, 32, 32, 64, None, torch.float32),
    "at_f32_dbrx_513": (1, 513, 48, 8, 128, None, torch.float32),
    "at_f32_dbrx_2048": (1, 2048, 48, 8, 128, None, torch.float32),
    "at_f32_hubert": (1, 1000, 16, 16, 80, None, torch.float32, False),
    "at_f32_d256": (1, 2300, 16, 1, 256, 2048, torch.float32)}
#: the reduced configs' layer (4 query heads over 2 kv heads of 16,
#: causal) at a 513-token prompt, by the kernel that serves it: float32
#: (phase 6) on ``flash_kernel``, bf16 on ``flash_mma``
REDUCED_ROWS = {
    "flash_kernel": (1, 513, 4, 2, 16, None, torch.float32),
    "flash_mma": (1, 513, 4, 2, 16, None, torch.bfloat16)}


def time_reduced(fa, timer, gen, dev) -> list:
    """REDUCED_ROWS, each an entry of its own in the kernels line (its
    launches are the reduced configs' paths in phase 6)."""
    out = []
    for name, shape in REDUCED_ROWS.items():
        row = flash_timing(fa, timer, gen, dev, *shape)
        require(row["kernel"] == name, f"{name}'s row on {row['kernel']}")
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:113", **row))
    return out


def time_flash_f32(fa, timer, gen, dev) -> dict:
    """The float32 flash kernel at F32_ROWS (an entry of its own in the
    kernels line; its launches are the float32 paths')."""
    rows = {k: flash_timing(fa, timer, gen, dev, *shape)
            for k, shape in F32_ROWS.items()}
    require(all(r["kernel"] == "flash_sm90_f32" for r in rows.values()),
            f"float32 rows not on flash_sm90_f32: {rows}")
    return dict(
        name="flash_sm90_f32", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:113",
        **rows.pop(""), **rows)


def decode_timing(da, timer, gen, dev, B, S, Hq, Hkv, D, lens,
                  dtype=torch.bfloat16) -> dict:
    """Time one decode step's attention over a cache of S slots (bf16
    unless ``dtype`` says otherwise)."""
    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    err = compare(f"decode timed shape D{D} {str(dtype)[6:]}",
                  da.decode_attention(q, k, v, lengths),
                  da.decode_attention_torch(q, k, v, lengths), dtype)
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
              for x in (k, v))
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    live = sum(min(n, S) for n in lens)
    flops = 4 * Hq * D * live
    size = dtype.itemsize
    nbytes = 2 * live * Hkv * D * size + 2 * B * Hq * D * size + B * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS
                       if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
    splits = da.decode_splits(B, Hkv, S, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    return dict(
        shape=f"B{B} S{S} H{Hq}/{Hkv} D{D} {str(dtype)[6:]} "
              f"lengths={list(lens)}",
        splits=splits, chunk=da.split_chunk(S, splits), max_abs_err=err,
        ms=timer(lambda: da.decode_attention(q, k, v, lengths)),
        plain_ms=timer(lambda: da.decode_attention_torch(q, k, v, lengths)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)))


def time_decode(da, timer, gen, dev) -> dict:
    """Slice shapes: 4 sequences over a 2048-slot cache, 32 heads of 64,
    bf16, lengths {9, 200, 514, 2047}; and recurrentgemma-9b's local
    layer, 16 query heads over one kv head of 256 in its 2048-slot ring,
    one sequence past the window; and llama3.2-3b's layer, 24 query heads
    over 8 kv heads of 128 (groups of 3: the CUDA-core pass 1), and the
    MoE models' layers, dbrx-132b's 48 over 8 (groups of 6, the same
    pass) and qwen3-moe-235b-a22b's 64 over 4 (groups of 16, the
    tensor-core pass), and qwen1.5-32b's 40 over 40 (groups of 1, the
    CUDA-core pass), at the first shape's slots and lengths; and the
    characterization's float32 decode group (stablelm-1.6b, batch 2 over
    256 slots, 32 heads of 64: the CUDA-core pass)."""
    return dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:72",
        **decode_timing(da, timer, gen, dev, 4, 2048, 32, 32, 64,
                        (9, 200, 514, 2047)),
        at_d256=decode_timing(da, timer, gen, dev, 4, 2048, 16, 1, 256,
                              (9, 200, 514, 2048)),
        at_llama=decode_timing(da, timer, gen, dev, 4, 2048, 24, 8, 128,
                               (9, 200, 514, 2047)),
        at_dbrx=decode_timing(da, timer, gen, dev, 4, 2048, 48, 8, 128,
                              (9, 200, 514, 2047)),
        at_qwen3_moe=decode_timing(da, timer, gen, dev, 4, 2048, 64, 4, 128,
                                   (9, 200, 514, 2047)),
        at_qwen1_5=decode_timing(da, timer, gen, dev, 4, 2048, 40, 40, 128,
                                 (9, 200, 514, 2047)),
        at_f32_characterize=decode_timing(da, timer, gen, dev, 2, 256, 32,
                                          32, 64, (256, 256), torch.float32))


# ---------------------------------------------------------------------------
# recurrent scans vs plain versions
# ---------------------------------------------------------------------------
def scan_inputs(B, S, D, dtype, gen, dev):
    a = torch.sigmoid(torch.randn(B, S, D, generator=gen, device=dev))
    b = torch.randn(B, S, D, generator=gen, device=dev)
    h0 = torch.randn(B, D, generator=gen, device=dev)
    return a.to(dtype), b.to(dtype), h0


def bits_check(name, got, want) -> float:
    """Require ``got`` to equal ``want`` bit for bit; returns the largest
    |got - want| (0 when equal) for the record."""
    mae = max_abs_diff(got.float(), want.float())
    same = bit_equal(got, want)
    print(f"  {name}: bitwise {'equal' if same else 'DIFFERENT'} "
          f"(max_abs_err={mae:.3e})")
    require(same, f"{name}: kernel differs from its plain version")
    return mae


def scan_checks(rg, gen, dev) -> int:
    """The RG-LRU kernel against its plain version, bit for bit: S of 1
    (decode), odd sizes, every served prefill length at full width, a
    ragged D and inputs at an odd element offset (element copies); with
    and without h0; h_last float32; a scan cut in two with the carry
    passed on equals one pass."""
    cases = [(4, 1, 4096), (3, 33, 128), (2, 17, 4099)] + [
        (1, s, 4096) for s in RG_PROMPT_LENS]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, D in cases:
            a, b, h0 = scan_inputs(B, S, D, dtype, gen, dev)
            for init in (None, h0):
                got = rg.rglru_scan(a, b, init)
                want = rg.linear_scan_torch(a, b, init)
                torch.cuda.synchronize()
                require(got[0].dtype == dtype
                        and got[1].dtype == torch.float32,
                        f"rglru dtypes {got[0].dtype}/{got[1].dtype}")
                label = (f"rglru {str(dtype)[6:]} B{B} S{S} D{D} "
                         f"h0={'yes' if init is not None else 'no'}")
                bits_check(label, got[0], want[0])
                bits_check(label + " h_last", got[1], want[1])
                n += 2
        # a and b one element past a 16-byte boundary: element copies
        a, b, h0 = scan_inputs(1, 300, 4096, dtype, gen, dev)
        store = torch.empty(2 * a.numel() + 2, dtype=dtype, device=dev)
        a1 = store[1:1 + a.numel()].view(a.shape)
        b1 = store[a.numel() + 2:].view(a.shape)
        a1.copy_(a)
        b1.copy_(b)
        got = rg.rglru_scan(a1, b1, h0)
        want = rg.linear_scan_torch(a, b, h0)
        torch.cuda.synchronize()
        label = f"rglru {str(dtype)[6:]} B1 S300 D4096 element copies"
        bits_check(label, got[0], want[0])
        bits_check(label + " h_last", got[1], want[1])
        a, b, h0 = scan_inputs(1, 1000, 4096, dtype, gen, dev)
        cut = 377
        full, last = rg.rglru_scan(a, b, h0)
        h1_all, h1 = rg.rglru_scan(a[:, :cut].contiguous(),
                                   b[:, :cut].contiguous(), h0)
        h2_all, h2 = rg.rglru_scan(a[:, cut:].contiguous(),
                                   b[:, cut:].contiguous(), h1)
        torch.cuda.synchronize()
        bits_check(f"rglru {str(dtype)[6:]} chunked carry h_all",
                   torch.cat([h1_all, h2_all], dim=1), full)
        bits_check(f"rglru {str(dtype)[6:]} chunked carry h_last", h2, last)
        n += 4
    return n


#: RWKV-6 decays checked: tests/test_kernels.py:133's sigmoid(N + 2);
#: that with w = 0 and w = 1 exactly on some steps and channels; w in
#: 0.01-0.05, whose products underflow to denormals and 0 within tens of
#: steps; and rwkv6-7b's own range, exp(-exp(w0 + lora)) around w0 = -6
#: (models/recurrent.py), ~0.9975
RWKV_DECAYS = ("sigmoid", "edges", "steep", "model")
#: RWKV-6 lengths checked: decode, and around the chunked prefill's chunk
#: of 16 steps (rwkv6.CHUNK): C - 1, C, C + 1, 2C + 1, and more
RWKV_TS = (1, 2, 15, 16, 17, 33, 64, 65)
#: RWKV-6 head sizes (D, Dv) checked: 16, 40, 64 and (20, 18), which no
#: block's 32 columns, warp's 16, 16-byte piece or decode vector divides
RWKV_HEADS = ((16, 16), (40, 40), (64, 64), (16, 64), (64, 40), (20, 18))


def rwkv_inputs(B, T, H, D, Dv, dtype, gen, dev, decay="sigmoid"):
    """tests/test_kernels.py:129-137's distributions; ``decay`` picks w
    from RWKV_DECAYS."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    r = normal(B, T, H, D).to(dtype)
    k = (normal(B, T, H, D) * 0.3).to(dtype)
    v = normal(B, T, H, Dv).to(dtype)
    w = torch.sigmoid(normal(B, T, H, D) + 2.0)
    if decay == "model":
        w = torch.exp(-torch.exp(-6.0 + 0.5 * normal(B, T, H, D)))
    elif decay == "steep":
        w = 0.01 + 0.04 * torch.rand((B, T, H, D), generator=gen, device=dev)
    elif decay == "edges":
        w[:, ::5, :, ::3] = 0.0
        w[:, 2::7, :, 1::4] = 1.0
    w = w.to(dtype)
    u = (normal(H, D) * 0.3).to(dtype)
    s0 = normal(B, H, D, Dv) * 0.1
    return r, k, v, w, u, s0


def rwkv_held(rk, label, got, args) -> float:
    """One launch's (y, state) held as its kernel is: T = 1 (the decode
    kernel) equal to ``rwkv6_torch`` bit for bit; the chunked prefill
    within RWKV_TOL of it and within ``rwkv6.TWIN_TOL`` of its twin.  Each
    output finite; returns the largest |Δ| against ``rwkv6_torch``."""
    dtype, T = args[0].dtype, args[0].shape[1]
    want = rk.rwkv6_torch(*args)
    form = "decode" if T == 1 else "chunked"
    twin = rk.twin(*args) if form == "chunked" else want
    worst = 0.0
    for name, g, x, z in zip(("y", "state"), got, want, twin):
        require(bool(torch.isfinite(g.float()).all()),
                f"{label} {name}: non-finite output")
        ok, err = within(g, x, RWKV_TOL[dtype])
        require(ok, f"{label} {name}: max_abs_err {err:.3e} past "
                f"{RWKV_TOL[dtype]} against the plain version")
        if form == "chunked":
            tol = rk.TWIN_TOL[dtype][name]
            ok, terr = within(g, z, tol)
            require(ok, f"{label} {name}: max_abs_err {terr:.3e} past {tol} "
                    "against the chunked twin")
        else:
            require(torch.equal(g, x), f"{label} {name}: the {form} kernel "
                    "does not repeat the plain version's bits")
        worst = max(worst, err)
    return worst


def rwkv_grid(rk, gen, dev) -> int:
    """The RWKV-6 kernel at every T of RWKV_TS, head sizes RWKV_HEADS,
    decay of RWKV_DECAYS, with and without state0, in both types, held by
    ``rwkv_held``: T = 1 bit for bit, the chunked prefill to the plain
    version (RWKV_TOL) and to its twin (``rwkv6.TWIN_TOL``); one line a
    (type, decay) with the worst error against the plain version."""
    C = rk.CHUNK
    require({C - 1, C, C + 1, 2 * C + 1} <= set(RWKV_TS),
            f"RWKV_TS {RWKV_TS} misses the chunk edges of C = {C}")
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = RWKV_TOL[dtype]
        for decay in RWKV_DECAYS:
            worst, first = 0.0, n
            for T in RWKV_TS:
                for D, Dv in RWKV_HEADS:
                    r, k, v, w, u, s0 = rwkv_inputs(2, T, 2, D, Dv, dtype,
                                                    gen, dev, decay)
                    for init in (None, s0):
                        args = (r, k, v, w, u, init)
                        label = (f"rwkv6 {str(dtype)[6:]} {decay} T{T} "
                                 f"D{D} Dv{Dv} state0="
                                 f"{'yes' if init is not None else 'no'}")
                        worst = max(worst, rwkv_held(
                            rk, label, rk.rwkv6_scan(*args), args))
                        n += 2
            print(f"  rwkv6 {str(dtype)[6:]} decay {decay}: {n - first} "
                  f"outputs at T {RWKV_TS}, heads {RWKV_HEADS}: T 1 equal "
                  f"bits, T > 1 within the twin's {rk.TWIN_TOL[dtype]}, "
                  f"max_abs_err vs plain={worst:.3e} (atol={tol['atol']:g}, "
                  f"rtol={tol['rtol']:g}) ok")
    return n


def rwkv_checks(rk, gen, dev) -> int:
    """The RWKV-6 kernel against its plain version: T of 1 (decode), odd
    sizes, the full-width prefill shape; with and without state0, held by
    ``rwkv_held``, and the sequential prefill (the parent's kernel,
    ``rwkv6.sequential_scan``) equal to the plain version bit for bit; a
    scan cut in two with the state passed on equals one pass within
    RWKV_TOL; a head's outputs the same bits whether it is launched among
    64 heads or among 32 (phase 18's ranks hold 32); then
    :func:`rwkv_grid`."""
    cases = [(4, 1, 64, 64, 64), (2, 17, 4, 32, 32), (1, 33, 3, 16, 40),
             (1, 64, 1, 64, 64), (1, 1000, 64, 64, 64)]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = RWKV_TOL[dtype]
        for B, T, H, D, Dv in cases:
            r, k, v, w, u, s0 = rwkv_inputs(B, T, H, D, Dv, dtype, gen, dev)
            for init in (None, s0):
                args = (r, k, v, w, u, init)
                got = rk.rwkv6_scan(*args)
                torch.cuda.synchronize()
                require(got[0].dtype == dtype
                        and got[1].dtype == torch.float32,
                        f"rwkv6 dtypes {got[0].dtype}/{got[1].dtype}")
                label = (f"rwkv6 {str(dtype)[6:]} B{B} T{T} H{H} D{D} "
                         f"Dv{Dv} state0={'yes' if init is not None else 'no'}")
                err = rwkv_held(rk, label, got, args)
                print(f"  {label}: max_abs_err={err:.3e} (atol="
                      f"{tol['atol']:g}, rtol={tol['rtol']:g}) ok")
                n += 2
                if T > 1:
                    seq = rk.sequential_scan(*args)
                    want = rk.rwkv6_torch(*args)
                    require(all(torch.equal(g, x) for g, x in zip(seq, want)),
                            f"{label}: the sequential prefill does not repeat "
                            "the plain version's bits")
                    n += 2
        r, k, v, w, u, s0 = rwkv_inputs(1, 1000, 64, 64, 64, dtype, gen, dev)
        cut = 377
        y, state = rk.rwkv6_scan(r, k, v, w, u, s0)
        first = [x[:, :cut].contiguous() for x in (r, k, v, w)]
        rest = [x[:, cut:].contiguous() for x in (r, k, v, w)]
        y1, s1 = rk.rwkv6_scan(*first, u, s0)
        y2, s2 = rk.rwkv6_scan(*rest, u, s1)
        torch.cuda.synchronize()
        compare(f"rwkv6 {str(dtype)[6:]} chunked carry y",
                torch.cat([y1, y2], dim=1), y, dtype, tol)
        compare(f"rwkv6 {str(dtype)[6:]} chunked carry state", s2, state,
                dtype, tol)
        half = [x[:, :, :32].contiguous() for x in (r, k, v, w)]
        y32, s32 = rk.rwkv6_scan(*half, u[:32].contiguous(),
                                 s0[:, :32].contiguous())
        torch.cuda.synchronize()
        require(torch.equal(y32, y[:, :, :32]) and torch.equal(s32,
                                                              state[:, :32]),
                f"rwkv6 {str(dtype)[6:]}: heads 0-31 differ when launched "
                "without heads 32-63")
        print(f"  rwkv6 {str(dtype)[6:]} heads 0-31 alone: bitwise equal to "
              "the same heads among 64")
        n += 4
    return n + rwkv_grid(rk, gen, dev)


def rglru_timing(rg, timer, gen, dev, B, S, D, with_h0) -> dict:
    a, b, h0 = scan_inputs(B, S, D, torch.bfloat16, gen, dev)
    h0 = h0 if with_h0 else None
    err = bits_check(f"rglru timed shape B{B} S{S}",
                     rg.rglru_scan(a, b, h0)[0],
                     rg.linear_scan_torch(a, b, h0)[0])
    # a, b in and h out (bf16), h0 in and h_last out (f32)
    nbytes = 3 * B * S * D * 2 + (2 if with_h0 else 1) * B * D * 4
    b_ms, b_by = bound(2.0 * B * S * D, nbytes, PEAK_F32_FLOPS)
    return dict(
        shape=f"B{B} S{S} D{D} bf16, {'f32 h0' if with_h0 else 'no h0'}",
        max_abs_err=err, ms=timer(lambda: rg.rglru_scan(a, b, h0)),
        plain_ms=timer(lambda: rg.linear_scan_torch(a, b, h0)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def time_rglru(rg, timer, gen, dev) -> dict:
    """Every served prefill: one prompt of each RG_PROMPT_LENS length
    through a recurrentgemma-9b RG-LRU layer, d_rnn 4096, bf16, no h0 (as
    a prefill calls it; the row's own numbers are at 1000 tokens); and
    the decode step's shape, one token for each of 4 slots with their
    h0."""
    rows = {s: rglru_timing(rg, timer, gen, dev, 1, s, 4096, False)
            for s in RG_PROMPT_LENS}
    return dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru.cu",
        replaces="src/repro/kernels/rglru.py:63",
        **rows.pop(1000),
        **{f"at_S{s}": row for s, row in rows.items()},
        at_decode=rglru_timing(rg, timer, gen, dev, 4, 1, 4096, True),
        library="none: no single PyTorch call computes a linear recurrence "
                "(torch.cumsum/cumprod give it only through a division "
                "that underflows)")


def rwkv6_timing(rk, timer, plain_timer, gen, dev, B, T, H, D, zero_state,
                 dtype=torch.bfloat16) -> dict:
    """One shape's row: the kernel as the served path launches it, beside
    the parent's kernel (``rwkv6.sequential_scan``, built in the same
    library), the plain version and the bound.  The bound
    counts the function's own work, 4 D Dv FLOP per (b, t, h) (rᵀ S and
    the rank-1 update), at the card's peak rate for the inputs' type (the
    bf16 tensor cores for bf16), against r, k, v, w and y, u, and state0
    read and the state written once."""
    r, k, v, w, u, s0 = rwkv_inputs(B, T, H, D, D, dtype, gen, dev)
    if zero_state:
        s0 = torch.zeros(B, H, D, D, device=dev)
    err = compare(f"rwkv6 timed shape T{T} {str(dtype)[6:]}",
                  rk.rwkv6_scan(r, k, v, w, u, s0)[0],
                  rk.rwkv6_torch(r, k, v, w, u, s0)[0], dtype,
                  RWKV_TOL[dtype])
    flops = 4.0 * B * T * H * D * D
    size = r.element_size()
    nbytes = 5 * B * T * H * D * size + H * D * size + 2 * B * H * D * D * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS
                       if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
    row = dict(
        shape=f"B{B} T{T} H{H} D{D} Dv{D} {str(dtype)[6:]}, "
              + ("zero state0" if zero_state else "f32 state0"),
        form="chunked" if T > 1 else "decode",
        max_abs_err=err,
        ms=timer(lambda: rk.rwkv6_scan(r, k, v, w, u, s0)))
    if T > 1:
        row["parent_ms"] = timer(lambda: rk.sequential_scan(
            r, k, v, w, u, s0))
    return dict(row, plain_ms=plain_timer(lambda: rk.rwkv6_torch(
        r, k, v, w, u, s0)), bound_ms=b_ms, bound_by=b_by, library_ms=None)


def state_copy_ms(timer, dev, B, H, D) -> float:
    """``Tensor.copy_`` of a decode step's float32 state into another: the
    bytes the decode step must read and write, with no arithmetic (a
    yardstick for the step's memory traffic under this timer, not a
    computation of the same function)."""
    a = torch.randn(B, H, D, D, device=dev)
    b = torch.empty_like(a)
    return timer(lambda: b.copy_(a))


#: the served prompt lengths (PROMPT_LENS) the RWKV-6 prefill is timed at
RWKV_TIMED_TS = (1000, 513, 100, 8)


def time_rwkv6(rk, timer, gen, dev) -> dict:
    """Each served prefill: one prompt of each RWKV_TIMED_TS length
    through an rwkv6-7b layer, 64 heads of 64, bf16, a float32 zero
    state0 (as a prefill calls it; the row's own numbers are at 1000
    tokens); the decode step's shape, one token for each of 4 slots with
    their state; and the 1000-token prefill in float32 (phase 10's
    type)."""
    # the plain version (~0.24 s a call at T 1000) is timed over fewer
    # calls than the kernels: it is the arithmetic's twin, not a yardstick
    # of speed
    plain = Timer(dev, reps=3, warmup=1)
    rows = {t: rwkv6_timing(rk, timer, plain, gen, dev, 1, t, 64, 64, True)
            for t in RWKV_TIMED_TS}
    return dict(
        name="rwkv6_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6.cu",
        replaces="src/repro/kernels/rwkv6.py:68",
        **rows.pop(1000),
        **{f"at_T{t}": row for t, row in rows.items()},
        at_decode=dict(rwkv6_timing(rk, timer, timer, gen, dev, 4, 1, 64,
                                    64, False),
                       state_copy_ms=state_copy_ms(timer, dev, 4, 64, 64)),
        at_f32=rwkv6_timing(rk, timer, plain, gen, dev, 1, 1000, 64, 64, True,
                            torch.float32),
        library="none: no single PyTorch call computes the matrix-state "
                "recurrence")


PCCS_KNOTS = (0.1, 0.3, 0.5, 0.7, 0.9)
# the Fig.-6-shaped PCCS surface of repro/profiling/virtual.py:42-50
PCCS_TABLE = ((1.00, 1.02, 1.06, 1.12, 1.20),
              (1.02, 1.08, 1.18, 1.32, 1.50),
              (1.05, 1.15, 1.32, 1.55, 1.82),
              (1.08, 1.24, 1.48, 1.80, 2.18),
              (1.12, 1.34, 1.64, 2.05, 2.60))


def pccs_tensors(dev, dtype=torch.float64):
    knots = torch.tensor(PCCS_KNOTS, dtype=dtype, device=dev)
    return knots, knots, torch.tensor(PCCS_TABLE, dtype=dtype, device=dev)


def demands(n, gen, dev, dtype):
    """Demands over [-0.1, 1.1): zeros, negatives, values outside the
    knots, and a quarter exactly on knots."""
    own, ext = ((torch.rand(n, generator=gen, device=dev,
                            dtype=torch.float64) * 1.2 - 0.1).to(dtype)
                for _ in range(2))
    knots = torch.tensor(PCCS_KNOTS, dtype=dtype, device=dev)
    on = torch.arange(n // 4, device=dev)
    own[on] = knots[on % 5]
    ext[on[::2]] = knots[(on[::2] // 5) % 5]
    own[n // 4:n // 4 + n // 16] = 0.0
    ext[-(n // 16) - 1:] = 0.0
    return own, ext


def slowdown_checks(sd, gen, dev) -> float:
    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        ok, ek, tab = pccs_tensors(dev, dtype)
        for n in (1, 1000, 1 << 20):
            own, ext = demands(n, gen, dev, dtype)
            got = sd.piecewise_slowdown(own, ext, ok, ek, tab)
            want = sd.piecewise_slowdown_torch(own, ext, ok, ek, tab)
            torch.cuda.synchronize()
            tol = SLOWDOWN_TOL[dtype]
            err = (got - want).abs()
            good = bool((err <= tol + tol * want.abs()).all())
            mae = float(err.max())
            worst = max(worst, mae)
            print(f"  slowdown {str(dtype)[6:]} N={n}: max_abs_err={mae:.3e} "
                  f"(atol=rtol={tol:g}) {'ok' if good else 'FAIL'}")
            require(good, "slowdown: kernel disagrees with its plain version")
    return worst


def select_inputs(P, L, gen, dev, dtype):
    cur, prop, best = (torch.randint(0, 3, (P, L), generator=gen, device=dev,
                                     dtype=torch.int32) for _ in range(3))
    cur_obj, prop_obj, best_obj = (
        (torch.rand(P, generator=gen, device=dev, dtype=torch.float64) * 9
         + 1).to(dtype) for _ in range(3))
    prop_obj[::7] = float("inf")               # error-poisoned proposals
    cur_obj[::14] = float("inf")               # inf - inf = NaN delta
    prop_obj[3::11] = float("nan")
    prop_obj[5::13] = -float("inf")
    prop_obj[1::17] = best_obj[1::17]          # ties: strict < keeps best
    u = torch.rand(P, generator=gen, device=dev,
                   dtype=torch.float64).to(dtype)
    return cur, prop, best, cur_obj, prop_obj, best_obj, u


#: the integer type of each floating type's width, for comparing bits
BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def bit_equal(a, b) -> bool:
    if a.dtype.is_floating_point:
        a, b = (x.view(BITS[x.element_size()]) for x in (a, b))
    return bool(torch.equal(a, b))


def max_abs_diff(got, want) -> float:
    """Largest |got - want|, counting equal values (equal infinities, NaN
    against NaN) as no difference."""
    same = (got == want) | (got.isnan() & want.isnan())
    return float(torch.where(same, 0.0, (got - want).abs()).max())


#: the select kernel's row lengths L = w x gmax: its 16-byte path at 64
#: (the orin search's 2 x 32), its 4-byte path at 3, 6 and 130
SELECT_LS = (3, 6, 64, 130)


def offset_copy(t):
    """``t`` copied into a view one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def select_forms(se, args, temp, offset=False):
    """The select kernel's two forms on ``args``: out of place, and in
    place into copies of the state (``offset``: the rows one element off
    a 16-byte boundary, the 4-byte path)."""
    cur, prop, best, cur_obj, prop_obj, best_obj, u = args
    move = offset_copy if offset else torch.clone
    if offset:
        cur, prop, best = (offset_copy(t) for t in (cur, prop, best))
    state = (move(cur), cur_obj.clone(), move(best), best_obj.clone())
    return {
        "out of place": se.anneal_select(cur, prop, best, cur_obj, prop_obj,
                                         best_obj, u, temp),
        "in place": se.anneal_select(state[0], prop, state[2], state[1],
                                     prop_obj, state[3], u, temp,
                                     out=state)}


def select_checks(se, gen, dev) -> int:
    """Every form at every row length, P 32 / 4096 / 65536, both types,
    and at L 64 and 130 with rows off a 16-byte boundary: each bit for
    bit the plain version, each one launch."""
    n = 0
    cases = [(P, L, False) for L in SELECT_LS for P in (32, 4096, 65536)]
    cases += [(4096, 64, True), (4096, 130, True)]
    for dtype in (torch.float64, torch.float32):
        for P, L, offset in cases:
            for temp in (0.37, 1e-40):         # 1e-40 takes the 1e-30 clamp
                args = select_inputs(P, L, gen, dev, dtype)
                want = se.anneal_select_torch(*args, temp)
                before = se.launches
                forms = select_forms(se, args, temp, offset)
                torch.cuda.synchronize()
                require(se.launches == before + len(forms),
                        f"select: {se.launches - before} launches for "
                        f"{len(forms)} calls")
                for form, got in forms.items():
                    same = all(bit_equal(g, w) for g, w in zip(got, want))
                    if not same:
                        print(f"  select {str(dtype)[6:]} P={P} L={L} "
                              f"temp={temp:g} offset={offset} {form}: "
                              f"DIFFERENT")
                    require(same, f"select ({form}): kernel differs from "
                            f"its plain version")
                    n += 1
        print(f"  select {str(dtype)[6:]}: two forms x L {SELECT_LS} x "
              f"P 32 / 4096 / 65536, offset rows at L 64 and 130, temp "
              f"0.37 and 1e-40: bitwise equal")
    return n


def time_slowdown(sd, timer, gen, dev, n) -> dict:
    """Search shape: one wave of the float64 search, N = chains x
    workloads demand pairs."""
    dtype = torch.float64
    ok, ek, tab = pccs_tensors(dev, dtype)
    own, ext = demands(n, gen, dev, dtype)
    err = float((sd.piecewise_slowdown(own, ext, ok, ek, tab)
                 - sd.piecewise_slowdown_torch(own, ext, ok, ek, tab))
                .abs().max())
    b_ms, b_by = bound(0.0, 3 * n * 8)             # own, ext in; s out
    return dict(
        name="piecewise_slowdown", route="cuda",
        source="src/repro_torch/kernels/csrc/slowdown.cu",
        replaces="src/repro/kernels/slowdown.py:75",
        shape=f"N={n} float64, 5x5 PCCS table",
        max_abs_err=err,
        ms=timer(lambda: sd.piecewise_slowdown(own, ext, ok, ek, tab)),
        plain_ms=timer(lambda: sd.piecewise_slowdown_torch(own, ext, ok, ek,
                                                           tab)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def select_bytes(P, L, accept, improved, rows, objs) -> tuple[int, int]:
    """Bytes the select function must move at (P, L) float64 given this
    run's decisions, out of place and in place.  Both read every chain's
    four scalars and the temperature.  Out of place, each output row needs
    one source row (``prop`` where the chain accepts or improves, else
    ``cur`` or ``best``), so a chain reads one row when it both accepts
    and improves and two otherwise, and writes both rows and both
    objectives.  In place, only the chains that accept or improve read
    their ``prop`` row, and only the ``rows`` and ``objs`` whose values
    change are written."""
    row, scalars = L * 4, 4 * P * 8 + 8
    both = int((accept & improved).sum())
    either = int((accept | improved).sum())
    out_of_place = (scalars + (2 * P - both) * row
                    + 2 * P * row + 2 * P * 8)
    in_place = scalars + either * row + rows * row + objs * 8
    return out_of_place, in_place


def time_select(se, timer, gen, dev, P, L) -> dict:
    """Search shape: one step of the float64 search, P chains of L =
    workloads x padded groups, the temperature on the device as the
    search's graph passes it; out of place, and in place into the state
    as the search's step calls it (the state restored, untimed, before
    each call).  The bounds count the bytes this run's decisions need:
    the four scalars of every chain, and of the rows only what each
    output takes (see ``select_bytes``)."""
    from repro_torch.kernels.ref import select_decision

    dtype = torch.float64
    args = select_inputs(P, L, gen, dev, dtype)
    cur, prop, best, cur_obj, prop_obj, best_obj, u = args
    temp = torch.full((1,), 0.37, dtype=dtype, device=dev)
    want = se.anneal_select_torch(*args, 0.37)
    forms = select_forms(se, args, temp)
    err = max(max_abs_diff(g.double(), w.double())
              for got in forms.values() for g, w in zip(got, want))
    accept, improved = select_decision(cur_obj, prop_obj, best_obj, u, 0.37)
    rows = int((want[0] != cur).any(1).sum() + (want[2] != best).any(1).sum())
    objs = sum(int((~((w == x) | (w.isnan() & x.isnan()))).sum())
               for w, x in ((want[1], cur_obj), (want[3], best_obj)))
    nbytes, ip_bytes = select_bytes(P, L, accept, improved, rows, objs)
    b_ms, b_by = bound(0.0, nbytes)
    ip_ms, ip_by = bound(0.0, ip_bytes)
    n_acc, n_imp = int(accept.sum()), int(improved.sum())
    n_both = int((accept & improved).sum())
    saved = tuple(t.clone() for t in (cur, cur_obj, best, best_obj))
    state = tuple(t.clone() for t in saved)

    def restore():
        for t, s0 in zip(state, saved):
            t.copy_(s0)

    def in_place(select):
        return lambda: select(state[0], prop, state[2], state[1], prop_obj,
                              state[3], u, temp, out=state)

    return dict(
        name="anneal_select", route="cuda",
        source="src/repro_torch/kernels/csrc/search.cu",
        replaces="src/repro/kernels/search.py:76",
        shape=f"P={P} L={L} float64, out of place ({n_acc} chains "
              f"accept, {n_imp} improve, {n_both} both)",
        max_abs_err=err,
        ms=timer(lambda: se.anneal_select(*args, temp)),
        plain_ms=timer(lambda: se.anneal_select_torch(*args, temp)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        at_in_place=dict(
            shape=f"P={P} L={L} float64, in place ({rows} rows and {objs} "
                  f"objectives change)",
            max_abs_err=err,
            ms=timer(in_place(se.anneal_select), before=restore),
            plain_ms=timer(in_place(se.anneal_select_torch), before=restore),
            bound_ms=ip_ms, bound_by=ip_by, library_ms=None))


def stream_operands(n, gen, dev):
    """Signed float32 values over twelve decades; the first ten slots of x
    and y hold +-0, subnormals, +-inf, NaN and values near the largest."""
    x, y = (torch.randn(n, generator=gen, device=dev)
            * 10.0 ** torch.randint(-6, 7, (n,), generator=gen, device=dev)
            for _ in range(2))
    specials = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e-45, float("inf"),
                             -float("inf"), float("nan"), 3.4e38, -3.4e38],
                            device=dev)
    k = min(n, specials.numel())
    x[:k] = specials[:k]
    y[:k] = specials.flip(0)[:k]
    return x, y


def stream_checks(st, gen, dev) -> int:
    """The stream kernel equals its plain version bit for bit: aligned,
    at a 4-byte offset (x[1:], y[1:]: the float4 path after a scalar
    head), and with x and y at different offsets (the scalar path)."""
    n_checks = 0
    for n in STREAM_NS:
        x, y = stream_operands(n + 2, gen, dev)
        cases = [("aligned", x[:n], y[:n]), ("offset 1", x[1:n + 1],
                                             y[1:n + 1])]
        if n == STREAM_NS[2]:
            cases.append(("offsets 1/2", x[1:n + 1], y[2:n + 2]))
        for label, a, b in cases:
            got = st.stream(a, b)
            want = st.stream_torch(a, b)
            torch.cuda.synchronize()
            same = bit_equal(got, want)
            print(f"  stream N={n} {label}: bitwise "
                  f"{'equal' if same else 'DIFFERENT'}")
            require(same, "stream: kernel differs from its plain version")
            n_checks += 1
        del x, y, got, want
        torch.cuda.empty_cache()
    return n_checks + duty_check(st, gen, dev)


def duty_check(st, gen, dev) -> int:
    """The duty-cycled antagonist (one launch, its own stream, a quarter
    of the SMs) at full and at a tenth of its duty over 4 MB operands:
    after at least one pass its output equals the plain version bit for
    bit, and raising the flag stops it."""
    n = 1 << 20
    x, y = stream_operands(n, gen, dev)
    out = torch.zeros_like(x)
    moved = torch.zeros(3, dtype=torch.int64, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    blocks = st.duty_blocks(dev, 0.25)
    side, ctl = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    for demand in (1.0, 0.1):
        out.zero_()
        flag.zero_()
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            st.duty_cycle(x, y, out, moved, flag, demand=demand,
                          period_ms=0.02, blocks=blocks, max_s=10.0)
        time.sleep(0.05)
        with torch.cuda.stream(ctl):
            flag.fill_(1)
        t0 = time.perf_counter()
        side.synchronize()
        stop_ms = (time.perf_counter() - t0) * 1e3
        nbytes, span = st.moved_stats(moved)
        passes = nbytes / (3 * 4 * (n // 4 * 4))
        same = bit_equal(out, st.stream_torch(x, y))
        print(f"  stream duty cycle {demand:g} on {blocks} SMs: {passes:.1f} "
              f"passes in {span * 1e3:.1f} ms = "
              f"{nbytes / max(span, 1e-9) / 1e9:.1f} GB/s, stopped "
              f"{stop_ms:.2f} ms after the flag, output bitwise "
              f"{'equal' if same else 'DIFFERENT'}")
        require(passes >= 1, f"the duty cycle streamed {passes} passes")
        require(same, "stream duty cycle: output differs from the plain "
                "version")
        require(stop_ms < 1000, f"the duty cycle took {stop_ms} ms to stop")
    return 2


def stream_timing(st, probes, timer, dev, mb) -> dict:
    """One pass of ``mb`` MB through the probe's own buffers: the kernel,
    the plain version and ``torch.add``."""
    x, y = probes.make_buffers(mb, device=dev)
    n = x.numel()
    want = st.stream_torch(x, y)
    got = st.stream(x, y)
    require(bit_equal(got, want),
            f"stream {mb} MB: the kernel differs from its plain version")
    err = max_abs_diff(got, want)
    lib_err = max_abs_diff(torch.add(y, x, alpha=st.SCALE), want)
    b_ms, b_by = bound(2.0 * n, 3 * n * 4, PEAK_F32_FLOPS)
    del got, want
    ms = timer(lambda: st.stream(x, y))
    return dict(
        shape=f"N={n} float32 ({mb:g} MB pass)", max_abs_err=err, ms=ms,
        plain_ms=timer(lambda: st.stream_torch(x, y)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: torch.add(y, x, alpha=st.SCALE)),
        library_max_abs_err=lib_err, bytes_per_s=3 * n * 4 / (ms * 1e-3))


def time_stream(st, probes, timer, dev) -> dict:
    """Probe shapes: the card's 1 GB calibration pass (probe_sizes), with
    the reference's 32 MB peak pass and a 256 MB pass beside it, through
    the probe's own buffers; the reference's 8 MB co-run pass is checked
    bitwise."""
    x, y = probes.make_buffers(STREAM_CORUN_MB, device=dev)
    same = bit_equal(st.stream(x, y), st.stream_torch(x, y))
    print(f"  stream N={x.numel()} ({STREAM_CORUN_MB:g} MB co-run pass): "
          f"bitwise {'equal' if same else 'DIFFERENT'}")
    require(same, "stream: kernel differs from its plain version at the "
            "co-run pass")
    require(probes.probe_sizes(dev).target_mb == STREAM_TIMED_MB[-1],
            "the timed pass is not the card's calibration pass")
    rows = {mb: stream_timing(st, probes, timer, dev, mb)
            for mb in STREAM_TIMED_MB}
    for row in rows.values():
        print(f"  stream at {row['shape']}: {row['ms']:.4f} ms = "
              f"{row['bytes_per_s'] / 1e9:.1f} GB/s (bound "
              f"{PEAK_BYTES / 1e9:g} GB/s), plain {row['plain_ms']:.4f}"
              f" ms, library {row['library_ms']:.4f} ms (max abs diff "
              f"{row['library_max_abs_err']:.3e})")
        require(row["bytes_per_s"] <= 1.05 * PEAK_BYTES or row is rows[32.0],
                f"stream reads {row['bytes_per_s'] / 1e9:.1f} GB/s, above "
                f"105% of {PEAK_BYTES / 1e9:g} GB/s: a timing fault")
    return dict(name="stream", route="cuda",
                source="src/repro_torch/kernels/csrc/stream.cu",
                replaces="src/repro/profiling/probes.py:51",
                **rows[1000.0], at_32MB=rows[32.0], at_256MB=rows[256.0])


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def make_prompts(vocab: int, lens=PROMPT_LENS) -> list:
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n) for n in lens]


def serve(fa, da, dev) -> dict:
    from repro_torch import configs
    from repro_torch.kernels.graph import Graph
    from repro_torch.models import build, kvcache
    from repro_torch.serve.engine import ServingEngine

    cfg = configs.get("stablelm-1.6b")
    t0 = time.perf_counter()
    model = build(cfg, backend="auto", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  built {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {sum(p.numel() for p in model.parameters()):,} "
          f"parameters in {time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(model, max_slots=4, capacity=2048)
    require(isinstance(eng.graph.graph, Graph),
            "the engine did not capture its step")
    prompts = make_prompts(cfg.vocab)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    da.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    peak = torch.cuda.max_memory_allocated()
    memory_row("serve stablelm-1.6b", serve_peak(cfg, 4, 2048, PROMPT_LENS),
               peak)

    require(len(done) == len(prompts), f"served {len(done)}/{len(prompts)}")
    for r in done:
        require(len(r.tokens) == MAX_NEW,
                f"request {r.rid} got {len(r.tokens)} tokens, not {MAX_NEW}")
    m = eng.metrics()
    L = cfg.n_layers
    require(launches["flash_attention"] == L * len(prompts),
            f"flash launches {launches['flash_attention']} != "
            f"{L} layers x {len(prompts)} prefills")
    require(launches["decode_attention"] == L * m["steps"],
            f"decode launches {launches['decode_attention']} != "
            f"{L} layers x {m['steps']} steps")
    print(f"  served {len(done)} requests, {m['tokens_out']} tokens, "
          f"{m['steps']} decode steps in {wall:.3f} s, mean step "
          f"{m['mean_step_ms']:.3f} ms (CUDA graph, launches per replay "
          f"{eng.graph.graph.launches}); launches {launches}")
    graph_tokens = engine_tokens(eng)

    # kernel path vs plain path, end to end, one prefill per prompt, each
    # written into slot 0 of the engine's cache as the engine does
    views = [kvcache.select(c, 0) for c in eng.caches]
    prefill_ms, rel_errs, floor = [], [], []
    for p in prompts:
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        out = {}
        for backend in ("cuda", "torch", "ref"):
            model.backend = backend
            out[backend], _ = model.prefill(batch, cache_out=views)
        model.backend = "auto"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(batch, cache_out=views)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        g, w, r = (out[b][0, -1] for b in ("cuda", "torch", "ref"))
        require(bool(torch.isfinite(g).all()), "non-finite prefill logits")
        rel = float((g - w).norm() / w.norm())
        # the plain path against the naive oracle: how far bf16 rounding
        # alone moves these logits through 24 random layers
        floor.append(float((r - w).norm() / w.norm()))
        top_g, top_w = int(g.argmax()), int(w.argmax())
        print(f"  prefill S={len(p)}: kernel-vs-plain logits rel err "
              f"{rel:.3e} (oracle-vs-plain {floor[-1]:.3e}), argmax "
              f"{top_g} vs {top_w}, {prefill_ms[-1]:.2f} ms")
        require(top_g == top_w, f"S={len(p)}: argmax differs")
        require(rel <= E2E_REL_TOL, f"S={len(p)}: rel err {rel} > "
                f"{E2E_REL_TOL}")
        rel_errs.append(rel)
    flash_e2e = prefill_flash(model, batch, views)
    print(f"  prefill S={len(prompts[-1])}, device ms: {flash_e2e}")

    return dict(arch=cfg.name, requests=len(done), max_new=MAX_NEW,
                prompt_lens=list(PROMPT_LENS), capacity=2048,
                launches=launches, decode_steps=m["steps"],
                tokens_out=m["tokens_out"], wall_s=wall,
                tokens_per_s=m["tokens_out"] / wall,
                mean_decode_step_ms=m["mean_step_ms"],
                prefill_ms=prefill_ms, e2e_logits_rel_err=rel_errs,
                oracle_vs_plain_rel_err=floor, prefill_flash=flash_e2e,
                max_memory_allocated=peak,
                graph_launches_per_replay=eng.graph.graph.launches,
                profile=profile_decode(eng, prompts),
                eager=eager_comparison(model, prompts, 2048, graph_tokens))


def f32_flash(cfg, before: int, prompts: int) -> dict:
    """The flash kernel a float32 run of ``cfg`` took (by its head size:
    ``kernel_for``) and its launches since the wrapper's count read
    ``before``; fatal unless each of ``prompts`` kernel-path prefills
    launched it once a layer of attention."""
    from repro_torch.kernels import flash_attention as fa

    layers = sum(k in ("attn", "local") for k in cfg.layer_kinds)
    got = dict(kernel=fa.kernel_for(torch.float32, cfg.d_head),
               launches=fa.launches - before)
    require(got["launches"] == prompts * layers,
            f"f32 {cfg.name}: {got} != {prompts} prefills x {layers} "
            f"attention layers")
    print(f"  f32 {cfg.name}: {got['launches']} {got['kernel']} launches")
    return got


def e2e_f32(dev, arch: str = "stablelm-1.6b") -> dict:
    """Kernel path against plain path, float32 end to end.

    Full-width ``arch`` with float32 weights, activations and KV cache
    (TF32 off), one prefill per served prompt.  The two paths differ only
    in summation order, so their last-token logits agree far inside the
    bf16 check's limit; every reading is printed before the limit is
    applied.  The flash kernel's launches are counted (``f32_flash``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build

    cfg = dataclasses.replace(configs.get(arch), dtype="float32",
                              kv_cache_dtype="float32")
    model = build(cfg, backend="cuda", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    rels, same = [], []
    before = fa.launches
    for p in make_prompts(cfg.vocab):
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        out = {}
        for backend in ("cuda", "torch"):
            model.backend = backend
            out[backend] = model.prefill(batch)[0][0, -1]
        g, w = out["cuda"], out["torch"]
        require(bool(torch.isfinite(g).all()), "non-finite f32 logits")
        rels.append(float((g - w).norm() / w.norm()))
        same.append(int(g.argmax()) == int(w.argmax()))
        print(f"  f32 prefill S={len(p)}: kernel-vs-plain logits rel err "
              f"{rels[-1]:.3e}, same argmax {same[-1]}")
    flash = f32_flash(cfg, before, len(rels))
    model.backend = "cuda"
    flash["profiled"] = f32_prefill_flash(model, batch)
    del model
    torch.cuda.empty_cache()
    require(all(same), "f32: argmax differs")
    require(max(rels) <= E2E_F32_REL_TOL,
            f"f32: rel err {max(rels)} > {E2E_F32_REL_TOL}")
    return dict(logits_rel_err=rels, flash=flash)


def f32_flash_profiled(run, label: str) -> dict:
    """One float32 call's device ms and its attention's, by the profiler's
    kernel names (``run`` makes the call).  Fatal if it ran
    ``flash_kernel`` or no ``flash_sm90_f32``: every head size of a
    full-width model (64, 80, 128, 256) is ``flash_sm90_f32``'s, and
    ``flash_kernel`` serves only the reduced configs' 16 (and 32)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels, _ = device_ms_by_kernel(prof)
    if not kernels:
        return {"device_ms": "not measured", "attention_ms": "not measured"}
    ms = {k: sum(v for n, v in kernels.items() if k in n)
          for k in ("flash_sm90_f32", "flash_kernel")}
    require(ms["flash_sm90_f32"] > 0 and ms["flash_kernel"] == 0,
            f"{label}: the float32 attention kernels: {ms}")
    print(f"  {label} profiled: flash_sm90_f32 {ms['flash_sm90_f32']:.3f} "
          f"ms, no flash_kernel")
    return {"device_ms": sum(kernels.values()),
            "attention_ms": ms["flash_sm90_f32"]}


def f32_prefill_flash(model, batch) -> dict:
    """``f32_flash_profiled`` of one prefill of ``batch``."""
    return f32_flash_profiled(lambda: model.prefill(batch),
                              f"f32 {model.cfg.name} prefill")


def engine_tokens(eng) -> dict:
    return {r.rid: list(r.tokens) for r in eng.completed}


def eager_comparison(model, prompts, capacity, graph_tokens) -> dict:
    """The same prompts through an engine that steps eagerly on the card:
    its greedy tokens must equal the graph engine's (fatal); its mean step
    and busy share are the comparison."""
    from repro_torch.serve.engine import ServingEngine

    eng = ServingEngine(model, max_slots=4, capacity=capacity, eager=True)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    eng.run_until_drained()
    same = engine_tokens(eng) == graph_tokens
    m = eng.metrics()
    print(f"  eager engine: mean step {m['mean_step_ms']:.3f} ms, tokens "
          f"{'identical to' if same else 'DIFFERENT from'} the graph's")
    require(same, "graph and eager decoding gave different tokens")
    out = dict(mean_decode_step_ms=m["mean_step_ms"], tokens_identical=same,
               profile=profile_decode(eng, prompts))
    del eng
    torch.cuda.empty_cache()
    return out


def device_ms_by_kernel(prof) -> tuple[dict, int]:
    """Device ms by kernel name, and the number of kernels, of a
    ``torch.profiler`` window."""
    kernels, count = {}, 0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0))
        if t > 0 and evt.device_type.name == "CUDA":
            kernels[evt.key] = kernels.get(evt.key, 0.0) + t / 1e3
            count += evt.count
    return kernels, count


def profile_steps(step, steps: int = 4, plain_ms: float | None = None
                  ) -> dict:
    """Device busy share and top kernels over ``steps`` steady calls of
    ``step`` (torch.profiler; "not measured" if it records no device
    time).  The profiler slows the host's side of a step, so the same
    number of steps just before it is timed unprofiled too (unless the
    caller timed one, ``plain_ms``): the device ms a step over that
    step's ms is the busy share without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    if plain_ms is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, _ = device_ms_by_kernel(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "unprofiled_ms_per_step": plain_ms}
    if busy == 0:
        out["device_busy_share"] = "not measured"
    else:
        out["device_busy_share"] = busy / wall_ms
        out["device_ms_per_step"] = busy / steps
        out["unprofiled_busy_share"] = busy / steps / plain_ms
        out["top_kernels_ms_per_step"] = {k[:60]: v / steps for k, v in top}
    return out


def profile_decode(eng, prompts, steps: int = 4) -> dict:
    """``profile_steps`` over an engine's steady decode steps, all
    ``prompts`` decoding."""
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    eng.step()                                   # admit all, first decode
    eng.step()
    out = profile_steps(eng.step, steps)
    print(f"  profiled {steps} decode steps: {out}")
    return out


def prefill_kernels(model, batch, views) -> dict:
    """Device ms by kernel name of one prefill (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(batch, cache_out=views)
        torch.cuda.synchronize()
    return device_ms_by_kernel(prof)[0]


def profile_prefill(model, batch, views, scan: str) -> dict:
    """Device ms of one prefill through the kernels (torch.profiler): all
    kernels', and those whose names hold ``scan`` (the recurrent scan's);
    "not measured" if the profiler records no device time.  Unlike the
    prefill's wall time, which the eager host dispatch paces, this moves
    with the kernels."""
    kernels = prefill_kernels(model, batch, views)
    if not kernels:
        return {"device_ms": "not measured", "scan_ms": "not measured"}
    return {"device_ms": sum(kernels.values()),
            "scan_ms": sum(v for k, v in kernels.items() if scan in k)}


def prefill_flash(model, batch, views) -> dict:
    """One prefill's device ms and its attention's (``flash_sm90``), by
    the profiler's kernel names.  Fatal if it ran ``flash_mma`` or no
    ``flash_sm90`` (every served model's heads are of 64 or 128)."""
    kernels = prefill_kernels(model, batch, views)
    if not kernels:
        return {"device_ms": "not measured", "attention_ms": "not measured"}
    ms = {k: sum(v for n, v in kernels.items() if k in n)
          for k in ("flash_sm90", "flash_mma")}
    require(ms["flash_sm90"] > 0 and ms["flash_mma"] == 0,
            f"the served prefill's attention kernels: {ms}")
    return {"device_ms": sum(kernels.values()),
            "attention_ms": ms["flash_sm90"]}


# ---------------------------------------------------------------------------
# serve the recurrent families
# ---------------------------------------------------------------------------
def perturb_recurrent(model, gen) -> int:
    """Fill the PERTURBED parameters with seeded N(0, 1 / fan_in) values;
    returns how many tensors were filled."""
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in PERTURBED:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                        * p.shape[0] ** -0.5)
                n += 1
    return n


def build_recurrent(cfg, backend, dev):
    """``cfg`` with seeded random weights and the perturbed recurrent
    parameters, on the card."""
    from repro_torch.models import build

    t0 = time.perf_counter()
    model = build(cfg, backend=backend, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.init(gen)
    n = perturb_recurrent(model, gen)
    torch.cuda.synchronize()
    print(f"  built {cfg.name} ({cfg.dtype}): {cfg.n_layers} layers "
          f"{dict(collections.Counter(cfg.layer_kinds))}, d_model "
          f"{cfg.d_model}, {sum(p.numel() for p in model.parameters()):,} "
          f"parameters, {n} tensors perturbed, in "
          f"{time.perf_counter() - t0:.1f} s")
    return model


def last_logits(model, backend, batch, views):
    model.backend = backend
    try:
        return model.prefill(batch, cache_out=views)[0][0, -1]
    finally:
        model.backend = "auto"


def rel_err(got, want) -> float:
    return float((got - want).norm() / want.norm())


def argmax_verdict(kernel, plain, correct: dict) -> dict:
    """Phase 9's verdict on one prompt's last-position logits, a pure
    function of them: ``kernel`` against ``plain``, where ``correct``
    maps a name to the logits of a path known to be right (the oracle,
    another summation order).

    The spread is the largest |Δ logit| of a correct path against the
    plain path.  The argmax passes when the plain path's logit at the
    kernel path's argmax lies within FLOOR_MARGIN x the spread of the
    plain path's maximum: two correct implementations may disagree on the
    argmax only among tokens that close.  The relative error passes at or
    below max(E2E_REL_TOL, FLOOR_MARGIN x the largest relative error of
    a correct path against the plain path)."""
    g, w = kernel.float().flatten(), plain.float().flatten()
    spreads = {n: float((c.float().flatten() - w).abs().max())
               for n, c in correct.items()}
    floors = {n: rel_err(c.float().flatten(), w) for n, c in correct.items()}
    spread_path = max(spreads, key=spreads.get)
    floor_path = max(floors, key=floors.get)
    top = int(g.argmax())
    margin = float(w.max() - w[top])
    margin_limit = FLOOR_MARGIN * spreads[spread_path]
    rel = rel_err(g, w)
    limit = max(E2E_REL_TOL, FLOOR_MARGIN * floors[floor_path])
    return dict(argmax=top, plain_argmax=int(w.argmax()), margin=margin,
                spread=spreads[spread_path], spread_path=spread_path,
                margin_limit=margin_limit, argmax_ok=margin <= margin_limit,
                rel_err=rel, floor=floors[floor_path], floor_path=floor_path,
                limit=limit, rel_ok=rel <= limit,
                ok=margin <= margin_limit and rel <= limit,
                spreads=spreads, floors=floors)


def verdict_line(v: dict) -> str:
    return (f"rel err {v['rel_err']:.3e} (limit {v['limit']:.3e}, floor "
            f"{v['floor']:.3e} set by {v['floor_path']}), argmax "
            f"{v['argmax']} vs {v['plain_argmax']}: margin "
            f"{v['margin']:.4f} (limit {v['margin_limit']:.4f} = "
            f"{FLOOR_MARGIN} x spread {v['spread']:.4f} set by "
            f"{v['spread_path']}) {'ok' if v['ok'] else 'REFUSED'}")


@contextlib.contextmanager
def swapped(module, name, fn):
    """Run the body with ``module.name`` replaced by ``fn``."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def chunked_scan(rk):
    """The plain RWKV-6 scan in the chunked kernel's order: float32
    ``rwkv6_chunked_torch`` at the kernel's chunk length, a correct path
    of phase 9's verdict (a summation order other than the plain path's,
    at float32 precision)."""
    def chunked(r, k, v, w, u, state0=None):
        return rk.rwkv6_chunked_torch(r, k, v, w, u, state0, rk.CHUNK)
    return chunked


def reset_scan(scan_fn, every: int = RWKV_FAULT_EVERY):
    """``scan_fn`` with the planted fault: the state starts again from
    state0 every ``every`` steps."""
    def scan(r, k, v, w, u, state0=None):
        ys = []
        for t0 in range(0, r.shape[1], every):
            y, state = scan_fn(*(x[:, t0:t0 + every] for x in (r, k, v, w)),
                               u, state0)
            ys.append(y)
        return torch.cat(ys, 1), state
    return scan


def rwkv_fault(model, rk, batch, views, plain, correct, n) -> dict:
    """The plain path with RWKV_FAULT_EVERY's reset on every layer (each
    segment through the float32 chunked order: a correct scan, quicker on
    the card than the step-by-step one), judged as the kernel path is:
    ``argmax_verdict`` must refuse it (fatal)."""
    with swapped(rk, "rwkv6_torch",
                 reset_scan(chunked_scan(rk))):
        faulty = last_logits(model, "torch", batch, views)
    v = argmax_verdict(faulty, plain, correct)
    v["rel_over_limit"] = v["rel_err"] / v["limit"]
    v["margin_over_limit"] = (v["margin"] / v["margin_limit"]
                              if v["margin_limit"] else math.inf)
    print(f"  planted RWKV-6 fault (state reset every {RWKV_FAULT_EVERY} "
          f"steps), S={n}: {verdict_line(v)}; rel err "
          f"{v['rel_over_limit']:.2f}x its limit, margin "
          f"{v['margin_over_limit']:.2f}x its limit")
    require(not v["ok"], f"S={n}: the verdict does not refuse the planted "
            "RWKV-6 fault: it cannot tell a fault from rounding")
    return v


#: phase 9's depths: each rwkv6-7b layer runs the same scan, and its plain
#: path (the verdict's yardstick, a 0.2 ms step a token a layer) set most
#: of the phase's time at 32 layers.  recurrentgemma-9b keeps all 38: at
#: 20 the verdict refused its 8-token prompt (kernel path 2.346e-2 from
#: the plain path, the oracle 1.718e-2, limit 2.148e-2), where at 38 the
#: kernel path sits at 0.84 of its limit; the float32 check of its layers
#: (phase 10) passes
SERVED_RECURRENT_LAYERS = {"rwkv6-7b": 16, "recurrentgemma-9b": 38}


def serve_recurrent(arch, mods, dev) -> dict:
    """Serve ``arch`` at full width through ``ServingEngine``: every
    request its MAX_NEW tokens, the exact launch count of each kernel on
    the path, and each prompt's prefill logits through the kernels
    against the plain path, judged by ``argmax_verdict`` against the
    correct paths (the oracle; for RWKV-6 layers also the plain path
    through the chunked order of ``chunked_scan``); then planted faults
    on the plain path (RWKV-6: the state reset every RWKV_FAULT_EVERY
    steps, which the verdict must refuse at every prompt of 100 tokens or
    more; RG-LRU: the scan's output zeroed)."""
    from repro_torch import configs
    from repro_torch.kernels.graph import Graph
    from repro_torch.models import kvcache
    from repro_torch.serve.engine import ServingEngine

    rg, rk = mods["rglru_scan"], mods["rwkv6_scan"]
    free_card()             # what earlier phases left stays out of the peak
    full = configs.get(arch)
    cfg = dataclasses.replace(full, n_layers=SERVED_RECURRENT_LAYERS[arch])
    lens, capacity = ((RG_PROMPT_LENS, RG_CAPACITY) if "rglru" in
                      cfg.layer_kinds else (PROMPT_LENS, 2048))
    model = build_recurrent(cfg, "auto", dev)
    eng = ServingEngine(model, max_slots=4, capacity=capacity)
    require(isinstance(eng.graph.graph, Graph),
            "the engine did not capture its step")
    prompts = make_prompts(cfg.vocab, lens)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)

    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: m.launches for name, m in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    memory_row(f"serve {arch} ({cfg.n_layers} layers)",
               serve_peak(cfg, 4, capacity, lens), peak)

    require(len(done) == len(prompts), f"served {len(done)}/{len(prompts)}")
    for r in done:
        require(len(r.tokens) == MAX_NEW,
                f"request {r.rid} got {len(r.tokens)} tokens, not {MAX_NEW}")
    m = eng.metrics()
    kinds = collections.Counter(cfg.layer_kinds)
    calls = m["admitted"] + m["steps"]           # prefills + decode steps
    want = {"flash_attention": kinds["local"] * m["admitted"],
            "decode_attention": kinds["local"] * m["steps"],
            "rglru_scan": kinds["rglru"] * calls,
            "rwkv6_scan": kinds["rwkv"] * calls}
    print(f"  served {len(done)} requests, {m['tokens_out']} tokens, "
          f"{m['admitted']} prefills, {m['steps']} decode steps in "
          f"{wall:.3f} s, mean step {m['mean_step_ms']:.3f} ms (CUDA graph, "
          f"launches per replay {eng.graph.graph.launches}); launches "
          f"{launches}")
    require(launches == want, f"launches {launches} != {want} (layers "
            f"{dict(kinds)} x prefills/steps)")
    graph_tokens = engine_tokens(eng)
    by_phase = {name: {"prefill": kinds[kind] * m["admitted"],
                       "decode": kinds[kind] * m["steps"]}
                for name, kind in (("rglru_scan", "rglru"),
                                   ("rwkv6_scan", "rwkv"))}

    views = [kvcache.select(c, 0) for c in eng.caches]
    prefill_ms, verdicts, faults, profiled = [], [], [], []
    scan = "rglru" if kinds["rglru"] else "rwkv6"
    for p in prompts:
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        out = {b: last_logits(model, b, batch, views)
               for b in ("cuda", "torch", "ref")}
        correct = {"oracle": out["ref"]}
        if kinds["rwkv"]:
            with swapped(rk, "rwkv6_torch", chunked_scan(rk)):
                correct["chunked"] = last_logits(model, "torch", batch, views)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(batch, cache_out=views)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        profiled.append(profile_prefill(model, batch, views, scan))
        g, w = out["cuda"], out["torch"]
        require(bool(torch.isfinite(g).all()), "non-finite prefill logits")
        v = argmax_verdict(g, w, correct)
        verdicts.append(v)
        print(f"  prefill S={len(p)}: {verdict_line(v)}, "
              f"{prefill_ms[-1]:.2f} ms; profiled: {profiled[-1]}")
        require(v["argmax_ok"], f"S={len(p)}: the kernel path's argmax "
                f"{v['argmax']} lies {v['margin']:.4f} below the plain "
                f"path's maximum, past {v['margin_limit']:.4f}")
        require(v["rel_ok"], f"S={len(p)}: rel err {v['rel_err']} > "
                f"{v['limit']}")
        if kinds["rwkv"] and len(p) >= 100:
            faults.append(rwkv_fault(model, rk, batch, views, w, correct,
                                     len(p)))

    out = dict(arch=cfg.name, n_layers=f"{cfg.n_layers} of {full.n_layers}",
               requests=len(done), max_new=MAX_NEW,
               prompt_lens=list(lens), capacity=capacity, launches=launches,
               prefills=m["admitted"], decode_steps=m["steps"],
               tokens_out=m["tokens_out"], wall_s=wall,
               tokens_per_s=m["tokens_out"] / wall,
               mean_decode_step_ms=m["mean_step_ms"], prefill_ms=prefill_ms,
               verdicts=verdicts, e2e_logits_rel_err=[
                   v["rel_err"] for v in verdicts],
               e2e_limit=[v["limit"] for v in verdicts],
               planted_rwkv6_faults=faults, prefill_device=profiled,
               max_memory_allocated=peak,
               launches_by_phase=by_phase,
               graph_launches_per_replay=eng.graph.graph.launches)
    if kinds["rglru"]:
        out["planted_fault_rel"] = planted_fault(model, rg, prompts[1], dev,
                                                 views)
    out["profile"] = profile_decode(eng, prompts)
    del eng
    out["eager"] = eager_comparison(model, prompts, capacity, graph_tokens)
    return out


#: the reduced configs phase 6 serves, each with the capacity factors of
#: its experts (None: no experts): the reduced configs' own 8.0, which
#: drops nothing, and the full configs' 1.25
#: (arch, MoE capacity factor, dtype): float32 runs ``flash_kernel``,
#: bf16 ``flash_mma`` (head size 16)
REDUCED_SERVED = (("stablelm-1.6b", None, "float32"),
                  ("recurrentgemma-9b", None, "float32"),
                  ("dbrx-132b", 8.0, "float32"), ("dbrx-132b", 1.25, "float32"),
                  ("qwen3-moe-235b-a22b", 8.0, "float32"),
                  ("qwen3-moe-235b-a22b", 1.25, "float32"),
                  ("stablelm-1.6b", None, "bfloat16"))


def serve_cli_obs(serve_main, argv, work: Path) -> dict:
    """The serve CLI with ``--trace-out`` and ``--metrics-out`` into
    ``work``: it must exit 0, and both files must parse."""
    trace, metrics = work / "serve.trace.json", work / "serve.metrics.json"
    argv = [*argv, "--trace-out", str(trace), "--metrics-out", str(metrics)]
    print(f"  python -m repro_torch.launch.serve {' '.join(argv)}")
    require(serve_main(argv) == 0, "the serve CLI failed")
    events = json.loads(trace.read_text())["traceEvents"]
    snapshot = json.loads(metrics.read_text())
    names = sorted({e["name"] for e in events})
    print(f"  trace: {len(events)} events, names {names}; metrics: "
          f"{sorted(snapshot)}")
    return dict(argv=argv, trace_events=len(events), metrics=sorted(snapshot))


def serve_reduced(mods, dev) -> dict:
    """The reduced (smoke) configs on the card: head size 16, float32
    (and reduced stablelm-1.6b in bf16).

    The port's serve CLI with ``--reduced`` on its default device, for
    stablelm-1.6b and dbrx-132b, and once with ``--trace-out`` and
    ``--metrics-out``; then each of REDUCED_SERVED through the graph
    engine (the eager engine's tokens must equal its tokens, every kernel
    of the path launches exactly), and each prompt's prefill and one
    decode step through the kernels against the plain path (relative
    logits error <= E2E_F32_REL_TOL, same argmax; in bf16 <= E2E_REL_TOL,
    the argmax reported)."""
    from repro_torch import configs
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serve.engine import ServingEngine

    out = {"cli_argv": []}
    for arch in ("stablelm-1.6b", "dbrx-132b"):
        argv = ["--arch", arch, "--reduced", "--requests", "3"]
        print(f"  python -m repro_torch.launch.serve {' '.join(argv)}")
        require(serve_main(argv) == 0, "the serve CLI failed")
        out["cli_argv"].append(argv)
    with tempfile.TemporaryDirectory() as tmp:
        out["cli_obs"] = serve_cli_obs(
            serve_main, ["--gateway", "--arch", "stablelm-1.6b", "--co-arch",
                         "dbrx-132b", "--reduced", "--requests", "2"],
            Path(tmp))
    lens = (8, 40, 100)
    for arch, cf, dtype in REDUCED_SERVED:
        cfg = configs.get(arch).reduced(dtype=dtype, param_dtype=dtype,
                                        kv_cache_dtype=dtype)
        if cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        name = (cfg.name + ("" if cf is None else f" cf {cf:g}")
                + ("" if dtype == "float32" else f" {dtype}"))
        tol = E2E_F32_REL_TOL if dtype == "float32" else E2E_REL_TOL
        require(cfg.d_head == 16, f"{cfg.name}: head {cfg.d_head}")
        model = build_recurrent(cfg, "auto", dev)
        prompts = make_prompts(cfg.vocab, lens)
        eng = ServingEngine(model, max_slots=4, capacity=128)
        for p in prompts:
            eng.submit(p, max_new=MAX_NEW)
        for m in mods.values():
            m.launches = 0
        eng.run_until_drained()
        launches = {name_: m.launches for name_, m in mods.items()}
        m = eng.metrics()
        kinds = collections.Counter(cfg.layer_kinds)
        attn = kinds["attn"] + kinds["local"]
        calls = m["admitted"] + m["steps"]
        want = {"flash_attention": attn * m["admitted"],
                "decode_attention": attn * m["steps"],
                "rglru_scan": kinds["rglru"] * calls,
                "rwkv6_scan": kinds["rwkv"] * calls}
        require(launches == want, f"{name}: launches {launches} != {want}")
        graph_tokens = engine_tokens(eng)
        del eng
        eager = ServingEngine(model, max_slots=4, capacity=128, eager=True)
        for p in prompts:
            eager.submit(p, max_new=MAX_NEW)
        eager.run_until_drained()
        same = engine_tokens(eager) == graph_tokens
        require(same, f"{name}: graph and eager tokens differ")
        rels, step_rels, same_argmax = [], [], []
        for p in prompts:
            batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
            g = last_logits(model, "cuda", batch, None).float()
            w = last_logits(model, "torch", batch, None).float()
            require(bool(torch.isfinite(g).all()), "non-finite logits")
            same_argmax.append(int(g.argmax()) == int(w.argmax()))
            require(same_argmax[-1] or dtype != "float32",
                    f"{name} S={len(p)}: argmax differs")
            rels.append(rel_err(g, w))
            # one decode step after prefill(n - 1), kernel vs plain path
            n = len(p) - 1
            model.backend = "cuda"
            _, caches = model.prefill(
                {"token_ids": torch.as_tensor(p[None, :n], device=dev)},
                capacity=128)
            model.backend = "auto"
            step = {"token_ids": torch.as_tensor(p[None, n:], device=dev),
                    "lengths": torch.tensor([n], dtype=torch.int32,
                                            device=dev)}
            logits = {}
            for backend in ("cuda", "torch"):
                model.backend = backend
                logits[backend], _ = model.decode_step(
                    [{k: ({kk: vv.clone() for kk, vv in v.items()}
                          if isinstance(v, dict) else v.clone())
                      for k, v in c.items()} for c in caches], step)
            model.backend = "auto"
            step_rels.append(rel_err(logits["cuda"][0, -1].float(),
                                     logits["torch"][0, -1].float()))
        kernel = mods["flash_attention"].kernel_for(getattr(torch, dtype),
                                                    cfg.d_head)
        print(f"  {name} (head {cfg.d_head}, {cfg.dtype}, {kernel}): "
              f"{m['steps']} graph steps, tokens identical to eager "
              f"{same}, launches {launches}; kernel-vs-plain logits rel err "
              f"prefill {max(rels):.3e}, decode {max(step_rels):.3e}, same "
              f"argmax {same_argmax}")
        require(max(rels) <= tol and max(step_rels) <= tol,
                f"{name}: rel err {max(rels)}/{max(step_rels)} > {tol}")
        out[name] = dict(dtype=dtype, kernel=kernel, prompt_lens=list(lens),
                         launches=launches, decode_steps=m["steps"],
                         tokens_identical=same, prefill_rel_err=rels,
                         decode_rel_err=step_rels, same_argmax=same_argmax)
        del model, eager
        torch.cuda.empty_cache()
    return out


def planted_fault(model, rg, prompt, dev, views) -> float:
    """The plain path with the RG-LRU scan's output zeroed, against the
    plain path: the perturbed weights must make the scan matter."""
    batch = {"token_ids": torch.as_tensor(prompt[None], device=dev)}
    sound = last_logits(model, "torch", batch, views)

    def zeroed(a, b, h0=None):
        return (torch.zeros_like(a),
                torch.zeros(a.shape[0], a.shape[2], device=a.device))

    with swapped(rg, "linear_scan_torch", zeroed):
        faulty = last_logits(model, "torch", batch, views)
    rel = rel_err(faulty, sound)
    print(f"  planted fault (RG-LRU scan output zeroed, S={len(prompt)}): "
          f"logits move by rel {rel:.3e} (must be >= {FAULT_MIN_REL:g})")
    require(rel >= FAULT_MIN_REL, f"planted fault moved the logits by only "
            f"{rel}: the RG-LRU layers do not matter")
    return rel


#: phase 10's depths: every layer kind of each model (recurrentgemma-9b's
#: pattern three times over), every prompt through each
F32_RECURRENT_LAYERS = {"rwkv6-7b": 8, "recurrentgemma-9b": 9}


def e2e_f32_recurrent(arch, dev) -> dict:
    """Kernel path against plain path, float32 end to end, on ``arch`` at
    full width cut to F32_RECURRENT_LAYERS (float32 weights, activations
    and caches; TF32 off): each prompt's prefill logits, and prefill(n +
    1) against prefill(n) and one decode step through the kernels."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa

    full = configs.get(arch)
    cfg = dataclasses.replace(full, dtype="float32",
                              kv_cache_dtype="float32",
                              n_layers=F32_RECURRENT_LAYERS[arch])
    print(f"  f32 {arch}: {cfg.n_layers} of {full.n_layers} layers")
    lens = RG_PROMPT_LENS if "rglru" in cfg.layer_kinds else PROMPT_LENS
    model = build_recurrent(cfg, "cuda", dev)
    rels, same, step_rels = [], [], []
    before, prefills = fa.launches, 0
    for p in make_prompts(cfg.vocab, lens):
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        g = last_logits(model, "cuda", batch, None)
        w = last_logits(model, "torch", batch, None)
        require(bool(torch.isfinite(g).all()), "non-finite f32 logits")
        rels.append(rel_err(g, w))
        same.append(int(g.argmax()) == int(w.argmax()))
        prefills += 1 + (len(p) > 1)        # the kernel path's prefills
        # prefill(n) then one decode step, against the prefill of n + 1
        n = len(p) - 1
        if n >= 1:
            model.backend = "cuda"
            _, caches = model.prefill(
                {"token_ids": torch.as_tensor(p[None, :n], device=dev)},
                capacity=RG_CAPACITY)
            step, _ = model.decode_step(caches, {
                "token_ids": torch.as_tensor(p[None, n:], device=dev),
                "lengths": torch.tensor([n], dtype=torch.int32,
                                        device=dev)})
            model.backend = "auto"
            step_rels.append(rel_err(step[0, -1], g))
        print(f"  f32 {cfg.name} prefill S={len(p)}: kernel-vs-plain logits "
              f"rel err {rels[-1]:.3e}, same argmax {same[-1]}"
              + (f"; prefill({n}) + decode vs prefill({n + 1}) rel err "
                 f"{step_rels[-1]:.3e}" if n >= 1 else ""))
    flash = f32_flash(cfg, before, prefills)
    if flash["launches"]:
        model.backend = "cuda"
        flash["profiled"] = f32_prefill_flash(model, batch)
        model.backend = "auto"
    del model
    torch.cuda.empty_cache()
    require(all(same), f"f32 {arch}: argmax differs")
    require(max(rels) <= E2E_F32_REL_TOL,
            f"f32 {arch}: rel err {max(rels)} > {E2E_F32_REL_TOL}")
    require(max(step_rels) <= E2E_F32_REL_TOL,
            f"f32 {arch}: prefill+decode rel err {max(step_rels)} > "
            f"{E2E_F32_REL_TOL}")
    return dict(n_layers=f"{cfg.n_layers} of {full.n_layers}",
                prompt_lens=list(lens), logits_rel_err=rels,
                prefill_decode_rel_err=step_rels, flash=flash)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------
SEARCH_STEPS = 64
#: the fixtures' 1024-chain solves run 128 steps: at 64 the orin fixture
#: stops at 4.2745 ms under PCCS, above greedy's 4.2663 ms (the same
#: chains on the CPU); 128 steps reach 4.1500 ms
FIXTURE_STEPS = 128
ORIN = "scenario4-exp8-orin-resnet101-googlenet-inception"


def fixture_requests() -> dict:
    """The golden Table-6 requests, loaded by the port, under PCCS."""
    from repro_torch.core import Plan
    from repro_torch.core.contention import PiecewiseModel

    pccs = PiecewiseModel(PCCS_KNOTS, PCCS_KNOTS, PCCS_TABLE)
    out = {}
    for path in sorted((ROOT / "tests" / "fixtures" / "plans")
                       .glob("*.json")):
        req = Plan.load(path).request
        out[path.stem] = (req, pccs)
    require(len(out) == 3 and ORIN in out, f"fixtures: {sorted(out)}")
    return out


def traced(fn):
    """``fn()`` under a tracer; returns its result and the args of its
    ``anneal.chunk`` spans (per chunk of chains: the graphs' wave budget
    W, the overflow replays, whether the steps were graphs, and each
    graph's launches per replay)."""
    from repro_torch.obs import Tracer, set_tracer

    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        out = fn()
    finally:
        set_tracer(prev)
    return out, [e["args"] for e in tracer.events()
                 if e.get("name") == "anneal.chunk"]


def graph_stats(chunks) -> dict:
    """W, overflow replays and the select kernel's warm-up launches (one
    per chunk of chains whose steps were captured: the warm-up before
    capture runs each graph's body once, the select kernel included)."""
    graphed = [c for c in chunks if c.get("graph")]
    return dict(graph=bool(chunks) and len(graphed) == len(chunks),
                waves=[c.get("waves") for c in chunks],
                overflow_replays=sum(c.get("overflow_replays", 0)
                                     for c in chunks),
                select_warmups=len(graphed),
                launches_per_replay=(graphed[0].get("launches_per_graph")
                                     if graphed else None))


def solve(sd, se, req, model, device, **knobs) -> tuple:
    """One ``Scheduler.solve`` with the kernel counts read around it."""
    from repro_torch.core import Scheduler

    sched = Scheduler(req.platform, model=model, evaluator="torch",
                      device=device)
    sd.launches = se.launches = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan, chunks = traced(lambda: sched.solve(
        list(req.graphs), req.objective,
        max_transitions=req.max_transitions,
        iterations=list(req.iterations),
        depends_on=list(req.depends_on), **knobs))
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"piecewise_slowdown": sd.launches,
                "anneal_select": se.launches}
    row = dict(device=device.type, solver=plan.solver,
               objective=plan.objective,
               assignments=[list(a) for a in plan.assignments], wall_s=wall,
               launches=launches)
    if plan.solver == "anneal":
        p = plan.solver_params
        evaluated = p["population"] * (p["steps"] + 1)
        row.update(device_objective=p["device_objective"], chain=p["chain"],
                   population=p["population"], steps=p["steps"],
                   precision=p["precision"], evaluated=evaluated,
                   cands_per_s=evaluated / wall, **graph_stats(chunks))
    print(f"  {req.graphs[0].name}+.. {plan.solver} on {device.type}: "
          f"{req.objective} {plan.objective:.12g} in {wall:.2f} s, "
          f"launches {launches}"
          + (f", {row['evaluated']} candidates, "
             f"{row['cands_per_s']:.0f}/s, graph {row['graph']}, W "
             f"{row['waves']}, {row['overflow_replays']} overflow replays"
             if "evaluated" in row else ""))
    return plan, row


def card_vs_cpu(sd, se, req, model, dev, population, label, host
                ) -> tuple:
    """The float64 anneal solve of ``req`` under ``model`` at
    ``population`` chains, on the card (as graphs, both search kernels
    launched, the select kernel once a step plus its warm-ups) and on the
    CPU (no kernel launched; solved by the host-work process,
    CPU_SOLVES): the card's device objective must be the CPU's to 1e-9.
    Returns the card's plan, both rows, whether the assignments are the
    same and the relative difference."""
    knobs = dict(solver="anneal", precision="x64", population=population,
                 steps=SEARCH_STEPS, seed=0)
    gpu_plan, gpu = solve(sd, se, req, model, dev, **knobs)
    require(gpu["graph"], f"{label}: the card's search did not run as "
            f"graphs")
    require(gpu["launches"]["piecewise_slowdown"] > 0
            and gpu["launches"]["anneal_select"]
            == SEARCH_STEPS + gpu["select_warmups"],
            f"{label}: search kernels did not launch: {gpu['launches']}")
    done = host.result("cpu_solves")[label]
    cpu = done["row"]
    require(all(cpu[k] == v for k, v in knobs.items() if k in cpu)
            and cpu["population"] == population,
            f"{label}: the host solved {cpu}, not {knobs}")
    require(cpu["launches"] == {"piecewise_slowdown": 0,
                                "anneal_select": 0},
            f"{label}: a kernel launched for CPU tensors")
    d_gpu, d_cpu = gpu["device_objective"], cpu["device_objective"]
    rel = abs(d_gpu - d_cpu) / abs(d_cpu)
    same = [list(a) for a in gpu_plan.assignments] == done["assignments"]
    print(f"  {label} cuda vs cpu: chain {gpu['chain']} vs {cpu['chain']}, "
          f"same assignment {same}, device objective {d_gpu!r} vs "
          f"{d_cpu!r} (rel {rel:.2e})")
    if not same:
        print(f"  tie: cuda {gpu['assignments']}\n       cpu  "
              f"{cpu['assignments']}")
    require(rel <= 1e-9, f"{label}: cuda and cpu incumbents differ: rel "
            f"{rel}")
    return gpu_plan, gpu, cpu, same, rel


def search(sd, se, dev, host) -> dict:
    reqs = fixture_requests()
    req, model = reqs[ORIN]
    gpu_plan, gpu, cpu_row, same, rel = card_vs_cpu(
        sd, se, req, model, dev, 4096, "orin x64", host)
    d_gpu = gpu["device_objective"]
    resim = abs(gpu_plan.objective - d_gpu) / abs(gpu_plan.objective)
    print(f"  device objective vs scalar re-simulation: rel {resim:.2e}")
    require(resim <= 1e-6, f"device objective off the scalar one: {resim}")

    fixtures = {}
    for name, (req_i, model_i) in reqs.items():
        _, row = solve(sd, se, req_i, model_i, dev, solver="anneal",
                       precision="x64", population=1024,
                       steps=FIXTURE_STEPS, seed=0)
        require(row["launches"]["anneal_select"]
                == FIXTURE_STEPS + row["select_warmups"],
                f"{name}: select launches {row['launches']}")
        _, greedy = solve(sd, se, req_i, model_i, dev, solver="greedy")
        ok = row["objective"] <= greedy["objective"] \
            + 1e-9 * abs(greedy["objective"])
        print(f"  {name}: anneal {row['objective']:.12g} vs greedy "
              f"{greedy['objective']:.12g} {'ok' if ok else 'WORSE'}")
        require(ok, f"{name}: anneal worse than greedy")
        fixtures[name] = dict(anneal=row, greedy=greedy)

    _, f32 = solve(sd, se, req, model, dev, solver="anneal",
                   precision="float32", population=4096,
                   steps=SEARCH_STEPS, seed=0)
    scaled = scaled_search(sd, se, req, model, dev, host)
    prof = profile_search(req, model, dev, sd, se)
    return dict(model="PCCS 5x5 (repro/profiling/virtual.py:42-50)",
                steps=SEARCH_STEPS, fixture_steps=FIXTURE_STEPS,
                orin_x64_cuda=gpu, orin_x64_cpu=cpu_row,
                same_assignment=same, device_objective_rel=rel,
                scalar_resim_rel=resim, fixtures=fixtures, orin_float32=f32,
                scaled=scaled, profile=prof)


# ---------------------------------------------------------------------------
# host work: what phases 7 and 15 compute without the card
# ---------------------------------------------------------------------------
#: the §4.4 severity the scaled solve prices contention at, and the
#: observed slowdown the rescheduled plan is made from (quantized 1.625)
SCALED_FACTOR = 1.5
OBSERVED_FACTOR = 1.6
#: phase 7's float64 CPU solves of the orin fixture, (label, the PCCS
#: surface scaled by this factor or None, chains); the card's solves of
#: the same knobs must give their incumbents (``card_vs_cpu``)
CPU_SOLVES = (("orin x64", None, 4096),
              (f"scaled x{SCALED_FACTOR} x64", SCALED_FACTOR, 1024))
#: torch's CPU threads in the host-work process: the card's phases keep
#: the host's other cores
HOST_THREADS = 4
#: the longest the script waits for one of the host work's results
HOST_TIMEOUT_S = 600


def host_work(out: str) -> int:
    """``--host-work OUT``: the work of phases 7 and 15 that needs no card,
    in a process of its own (no CUDA device visible to it) that ``main``
    starts before the build, so that it runs beside the card's phases:
    the float64 anneal solves CPU_SOLVES on the CPU, then the dry run over
    every architecture and shape (``launch.dryrun``) and the MoE depths
    it gives 4 slots of 1040.  Each result is written as JSON to
    ``OUT.<name>.json`` as soon as it is done."""
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.dynamic import ScaledContentionModel
    from repro_torch.kernels import search as se
    from repro_torch.kernels import slowdown as sd
    from repro_torch.launch import dryrun

    torch.set_num_threads(HOST_THREADS)

    def write(name, value):
        tmp = Path(f"{out}.{name}.tmp")
        tmp.write_text(json.dumps(value))
        tmp.rename(f"{out}.{name}.json")

    req, pccs = fixture_requests()[ORIN]
    solves = {}
    for label, factor, population in CPU_SOLVES:
        model = pccs if factor is None else ScaledContentionModel(pccs,
                                                                  factor)
        plan, row = solve(sd, se, req, model, torch.device("cpu"),
                          solver="anneal", precision="x64",
                          population=population, steps=SEARCH_STEPS, seed=0)
        solves[label] = dict(row=row, assignments=[
            list(a) for a in plan.assignments])
    write("cpu_solves", solves)
    t0 = time.perf_counter()
    recs = dryrun.run(list(configs.ARCHS), list(SHAPES), log=lambda _: None)
    write("dryrun", dict(records=recs, seconds=time.perf_counter() - t0,
                         moe_layers_at_1040=moe_layers(1040)))
    return 0


class HostWork:
    """The ``--host-work`` process (``host_work``), started at once; its
    output is printed, indented, when its first result is taken, and it
    is killed by ``close`` if it is still running."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        self.out = Path(self.dir.name) / "host"
        self.log = Path(self.dir.name) / "host.log"
        self.t0 = time.perf_counter()
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--host-work", str(self.out)], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        self.done, self.printed = {}, 0

    def result(self, name: str) -> dict:
        """Result ``name``, waiting for it; fatal if the process ended
        without it."""
        path = Path(f"{self.out}.{name}.json")
        t0 = time.perf_counter()
        if name in self.done:
            return self.done[name]
        while name not in self.done:
            if path.exists():
                self.done[name] = json.loads(path.read_text())
                self.done[name]["ready_after_s"] = time.perf_counter() - (
                    self.t0)
                self.done[name]["waited_s"] = time.perf_counter() - t0
                break
            rc = self.proc.poll()
            require(rc is None and time.perf_counter() - t0 < HOST_TIMEOUT_S,
                    f"the host-work process gave no {name} (exit {rc}):\n"
                    + self.log.read_text()[-4000:])
            time.sleep(0.1)
        lines = self.log.read_text().splitlines()
        for line in lines[self.printed:]:
            print(f"    [host work] {line}")
        self.printed = len(lines)
        got = self.done[name]
        print(f"  host work: {name} ready {got['ready_after_s']:.1f} s "
              f"after the script started it, waited {got['waited_s']:.1f} s")
        return got

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.dir.cleanup()


def scaled_search(sd, se, req, pccs, dev, host) -> dict:
    """§4.4 on the card: the orin fixture under ``ScaledContentionModel(
    pccs, 1.5)`` (the scaled surface through the slowdown kernel, then
    the select kernel in every step), float64 at 1024 chains, must give
    the CPU's incumbent; then a plan ``reschedule_plan`` rescaled, saved
    and loaded back, keeps its model, factor and request hash (the
    format ``tests/test_torch_dynamic.py`` holds to the reference's, both
    ways)."""
    from repro_torch.core import Plan, Scheduler
    from repro_torch.core.dynamic import (ScaledContentionModel,
                                          quantize_severity, reschedule_plan)

    _, gpu, cpu, same, rel = card_vs_cpu(
        sd, se, req, ScaledContentionModel(pccs, SCALED_FACTOR), dev, 1024,
        f"scaled x{SCALED_FACTOR} x64", host)
    sched = Scheduler(req.platform, model=pccs, device=dev)
    plan = reschedule_plan(sched, list(req.graphs), OBSERVED_FACTOR,
                           objective=req.objective,
                           max_transitions=req.max_transitions,
                           iterations=list(req.iterations),
                           depends_on=list(req.depends_on))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "rescheduled.json"
        plan.save(path)
        back = Plan.load(path)
    loaded = back.request.model
    ok = (type(loaded) is ScaledContentionModel
          and loaded.factor == quantize_severity(OBSERVED_FACTOR)
          and loaded.base == pccs and back.request_hash == plan.request_hash
          and back.assignments == plan.assignments)
    print(f"  rescheduled plan (observed {OBSERVED_FACTOR}, factor "
          f"{loaded.factor}, {plan.solver}) saved and loaded: "
          f"{'same model and request hash' if ok else 'DIFFERENT'}")
    require(ok, "a rescaled plan did not load back as it was saved")
    return dict(factor=SCALED_FACTOR, cuda=gpu, cpu=cpu,
                same_assignment=same, device_objective_rel=rel,
                rescheduled=dict(observed=OBSERVED_FACTOR,
                                 factor=loaded.factor, solver=plan.solver,
                                 request_hash=plan.request_hash))


def profile_search(req, model, dev, sd, se, steps: int = 16) -> dict:
    """Device busy share of the orin float64 solve at 4096 chains, the
    graphs' capture included: ``steps`` steps, timed once unprofiled and
    then under torch.profiler (whose trace of all 64 steps holds ~600,000
    kernels and takes a minute to read back).  The profile sums the
    slowdown kernel (``sd``) and the select kernel (``se``) over the
    solve's eager evaluation and graph replays: their launches and device
    time, and the device kernels of the whole solve."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Scheduler

    def fresh():        # a Scheduler of its own: no plan cached by another
        return Scheduler(req.platform, model=model, evaluator="torch",
                         device=dev)

    kw = dict(max_transitions=req.max_transitions,
              iterations=list(req.iterations),
              depends_on=list(req.depends_on), solver="anneal",
              precision="x64", population=4096, steps=steps, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh().solve(list(req.graphs), req.objective, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    sched = fresh()
    sd.launches = se.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.solve(list(req.graphs), req.objective, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    slowdown_launches, select_launches = sd.launches, se.launches
    kernels, launches = device_ms_by_kernel(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out = {"population": 4096, "steps": steps, "precision": "x64",
           "wall_ms": wall_ms, "unprofiled_wall_ms": plain_ms,
           "device_kernels": launches,
           "slowdown_launches": slowdown_launches,
           "select_launches": select_launches}
    if busy == 0:
        out["device_busy_share"] = "not measured"
        out["slowdown_device_ms"] = "not measured"
        out["select_device_ms"] = "not measured"
    else:
        out["device_busy_share"] = busy / wall_ms
        out["unprofiled_busy_share"] = busy / plain_ms
        out["device_ms"] = busy
        out["top_kernels_ms"] = {k[:60]: v for k, v in top}
        # the two hand-written search kernels' share of the device time
        out["search_kernels_ms"] = {
            name: sum(v for k, v in kernels.items() if name in k)
            for name in ("slowdown_kernel", "select_kernel")}
        out["slowdown_device_ms"] = out["search_kernels_ms"][
            "slowdown_kernel"]
        out["select_device_ms"] = out["search_kernels_ms"]["select_kernel"]
        print(f"  slowdown kernel in one solve: "
              f"{out['slowdown_device_ms']:.4f} ms of device time over "
              f"{slowdown_launches} launches, select kernel "
              f"{out['select_device_ms']:.4f} ms over {select_launches}; "
              f"{launches} device kernels in all; "
              f"the solve {wall_ms:.1f} ms of wall "
              f"time ({plain_ms:.1f} unprofiled), the card busy "
              f"{busy / wall_ms:.1%} ({busy / plain_ms:.1%} of the "
              f"unprofiled)")
    print(f"  profiled one solve: {out}")
    return out


# ---------------------------------------------------------------------------
# characterize
# ---------------------------------------------------------------------------
def rises(slowdowns) -> bool:
    """Slowdowns in order of demand never fall by more than 5%."""
    return all(b >= 0.95 * a for a, b in zip(slowdowns, slowdowns[1:]))


def calibration_spread(levels, timer) -> dict:
    """The calibration's co-run sweep again, SPREAD_REPEATS times with
    the antagonist on each of SPREAD_SHARES of the SMs: how far repeated
    calibrations in one process agree.  At the calibration's own share
    every repeat must rise with the demand within 5% (fatal)."""
    from repro_torch.profiling import probes

    out = {}
    for share in SPREAD_SHARES:
        sizes = dataclasses.replace(probes.CUDA_SIZES, sm_share=share)
        reps = []
        for _ in range(SPREAD_REPEATS):
            base_ms, recs = probes.stream_slowdowns(levels, sizes=sizes,
                                                    timer=timer)
            slowdowns = [c["slowdown"] for c in recs]
            reps.append(dict(base_ms=base_ms, slowdowns=slowdowns,
                             rises=rises(slowdowns),
                             gb_per_s=[c["probe_bytes_per_s"] / 1e9
                                       for c in recs]))
            print(f"  spread, antagonist on {share:g} of the SMs: "
                  f"standalone {base_ms:.4f} ms; slowdowns "
                  f"{[round(v, 4) for v in slowdowns]} (rise within 5%: "
                  f"{rises(slowdowns)}); antagonist "
                  f"{[round(c['probe_bytes_per_s'] / 1e9) for c in recs]} "
                  f"GB/s")
            require(rises(slowdowns)
                    or share != probes.CUDA_SIZES.sm_share,
                    f"repeated calibration does not rise with the demand: "
                    f"{slowdowns}")
        tops = [r["slowdowns"][-1] for r in reps]
        print(f"  spread at {share:g}: top sample {min(tops):.4f}-"
              f"{max(tops):.4f} over {SPREAD_REPEATS} repeats")
        out[f"{share:g}"] = dict(repeats=reps, top=tops)
    return out


def characterize(fa, da, sd, se, st, path: Path,
                 kind: str = "prefill") -> dict:
    """The port's profiling CLI on full-width stablelm-1.6b, its layer
    groups a ``kind`` step (prefill through the flash kernel, decode
    through the decode kernel), writing its bundle to ``path``, then a
    solve from the bundle through ``Scheduler.from_bundle``.  The
    calibration's repeatability sweep runs with the prefill only."""
    from repro_torch.core import Scheduler
    from repro_torch.launch.profile import main as profile_main
    from repro_torch.profiling import ProfileBundle, TimerConfig, harness

    # the attention kernel's count where each group's runner is made: the
    # CLI drives the groups one after another, so the differences are per
    # group
    attn = fa if kind == "prefill" else da
    marks = []
    make_runner = harness._group_runner

    def marked_runner(*args, **kwargs):
        marks.append(attn.launches)
        return make_runner(*args, **kwargs)

    argv = ["--executor", "torch", "--arch", "stablelm-1.6b", "--kind", kind,
            "--fit", "piecewise", "--solve", "--solver", "anneal", "--out",
            str(path)]
    print(f"  python -m repro_torch.launch.profile {' '.join(argv)}")
    harness._group_runner = marked_runner
    fa.launches = da.launches = sd.launches = se.launches = 0
    st.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rc = profile_main(argv)
    finally:
        harness._group_runner = make_runner
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches,
                "piecewise_slowdown": sd.launches,
                "anneal_select": se.launches, "stream": st.launches}
    require(rc == 0, f"profile CLI exited {rc}")
    bundle = ProfileBundle.load(path)
    prov = bundle.provenance
    calls = prov["timer"]["warmup"] + prov["timer"]["repeats"]
    per_group = [b - a for a, b in zip(marks, marks[1:] + [attn.launches])]
    for g, n in zip(prov["groups"], per_group):
        print(f"  {g['name']}: {g['median_ms']:.4f} ms (n={g['n_kept']}/"
              f"{g['n_total']}, std {g['std_ms']:.4f}), {n} "
              f"{attn.__name__.rsplit('.', 1)[-1]} launches")
    probe = prov["probe"]
    print(f"  probe sizes {probe}")
    print(f"  probe peak {prov['peak_stream_bytes_per_s'] / 1e9:.2f} GB/s "
          f"({probe['peak_mb']:g} MB pass); target pass "
          f"{prov['stream_base_ms']:.4f} ms ({probe['target_mb']:g} MB)")
    for c in prov["corun"]:
        print(f"  demand {c['ext']:g}: co-run {c['co_ms']:.4f} ms over "
              f"{c['base_ms']:.4f} ms standalone, ratio {c['ratio']:.4f}, "
              f"slowdown {c['slowdown']:.4f}, antagonist "
              f"{c['probe_launches']} launch, {c['probe_passes']:.1f} "
              f"passes x "
              f"{c['probe_bytes_per_pass'] / 1e6:.1f} MB in "
              f"{c['probe_s']:.3f} s = {c['probe_bytes_per_s'] / 1e9:.2f} "
              f"GB/s")
    fit = prov["fit"]
    print(f"  fit {type(bundle.model).__name__}: rmse {fit['rmse']:.4f}, "
          f"max_rel {fit['max_rel_err']:.2%}, {fit['steps']} Adam steps; "
          f"bundle {bundle.bundle_hash()}; launches {launches}; "
          f"{wall:.1f} s")
    layers = 3                          # per group: 24 layers in 8 groups
    require(len(bundle.graphs) == 1 and len(bundle.graphs[0]) == 8
            and len(per_group) == 8,
            f"expected 8 measured groups, got {per_group}")
    require(all(n == layers * calls for n in per_group),
            f"{kind} attention launches per group {per_group} != {layers} "
            f"x {calls}")
    other = "decode_attention" if kind == "prefill" else "flash_attention"
    require(launches[other] == 0, f"a {kind} characterization launched "
            f"{launches[other]} {other}")
    require(probe["blocks"] == max(1, int(
        torch.cuda.get_device_properties(0).multi_processor_count
        * probe["sm_share"])), f"antagonist grid {probe['blocks']}")
    require(all(c["probe_passes"] > 0 and c["probe_launches"] == 1
                for c in prov["corun"]),
            "the antagonist made no pass at some demand level")
    # the peak passes, the antagonist's full-duty launch, and each level's
    # standalone and co-run passes and antagonist launch
    stream_calls = calls + 1 + sum(2 * calls + c["probe_launches"]
                                   for c in prov["corun"])
    require(launches["stream"] == stream_calls,
            f"stream launches {launches['stream']} != {stream_calls} "
            f"(peak {calls}, the full-duty antagonist, plus each level's "
            f"2 x {calls} target calls and antagonist launch)")
    require(launches["piecewise_slowdown"] > 0
            and launches["anneal_select"] > 0,
            f"the CLI's anneal solve launched no search kernel: {launches}")
    again = ProfileBundle.from_json(bundle.to_json())
    require(again.bundle_hash() == bundle.bundle_hash(),
            "bundle did not round-trip")
    # each sample is its level's co-run over the standalone pass timed
    # just before it, floored at 1 (a co-run read faster than standalone
    # is noise)
    want = [(c["ext"], max(1.0, c["co_ms"] / c["base_ms"]))
            for c in prov["corun"]]
    require(len(bundle.samples) == len(want) and all(
        s[1] == e and s[2] == w >= 1.0
        for s, (e, w) in zip(bundle.samples, want)),
        f"co-run samples {bundle.samples} are not the measured slowdowns "
        f"{want}")
    ordered = sorted(bundle.samples, key=lambda smp: smp[1])
    monotone = rises([smp[2] for smp in ordered])
    print(f"  samples (own, ext, slowdown): {[list(x) for x in ordered]}; "
          f"non-decreasing in ext within 5%: {monotone}; fit max rel err "
          f"{fit['max_rel_err']:.2%} against the {FIT_GATE:.0%} gate")
    print(f"  fit warning: {prov['fit_warning']}")
    require(monotone, f"the samples fall by more than 5% as the demand "
            f"rises: {[smp[2] for smp in ordered]}")

    spread = (calibration_spread([c["ext"] for c in prov["corun"]],
                                 TimerConfig.from_dict(prov["timer"]))
              if kind == "prefill" else None)

    sched = Scheduler.from_bundle(bundle, evaluator="torch")
    require(sched.device.type == "cuda", f"solved on {sched.device}")
    sd.launches = se.launches = 0
    steps = 64
    t0 = time.perf_counter()
    plan, chunks = traced(lambda: sched.solve(
        list(bundle.graphs), "latency", solver="anneal", max_transitions=2,
        population=1024, steps=steps, seed=0))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    warmups = graph_stats(chunks)["select_warmups"]
    search_launches = {"piecewise_slowdown": sd.launches,
                       "anneal_select": se.launches}
    greedy = sched.solve(list(bundle.graphs), "latency", solver="greedy",
                         max_transitions=2)
    print(f"  from_bundle(evaluator='torch') on cuda: {plan.summary()}")
    print(f"  anneal {plan.objective!r} in {solve_s:.2f} s (launches "
          f"{search_launches}) vs greedy {greedy.objective!r}")
    require(search_launches["piecewise_slowdown"] > 0
            and search_launches["anneal_select"] == steps + warmups,
            f"search kernels did not launch: {search_launches}")
    require(plan.objective <= greedy.objective
            + 1e-9 * abs(greedy.objective), "anneal worse than greedy")
    return dict(argv=argv, wall_s=wall, launches=launches,
                attention_per_group=per_group, groups=prov["groups"],
                peak_stream_bytes_per_s=prov["peak_stream_bytes_per_s"],
                stream_base_ms=prov["stream_base_ms"], corun=prov["corun"],
                samples=[list(x) for x in bundle.samples], fit=fit,
                probe=probe, samples_monotone=monotone, spread=spread,
                model=type(bundle.model).__name__,
                bundle_hash=bundle.bundle_hash(),
                search_cands_per_s=prov.get("search_cands_per_s"),
                device=prov.get("device"),
                from_bundle=dict(objective=plan.objective,
                                 assignments=[list(a) for a in
                                              plan.assignments],
                                 solve_s=solve_s, launches=search_launches,
                                 select_warmups=warmups,
                                 greedy_objective=greedy.objective))


# ---------------------------------------------------------------------------
# the multi-tenant gateway and the fleet
# ---------------------------------------------------------------------------
GW_ARCHS = ("stablelm-1.6b", "llama3.2-3b")
#: slots of each tenant's KV cache: the longest prompt plus MAX_NEW
GW_CAPACITY = 1040
#: the shared KV budget of the budget check, in slots of the larger tenant
GW_BUDGET_SLOTS = 3
#: the injected step time of the reschedule check, over the tenant's floor
GW_INJECTED = 3.0
FLEET_TRACE = "bursty:base=150,burst=1200,n=10000,tenants=100,seed=7"


def run_cli(main_fn, argv) -> tuple[int, str, float]:
    """``main_fn(argv)`` in this process, its standard output captured and
    printed indented; returns the exit code, the output and the seconds."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main_fn(argv)
        torch.cuda.synchronize()
    finally:                     # what it printed, even when it raised
        for line in buf.getvalue().splitlines():
            print(f"    {line}")
    return rc, buf.getvalue(), time.perf_counter() - t0


def drive_gateway(gw) -> dict:
    """Step ``gw`` until drained, on the engines' own wall-clock step
    times; the KV bytes in use after every step, each tenant's step times
    split by whether the step admitted (ran prefills) first, the monitors'
    highest ratio, and the gateway's wall ms per step."""
    kv, walls = [], []
    admit_ms = {n: [] for n in gw.engines}
    plain_ms = {n: [] for n in gw.engines}
    top_ratio = {n: 0.0 for n in gw.engines}
    events = len(gw.reschedules)
    while gw.has_work:
        before = {n: e.counters.admitted for n, e in gw.engines.items()}
        steps = {n: e.counters.steps for n, e in gw.engines.items()}
        t0 = time.perf_counter()
        rep = gw.step()
        walls.append((time.perf_counter() - t0) * 1e3)
        kv.append(rep.kv_bytes_in_use)
        for n, e in gw.engines.items():
            if e.counters.steps > steps[n]:
                (admit_ms if e.counters.admitted > before[n]
                 else plain_ms)[n].append(e.counters.last_step_ms)
            top_ratio[n] = max(top_ratio[n], gw.monitors[n].ratio)
    return dict(kv=kv, wall_ms=walls, admit_step_ms=admit_ms,
                plain_step_ms=plain_ms, top_ratio=top_ratio,
                reschedules=len(gw.reschedules) - events)


def profile_gateway(gw, prompts, steps: int = 4) -> dict:
    """``profile_steps`` over multiplexed gateway steps, every tenant
    decoding its ``prompts``; then drained."""
    for name, ps in prompts.items():
        for p in ps:
            gw.submit(name, p, max_new=MAX_NEW)
    gw.step()                                    # admit all, first decode
    gw.step()
    out = profile_steps(gw.step, steps)
    print(f"  profiled {steps} multiplexed steps: {out}")
    gw.run_until_drained()
    return out


def gateway_peak(gw) -> dict:
    """Both tenants' weights and caches, and the larger prefill's
    temporaries (the gateway prefills one request at a time)."""
    rows = [serve_peak(e.model.cfg, 4, GW_CAPACITY, PROMPT_LENS)
            for e in gw.engines.values()]
    held = sum(r["weights_bytes"] + r["cache_bytes"] for r in rows)
    run = held + max(r["activation_bytes"] for r in rows)
    build = max(r["build_bytes"] - r["weights_bytes"] for r in rows) + sum(
        r["weights_bytes"] for r in rows)
    return dict(run_bytes=run, peak_bytes=max(run, build))


def gateway(fa, da, dev, bundle_path: Path) -> dict:
    """Full-width stablelm-1.6b and llama3.2-3b served together through
    ``MultiTenantGateway`` on the card, planned on the reference's
    ``v5e-4x12-split``; each tenant's decode step its own CUDA graph."""
    from repro_torch import configs
    from repro_torch.core.accelerators import tpu_pod_split
    from repro_torch.kernels.graph import Graph
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import kvcache
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.gateway import (GatewayConfig, MultiTenantGateway,
                                           TenantSpec)

    free_card()             # what earlier phases left stays out of the peak
    specs = [TenantSpec(a, configs.get(a), max_slots=4, capacity=GW_CAPACITY,
                        max_new=MAX_NEW) for a in GW_ARCHS]
    gcfg = GatewayConfig(platform=tpu_pod_split(4, 12,
                                                name="v5e-4x12-split"))
    t0 = time.perf_counter()
    gw = MultiTenantGateway(specs, gcfg, device=dev)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    require(gw.scheduler.device.type == "cuda",
            f"the gateway planned on {gw.scheduler.device}")
    attn = {}
    for name, eng in gw.engines.items():
        cfg = eng.model.cfg
        attn[name] = sum(k in ("attn", "local") for k in cfg.layer_kinds)
        require(eng.device.type == "cuda", f"{name} runs on {eng.device}")
        require(isinstance(eng.graph.graph, Graph),
                f"{name}: the engine did not capture its step")
        require(eng.graph.graph.launches == {"decode_attention": attn[name]},
                f"{name}: launches per replay {eng.graph.graph.launches}")
        n_params = sum(p.numel() for p in eng.model.parameters())
        print(f"  {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, vocab "
              f"{cfg.vocab}, {n_params:,} parameters; launches per replay "
              f"{eng.graph.graph.launches}")
    print(f"  booted in {boot_s:.1f} s ({gw.scheduler.solves} solve, "
          f"{gw.plan.plan.solve_time_s:.3f} s):")
    for line in gw.plan.summary().splitlines():
        print(f"    {line}")
    prompts = {n: make_prompts(s.cfg.vocab) for n, s in gw.specs.items()}

    # 1. serve both tenants on the card's own step times
    for name, ps in prompts.items():
        for p in ps:
            gw.submit(name, p, max_new=MAX_NEW)
    fa.launches = da.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = drive_gateway(gw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    memory_row("gateway stablelm-1.6b + llama3.2-3b", gateway_peak(gw),
               torch.cuda.max_memory_allocated())
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    steps = {n: e.steps for n, e in gw.engines.items()}
    want = {"flash_attention": sum(attn[n] * len(prompts[n]) for n in attn),
            "decode_attention": sum(attn[n] * steps[n] for n in attn)}
    tokens = {n: engine_tokens(e) for n, e in gw.engines.items()}
    for name, got in tokens.items():
        require(len(got) == len(prompts[name])
                and all(len(t) == MAX_NEW for t in got.values()),
                f"{name}: {len(got)} requests served")
    print(f"  served {sum(map(len, tokens.values()))} requests in "
          f"{gw.total_steps} multiplexed steps ({steps}) in {wall:.3f} s; "
          f"launches {launches}, want {want}")
    require(launches == want, f"gateway launches {launches} != {want}")
    tenants = {}
    for name, eng in gw.engines.items():
        m = eng.metrics()
        tenants[name] = dict(
            mean_decode_step_ms=m["mean_step_ms"],
            admission_step_ms=run["admit_step_ms"][name],
            median_other_step_ms=statistics.median(
                run["plain_step_ms"][name]),
            top_monitor_ratio=run["top_ratio"][name])
        print(f"  {name}: mean decode step {m['mean_step_ms']:.3f} ms, "
              f"steps after an admission {run['admit_step_ms'][name]} ms, "
              f"median of the others "
              f"{tenants[name]['median_other_step_ms']:.3f} ms, monitor "
              f"ratio up to {run['top_ratio'][name]:.3f}")
    print(f"  multiplexed step wall: mean "
          f"{statistics.mean(run['wall_ms']):.3f} ms, median "
          f"{statistics.median(run['wall_ms']):.3f} ms; reschedules fired "
          f"by the card's own step times: {run['reschedules']} (threshold "
          f"{gcfg.slowdown_threshold})")

    # 2. each tenant alone: a standalone engine over the same model
    for name, eng in gw.engines.items():
        alone = ServingEngine(eng.model, max_slots=4, capacity=GW_CAPACITY)
        for p in prompts[name]:
            alone.submit(p, max_new=MAX_NEW)
        alone.run_until_drained()
        same = engine_tokens(alone) == tokens[name]
        tenants[name]["standalone_mean_decode_step_ms"] = (
            alone.counters.mean_step_ms)
        tenants[name]["tokens_equal_standalone"] = same
        print(f"  {name} alone: mean decode step "
              f"{alone.counters.mean_step_ms:.3f} ms, tokens "
              f"{'identical to' if same else 'DIFFERENT from'} the "
              f"gateway's")
        require(same, f"{name}: the gateway changed the greedy tokens")
        del alone
    torch.cuda.empty_cache()

    # 3. llama3.2-3b, kernel path against plain path (bf16)
    llama = gw.engines["llama3.2-3b"]
    views = [kvcache.select(c, 0) for c in llama.caches]
    llama_rel, llama_floor = [], []
    for p in prompts["llama3.2-3b"]:
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        g, w, r = (last_logits(llama.model, b, batch, views)
                   for b in ("cuda", "torch", "ref"))
        require(bool(torch.isfinite(g).all()), "non-finite llama logits")
        llama_rel.append(rel_err(g, w))
        llama_floor.append(rel_err(r, w))
        top_g, top_w = int(g.argmax()), int(w.argmax())
        gap = torch.topk(w.float(), 2).values
        print(f"  llama3.2-3b prefill S={len(p)}: kernel-vs-plain logits "
              f"rel err {llama_rel[-1]:.3e} (oracle-vs-plain "
              f"{llama_floor[-1]:.3e}), argmax {top_g} vs {top_w}, plain "
              f"top-2 gap {float(gap[0] - gap[1]) / float(w.std()):.4f} sd")
        require(top_g == top_w, f"llama S={len(p)}: argmax differs")
        require(llama_rel[-1] <= E2E_REL_TOL,
                f"llama S={len(p)}: rel err {llama_rel[-1]} > {E2E_REL_TOL}")
    llama_flash = prefill_flash(llama.model, batch, views)
    print(f"  llama3.2-3b prefill S={len(p)}, device ms: {llama_flash}")

    # 4. the shared KV budget: GW_BUDGET_SLOTS slots of the larger tenant
    budget = GW_BUDGET_SLOTS * max(s.kv_bytes_per_slot
                                   for s in gw.specs.values())
    gw.gcfg = dataclasses.replace(gw.gcfg, memory_budget_bytes=budget)
    done_before = {n: len(e.completed) for n, e in gw.engines.items()}
    deferred_before = gw.deferred_admissions
    for name, ps in prompts.items():
        for p in ps:
            gw.submit(name, p, max_new=MAX_NEW)
    budgeted = drive_gateway(gw)
    deferred = gw.deferred_admissions - deferred_before
    completed = {n: len(e.completed) - done_before[n]
                 for n, e in gw.engines.items()}
    print(f"  budget {budget:,} B ({GW_BUDGET_SLOTS} slots): "
          f"{len(budgeted['kv'])} steps, KV in use up to "
          f"{max(budgeted['kv']):,} B, {deferred} deferred admissions, "
          f"completed {completed}")
    require(max(budgeted["kv"]) <= budget, "the KV budget was exceeded")
    require(deferred > 0, "the budget deferred no admission")
    require(all(completed[n] == len(prompts[n]) for n in completed),
            f"requests lost under the budget: {completed}")
    gw.gcfg = dataclasses.replace(gw.gcfg, memory_budget_bytes=None)

    # 5. an injected slowdown re-schedules (§4.4): past the monitors'
    # warm-up, every step reported at GW_INJECTED x the tenant's floor
    # until one fires (a monitor that fired on the card's own steps holds
    # off for its cooldown first); long requests keep both tenants busy
    for name, ps in prompts.items():
        for p in ps:
            gw.submit(name, p[:8], max_new=2 * MAX_NEW)
    for _ in range(gcfg.warmup + 1):
        gw.step()
    events = len(gw.reschedules)
    injected = 0
    while (len(gw.reschedules) == events
           and injected < gcfg.cooldown + 2 * gcfg.patience):
        gw.step(observed_ms={n: GW_INJECTED * gw._floor_ms[n]
                             for n in gw.engines})
        injected += 1
    require(len(gw.reschedules) > events,
            f"{injected} injected steps at {GW_INJECTED}x the floor "
            f"re-scheduled nothing")
    ev = gw.reschedules[-1]
    print(f"  injected {GW_INJECTED}x the floor: re-scheduled after "
          f"{injected} steps ({ev})")
    require(ev.new_objective <= ev.old_objective + 1e-9,
            f"the re-schedule worsened the objective: {ev}")
    gw.run_until_drained()

    # 6. one multiplexed step profiled
    prof = profile_gateway(gw, prompts)
    result = dict(
        archs=list(GW_ARCHS), platform=gw.plan.platform.name,
        capacity=GW_CAPACITY, max_new=MAX_NEW,
        prompt_lens=list(PROMPT_LENS), boot_s=boot_s,
        plan=dict(request_hash=gw.plan.plan.request_hash,
                  solver=gw.plan.plan.solver,
                  objective=gw.plan.solution.objective,
                  round_robin_fps=gw.plan.round_robin.throughput_fps),
        launches=launches, steps=steps, multiplexed_steps=len(run["wall_ms"]),
        wall_s=wall, step_wall_ms_mean=statistics.mean(run["wall_ms"]),
        step_wall_ms_median=statistics.median(run["wall_ms"]),
        tenants=tenants, wall_clock_reschedules=run["reschedules"],
        slowdown_threshold=gcfg.slowdown_threshold,
        llama_logits_rel_err=llama_rel, llama_oracle_vs_plain=llama_floor,
        llama_prefill_flash=llama_flash,
        budget=dict(bytes=budget, slots=GW_BUDGET_SLOTS,
                    max_kv_in_use=max(budgeted["kv"]), deferred=deferred,
                    steps=len(budgeted["kv"]),
                    wall_clock_reschedules=budgeted["reschedules"]),
        injected=dict(factor=GW_INJECTED, steps=injected,
                      event=dataclasses.asdict(ev)),
        profile=prof)
    del gw, llama, views
    torch.cuda.empty_cache()

    # 7. float32 end to end on llama3.2-3b
    result["llama_e2e_f32"] = e2e_f32(dev, "llama3.2-3b")

    # 8. the launcher: a saved plan boots with zero solves; the plan on
    # the characterization's measured bundle
    with tempfile.TemporaryDirectory() as tmp:
        plan = str(Path(tmp) / "gw.json")
        co = ["--gateway", "--arch", GW_ARCHS[0], "--co-arch", GW_ARCHS[1]]
        argv = [*co, "--plan-only", "--save-plan", plan]
        print(f"  python -m repro_torch.launch.serve {' '.join(argv)}")
        rc, _, _ = run_cli(serve_main, argv)
        require(rc == 0, f"--plan-only exited {rc}")
        argv = [*co, "--plan", plan, "--requests", "2"]
        print(f"  python -m repro_torch.launch.serve {' '.join(argv)}")
        rc, out, cli_s = run_cli(serve_main, argv)
        require(rc == 0 and "with zero solver invocations" in out,
                f"--plan exited {rc} or solved afresh")
    torch.cuda.empty_cache()
    argv = [*co, "--plan-only", "--profile-bundle", str(bundle_path)]
    print(f"  python -m repro_torch.launch.serve {' '.join(argv)}")
    rc, out, _ = run_cli(serve_main, argv)
    result["launcher"] = dict(plan_boot_s=cli_s, bundle_rc=rc,
                              bundle_plan=out.splitlines())
    return result


def fleet(sd, se, bundle_path: Path) -> dict:
    """The README's fleet run with ``--solver anneal --evaluator torch``,
    its pool solved on the card: as written (the pod split's default
    proportional-share model, so only the select kernel is on its path),
    then priced under phase 8's measured PCCS surface (``--profile-bundle``:
    the slowdown kernel too), then that pool booted again from the sharded
    plan cache with ``--expect-cached``."""
    from repro_torch.core.plan import Plan
    from repro_torch.launch.serve import main as serve_main

    def read(out):
        head = re.search(r"n=(\d+) .*hash=(\w+)", out)
        solves = re.search(r"pool: \d+ plans, (\d+) solver", out)
        rep = re.search(r"requests=(\d+) completed=(\d+) shed=(\d+)", out)
        lat = re.search(r"p50=([\d.]+)ms p99=([\d.]+)ms "
                        r"sustained=([\d.]+) req/s", out)
        require(all((head, solves, rep, lat)), "unreadable fleet output")
        n, done, shed = map(int, rep.groups())
        require(done + shed == n == int(head.group(1)),
                f"the replay lost requests: {rep.group(0)}")
        return dict(trace_hash=head.group(2), solves=int(solves.group(1)),
                    requests=n, completed=done, shed=shed,
                    p50_ms=float(lat.group(1)), p99_ms=float(lat.group(2)),
                    sustained_rps=float(lat.group(3)))

    runs = {}
    bundle = ["--profile-bundle", str(bundle_path)]
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--fleet", "--arch", GW_ARCHS[0], "--co-arch", GW_ARCHS[1],
                "--trace", FLEET_TRACE, "--slo", "p99=400", "--solver",
                "anneal", "--evaluator", "torch", "--cache-root", tmp]
        for name, extra in (("readme", []), ("measured", bundle),
                            ("cached", [*bundle, "--expect-cached"])):
            print(f"  python -m repro_torch.launch.serve "
                  f"{' '.join(argv + extra)}")
            sd.launches = se.launches = 0
            seen = set(Path(tmp).glob("*/plan-*.json"))
            rc, out, wall = run_cli(serve_main, argv + extra)
            require(rc == 0, f"the fleet run {name} exited {rc}")
            plans = [Plan.load(f) for f in
                     set(Path(tmp).glob("*/plan-*.json")) - seen]
            runs[name] = dict(
                read(out), wall_s=wall,
                pool_solve_s=sum(p.solve_time_s for p in plans),
                pool_solvers=sorted({p.solver for p in plans}),
                launches={"piecewise_slowdown": sd.launches,
                          "anneal_select": se.launches})
            r = runs[name]
            print(f"  {name}: {r['solves']} solves in {r['pool_solve_s']:.2f}"
                  f" s by {r['pool_solvers']}, launches {r['launches']}; p50 "
                  f"{r['p50_ms']} ms, p99 {r['p99_ms']} ms, "
                  f"{r['sustained_rps']} req/s")
    readme, measured, cached = runs.values()
    for r in (readme, measured):
        require(r["solves"] == 3 and r["pool_solvers"] == ["anneal"],
                f"the pool was not solved by the anneal search: {r}")
    require(readme["launches"]["anneal_select"] > 0,
            f"the README pool's solves launched no select kernel: "
            f"{readme['launches']}")
    require(all(v > 0 for v in measured["launches"].values()),
            f"the measured pool's solves did not launch both search "
            f"kernels: {measured['launches']}")
    require(cached["solves"] == 0, "the cached boot solved afresh")
    require(len({r["trace_hash"] for r in runs.values()}) == 1,
            "the runs replayed different traces")
    return dict(argv=argv, trace=FLEET_TRACE, runs=runs)


# ---------------------------------------------------------------------------
# the mixture-of-experts models
# ---------------------------------------------------------------------------
#: the MoE models at full width, their depth cut by hand in PR 21 to what
#: one card holds beside the untied float32 token table and head (2 x
#: ~2.5 GB): a bf16 dbrx-132b layer is 6.5 GB, a qwen3-moe-235b-a22b layer
#: 5.0 GB.  Phase 13 now serves at the dry run's depth (``moe_layers``).
MOE_LAYERS_PR21 = {"dbrx-132b": 8, "qwen3-moe-235b-a22b": 10}
MOE_SLOTS, MOE_CAPACITY = 4, 2048


def moe_layers(capacity: int = MOE_CAPACITY) -> dict:
    """The deepest depth of each MoE model whose serving peak the dry run
    puts within one card, for phase 13's load (MOE_SLOTS slots of
    ``capacity``, prompts up to max(PROMPT_LENS) tokens)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun

    return {arch: dryrun.deepest_depth(
        configs.get(arch), lambda c: serve_peak(c, MOE_SLOTS, capacity,
                                                PROMPT_LENS)["peak_bytes"])
        for arch in MOE_LAYERS_PR21}


#: phase 13's depths, the dry run's (set by ``main``)
MOE_LAYERS = {}
#: the float32 end-to-end check's depth: a float32 layer is 13 / 10 GB
MOE_F32_LAYERS = 2
#: the block oracle: one float32 layer over a 513-token prefill at the
#: full configs' capacity factor 1.25, so experts drop tokens; the
#: reference's own block tolerance (tests/test_models.py::TestMoE)
MOE_ORACLE_T = 513
MOE_ORACLE_TOL = dict(atol=1e-5, rtol=1e-5)


def moe_routes(model, run):
    """``run()`` with every MoE block's input recorded; returns what it
    returned and, for each call in order, that block's routing: the
    chosen experts (T, k) ascending, the top-k margin (the k-th minus the
    (k+1)-th probability, (T,)) and the entries its capacity dropped."""
    from repro_torch.models import moe
    from repro_torch.models.layers import rmsnorm

    seen = []
    hooks = [layer.c.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for layer in model.layers if isinstance(layer.c, moe.MoE)]
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    routes = []
    for mod, x in seen:
        h = rmsnorm(x, mod.ln).to(mod.wi.dtype).reshape(-1, x.shape[-1])
        _, probs, _, experts = mod.route(h)
        k = experts.shape[1]
        top = probs.topk(k + 1, dim=-1).values
        keep = moe.dispatch(mod.cfg, experts)[3]
        routes.append(dict(experts=experts.sort(-1).values,
                           margin=top[:, k - 1] - top[:, k],
                           drops=int((~keep).sum())))
    return out, routes


def route_flips(a, b) -> int:
    """(layer, token) pairs whose top-k sets differ between two runs'
    routes."""
    return sum(int((ra["experts"] != rb["experts"]).any(-1).sum())
               for ra, rb in zip(a, b))


def pinned_logits(model, backend, batch, views, routes):
    """``last_logits`` with each MoE block's top-k experts taken, call by
    call, from ``routes`` (another run's ``moe_routes``).  Each block's
    router still computes its own probabilities, and its gates are those
    probabilities at the pinned experts, ordered and renormalised as
    ``MoE.route`` orders and renormalises its own top k; so no (token,
    layer) pair can flip, the drops are the pinned run's, and the logits
    move with the attention kernels' rounding only."""
    from repro_torch.models import moe

    blocks = [layer.c for layer in model.layers
              if isinstance(layer.c, moe.MoE)]
    require(len(routes) == len(blocks),
            f"{len(routes)} routes for {len(blocks)} MoE blocks")
    pins = iter(rt["experts"] for rt in routes)

    def pinned(mod):
        def route(h):
            logits, probs, _, _ = moe.MoE.route(mod, h)
            experts = next(pins)
            gates, order = probs.gather(-1, experts).sort(
                dim=-1, descending=True, stable=True)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            return logits, probs, gates, experts.gather(-1, order)
        return route

    for mod in blocks:
        mod.route = pinned(mod)
    try:
        out = last_logits(model, backend, batch, views)
    finally:
        for mod in blocks:
            del mod.route
    require(next(pins, None) is None, "a pinned route was not used")
    return out


def free_card() -> None:
    """Free what the last model left on the card: an eager engine's step
    function and its step object refer to each other, so a dead engine's
    caches and the model it holds wait for the cycle collector; a MoE
    model takes most of the card."""
    gc.collect()
    torch.cuda.empty_cache()


def build_moe(arch, layers, dev, dtype="bfloat16"):
    """Full-width ``arch`` cut to ``layers`` layers, seeded random weights
    on the card; returns the model and the cut as ``reduced``."""
    from repro_torch import configs
    from repro_torch.models import build

    full = configs.get(arch)
    cfg = dataclasses.replace(full, n_layers=layers, dtype=dtype,
                              kv_cache_dtype=dtype)
    t0 = time.perf_counter()
    model = build(cfg, backend="auto", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"  built {cfg.name} ({dtype}): {layers} of {full.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k}, {n:,} parameters in "
          f"{time.perf_counter() - t0:.1f} s")
    return model, {"n_layers": f"{layers} of {full.n_layers}"}


def serve_moe(arch, mods, dev) -> dict:
    """Serve full-width ``arch``, depth cut to MOE_LAYERS, through
    ``ServingEngine`` with graph steps: every request its MAX_NEW tokens,
    exact flash and decode launches, an eager engine's tokens.

    Then each prompt's prefill through the kernels against the plain path
    in bf16.  Unpinned, router flips are common: bf16 rounding of the
    attention output moves the hidden state ~1e-2, router logits are
    ~N(0, 1), and 4-22% of (token, layer) pairs lie that close to the
    k-th/(k+1)-th boundary; a flip changes the token's experts and,
    through capacity, other tokens' drops, and moves every later token
    through attention (an 8-token dbrx-132b prompt with 3 flips at other
    tokens moved the last token's logits 3.75e-2 and its argmax).  So
    each prompt is held with the plain path's experts pinned in every
    layer (``pinned_logits``), on the kernel path and on the oracle path
    alike: same argmax as the plain path, and E2E_REL_TOL or FLOOR_MARGIN
    x the pinned oracle-vs-plain floor, phase 9's rule, for every prompt.
    The plain path pinned to its own experts must give its own logits
    bit for bit, which shows the pin changes nothing but the choice.  The
    unpinned error, flips, drops on each path and smallest top-k margin
    are reported only."""
    from repro_torch.kernels.graph import Graph
    from repro_torch.models import kvcache
    from repro_torch.serve.engine import ServingEngine

    fa, da = mods["flash_attention"], mods["decode_attention"]
    free_card()             # what earlier phases left stays out of the peak
    model, reduced = build_moe(arch, MOE_LAYERS[arch], dev)
    cfg = model.cfg
    eng = ServingEngine(model, max_slots=MOE_SLOTS, capacity=MOE_CAPACITY)
    require(isinstance(eng.graph.graph, Graph),
            "the engine did not capture its step")
    prompts = make_prompts(cfg.vocab)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    peak = torch.cuda.max_memory_allocated()
    memory_row(f"serve {arch} ({cfg.n_layers} layers)",
               serve_peak(cfg, MOE_SLOTS, MOE_CAPACITY, PROMPT_LENS), peak)
    require(len(done) == len(prompts), f"served {len(done)}/{len(prompts)}")
    for r in done:
        require(len(r.tokens) == MAX_NEW,
                f"request {r.rid} got {len(r.tokens)} tokens, not {MAX_NEW}")
    m = eng.metrics()
    L = cfg.n_layers
    want = {"flash_attention": L * m["admitted"],
            "decode_attention": L * m["steps"]}
    print(f"  served {len(done)} requests, {m['tokens_out']} tokens, "
          f"{m['admitted']} prefills, {m['steps']} decode steps in "
          f"{wall:.3f} s, mean step {m['mean_step_ms']:.3f} ms (CUDA graph, "
          f"launches per replay {eng.graph.graph.launches}); launches "
          f"{launches}")
    require(launches == want, f"launches {launches} != {want} ({L} layers "
            f"x prefills/steps)")
    graph_tokens = engine_tokens(eng)

    views = [kvcache.select(c, 0) for c in eng.caches]
    prompts_out = []
    for p in prompts:
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        out, routes = {}, {}
        for b in ("cuda", "torch", "ref"):
            out[b], routes[b] = moe_routes(
                model, lambda b=b: last_logits(model, b, batch, views))
        pin = {b: pinned_logits(model, b, batch, views, routes["torch"])
               for b in ("cuda", "torch", "ref")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(batch, cache_out=views)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        profiled = profile_prefill(model, batch, views, "flash")
        g, w, r = pin["cuda"], out["torch"], pin["ref"]
        require(bool(torch.isfinite(g).all()), "non-finite prefill logits")
        require(torch.equal(pin["torch"], w), f"S={len(p)}: the plain "
                f"path pinned to its own experts changed its logits")
        flips = route_flips(routes["cuda"], routes["torch"])
        oracle_flips = route_flips(routes["ref"], routes["torch"])
        rel, floor = rel_err(g, w), rel_err(r, w)
        limit = max(E2E_REL_TOL, FLOOR_MARGIN * floor)
        top_g, top_w = int(g.argmax()), int(w.argmax())
        two = torch.topk(w.float(), 2).values
        row = dict(
            prompt_len=len(p), rel_err=rel, oracle_vs_plain_rel_err=floor,
            limit=limit, argmax=[top_g, top_w, int(r.argmax())],
            plain_top2_gap_sd=float((two[0] - two[1]) / w.float().std()),
            unpinned_rel_err=rel_err(out["cuda"], w),
            unpinned_oracle_vs_plain_rel_err=rel_err(out["ref"], w),
            unpinned_argmax=[int(out["cuda"].argmax()),
                             int(out["ref"].argmax())],
            router_flips=flips, oracle_router_flips=oracle_flips,
            drops={b: [rt["drops"] for rt in routes[b]] for b in routes},
            min_margin=min(float(rt["margin"].min())
                           for rt in routes["torch"]),
            prefill_ms=prefill_ms, prefill_device=profiled)
        print(f"  prefill S={len(p)}, routing pinned to the plain path's: "
              f"kernel-vs-plain logits rel err {rel:.3e} (oracle-vs-plain "
              f"{floor:.3e}, limit {limit:.3e}), argmax {top_g} vs {top_w} "
              f"(oracle {row['argmax'][2]}; plain top-2 gap "
              f"{row['plain_top2_gap_sd']:.4f} sd); unpinned: rel err "
              f"{row['unpinned_rel_err']:.3e} (oracle-vs-plain "
              f"{row['unpinned_oracle_vs_plain_rel_err']:.3e}), argmax "
              f"{row['unpinned_argmax']}, router flips {flips} of "
              f"{len(p) * L} (oracle vs plain {oracle_flips}), drops "
              f"{row['drops']}, smallest top-k margin "
              f"{row['min_margin']:.3e}; {prefill_ms:.2f} ms; profiled: "
              f"{profiled}")
        require(top_g == top_w, f"S={len(p)}: argmax differs")
        require(rel <= limit, f"S={len(p)}: rel err {rel} > {limit}")
        prompts_out.append(row)
    flash_e2e = prefill_flash(model, batch, views)
    print(f"  prefill S={len(p)}, device ms: {flash_e2e}")

    result = dict(arch=arch, reduced=reduced, requests=len(done),
                  max_new=MAX_NEW, prompt_lens=list(PROMPT_LENS),
                  capacity=MOE_CAPACITY, launches=launches,
                  prefills=m["admitted"],
                  decode_steps=m["steps"], tokens_out=m["tokens_out"],
                  wall_s=wall, mean_decode_step_ms=m["mean_step_ms"],
                  max_memory_allocated=peak,
                  graph_launches_per_replay=eng.graph.graph.launches,
                  prompts=prompts_out, prefill_flash=flash_e2e,
                  profile=profile_decode(eng, prompts))
    del eng
    result["eager"] = eager_comparison(model, prompts, 2048, graph_tokens)
    del model
    free_card()
    return result


def moe_block_oracle(arch, dev) -> dict:
    """One full-width float32 MoE block of ``arch`` over MOE_ORACLE_T
    tokens at capacity factor 1.25 against a per-expert oracle.

    The MoE code is the same on the kernel path and the plain path, so
    the kernel-vs-plain checks do not test it; this does.  The oracle
    takes the block's router logits, routes on the host in float64 (top-k
    with the lower expert first on ties, renormalised gates, each expert
    keeping its first ``cap`` tokens in token order), then runs each
    expert's kept tokens through that expert's weights as plain matmuls
    and adds the gated outputs.  The block's output must agree within
    MOE_ORACLE_TOL and its dropped count must equal the oracle's; the
    oracle with one expert's combine weight zeroed (the busiest) must
    move its tokens' expert output by FAULT_MIN_REL or more, and the same
    comparison must reject the block's output against it."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.layers import rmsnorm

    cfg = dataclasses.replace(configs.get(arch), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    require(cfg.act == "swiglu", f"{arch}: the oracle computes swiglu")
    E, k, T, d = cfg.moe.n_experts, cfg.moe.top_k, MOE_ORACLE_T, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(1)
    block = moe.MoE(cfg, dev)
    with torch.no_grad():
        block.init(gen)
        block.ln.copy_(0.1 * torch.randn(d, generator=gen, device=dev))
        # tokens sharing a component, as a prompt's do: the router then
        # favours some experts, which overflow their capacity
        x = (torch.randn(d, generator=gen, device=dev)
             + torch.randn(1, T, d, generator=gen, device=dev))
        y, _ = block(x)
        h = rmsnorm(x, block.ln).reshape(T, d)
        logits, _, _, experts = block.route(h)
        drops = int((~moe.dispatch(cfg, experts)[3]).sum())
    cap = moe.capacity(cfg, T)

    lg = logits.double().cpu().numpy()
    probs = np.exp(lg - lg.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    choice = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gate = np.take_along_axis(probs, choice, -1)
    gate /= np.maximum(gate.sum(-1, keepdims=True), 1e-9)
    srt = -np.sort(-probs, axis=-1)
    margin = float((srt[:, k - 1] - srt[:, k]).min())
    kept = {e: [] for e in range(E)}
    oracle_drops = 0
    for t in range(T):
        for j in range(k):
            e = int(choice[t, j])
            if len(kept[e]) < cap:
                kept[e].append((t, float(gate[t, j])))
            else:
                oracle_drops += 1

    def oracle(zero=None):
        out = torch.zeros(T, d, device=dev)
        with torch.no_grad():
            for e in range(E):
                if not kept[e]:
                    continue
                idx = torch.tensor([t for t, _ in kept[e]], device=dev)
                g = torch.tensor([0.0 if e == zero else w
                                  for _, w in kept[e]], device=dev)
                he = h[idx]
                a = torch.nn.functional.silu(he @ block.wi_gate[e]) * (
                    he @ block.wi[e])
                out.index_add_(0, idx, g[:, None] * (a @ block.wo[e]))
        return out

    want = oracle()
    err = compare(f"moe block {arch} f32 T{T} cap {cap} vs per-expert "
                  f"oracle", y[0], x[0] + want, torch.float32, MOE_ORACLE_TOL)
    busiest = max(kept, key=lambda e: len(kept[e]))
    rows = torch.tensor([t for t, _ in kept[busiest]], device=dev)
    faulty = oracle(busiest)
    moved = rel_err(faulty[rows], want[rows])
    caught = not within(y[0], x[0] + faulty, MOE_ORACLE_TOL)[0]
    print(f"  {arch}: {drops} of {T * k} entries dropped (oracle "
          f"{oracle_drops}), smallest top-k margin {margin:.3e}; expert "
          f"{busiest}'s combine weight zeroed moves its {len(rows)} tokens' "
          f"expert output by rel {moved:.3e} (must be >= {FAULT_MIN_REL:g}), "
          f"and the comparison above rejects the block against it: "
          f"{caught}")
    require(drops == oracle_drops > 0,
            f"{arch}: dropped {drops}, the oracle {oracle_drops}")
    require(moved >= FAULT_MIN_REL, f"{arch}: the planted fault moved the "
            f"output by only {moved}")
    require(caught, f"{arch}: the block's output passes against the "
            f"faulty oracle")
    del block
    free_card()
    return dict(tokens=T, capacity=cap, max_abs_err=err, drops=drops,
                oracle_drops=oracle_drops, fault_expert=busiest,
                fault_rel=moved, fault_caught=caught, min_margin=margin)


def e2e_f32_moe(arch, dev) -> dict:
    """Kernel path against plain path, float32 end to end, on full-width
    ``arch`` cut to MOE_F32_LAYERS layers: each prompt's prefill logits
    (<= E2E_F32_REL_TOL, same argmax), with the router flips between the
    two paths and the smallest top-k margin reported."""
    from repro_torch.kernels import flash_attention as fa

    model, reduced = build_moe(arch, MOE_F32_LAYERS, dev, "float32")
    rels, same, flips, margins = [], [], [], []
    before = fa.launches
    for p in make_prompts(model.cfg.vocab):
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        g, rg = moe_routes(model, lambda: last_logits(model, "cuda", batch,
                                                      None))
        w, rw = moe_routes(model, lambda: last_logits(model, "torch", batch,
                                                      None))
        require(bool(torch.isfinite(g).all()), "non-finite f32 logits")
        rels.append(rel_err(g, w))
        same.append(int(g.argmax()) == int(w.argmax()))
        flips.append(route_flips(rg, rw))
        margins.append(min(float(rt["margin"].min()) for rt in rw))
        print(f"  f32 {arch} prefill S={len(p)}: kernel-vs-plain logits rel "
              f"err {rels[-1]:.3e}, same argmax {same[-1]}, router flips "
              f"{flips[-1]}, smallest top-k margin {margins[-1]:.3e}")
    flash = f32_flash(model.cfg, before, len(rels))
    del model
    free_card()
    require(all(same), f"f32 {arch}: argmax differs")
    require(max(rels) <= E2E_F32_REL_TOL,
            f"f32 {arch}: rel err {max(rels)} > {E2E_F32_REL_TOL}")
    return dict(reduced=reduced, prompt_lens=list(PROMPT_LENS),
                logits_rel_err=rels, router_flips=flips, min_margin=margins,
                flash=flash)


# ---------------------------------------------------------------------------
# the four configurations no earlier phase ran: qwen1.5-32b (int8 KV
# cache), nemotron-4-15b, internvl2-2b served; hubert-xlarge's encoder
# ---------------------------------------------------------------------------
#: the decoder models phase 20 serves at published widths
SLICE_ARCHS = ("qwen1.5-32b", "nemotron-4-15b", "internvl2-2b")
ENCODER_ARCH = "hubert-xlarge"
#: the float32 end-to-end cuts' depth
SLICE_F32_LAYERS = 2
#: internvl2-2b's prefix prefill: text positions follow the 1024 patches
VLM_PROMPT = 1100
#: hubert-xlarge's frames (B 1)
ENCODER_FRAMES = 1000


def slice_depth(cfg, slots=4, capacity=2048, lens=PROMPT_LENS) -> int:
    """The deepest depth of ``cfg`` whose serving peak the dry run puts
    within one card at phase 20's load, at most its own depth."""
    from repro_torch.launch import dryrun

    return min(cfg.n_layers, dryrun.deepest_depth(
        cfg, lambda c: serve_peak(c, slots, capacity, lens)["peak_bytes"]))


def build_dense(cfg, dev, backend="auto"):
    """``cfg`` with seeded random weights on the card, each weight drawn
    in float32 one at a time and stored in the dtype it is used in (no
    whole-model float32 copy)."""
    from repro_torch.models import build

    t0 = time.perf_counter()
    model = build(cfg, backend=backend, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  built {cfg.name} ({cfg.dtype}, {cfg.kv_cache_dtype} cache): "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.d_head}, {cfg.act}, "
          f"{sum(p.numel() for p in model.parameters()):,} parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, in "
          f"{time.perf_counter() - t0:.1f} s")
    return model


def served_verdict(label, g, w, r) -> dict:
    """One bf16 prefill's kernel-path logits ``g`` against the plain
    path's ``w``: E2E_REL_TOL and the same argmax; where that fails and
    the oracle ``r`` errs as much against the plain path (rounding
    through the layers, not a kernel), phase 9's ``argmax_verdict`` with
    the oracle as the correct path.  Fatal unless one of them passes."""
    require(bool(torch.isfinite(g).all()), f"{label}: non-finite logits")
    rel, floor = rel_err(g, w), rel_err(r, w)
    same = int(g.argmax()) == int(w.argmax())
    v = argmax_verdict(g, w, {"oracle": r})
    strict = same and rel <= E2E_REL_TOL
    row = dict(rel_err=rel, oracle_vs_plain_rel_err=floor,
               argmax=[int(g.argmax()), int(w.argmax()), int(r.argmax())],
               strict_ok=strict,
               judged_by="E2E_REL_TOL" if strict else "argmax_verdict",
               verdict=v)
    print(f"  {label}: kernel-vs-plain logits rel err {rel:.3e} "
          f"(oracle-vs-plain {floor:.3e}), argmax {row['argmax'][0]} vs "
          f"{row['argmax'][1]} (oracle {row['argmax'][2]}): "
          + ("ok" if strict else
             f"past {E2E_REL_TOL:g} or argmax, so phase 9's verdict: "
             f"{verdict_line(v)}"))
    require(strict or v["ok"], f"{label}: kernel path refused ({rel})")
    return row


def int8_cache_check(model, batch, views) -> dict:
    """After a prefill into the int8 cache ``views``, each layer's
    dequantized k and v rows against the prompt's unquantized k and v
    (the attention block's own output, caught by a hook and compared
    once the layer's cache is written): within the quantization's bound,
    |x|max / 254 per row (x / scale rounds to the nearest of 255 levels
    of step |x|max / 127), plus the bf16 rounding of the dequantized
    value (2^-8 of it: bf16 keeps 8 significant bits).  Fatal."""
    from repro_torch.models import kvcache

    held, worst, n = {}, [], len(model.layers)

    def grab(i):
        def hook(mod, args, out):
            held[i] = out[1]
        return hook

    def check(i):
        k, v = held.pop(i)
        for name, x in (("k", k), ("v", v)):
            S = x.shape[1]
            lay = views[i][name]
            got = kvcache.dequant({"data": lay["data"][:, :S],
                                   "scale": lay["scale"][:, :S]}).float()
            xf = x.float()
            limit = (xf.abs().amax(-1, keepdim=True) / 254 * (1 + 1e-4)
                     + got.abs() * 2.0 ** -8 * (1 + 2.0 ** -7))
            over = float(((got - xf).abs() / limit).max())
            worst.append(over)

    hooks = [layer.t.register_forward_hook(grab(i))
             for i, layer in enumerate(model.layers)]
    hooks += [model.layers[i].register_forward_pre_hook(
        lambda mod, args, i=i: check(i - 1)) for i in range(1, n)]
    try:
        model.prefill(batch, cache_out=views)
        check(n - 1)
    finally:
        for h in hooks:
            h.remove()
    got = dict(layers=n, tokens=int(batch["token_ids"].shape[1]),
               worst_err_over_bound=max(worst))
    print(f"  int8 cache after a {got['tokens']}-token prefill, {n} layers "
          f"x k, v: largest |dequantized - unquantized| is "
          f"{got['worst_err_over_bound']:.4f} of its bound (|x|max / 254 "
          f"per row + the bf16 rounding)")
    require(got["worst_err_over_bound"] <= 1.0,
            f"the int8 cache is off its quantization bound: {got}")
    return got


def dequant_ms(model, eng) -> dict:
    """The int8 cache's dequantization in one decode step, stepped eagerly
    over the engine's caches (slots as they stand) under the profiler
    with ``kvcache.dequant`` in a ``kv_dequant`` range: the device ms of
    the kernels under that range beside the step's.  A finding, not a
    check."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import kvcache

    plain = kvcache.dequant
    calls = []

    def ranged(layer):
        calls.append(1)
        with record_function("kv_dequant"):
            return plain(layer)

    batch = {"token_ids": torch.as_tensor(eng.last_tok[:, None],
                                          device=eng.device),
             "lengths": torch.as_tensor(eng.lengths, device=eng.device)}
    with swapped(kvcache, "dequant", ranged):
        model.decode_step(eng.caches, batch)             # warm
        torch.cuda.synchronize()
        calls.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(eng.caches, batch)
            torch.cuda.synchronize()
    ms = sum(getattr(e, "device_time_total", 0) for e in prof.events()
             if e.name == "kv_dequant" and e.device_type.name == "CPU") / 1e3
    kernels, _ = device_ms_by_kernel(prof)
    out = dict(calls=len(calls), dequant_ms=ms if ms > 0 else "not measured",
               eager_step_device_ms=sum(kernels.values()))
    print(f"  int8 dequantization in one eager decode step: {len(calls)} "
          f"calls, {out['dequant_ms'] if ms == 0 else f'{ms:.3f} ms'} of "
          f"device time (the profiler's kv_dequant range), of the step's "
          f"{out['eager_step_device_ms']:.3f} device ms")
    return out


def vlm_batch(cfg, dev, dtype=torch.bfloat16) -> dict:
    """internvl2-2b's prefix prefill: VLM_PROMPT seeded tokens and seeded
    ``mm_embeds`` (1 x mm_prefix x mm_embed_dim) for its first positions."""
    import numpy as np

    gen = torch.Generator(device=dev).manual_seed(5)
    ids = np.random.default_rng(5).integers(0, cfg.vocab, VLM_PROMPT)
    return {"token_ids": torch.as_tensor(ids[None], device=dev),
            "mm_embeds": torch.randn(1, cfg.mm_prefix, cfg.mm_embed_dim,
                                     generator=gen, device=dev).to(dtype)}


def vlm_prefix(model, views, dev) -> dict:
    """internvl2-2b's patch prefix: one VLM_PROMPT-token prefill with
    ``vlm_batch``'s patch embeddings through the kernels against the
    plain path (``served_verdict``: E2E_REL_TOL and the same argmax, or
    phase 9's verdict where the oracle path errs as far; one flash launch
    a layer), then with ``mm_proj`` zeroed the logits must move by
    FAULT_MIN_REL or more (the prefix reaches the output).  The float32
    cut holds the same prefill to E2E_F32_REL_TOL (``e2e_f32_dense``)."""
    from repro_torch.kernels import flash_attention as fa

    cfg = model.cfg
    batch = vlm_batch(cfg, dev)
    before = fa.launches
    g = last_logits(model, "cuda", batch, views)
    launches = fa.launches - before
    w = last_logits(model, "torch", batch, views)
    r = last_logits(model, "ref", batch, views)
    row = served_verdict(f"prefix prefill S={VLM_PROMPT} (mm_embeds 1 x "
                         f"{cfg.mm_prefix} x {cfg.mm_embed_dim} in the "
                         f"first {cfg.mm_prefix} positions)", g, w, r)
    saved = model.emb.mm_proj.detach().clone()
    with torch.no_grad():
        model.emb.mm_proj.zero_()
    try:
        zeroed = last_logits(model, "cuda", batch, views)
    finally:
        with torch.no_grad():
            model.emb.mm_proj.copy_(saved)
    moved = rel_err(zeroed, g)
    out = dict(prompt_len=VLM_PROMPT, mm_prefix=cfg.mm_prefix, **row,
               flash_launches=launches, zeroed_mm_proj_rel=moved)
    print(f"  prefix prefill: {launches} flash launches; mm_proj zeroed "
          f"moves the logits by rel {moved:.3e} (must be >= "
          f"{FAULT_MIN_REL:g})")
    require(launches == cfg.n_layers, f"prefix prefill: {launches} flash "
            f"launches, not {cfg.n_layers}")
    require(moved >= FAULT_MIN_REL, f"zeroing mm_proj moved the logits by "
            f"only {moved}: the prefix does not reach the output")
    return out


def serve_dense(arch, mods, dev) -> dict:
    """Serve full-width ``arch`` (at the dry run's deepest depth for 4
    slots of 2048, its own unless that does not fit) through
    ``ServingEngine`` with graph steps, as phase 4 serves stablelm-1.6b:
    every request its MAX_NEW tokens, exact flash and decode launches,
    the run's peak against the dry run's, each prompt's bf16 prefill
    through the kernels against the plain path in the engine's slot-0
    cache views (``served_verdict``), the 1000-token prefill's device ms,
    the graph step's ms and busy share; qwen1.5-32b's int8 cache held to
    its quantization bound and its dequantization's ms a step;
    internvl2-2b's patch prefix (``vlm_prefix``); an eager engine's tokens
    where a second engine fits beside the first (not qwen1.5-32b's)."""
    from repro_torch import configs
    from repro_torch.kernels.graph import Graph
    from repro_torch.models import kvcache
    from repro_torch.serve.engine import ServingEngine

    fa, da = mods["flash_attention"], mods["decode_attention"]
    free_card()             # what earlier phases left stays out of the peak
    full = configs.get(arch)
    depth = slice_depth(full)
    require(depth >= 1, f"{arch}: the dry run fits no layer")
    cfg = dataclasses.replace(full, n_layers=depth)
    held = torch.cuda.memory_allocated()
    print(f"  {arch}: the dry run's deepest depth for 4 slots of 2048 is "
          f"{depth} of {full.n_layers} layers; this process holds "
          f"{held / 1e9:.3f} GB before the build (in the peak below)")
    model = build_dense(cfg, dev)
    eng = ServingEngine(model, max_slots=4, capacity=2048)
    require(isinstance(eng.graph.graph, Graph),
            "the engine did not capture its step")
    prompts = make_prompts(cfg.vocab)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    peak = torch.cuda.max_memory_allocated()
    mem = memory_row(f"serve {arch} ({depth} layers)",
                     serve_peak(cfg, 4, 2048, PROMPT_LENS), peak)
    require(len(done) == len(prompts), f"served {len(done)}/{len(prompts)}")
    for r in done:
        require(len(r.tokens) == MAX_NEW,
                f"request {r.rid} got {len(r.tokens)} tokens, not {MAX_NEW}")
    m = eng.metrics()
    want = {"flash_attention": depth * m["admitted"],
            "decode_attention": depth * m["steps"]}
    print(f"  served {len(done)} requests, {m['tokens_out']} tokens, "
          f"{m['admitted']} prefills, {m['steps']} decode steps in "
          f"{wall:.3f} s, mean step {m['mean_step_ms']:.3f} ms (CUDA graph, "
          f"launches per replay {eng.graph.graph.launches}); launches "
          f"{launches}")
    require(launches == want, f"launches {launches} != {want} ({depth} "
            f"layers x prefills/steps)")
    graph_tokens = engine_tokens(eng)

    views = [kvcache.select(c, 0) for c in eng.caches]
    rows, prefill_ms = [], []
    for p in prompts:
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        out = {b: last_logits(model, b, batch, views)
               for b in ("cuda", "torch", "ref")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(batch, cache_out=views)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(served_verdict(f"prefill S={len(p)}", out["cuda"],
                                   out["torch"], out["ref"]))
    flash_e2e = prefill_flash(model, batch, views)
    print(f"  prefill S={len(prompts[-1])}: {prefill_ms[-1]:.2f} ms wall, "
          f"device ms {flash_e2e}")
    result = dict(arch=arch, n_layers=f"{depth} of {full.n_layers}",
                  kv_cache_dtype=cfg.kv_cache_dtype, requests=len(done),
                  max_new=MAX_NEW, prompt_lens=list(PROMPT_LENS),
                  capacity=2048, launches=launches, prefills=m["admitted"],
                  decode_steps=m["steps"], tokens_out=m["tokens_out"],
                  wall_s=wall, mean_decode_step_ms=m["mean_step_ms"],
                  prefill_ms=prefill_ms, prompts=rows,
                  prefill_flash=flash_e2e, memory=mem,
                  held_before_build=held,
                  graph_launches_per_replay=eng.graph.graph.launches)
    if cfg.kv_cache_dtype == "int8":
        result["int8_cache"] = int8_cache_check(model, batch, views)
    if cfg.mm_prefix:
        result["prefix"] = vlm_prefix(model, views, dev)
    result["profile"] = profile_decode(eng, prompts)
    if cfg.kv_cache_dtype == "int8":
        result["int8_cache"]["dequant"] = dequant_ms(model, eng)
    del eng, views
    free_card()
    if cfg.kv_cache_dtype == "int8":
        result["eager"] = ("not run: a second engine's cache does not fit "
                           "beside the first")
        print(f"  eager engine: {result['eager']}")
    else:
        result["eager"] = eager_comparison(model, prompts, 2048,
                                           graph_tokens)
    del model
    free_card()
    return result


def e2e_f32_dense(arch, dev) -> dict:
    """Kernel path against plain path, float32 end to end, on full-width
    ``arch`` cut to SLICE_F32_LAYERS layers with a float32 KV cache (for
    qwen1.5-32b in place of its int8 one, whose rounding is not a
    kernel's): each prompt's prefill logits (and internvl2-2b's prefix
    prefill, ``vlm_batch``), and prefill(n) plus one decode step through
    the kernels against prefill(n + 1), each within E2E_F32_REL_TOL with
    the same argmax; one flash launch a layer a kernel-path prefill."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa

    full = configs.get(arch)
    cfg = dataclasses.replace(full, n_layers=SLICE_F32_LAYERS,
                              dtype="float32", kv_cache_dtype="float32")
    if full.kv_cache_dtype != "float32":
        print(f"  f32 {arch}: the cut's KV cache is float32 (the served "
              f"model's is {full.kv_cache_dtype})")
    model = build_dense(cfg, dev, backend="cuda")
    rels, same, step_rels, step_same = [], [], [], []
    prompts = make_prompts(cfg.vocab)
    before = fa.launches
    for p in prompts:
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        g = last_logits(model, "cuda", batch, None)
        w = last_logits(model, "torch", batch, None)
        require(bool(torch.isfinite(g).all()), "non-finite f32 logits")
        rels.append(rel_err(g, w))
        same.append(int(g.argmax()) == int(w.argmax()))
        print(f"  f32 {arch} ({SLICE_F32_LAYERS} layers) prefill S={len(p)}: "
              f"kernel-vs-plain logits rel err {rels[-1]:.3e}, same argmax "
              f"{same[-1]}")
    flash = f32_flash(cfg, before, len(prompts))
    prefix = None
    if cfg.mm_prefix:
        batch = vlm_batch(cfg, dev, torch.float32)
        launched = fa.launches
        g = last_logits(model, "cuda", batch, None)
        launched = fa.launches - launched
        w = last_logits(model, "torch", batch, None)
        prefix = dict(rel_err=rel_err(g, w),
                      same_argmax=int(g.argmax()) == int(w.argmax()),
                      flash_launches=launched)
        require(launched == cfg.n_layers, f"f32 prefix prefill: {launched} "
                f"flash launches, not {cfg.n_layers}")
        rels.append(prefix["rel_err"])
        same.append(prefix["same_argmax"])
        print(f"  f32 {arch} ({SLICE_F32_LAYERS} layers) prefix prefill "
              f"S={VLM_PROMPT}: kernel-vs-plain logits rel err "
              f"{prefix['rel_err']:.3e}, same argmax {prefix['same_argmax']}")
    model.backend = "cuda"
    for p in prompts:
        n = len(p) - 1
        want = model.prefill({"token_ids": torch.as_tensor(
            p[None], device=dev)})[0][0, -1]
        _, caches = model.prefill(
            {"token_ids": torch.as_tensor(p[None, :n], device=dev)},
            capacity=len(p) + 8)
        step, _ = model.decode_step(caches, {
            "token_ids": torch.as_tensor(p[None, n:], device=dev),
            "lengths": torch.tensor([n], dtype=torch.int32, device=dev)})
        step_rels.append(rel_err(step[0, -1], want))
        step_same.append(int(step[0, -1].argmax()) == int(want.argmax()))
        print(f"  f32 {arch} prefill({n}) + decode vs prefill({n + 1}): rel "
              f"err {step_rels[-1]:.3e}, same argmax {step_same[-1]}")
    del model, caches
    free_card()
    require(all(same) and all(step_same), f"f32 {arch}: argmax differs")
    require(max(rels) <= E2E_F32_REL_TOL,
            f"f32 {arch}: rel err {max(rels)} > {E2E_F32_REL_TOL}")
    require(max(step_rels) <= E2E_F32_REL_TOL,
            f"f32 {arch}: prefill+decode rel err {max(step_rels)} > "
            f"{E2E_F32_REL_TOL}")
    return dict(n_layers=f"{SLICE_F32_LAYERS} of {full.n_layers}",
                kv_cache_dtype="float32", prompt_lens=list(PROMPT_LENS),
                logits_rel_err=rels, prefill_decode_rel_err=step_rels,
                flash=flash, prefix=prefix)


def encoder(mods, dev) -> dict:
    """hubert-xlarge's encoder at full width and depth on seeded frame
    embeddings (B 1, ENCODER_FRAMES frames), bidirectional: one flash
    launch a layer on the kernel path (``flash_sm90`` at head size 80, by
    the profiler), the whole output against the plain path within
    E2E_REL_TOL (the share of frames whose argmax differs reported), the
    run's peak against the dry run's; then float32 at SLICE_F32_LAYERS
    layers within E2E_F32_REL_TOL with every frame's argmax the same."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs

    fa = mods["flash_attention"]
    free_card()
    cfg = configs.get(ENCODER_ARCH)
    depth = slice_depth(cfg, 1, ENCODER_FRAMES, (ENCODER_FRAMES,))
    require(depth == cfg.n_layers, f"{ENCODER_ARCH}: the dry run fits "
            f"{depth} of {cfg.n_layers} layers")
    held = torch.cuda.memory_allocated()
    print(f"  {ENCODER_ARCH}: this process holds {held / 1e9:.3f} GB before "
          f"the build (in the peak below)")
    model = build_dense(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {"embeds": torch.randn(1, ENCODER_FRAMES, cfg.d_model,
                                   generator=gen, device=dev
                                   ).to(torch.bfloat16)}
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    g = model(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    mem = memory_row(f"encode {ENCODER_ARCH} (B 1 x {ENCODER_FRAMES})",
                     serve_peak(cfg, 1, ENCODER_FRAMES, (ENCODER_FRAMES,)),
                     peak)
    require(launches == cfg.n_layers, f"encoder: {launches} flash launches, "
            f"not {cfg.n_layers}")
    model.backend = "torch"
    w = model(batch)
    model.backend = "auto"
    require(tuple(g.shape) == (1, ENCODER_FRAMES, cfg.vocab)
            and bool(torch.isfinite(g).all()),
            f"encoder output {tuple(g.shape)}, finite "
            f"{bool(torch.isfinite(g).all())}")
    rel = rel_err(g, w)
    flipped = float((g.argmax(-1) != w.argmax(-1)).float().mean())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(batch)
        torch.cuda.synchronize()
    kernels, _ = device_ms_by_kernel(prof)
    ms = {k: sum(v for n, v in kernels.items() if k in n)
          for k in ("flash_mma", "flash_sm90")}
    if kernels:
        require(ms["flash_sm90"] > 0 and ms["flash_mma"] == 0,
                f"the encoder's attention kernels: {ms}")
    device = ({"device_ms": sum(kernels.values()),
               "attention_ms": ms["flash_sm90"]} if kernels else
              {"device_ms": "not measured", "attention_ms": "not measured"})
    print(f"  encoder bf16, {cfg.n_layers} layers, {launches} flash "
          f"launches ({fa.kernel_for(torch.bfloat16, cfg.d_head)} at head "
          f"size {cfg.d_head}): kernel-vs-plain output rel err {rel:.3e} "
          f"(limit {E2E_REL_TOL:g}), frames whose argmax differs "
          f"{flipped:.4f}; forward {wall_ms:.2f} ms wall, device ms "
          f"{device}")
    require(rel <= E2E_REL_TOL, f"encoder: rel err {rel} > {E2E_REL_TOL}")
    del model, g, w
    free_card()

    f32 = dataclasses.replace(cfg, n_layers=SLICE_F32_LAYERS,
                              dtype="float32", kv_cache_dtype="float32")
    model = build_dense(f32, dev, backend="cuda")
    batch = {"embeds": batch["embeds"].float()}
    before = fa.launches
    g32 = model(batch)
    f32_launches = fa.launches - before
    profiled = f32_flash_profiled(lambda: model(batch),
                                  f"encoder f32 ({SLICE_F32_LAYERS} layers)")
    model.backend = "torch"
    w32 = model(batch)
    rel32 = rel_err(g32, w32)
    same = bool((g32.argmax(-1) == w32.argmax(-1)).all())
    print(f"  encoder f32 ({SLICE_F32_LAYERS} layers, "
          f"{fa.kernel_for(torch.float32, cfg.d_head)}, {f32_launches} "
          f"launches): kernel-vs-plain rel err {rel32:.3e}, every frame's "
          f"argmax the same {same}")
    del model
    free_card()
    require(f32_launches == SLICE_F32_LAYERS,
            f"encoder f32: {f32_launches} flash launches")
    require(same, "encoder f32: a frame's argmax differs")
    require(rel32 <= E2E_F32_REL_TOL,
            f"encoder f32: rel err {rel32} > {E2E_F32_REL_TOL}")
    return dict(arch=ENCODER_ARCH, n_layers=cfg.n_layers,
                frames=ENCODER_FRAMES, launches=launches, rel_err=rel,
                argmax_differs_share=flipped, wall_ms=wall_ms,
                device=device, memory=mem, held_before_build=held,
                f32=dict(n_layers=f"{SLICE_F32_LAYERS} of {cfg.n_layers}",
                         launches=f32_launches, rel_err=rel32,
                         same_argmax=same, profiled=profiled))


def slice_cli() -> dict:
    """The serve CLI on the card: ``--arch hubert-xlarge`` must exit 1 with
    the reference's message, and ``--arch internvl2-2b --requests 4``
    (full width) must serve its 4 requests and exit 0."""
    from repro_torch.launch.serve import main as serve_main

    rc, out, _ = run_cli(serve_main, ["--arch", ENCODER_ARCH])
    message = f"{ENCODER_ARCH} is encoder-only: no decode service"
    require(rc == 1 and message in out,
            f"serve --arch {ENCODER_ARCH}: exit {rc}, {out!r}")
    rc2, out2, s = run_cli(serve_main, ["--arch", "internvl2-2b",
                                        "--requests", "4"])
    require(rc2 == 0 and "served 4 requests" in out2,
            f"serve --arch internvl2-2b: exit {rc2}")
    free_card()
    return dict(encoder_exit=rc, encoder_message=message, serve_exit=rc2,
                serve_s=s)


def card_slice(mods, dev) -> dict:
    """Phase 20: SLICE_ARCHS served (``serve_dense``) and each in float32
    at a cut (``e2e_f32_dense``), hubert-xlarge's encoder (``encoder``),
    the serve CLI (``slice_cli``)."""
    out = {}
    for arch in SLICE_ARCHS:
        out[arch] = serve_dense(arch, mods, dev)
        out[arch]["e2e_f32"] = e2e_f32_dense(arch, dev)
    out[ENCODER_ARCH] = encoder(mods, dev)
    out["cli"] = slice_cli()
    free_card()
    return out


# ---------------------------------------------------------------------------
# the dry run and training
# ---------------------------------------------------------------------------
def dryrun_phase(host) -> dict:
    """``launch.dryrun`` over every architecture and shape (run by the
    host-work process, ``host_work``), and the MoE depths it gives phase
    13's load beside the ones first cut by hand (MOE_LAYERS_PR21)."""
    from repro_torch.analysis import report

    done = host.result("dryrun")
    recs, took, at_1040 = (done["records"], done["seconds"],
                           done["moe_layers_at_1040"])
    failed = [r for r in recs if r["status"] == "fail"]
    require(not failed, "dry run cells failed:\n"
            + "\n".join(r["error"] for r in failed))
    by_cell = {(r["arch"], r["shape"]): r for r in recs}
    print("  " + report.dryrun_table(by_cell).replace("\n", "\n  "))
    print(f"  {len(recs)} cells in {took:.1f} s (the host-work process); "
          f"MoE serving depth for 4 slots of {MOE_CAPACITY} (phase 13): {MOE_LAYERS}, of 1040: "
          f"{at_1040}; PR 21's by hand: {MOE_LAYERS_PR21}")
    require(all(MOE_LAYERS[a] >= 1 for a in MOE_LAYERS),
            f"the dry run fits no MoE layer: {MOE_LAYERS}")
    cells = {f"{r['arch']} {r['shape']}": (
        {"status": "skip"} if r["status"] == "skip" else dict(
            peak_gb=r["memory"]["peak_estimate_gb"],
            fits=r["memory"]["fits"],
            deepest_depth=r["memory"]["deepest_depth"],
            largest_batch=r["memory"]["largest_batch"],
            flops=r["cost"]["flops"],
            bottleneck=r["roofline"]["bottleneck"],
            roofline_fraction=r["roofline"]["roofline_fraction"]))
        for r in recs}
    return dict(seconds=took, moe_layers=dict(MOE_LAYERS),
                moe_layers_at_1040=at_1040,
                moe_layers_pr21=MOE_LAYERS_PR21, cells=cells)


def train_data(cfg, seq, batch, seed=1234):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))


def step_ms(hist) -> list[float]:
    walls = [0.0] + [h["wall_s"] for h in hist]
    return [(b - a) * 1e3 for a, b in zip(walls, walls[1:])]


def train_full(fa, da, dev) -> dict:
    """16a: full-width stablelm-1.6b, float32 master leaves, bf16
    compute, remat, AdamW at a constant TRAIN_LR."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import Trainer

    cfg = configs.get(TRAIN_ARCH)
    cell = ShapeCell("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    predicted = dryrun.train_memory(cfg, cell)
    flops = dryrun.matmul_flops(cfg, cell) + dryrun.mixer_flops(cfg, cell)
    executed = flops + dryrun.matmul_flops(cfg, cell, backward=False)
    model = build(cfg, backend="torch", device=dev, layout="train")
    trainer = Trainer(model, train_data(cfg, TRAIN_SEQ, TRAIN_BATCH),
                      optimizer=opt_lib.make("adamw", TRAIN_LR))
    trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sum(t.numel() for t in model.leaves.values()):,} float32 "
          f"parameters in {len(model.leaves)} leaves; batch {TRAIN_BATCH} "
          f"x {TRAIN_SEQ} tokens, remat {cfg.remat}")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = da.launches = 0
    hist = trainer.run(TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    losses = [h["loss"] for h in hist]
    ms = step_ms(hist)
    steady = statistics.median(ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"  losses {[round(x, 4) for x in losses]}")
    print(f"  step ms: first {ms[0]:.1f}, median of the rest {steady:.1f} "
          f"({min(ms[1:]):.1f}-{max(ms[1:]):.1f}); {tokens / steady * 1e3:,.0f} "
          f"tokens/s; MFU {flops / (steady * 1e-3) / PEAK_BF16_FLOPS:.4f} "
          f"(the dry run's {flops:.4e} FLOPs a step; {executed:.4e} with "
          f"the remat recompute); launches {launches}")
    row = memory_row(f"train {cfg.name}", predicted, peak)
    bad = [k for k, g in model.grads.items()
           if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0]
    require(not bad, f"gradient leaves not finite or all zero: {bad}")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(statistics.mean(losses[-5:]) < losses[0],
            f"the loss did not fall: {losses}")
    require(launches == {"flash_attention": 0, "decode_attention": 0},
            f"training launched kernels: {launches}")
    q = torch.randn(1, 64, 4, 64, device=dev, requires_grad=True)
    k = torch.randn(1, 64, 4, 64, device=dev)
    try:
        ops.attention(q, k, k)
        refused = None
    except RuntimeError as exc:
        refused = str(exc)
    require(refused is not None and "backend='torch'" in refused,
            "the kernel path took an input that needs a gradient")
    print(f"  the kernel path under grad: RuntimeError ({refused[:60]}...)")
    require(abs(row["measured_over_predicted"] - 1) <= TRAIN_PEAK_TOL,
            f"training peak {peak / 1e9:.2f} GB is off the dry run's "
            f"{predicted['run_bytes'] / 1e9:.2f} GB by more than "
            f"{TRAIN_PEAK_TOL:.0%}")
    batch = to_device(trainer.data.batch_at(TRAIN_STEPS), dev)
    prof = profile_steps(lambda: trainer.step_fn(trainer.state, batch), 2)
    print(f"  profiled 2 training steps: {prof}")
    del trainer, model, batch
    free_card()
    return dict(arch=cfg.name, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                steps=TRAIN_STEPS, lr=TRAIN_LR, losses=losses, step_ms=ms,
                median_step_ms=steady, tokens_per_s=tokens / steady * 1e3,
                flops=flops, flops_executed=executed,
                mfu=flops / (steady * 1e-3) / PEAK_BF16_FLOPS,
                launches=launches, peak=row,
                predicted={k: v for k, v in predicted.items()},
                grad_norms=[h["grad_norm"] for h in hist], profile=prof)


def cut_config(dtype):
    from repro_torch import configs
    return dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=CUT_LAYERS,
                               dtype=dtype, kv_cache_dtype=dtype)


def leaf_rel(a, b) -> float:
    """max |a - b| / max |b| over one leaf (0 when both are 0)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff if scale == 0 else diff / scale


def train_card_vs_cpu(dev) -> dict:
    """16b: one float32 step of the 2-layer cut on the card and on the CPU
    from the same weights and the same AdamW state (one CPU step taken
    first, so that the compared update is not the first step's, whose
    sign(g) turns any rounding of a near-zero gradient into a 2 lr
    jump)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import Trainer, TrainState

    cfg = cut_config("float32")
    data = train_data(cfg, CUT_SEQ, CUT_BATCH, seed=5)
    opt = opt_lib.make("adamw", TRAIN_LR)
    cpu = build(cfg, backend="torch", device="cpu", layout="train")
    tc = Trainer(cpu, data, optimizer=opt)
    tc.init_state(torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    tc.run(1)
    card = build(cfg, backend="torch", device=dev, layout="train")
    with torch.no_grad():
        for k, v in cpu.leaves.items():
            card.leaves[k].copy_(v)
    tg = Trainer(card, data, optimizer=opt)
    tg.state = TrainState(1, card.leaves, {
        k: {p: t.to(dev, copy=True) for p, t in v.items()}
        for k, v in tc.state.opt.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hg = tg.run(2)[-1]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    hc = tc.run(2)[-1]
    cpu_s = time.perf_counter() - t0
    loss = abs(hg["loss"] - hc["loss"]) / abs(hc["loss"])
    gnorm = abs(hg["grad_norm"] - hc["grad_norm"]) / hc["grad_norm"]
    grads = max(leaf_rel(card.grads[k], g) for k, g in cpu.grads.items())
    leaves = {k: leaf_rel(card.leaves[k], v) for k, v in cpu.leaves.items()}
    worst = max(leaves, key=leaves.get)
    print(f"  float32 {cfg.name} at {CUT_LAYERS} layers, batch {CUT_BATCH} "
          f"x {CUT_SEQ}: card vs CPU loss {hg['loss']:.7f} vs "
          f"{hc['loss']:.7f} (rel {loss:.2e}), grad norm rel {gnorm:.2e}, "
          f"gradient leaves up to {grads:.2e}, updated leaves up to "
          f"{leaves[worst]:.2e} ({worst}); the CPU's two steps "
          f"{cpu_s:.1f} s")
    row = memory_row(f"train {cfg.name} ({CUT_LAYERS} layers, float32)",
                     dryrun.train_memory(cfg, ShapeCell(
                         "t", CUT_SEQ, CUT_BATCH, "train")), peak)
    require(loss <= CPU_LOSS_RTOL, f"card vs CPU loss rel {loss}")
    require(gnorm <= CPU_GRAD_RTOL, f"card vs CPU grad norm rel {gnorm}")
    require(grads <= CPU_GRAD_RTOL, f"card vs CPU gradients rel {grads}")
    require(leaves[worst] <= CPU_LEAF_RTOL,
            f"card vs CPU updated {worst} rel {leaves[worst]}")
    del tg, card
    free_card()
    return dict(layers=CUT_LAYERS, seq=CUT_SEQ, batch=CUT_BATCH,
                loss=[hg["loss"], hc["loss"]], loss_rel=loss,
                grad_norm_rel=gnorm, grad_leaf_rel=grads,
                updated_leaf_rel=leaves[worst], worst_leaf=worst,
                cpu_s=cpu_s, peak=row)


def train_restart(dev) -> dict:
    """16c: the bf16 2-layer cut saved at step RESTART_AT and restored
    into a fresh ``Trainer``; the restored state must equal the saved one
    bit for bit and the next loss the uninterrupted run's.  Scoped to
    ``torch.use_deterministic_algorithms(True)``, which needs cuBLAS's
    fixed workspace (``CUBLAS_WORKSPACE_CONFIG``) and takes the sorted,
    deterministic ``index_put_`` for the token table's backward."""
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import Trainer

    cfg = cut_config("bfloat16")
    prior = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def trainer():
                model = build(cfg, backend="torch", device=dev,
                              layout="train")
                return Trainer(model, train_data(cfg, CUT_SEQ, CUT_BATCH, 9),
                               ckpt_dir=tmp, ckpt_every=RESTART_AT,
                               optimizer=opt_lib.make("adamw", TRAIN_LR))
            a = trainer()
            a.restore_or_init(torch.Generator(device=dev).manual_seed(0))
            t0 = time.perf_counter()
            a.run(RESTART_AT)
            save_s = time.perf_counter() - t0
            saved = {k: v.detach().cpu().clone()
                     if isinstance(v, torch.Tensor) else v
                     for k, v in ckpt_lib.flatten(a.state).items()}
            nbytes = (Path(tmp) / f"ckpt_{RESTART_AT:08d}.npz").stat().st_size
            a.ckpt_dir = None
            b = trainer()
            t0 = time.perf_counter()
            b.restore_or_init()
            restore_s = time.perf_counter() - t0
            b.ckpt_dir = None
            restored = ckpt_lib.flatten(b.state)
            differ = [k for k, v in saved.items()
                      if (not torch.equal(restored[k].cpu(), v)
                          if isinstance(v, torch.Tensor)
                          else restored[k] != v)]
            la = a.run(RESTART_AT + 1)[-1]["loss"]
            lb = b.run(RESTART_AT + 1)[-1]["loss"]
    finally:
        torch.use_deterministic_algorithms(False)
        if prior is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior
    print(f"  bf16 {cfg.name} at {CUT_LAYERS} layers: checkpoint at step "
          f"{RESTART_AT} ({nbytes / 1e9:.2f} GB, {len(saved)} arrays; the "
          f"run with its save {save_s:.1f} s, the restore {restore_s:.1f} "
          f"s); restored leaves differing {len(differ)}; step "
          f"{RESTART_AT + 1} loss uninterrupted {la!r}, restarted {lb!r}")
    require(not differ, f"restored state differs at {differ[:5]}")
    require(la == lb, f"the restarted loss {lb!r} != {la!r}")
    del a, b
    free_card()
    return dict(layers=CUT_LAYERS, at_step=RESTART_AT, bytes=nbytes,
                arrays=len(saved), save_run_s=save_s, restore_s=restore_s,
                loss_uninterrupted=la, loss_restarted=lb)


def train_moe(dev) -> dict:
    """16d: full-width dbrx-132b at the dry run's training depth (at
    least 1), Adafactor, 16 microbatches of one 256-token sequence."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import dryrun
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import Trainer

    full = configs.get(MOE_TRAIN_ARCH)
    cell = ShapeCell("train", MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, "train")
    depth = dryrun.deepest_depth(
        full, lambda c: dryrun.train_memory(c, cell)["peak_bytes"])
    cfg = dataclasses.replace(full, n_layers=max(1, depth))
    predicted = dryrun.train_memory(cfg, cell)
    model = build(cfg, backend="torch", device=dev, layout="train")
    data = train_data(cfg, MOE_TRAIN_SEQ, MOE_TRAIN_BATCH)
    trainer = Trainer(model, data, optimizer=opt_lib.make(
        cfg.optimizer, cfg.learning_rate))
    trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    factored = dryrun.optimizer_bytes(cfg, model.leaves)
    adamw = 2 * dryrun.weight_bytes(cfg, "train")
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} of {full.n_layers} layers (the dry "
          f"run's training depth: {depth}), "
          f"{sum(t.numel() for t in model.leaves.values()):,} float32 "
          f"parameters; {cfg.optimizer} state {factored / 1e9:.4f} GB "
          f"(AdamW's would be {adamw / 1e9:.2f} GB); {cfg.microbatches} "
          f"microbatches of {MOE_TRAIN_BATCH // cfg.microbatches} x "
          f"{MOE_TRAIN_SEQ}")
    torch.cuda.reset_peak_memory_stats()
    hist = trainer.run(MOE_TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = step_ms(hist)
    row = memory_row(f"train {cfg.name} ({cfg.n_layers} layers)",
                     predicted, peak)
    mb = to_device(data.batch_at(0), dev)
    mb = {k: v[:MOE_TRAIN_BATCH // cfg.microbatches] for k, v in mb.items()}
    loss, met = model.loss_fn(mb)
    met = {k: float(v.detach()) if isinstance(v, torch.Tensor) else v
           for k, v in met.items()}
    parts = met["nll"] + met["z"] + met["moe_aux"] + met["moe_z"]
    print(f"  losses {[h['loss'] for h in hist]}, step ms "
          f"{[round(x, 1) for x in ms]}; one microbatch: loss "
          f"{met['loss']:.5f} = nll {met['nll']:.5f} + z {met['z']:.5f} + "
          f"moe_aux {met['moe_aux']:.5f} + moe_z {met['moe_z']:.5f}")
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in hist), f"non-finite losses {hist}")
    require(met["moe_aux"] > 0 and met["moe_z"] > 0
            and math.isfinite(met["loss"])
            and abs(met["loss"] - parts) <= 1e-5 * abs(parts),
            f"the MoE losses are not in the loss: {met}")
    del trainer, model, loss
    free_card()
    return dict(arch=cfg.name, layers=cfg.n_layers, dryrun_depth=depth,
                steps=MOE_TRAIN_STEPS, losses=[h["loss"] for h in hist],
                step_ms=ms, microbatch_metrics=met,
                optimizer_bytes=factored, adamw_bytes=adamw, peak=row,
                predicted={k: v for k, v in predicted.items()})


def start_train_cli() -> tuple:
    """16e, started: the training launcher as a user runs it, in a
    process of its own beside 16a-d (the reduced config: its card
    memory is small)."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            TRAIN_ARCH, "--steps", "20"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE), time.perf_counter()


def train_cli(started) -> dict:
    """16e: the launcher started by ``start_train_cli`` must exit 0."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    took = time.perf_counter() - t0
    tail = stdout.strip().splitlines()[-3:]
    print(f"  python -m repro_torch.launch.train --arch {TRAIN_ARCH} "
          f"--steps 20 (beside 16a-d): exit {proc.returncode}, joined "
          f"{took:.1f} s after its start; {tail}")
    require(proc.returncode == 0, f"the launcher exited {proc.returncode}: "
            f"{stderr[-2000:]}")
    return dict(rc=proc.returncode, seconds=took, tail=tail)


def train(fa, da, dev) -> dict:
    free_card()
    cli = start_train_cli()
    try:
        out = {"full": train_full(fa, da, dev),
               "card_vs_cpu": train_card_vs_cpu(dev),
               "restart": train_restart(dev),
               "moe": train_moe(dev)}
    except BaseException:
        cli[0].kill()
        cli[0].wait()
        raise
    out["cli"] = train_cli(cli)
    return out



# ---------------------------------------------------------------------------
# phase 17: several ranks on the card
# ---------------------------------------------------------------------------

#: the ranks of the ring search (sharing the card), and its population
MD_DEVICES = (2, 4)
MD_POPULATION = 4096
#: the expert-parallel block: full-width dbrx-132b over 2 ranks, one
#: block of EP_TOKENS tokens (the fewest that take the path)
EP_ARCH, EP_RANKS, EP_TOKENS = "dbrx-132b", 2, 2048
#: float32 expert-parallel block against the plain one-device block, at
#: capacity factor E / k, where no expert can drop a token of either
EP_F32_TOL = dict(atol=1e-4, rtol=1e-4)
#: the reduced block on the card's ranks against the CPU's one-device
#: block (tests/test_torch_moe.py's tolerance)
EP_REDUCED_TOL = dict(atol=1e-5, rtol=1e-5)


def orin_tables():
    from repro_torch.core import search_torch
    req, model = fixture_requests()[ORIN]
    return req, search_torch.build_tables(
        req.platform, list(req.graphs), model, req.max_transitions,
        iterations=list(req.iterations), depends_on=list(req.depends_on))


def ring_key(device: str, devices: int, population: int = MD_POPULATION,
             steps: int = SEARCH_STEPS) -> dict:
    """Phase 7's orin fixture searched in float64 with the ring on
    ``devices`` ranks; the incumbent's assignment, objective and chain."""
    from repro_torch.core import search_torch
    req, tables = orin_tables()
    out = search_torch.anneal_search(
        tables, objective=req.objective, seed=0, population=population,
        steps=steps, precision="x64", devices=devices, device=device)
    return dict(assignment=[list(a) for a in out.assignment],
                objective=out.objective, chain=out.chain,
                migrate=out.migrate, fanout=out.fanout)


def ring_search(sd, se, dev) -> dict:
    """17a: the ring search at 1, 2 and 4 ranks sharing the card, and at
    one rank on the CPU (a subprocess, run alongside): the same incumbent
    bit for bit, both search kernels launched in every rank."""
    from repro_torch import ranks as rank_lib

    cpu = subprocess.Popen(
        [sys.executable, "-c", f"import json, chip_smoke; print(json.dumps("
         f"chip_smoke.ring_key('cpu', 1, {MD_POPULATION}, {SEARCH_STEPS})))"],
        cwd=ROOT, text=True,
        stdout=subprocess.PIPE, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    rank_lib.share_devices(max(MD_DEVICES))
    rows = {}
    # the largest pool first: the last, of 2 ranks, stays open for 17b-d
    # and phases 18 and 19 (a pool takes ~8-20 s to start)
    for devices in (1,) + tuple(sorted(MD_DEVICES, reverse=True)):
        pool_s = 0.0
        if devices > 1:
            t0 = time.perf_counter()
            rank_lib.rank_pool(devices, dev)
            pool_s = time.perf_counter() - t0
        sd.launches = se.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, chunks = traced(lambda: ring_key(dev, devices, MD_POPULATION,
                                              SEARCH_STEPS))
        wall = time.perf_counter() - t0
        if devices == 1:
            ranks = [dict(rank=0, seam_ms=[], waves=chunks[0]["waves"],
                          launches={"slowdown": sd.launches,
                                    "search": se.launches})]
        else:
            ranks = chunks[0]["ranks"]
        for r in ranks:
            require(r["launches"]["search"] == SEARCH_STEPS + 1
                    and r["launches"]["slowdown"] > 0,
                    f"ring x{devices}: rank {r['rank']}'s search kernels "
                    f"launched {r['launches']}")
        # each exchange's host ms, by rank; the first also waits out the
        # ranks' skew in set-up (library loads, warm-up, captures)
        first = [r["seam_ms"][0] for r in ranks if r["seam_ms"]]
        later = [ms for r in ranks for ms in r["seam_ms"][1:]]
        rows[devices] = dict(got, wall_s=wall, pool_start_s=pool_s,
                             ranks=ranks, seam_first_ms=first,
                             seam_later_ms=(statistics.median(later)
                                            if later else None))
        print(f"  ring on {devices} rank(s): chain {got['chain']}, objective "
              f"{got['objective']!r}, {wall:.2f} s (helper ranks started in "
              f"{pool_s:.1f} s), seam "
              + (f"first exchange {', '.join(f'{v:.1f}' for v in first)} "
                 f"ms by rank, later ones median "
                 f"{rows[devices]['seam_later_ms']} ms"
                 if first else "local")
              + f", select launches by rank "
              f"{[r['launches']['search'] for r in ranks]}")
    out, _ = cpu.communicate(timeout=600)
    require(cpu.returncode == 0, f"the CPU's ring search exited "
            f"{cpu.returncode}")
    rows["cpu"] = json.loads(out.strip().splitlines()[-1])

    def ident(row):
        return (row["assignment"], row["objective"], row["chain"])
    same = {str(k): ident(v) == ident(rows[1]) for k, v in rows.items()}
    print(f"  incumbent equal to one rank's on the card, bit for bit: {same}")
    require(all(same.values()), f"ring incumbents differ: {same}")
    return dict(population=MD_POPULATION, steps=SEARCH_STEPS,
                rows={str(k): v for k, v in rows.items()}, identical=same)


def ep_configs(arch: str = EP_ARCH) -> dict:
    """17b's configs of ``arch``: bf16 and float32 (at capacity factor
    E / k, where no token can drop) one-layer cuts at full width, the
    reduced config, and a float32 2-layer cut for the prefill."""
    from repro_torch import configs
    full = configs.get(arch)

    def cut(dtype, layers=1, cf=None):
        cfg = dataclasses.replace(full, n_layers=layers, dtype=dtype,
                                  kv_cache_dtype=dtype)
        if cf is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return dict(bf16=cut("bfloat16"),
                f32=cut("float32", cf=full.moe.n_experts / full.moe.top_k),
                reduced=full.reduced(), model=cut("float32", layers=2))


def ep_block(cfg, dev, mesh=None, seed=0):
    from repro_torch.models import moe
    block = moe.MoE(cfg, dev, mesh=mesh)
    block.init(torch.Generator(device=dev).manual_seed(seed))
    return block


def ep_input(cfg, dev, tokens, dtype):
    gen = torch.Generator(device=dev).manual_seed(1)
    return torch.randn(1, tokens, cfg.d_model, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


def ep_rank(dev_name: str, cfgs: dict) -> list:
    """17b, on every rank of a 2-rank pool sharing the card (the mesh
    (data=1, model=2)), with the configs ``ep_configs`` gives; returns
    every rank's results."""
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import build

    dev = torch.device(dev_name)
    m = tmesh.device_mesh((1, EP_RANKS), device=dev.type)
    res = {"rank": dist.get_rank()}

    # bf16 at full width: each rank holds 8 of the 16 experts
    cfg = cfgs["bf16"]
    block = ep_block(cfg, dev, m)
    res["held_gb"] = sum(getattr(block, n).numel() * 2 for n in
                         ("wi_gate", "wi", "wo")) / 1e9
    x = ep_input(cfg, dev, EP_TOKENS, torch.bfloat16)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with torch.no_grad():
        block(x)                                   # warm-up
        sync()
        t0 = time.perf_counter()
        y, _ = block(x)
        sync()
    res["bf16_ms"] = (time.perf_counter() - t0) * 1e3
    res["bf16_finite"] = bool(torch.isfinite(y).all())
    res["bf16_sum"] = float(y.float().sum())
    res["bf16_ep_calls"] = block.ep_calls
    del block, y
    free_card()

    # float32 at full width, against the plain one-device block on rank 0
    cfg = cfgs["f32"]
    x = ep_input(cfg, dev, EP_TOKENS, torch.float32)
    block = ep_block(cfg, dev, m)
    with torch.no_grad():
        y, _ = block(x)
    res["f32_ep_calls"] = block.ep_calls
    del block
    free_card()
    if dist.get_rank() == 0:
        with torch.no_grad():
            want, _ = ep_block(cfg, dev)(x)
        res["f32_err"] = float((y - want).abs().max())
        res["f32_ok"] = bool(torch.allclose(y, want, **EP_F32_TOL))
        del want
    del y, x
    free_card()

    # the reduced block on the ranks against the CPU's one-device block
    cfg = cfgs["reduced"]
    block = ep_block(cfg, torch.device("cpu"))
    x = ep_input(cfg, torch.device("cpu"), EP_TOKENS, torch.float32)
    from repro_torch.models import moe
    from repro_torch.models.convert import shard_experts
    card = moe.MoE(cfg, dev, mesh=m)
    card.load_state_dict(shard_experts(cfg, block.state_dict(), card.rules,
                                       m))
    with torch.no_grad():
        want, _ = block(x)
        got, _ = card(x.to(dev))
    res["reduced_err"] = float((got.cpu() - want).abs().max())
    res["reduced_ok"] = bool(torch.allclose(got.cpu(), want,
                                            **EP_REDUCED_TOL))
    res["reduced_ep_calls"] = card.ep_calls
    # below the path's conditions (a decode step's token count) a block
    # that holds a slice of the experts takes the other path over them,
    # the ranks' combines summed (phase 18 serves through it)
    with torch.no_grad():
        short, _ = card(x[:, :16].to(dev))
        want_short, _ = block(x[:, :16])
    res["short_ok"] = bool(torch.allclose(short.cpu(), want_short,
                                          **EP_REDUCED_TOL))
    res["short_ep_calls"] = card.ep_calls - res["reduced_ep_calls"]
    del card

    # a float32 2-layer cut of full-width dbrx-132b on the mesh: its
    # prefill of EP_TOKENS tokens through the flash kernel, against the
    # plain path
    cfg = cfgs["model"]
    model = build(cfg, backend="auto", device=dev, mesh=m)
    model.init(torch.Generator(device=dev).manual_seed(0))
    batch = {"token_ids": torch.randint(
        0, cfg.vocab, (1, EP_TOKENS), device=dev,
        generator=torch.Generator(device=dev).manual_seed(2))}
    fa.launches = 0
    logits = model.forward(batch, last_only=True).float()
    res["prefill_flash_launches"] = fa.launches
    model.backend = "torch"
    plain = model.forward(batch, last_only=True).float()
    res["prefill_ep_calls"] = sum(layer.c.ep_calls for layer in model.layers)
    res["prefill_rel"] = float((logits - plain).abs().max()
                               / plain.abs().max())
    res["prefill_argmax_same"] = bool(
        (logits.argmax(-1) == plain.argmax(-1)).all())
    del model, logits, plain
    free_card()

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, res)
    return out


def expert_parallel(fa, dev) -> dict:
    """17b: the expert-parallel block on 2 ranks sharing the card."""
    from repro_torch import ranks as rank_lib

    rank_lib.share_devices(EP_RANKS)
    ranks = rank_lib.rank_pool(EP_RANKS, dev).run("chip_smoke:ep_rank",
                                                  dev.type, ep_configs())
    for r in ranks:
        print(f"  rank {r['rank']}: bf16 block of {EP_TOKENS} tokens "
              f"{r['bf16_ms']:.2f} ms holding {r['held_gb']:.2f} GB of "
              f"experts (expert-parallel {r['bf16_ep_calls']}x, the "
              f"warm-up and the timed call); reduced "
              f"block vs the CPU max |diff| {r['reduced_err']:.3g}; 2-layer "
              f"prefill: {r['prefill_flash_launches']} flash launches, "
              f"{r['prefill_ep_calls']} expert-parallel blocks, logits vs "
              f"plain rel {r['prefill_rel']:.3g}, argmax same "
              f"{r['prefill_argmax_same']}")
        require(r["bf16_finite"] and r["bf16_ep_calls"] == 2
                and r["f32_ep_calls"] == 1 and r["reduced_ep_calls"] == 1
                and r["short_ok"] and r["short_ep_calls"] == 0,
                f"rank {r['rank']}: the expert-parallel path: {r}")
        require(r["reduced_ok"], f"rank {r['rank']}: reduced block off the "
                f"CPU's by {r['reduced_err']}")
        require(r["prefill_flash_launches"] == 2
                and r["prefill_ep_calls"] == 4
                and r["prefill_argmax_same"]
                and r["prefill_rel"] <= E2E_F32_REL_TOL,
                f"rank {r['rank']}: the 2-layer prefill: {r}")
    require(len({r["bf16_sum"] for r in ranks}) == 1,
            "the ranks' bf16 outputs differ")
    f32 = ranks[0]
    print(f"  float32 full-width block vs the plain one-device block: max "
          f"|diff| {f32['f32_err']:.3g} (limit {EP_F32_TOL})")
    require(f32["f32_ok"], f"float32 block off by {f32['f32_err']}")
    return dict(tokens=EP_TOKENS, ranks=ranks)


def start_serve_cli(work: Path) -> tuple:
    """17c, started: the gateway CLI at full width with ``--devices 2``
    (serving 2 requests a tenant) and with ``--devices 1`` (the plan
    alone), both saving their plans; :func:`serve_cli_devices` ends it."""
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--gateway",
            "--arch", "stablelm-1.6b", "--co-arch", "llama3.2-3b",
            "--solver", "anneal"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {n: subprocess.Popen(
        base + ["--devices", str(n), "--requests", "2",
                "--save-plan", str(work / f"plan{n}.json")]
        + ([] if n > 1 else ["--plan-only"]), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for n in (1, 2)}
    return procs, time.perf_counter()


def serve_cli_devices(work: Path, started) -> dict:
    """17c: ``--devices 2`` exited 0 and planned what ``--devices 1``
    planned."""
    from repro_torch.core import Plan
    procs, t0 = started
    outs = {n: p.communicate(timeout=900)[0] for n, p in procs.items()}
    wall = time.perf_counter() - t0
    for n, p in procs.items():
        for line in outs[n].splitlines()[-6:]:
            print(f"    [--devices {n}] {line}")
        require(p.returncode == 0, f"serve --devices {n} exited "
                f"{p.returncode}")
    plans = {n: Plan.load(work / f"plan{n}.json") for n in (1, 2)}
    params = plans[2].solver_params
    same = plans[1].assignments == plans[2].assignments
    print(f"  serve --gateway --devices 2 (full width): plan equal to "
          f"--devices 1's {same}, solver params devices "
          f"{params.get('devices')} migrate {params.get('migrate')} fanout "
          f"{params.get('fanout')}; both done {wall:.1f} s after their "
          f"start (beside 17d)")
    require(same and params.get("devices") == 2,
            "--devices 2's plan is not --devices 1's")
    return dict(same_plan=same, wall_s=wall, params=params)


def ckpt_rank(dev_name: str, ckpt_dir: str, like: dict) -> list:
    """17d, on every rank: the checkpoint restored onto the (1, 2) mesh,
    each leaf's dim 0 split over "model" where it divides; this rank's
    blocks compared bit for bit with its rows of the file's arrays, cut
    here by the rank's index (not by the sharding that placed them)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import sharding
    from repro_torch.train import checkpoint as ckpt_lib

    m = tmesh.device_mesh((1, EP_RANKS), device=dev_name)
    rules = {"rows": "model"}
    shardings = {k: sharding.named_sharding(
        m, rules, ("rows",) + (None,) * (v.dim() - 1), tuple(v.shape))
        for k, v in like.items() if isinstance(v, torch.Tensor)}
    t0 = time.perf_counter()
    state, step = ckpt_lib.restore(ckpt_dir, like, shardings=shardings)
    secs = time.perf_counter() - t0
    import numpy as np
    differ, split = [], 0
    with np.load(Path(ckpt_dir) / f"ckpt_{step:08d}.npz") as data:
        for k, v in state.items():
            if not isinstance(like[k], torch.Tensor):
                if v != like[k]:
                    differ.append(k)
                continue
            whole = torch.from_numpy(data[k])
            rows = whole.shape[0] // EP_RANKS
            want = (whole[dist.get_rank() * rows:][:rows]
                    if whole.shape[0] % EP_RANKS == 0 else whole)
            local = v.to_local()
            split += local.shape != v.shape
            if local.device.type != dev_name or not torch.equal(
                    local.cpu(), want):
                differ.append(k)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, dict(rank=dist.get_rank(), step=step,
                                     differ=differ, split=split,
                                     leaves=len(shardings), restore_s=secs))
    return out


def ckpt_on_mesh(dev, work: Path, cfg=None) -> dict:
    """17d: phase 16's 2-layer cut (its float32 leaves, the training
    layout) saved on one rank and restored onto the 2-rank mesh, bit for
    bit."""
    from repro_torch import ranks as rank_lib
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt_lib

    cfg = cfg or cut_config("float32")
    model = build(cfg, backend="torch", device=dev, layout="train")
    model.init(torch.Generator(device=dev).manual_seed(0))
    state = {"step": 0, "params": model.leaves}
    t0 = time.perf_counter()
    path = ckpt_lib.save(work / "ckpt", 0, state)
    save_s = time.perf_counter() - t0
    like = {k: (torch.empty(v.shape, dtype=v.dtype, device="meta")
                if isinstance(v, torch.Tensor) else v)
            for k, v in ckpt_lib.flatten(state).items()}
    del model, state
    free_card()
    ranks = rank_lib.rank_pool(EP_RANKS, dev).run(
        "chip_smoke:ckpt_rank", dev.type, str(work / "ckpt"), like)
    gb = path.stat().st_size / 1e9
    print(f"  {cfg.name} at {cfg.n_layers} layers: {gb:.2f} GB saved in "
          f"{save_s:.1f} s")
    for r in ranks:
        print(f"  rank {r['rank']}: restored step {r['step']}, "
              f"{r['leaves']} arrays ({r['split']} split over the model "
              f"axis) in {r['restore_s']:.1f} s; differing {r['differ'][:3]}")
        require(not r["differ"] and r["split"] > 0,
                f"rank {r['rank']}: restore onto the mesh: {r}")
    return dict(gb=gb, save_s=save_s, ranks=ranks)


def multidevice(fa, sd, se, dev) -> dict:
    """Phase 17: several ranks sharing the card."""
    from repro_torch import ranks as rank_lib

    t0 = time.perf_counter()
    # helper ranks import this script by name
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"  rank 0 (this process) holds {held:.2f} GB "
          f"({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved); the "
          f"card has {free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    out = {"ring": ring_search(sd, se, dev)}
    free_card()
    work = tempfile.TemporaryDirectory()
    started = None
    try:
        out["expert_parallel"] = expert_parallel(fa, dev)
        # the CLI runs in processes of its own beside 17d
        started = start_serve_cli(Path(work.name))
        out["checkpoint"] = ckpt_on_mesh(dev, Path(work.name))
        out["serve_cli"] = serve_cli_devices(Path(work.name), started)
    except BaseException:
        rank_lib.close_pool()
        raise
    finally:
        for p in (started[0].values() if started else ()):
            if p.poll() is None:
                p.kill()
                p.wait()
        work.cleanup()
        free_card()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 18: tensor-parallel serving on ranks sharing the card
# ---------------------------------------------------------------------------

#: two ranks of a (data 1, model 2) mesh over gloo, sharing the card
TP_SIZES = (1, 2)
TP_SLOTS, TP_CAPACITY = 4, 1040
#: recurrentgemma-9b: its prompts end past the 2048-token window
TP_RG_LENS, TP_RG_CAPACITY = (8, 100, 513, 2300), RG_CAPACITY
#: the float32 cuts: llama3.2-3b's 2 layers; the recurrent models' 3
#: (recurrentgemma-9b's rglru, rglru, local)
TP_F32_LAYERS = {"llama3.2-3b": 2, "recurrentgemma-9b": 3, "rwkv6-7b": 3}
#: the bf16 models' depths, cut from the full ones to keep the run within
#: its time (recurrentgemma-9b keeps 2 of its local layers; each layer of
#: a kind splits and gathers as the others do)
TP_DEPTHS = {"llama3.2-3b": 4, "recurrentgemma-9b": 6, "rwkv6-7b": 4}
#: prefill(n) + one decode step against prefill(n + 1): the step's token
#: lands on slot 520, the first of rank 1's chunk of 1040
TP_STEP_N = 520
#: dbrx-132b's depth: the mesh dry run's deepest whose per-rank peak fits
#: this share of the card (two ranks share it; the 10% left covers both
#: contexts and rank 0's earlier allocations)
TP_CARD_SHARE = 0.9 / 2
TP_MOE_ARCH = "dbrx-132b"


def tp_desc():
    from repro_torch.launch import mesh as tmesh
    return tmesh.Mesh(("data", "model"), TP_SIZES)


def tp_peak(cfg, capacity, lens) -> dict:
    from repro_torch.launch import dryrun
    return dryrun.mesh_serve_memory(cfg, tp_desc(), TP_SLOTS, capacity, 1,
                                    max(lens))


def tp_depth(arch) -> int:
    from repro_torch import configs
    from repro_torch.analysis.roofline import HBM_BYTES
    from repro_torch.launch import dryrun
    return dryrun.deepest_depth(
        configs.get(arch), lambda c: tp_peak(c, TP_CAPACITY,
                                             PROMPT_LENS)["peak_bytes"],
        TP_CARD_SHARE * HBM_BYTES)


def tp_counts() -> dict:
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     rglru, rwkv6)
    return dict(flash_attention=flash_attention.launches,
                decode_attention=decode_attention.launches,
                decode_attention_partials=decode_attention.partials_launches,
                decode_attention_combine=decode_attention.combine_launches,
                rglru_scan=rglru.launches, rwkv6_scan=rwkv6.launches)


def tp_zero() -> None:
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     rglru, rwkv6)
    from repro_torch.models import collectives
    for m in (flash_attention, rglru, rwkv6):
        m.launches = 0
    decode_attention.launches = decode_attention.partials_launches = 0
    decode_attention.combine_launches = 0
    collectives.reset()


def tp_serve(model, prompts, capacity, dev) -> dict:
    """Each prompt prefilled into its slot of TP_SLOTS x ``capacity``
    caches, then MAX_NEW greedy decode steps of every slot, eager; the
    prefill logits, the tokens and each step's ms."""
    from repro_torch.models import kvcache
    caches = model.init_cache(TP_SLOTS, capacity)
    last, toks = [], []
    for i, p in enumerate(prompts):
        views = [kvcache.select(c, i) for c in caches]
        logits, _ = model.prefill(
            {"token_ids": torch.as_tensor(p[None], device=dev)},
            capacity=capacity, cache_out=views)
        last.append(logits[0, -1].float())
        toks.append(int(logits[0, -1].argmax()))
    tok = torch.tensor(toks, dtype=torch.int32, device=dev)[:, None]
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=dev)
    out, ms = [tok[:, 0].tolist()], []
    for _ in range(MAX_NEW - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(
            caches, {"token_ids": tok, "lengths": lengths})
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok[:, 0].tolist())
        lengths = lengths + 1
    return dict(last=torch.stack(last), tokens=[list(t) for t in zip(*out)],
                step_ms=ms, caches=caches, tok=tok, lengths=lengths)


def tp_build(cfg, dev, mesh, backend="auto", seed=0):
    from repro_torch.models import build
    model = build(cfg, backend=backend, device=dev, mesh=mesh,
                  rules=cfg.serve_rules if mesh is not None else None)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    return model


def tp_bf16(arch, depth, capacity, lens, dev, m) -> dict:
    """One bf16 model on the mesh at full width: tokens, exact launches,
    collectives against the dry run's plan, the rank's KV bytes, its peak
    against the mesh dry run's, and (rank 0) the logits and tokens of the
    one-device kernel path on the same weights."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.analysis import roofline
    from repro_torch.launch import dryrun
    from repro_torch.models import collectives

    cfg = dataclasses.replace(configs.get(arch), n_layers=depth)
    prompts = make_prompts(cfg.vocab, lens)
    base = torch.cuda.memory_allocated()
    print(f"  rank {dist.get_rank()}, {arch} ({depth} layers): holds "
          f"{base / 1e9:.2f} GB before the build", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tp_build(cfg, dev, m)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tp_zero()
    got = tp_serve(model, prompts, capacity, dev)
    counts = tp_counts()
    recs = list(collectives.records)
    coll_s = collectives.seconds
    peak = torch.cuda.max_memory_allocated() - base
    kv = sum(t.numel() * t.element_size() for c in got["caches"]
             for x in c.values() if isinstance(x, dict) for t in x.values())
    plan = dryrun.serve_collectives(cfg, tp_desc(), TP_SLOTS, capacity,
                                    lens, MAX_NEW - 1)
    mine = roofline.parse_collectives(collectives.hlo_text(recs))
    want = roofline.parse_collectives(collectives.hlo_text(plan))
    # the eager step's profile, on copies of the caches' state
    state = dict(caches=got["caches"], tok=got["tok"],
                 lengths=got["lengths"])

    def step():
        model.decode_step(state["caches"], {"token_ids": state["tok"],
                                            "lengths": state["lengths"]})
    collectives.reset()
    prof = profile_steps(step, steps=4)
    prof["collective_host_ms_per_step"] = collectives.seconds * 1e3 / 8
    collectives.reset()
    res = dict(arch=arch, n_layers=depth, rank=dist.get_rank(),
               build_s=build_s, tokens=got["tokens"],
               step_ms=got["step_ms"], launches=counts,
               collectives=dict(op_counts=mine.op_counts,
                                operand_bytes=mine.operand_bytes,
                                moved_bytes=mine.moved_bytes,
                                host_s=coll_s),
               planned=dict(op_counts=want.op_counts,
                            operand_bytes=want.operand_bytes,
                            moved_bytes=want.moved_bytes),
               kv_bytes=kv, peak_bytes=peak,
               predicted_peak_bytes=tp_peak(cfg, capacity,
                                            lens)["peak_bytes"],
               profile=prof)
    last = got["last"]
    del model, got, state, step
    free_card()
    # the one-device model needs the card the ranks' blocks held: every
    # rank frees its blocks first, and waits for rank 0's run
    dist.barrier()
    if dist.get_rank() == 0:        # the one-device kernel path
        one = tp_build(cfg, dev, None)
        ref = tp_serve(one, prompts, capacity, dev)
        res["one_device_kv_bytes"] = sum(
            t.numel() * t.element_size() for c in ref["caches"]
            for x in c.values() if isinstance(x, dict) for t in x.values())
        res["bf16_rel_err"] = [rel_err(g, w) for g, w in
                               zip(last, ref["last"])]
        res["bf16_argmax_same"] = [int(g.argmax()) == int(w.argmax())
                                   for g, w in zip(last, ref["last"])]
        res["tokens_in_common"] = [
            sum(a == b for a, b in zip(x, y))
            for x, y in zip(res["tokens"], ref["tokens"])]
        del one, ref
        free_card()
    dist.barrier()
    return res


def tp_f32(arch, dev, m) -> dict:
    """A float32 cut of ``arch`` at full width on the mesh (the kernel
    path) against the one-device plain path on the same weights (the
    recurrent models' PERTURBED ones too, cut to each rank by
    ``shard_params``): the last prompt's prefill logits, and prefill(n) +
    one decode step against prefill(n + 1) on the mesh."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.models.convert import shard_params

    cfg = dataclasses.replace(configs.get(arch), n_layers=TP_F32_LAYERS[arch],
                              dtype="float32", kv_cache_dtype="float32")
    recurrent = arch != "llama3.2-3b"
    one = build(cfg, backend="torch", device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    one.init(gen)
    if recurrent:
        perturb_recurrent(one, gen)
    model = build(cfg, device=dev, mesh=m, rules=cfg.serve_rules)
    model.load_state_dict(shard_params(cfg, one.state_dict(), model.rules,
                                       m))
    n = 2300 if recurrent else TP_STEP_N + 1
    p = make_prompts(cfg.vocab, (n,))[0]
    cap = TP_RG_CAPACITY if recurrent else TP_CAPACITY
    batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
    got = model.prefill(batch, capacity=cap)[0][0, -1]
    want = one.prefill(batch, capacity=cap)[0][0, -1]
    step_n = n - 1
    _, caches = model.prefill({"token_ids": batch["token_ids"][:, :step_n]},
                              capacity=cap)
    step = model.decode_step(caches, {
        "token_ids": batch["token_ids"][:, step_n:],
        "lengths": torch.tensor([step_n], dtype=torch.int32,
                                device=dev)})[0][0, -1]
    res = dict(arch=arch, n_layers=cfg.n_layers, prompt=n,
               rel_err=rel_err(got, want),
               argmax_same=int(got.argmax()) == int(want.argmax()),
               step_n=step_n, step_rel_err=rel_err(step, got),
               step_argmax_same=int(step.argmax()) == int(got.argmax()),
               rank=dist.get_rank())
    del one, model, caches
    free_card()
    return res


def tp_moe_block(dev, m) -> dict:
    """One float32 dbrx-132b block at decode size (4 tokens), capacity
    factor E / k, split over the mesh (8 experts a rank) against the
    one-device block holding all 16."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.sharding import Split

    full = configs.get(TP_MOE_ARCH)
    cfg = dataclasses.replace(full, dtype="float32", moe=dataclasses.replace(
        full.moe, capacity_factor=full.moe.n_experts / full.moe.top_k))
    block = moe.MoE(cfg, dev, rules=cfg.serve_rules, mesh=m,
                    split=Split(m, cfg.serve_rules))
    block.init(torch.Generator(device=dev).manual_seed(0))
    x = torch.randn(1, 4, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        y, _ = block(x)
    held = block.wi.shape[0]
    del block
    free_card()
    one = moe.MoE(cfg, dev)
    one.init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        want, _ = one(x)
    ok, err = within(y, want, MOE_ORACLE_TOL)
    del one
    free_card()
    return dict(held=held, ok=ok, max_abs_err=err)


def tp_rank(dev_name: str, plan: dict) -> list:
    """Phase 18 on every rank of the 2-rank pool (mesh (1, 2))."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh

    dev = torch.device(dev_name)
    m = tmesh.device_mesh(TP_SIZES, device=dev.type)
    res = {"rank": dist.get_rank()}
    t0 = time.perf_counter()
    res["llama"] = tp_bf16("llama3.2-3b", plan["llama3.2-3b"], TP_CAPACITY,
                           PROMPT_LENS, dev, m)
    res["llama_f32"] = tp_f32("llama3.2-3b", dev, m)
    res["rgemma"] = tp_bf16("recurrentgemma-9b", plan["recurrentgemma-9b"],
                            TP_RG_CAPACITY, TP_RG_LENS, dev, m)
    res["rgemma_f32"] = tp_f32("recurrentgemma-9b", dev, m)
    res["rwkv"] = tp_bf16("rwkv6-7b", plan["rwkv6-7b"], TP_CAPACITY,
                          PROMPT_LENS, dev, m)
    res["rwkv_f32"] = tp_f32("rwkv6-7b", dev, m)
    res["dbrx"] = tp_bf16(TP_MOE_ARCH, plan[TP_MOE_ARCH], TP_CAPACITY,
                          PROMPT_LENS, dev, m)
    res["dbrx_block"] = tp_moe_block(dev, m)
    res["seconds"] = time.perf_counter() - t0
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, res)
    return out


def tp_require(r: dict, layers: dict) -> None:
    """The fatal checks of one rank's bf16 model run."""
    arch, n = r["arch"], r["n_layers"]
    c = r["launches"]
    att = sum(k in ("attn", "local") for k in layers[arch])
    rec = sum(k == "rglru" for k in layers[arch])
    rwk = sum(k == "rwkv" for k in layers[arch])
    prefills, steps = TP_SLOTS, MAX_NEW - 1
    want = dict(flash_attention=att * prefills, decode_attention=0,
                decode_attention_partials=att * steps,
                decode_attention_combine=att * steps,
                rglru_scan=rec * (prefills + steps),
                rwkv6_scan=rwk * (prefills + steps))
    require(c == want, f"{arch} rank {r['rank']}: launches {c}, want {want}")
    require(all(len(t) == MAX_NEW for t in r["tokens"]),
            f"{arch}: a request got fewer than {MAX_NEW} tokens")
    mine, plan = r["collectives"], r["planned"]
    require(mine["op_counts"] == plan["op_counts"]
            and mine["operand_bytes"] == plan["operand_bytes"],
            f"{arch} rank {r['rank']}: collectives {mine} != the dry "
            f"run's {plan}")
    require(r["peak_bytes"] <= r["predicted_peak_bytes"],
            f"{arch} rank {r['rank']}: peak {r['peak_bytes'] / 1e9:.2f} GB "
            f"over the mesh dry run's {r['predicted_peak_bytes'] / 1e9:.2f}")


def tensor_parallel(dev) -> dict:
    """Phase 18: tensor-parallel serving on 2 ranks sharing the card."""
    from repro_torch import configs
    from repro_torch import ranks as rank_lib
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)
    free_card()
    plan = dict(TP_DEPTHS)
    plan[TP_MOE_ARCH] = tp_depth(TP_MOE_ARCH)
    layers = {arch: dataclasses.replace(configs.get(arch),
                                        n_layers=n).layer_kinds
              for arch, n in plan.items()}
    print(f"  depths: {plan} ({TP_MOE_ARCH}'s the mesh dry run's deepest "
          f"whose per-rank peak fits {TP_CARD_SHARE:.2f} of the card)")
    rank_lib.share_devices(TP_SIZES[1])
    try:           # phase 17's pool of 2 ranks, kept open for phase 19
        ranks = rank_lib.rank_pool(TP_SIZES[1], dev).run("chip_smoke:tp_rank",
                                                         dev.type, plan)
    except BaseException:
        rank_lib.close_pool()
        raise
    finally:
        free_card()
    for key in ("llama", "rgemma", "rwkv", "dbrx"):
        rs = [r[key] for r in ranks]
        for r in rs:
            pr = r["profile"]
            busy = pr.get("unprofiled_busy_share")
            print(f"  {r['arch']} ({r['n_layers']} layers) rank {r['rank']}: "
                  f"built in {r['build_s']:.1f} s; eager step "
                  f"{statistics.median(r['step_ms']):.2f} ms (median of "
                  f"{len(r['step_ms'])}), profiled "
                  f"{pr['unprofiled_ms_per_step']:.2f} ms, device busy "
                  f"{busy if busy is None else f'{busy:.3f}'}, collectives' "
                  f"host ms a step {pr['collective_host_ms_per_step']:.2f}; "
                  f"launches {r['launches']}; collectives "
                  f"{r['collectives']['op_counts']} "
                  f"{r['collectives']['operand_bytes'] / 1e6:.3f} MB "
                  f"(planned {r['planned']['op_counts']} "
                  f"{r['planned']['operand_bytes'] / 1e6:.3f} MB); KV "
                  f"{r['kv_bytes'] / 1e9:.3f} GB; memory, {r['arch']} "
                  f"rank {r['rank']}: mesh dry run "
                  f"{r['predicted_peak_bytes'] / 1e9:.3f} GB, "
                  f"max_memory_allocated {r['peak_bytes'] / 1e9:.3f} GB")
            tp_require(r, layers)
        require(rs[0]["tokens"] == rs[1]["tokens"],
                f"{key}: the ranks' tokens differ")
        r0 = rs[0]
        require(all(r["kv_bytes"] * TP_SIZES[1] == r0["one_device_kv_bytes"]
                    for r in rs) or key == "rwkv",
                f"{key}: a rank's KV bytes are not 1/{TP_SIZES[1]} of the "
                f"one-device cache's")
        print(f"  {key} bf16 against the one-device kernel path: rel err "
              f"{[f'{e:.3e}' for e in r0['bf16_rel_err']]}, argmax same "
              f"{r0['bf16_argmax_same']}, tokens in common "
              f"{r0['tokens_in_common']} of {MAX_NEW}")
        MEMORY.extend(dict(run=f"tensor-parallel {r['arch']} rank "
                           f"{r['rank']}",
                           predicted_bytes=r["predicted_peak_bytes"],
                           measured_bytes=r["peak_bytes"],
                           measured_over_predicted=r["peak_bytes"]
                           / r["predicted_peak_bytes"]) for r in rs)
    for key in ("llama_f32", "rgemma_f32", "rwkv_f32"):
        for r in (x[key] for x in ranks):
            print(f"  f32 {r['arch']} {r['n_layers']}-layer cut, rank "
                  f"{r['rank']}: mesh vs one-device plain path rel err "
                  f"{r['rel_err']:.3e} (argmax same {r['argmax_same']}) at "
                  f"{r['prompt']} tokens; prefill({r['step_n']}) + decode "
                  f"vs prefill({r['step_n'] + 1}) rel err "
                  f"{r['step_rel_err']:.3e} (argmax same "
                  f"{r['step_argmax_same']})")
            require(r["rel_err"] <= E2E_F32_REL_TOL and r["argmax_same"]
                    and r["step_rel_err"] <= E2E_F32_REL_TOL
                    and r["step_argmax_same"],
                    f"f32 {r['arch']} on the mesh: {r}")
    for r in (x["dbrx_block"] for x in ranks):
        print(f"  f32 {TP_MOE_ARCH} block at 4 tokens on the mesh, "
              f"{r['held']} experts a rank, vs the one-device block: max "
              f"|diff| {r['max_abs_err']:.3e} (limit {MOE_ORACLE_TOL})")
        require(r["ok"] and r["held"] == configs.get(
            TP_MOE_ARCH).moe.n_experts // TP_SIZES[1],
            f"f32 {TP_MOE_ARCH} block on the mesh: {r}")
    # e. the mesh dry run's records of the four models at (1, 2)
    records = {}
    for key, arch in (("llama", "llama3.2-3b"),
                      ("rgemma", "recurrentgemma-9b"), ("rwkv", "rwkv6-7b"),
                      ("dbrx", TP_MOE_ARCH)):
        rec = dryrun.mesh_cell(arch, "decode_32k", tp_desc(), "1x2")
        cell = {k: rec[k] for k in ("status", "per_device", "collectives")
                if k in rec}
        cell["memory"] = {k: rec["memory"][k] for k in
                          ("peak_bytes", "fits", "deepest_depth")} \
            if "memory" in rec else None
        records[arch] = cell
        r0 = ranks[0][key]
        print(f"  dry run (1, 2) {arch} decode_32k: peak "
              f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB a device, "
              f"deepest depth {rec['memory']['deepest_depth']}, collectives "
              f"a step {rec['collectives']['op_counts']}; measured in this "
              f"phase at {r0['n_layers']} layers: peak "
              f"{r0['peak_bytes'] / 1e9:.2f} GB, collectives "
              f"{r0['collectives']['op_counts']} over {TP_SLOTS} prefills "
              f"and {MAX_NEW - 1} steps")
    out = dict(depths=plan, ranks=ranks, dryrun_1x2=records,
               seconds=time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# phase 19: training on 2 ranks sharing the card
# ---------------------------------------------------------------------------

#: 19a: full-width stablelm-1.6b steps before the profiled one (a step
#: takes ~20 s at its 24 layers: its collectives cross host memory over
#: gloo)
MT_STEPS = 1
#: 19a's depth: every layer gathers and reduce-scatters the same way, and
#: at 24 layers its two steps took ~50 s of the script's time limit (at 4,
#: ~30 s; at 2, 22-57 s by the host)
MT_DEPTH = 1
#: 19d: full-width dbrx-132b steps
MT_MOE_STEPS = 2
#: 19b and 19d's float32 checks start from a moment of some steps (seeded,
#: step MT_WARM_STEP): the first AdamW / Adafactor update is about sign(g)
#: lr, which turns a gradient at rounding level into a 2 lr jump
MT_WARM_STEP = 3


def mt_peak(cfg, cell) -> dict:
    from repro_torch.launch import dryrun
    return dryrun.mesh_train_memory(cfg, tp_desc(), cell)


def mt_depth(arch, cell) -> int:
    from repro_torch import configs
    from repro_torch.analysis.roofline import HBM_BYTES
    from repro_torch.launch import dryrun
    return dryrun.deepest_depth(
        configs.get(arch), lambda c: mt_peak(c, cell)["peak_bytes"],
        TP_CARD_SHARE * HBM_BYTES)


def mt_trainer(cfg, dev, m, data, optimizer, ckpt_dir=None, every=50):
    from repro_torch.models import build
    from repro_torch.train.trainer import Trainer
    model = build(cfg, backend="torch", device=dev, layout="train", mesh=m)
    return Trainer(model, data, ckpt_dir=ckpt_dir, ckpt_every=every,
                   optimizer=optimizer)


def mt_bf16(arch, cfg, cell, steps, opt, dev, m, profile=False) -> dict:
    """A bf16 model on the mesh at full width: ``steps`` steps (then a
    profiled one), the losses, norms and step ms, the collectives' host
    ms, its blocks of the gradients finite and nonzero, and its peak
    against the mesh dry run's."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import collectives

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = mt_trainer(cfg, dev, m, train_data(
        cfg, cell.seq_len, cell.global_batch), opt)
    trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = trainer.model
    collectives.reset()
    hist = trainer.run(steps, log_every=1)
    torch.cuda.synchronize()
    host_s, n_coll = collectives.seconds, len(collectives.records)
    peak = torch.cuda.max_memory_allocated() - base
    bad = [k for k, g in model.grads.items()
           if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0]
    res = dict(arch=arch, n_layers=cfg.n_layers, rank=dist.get_rank(),
               build_s=build_s, losses=[h["loss"] for h in hist],
               grad_norms=[h["grad_norm"] for h in hist],
               step_ms=step_ms(hist), bad_grads=bad,
               leaf_bytes=sum(t.numel() * 4 for t in model.leaves.values()),
               collectives_per_step=n_coll / steps,
               collective_host_ms_per_step=host_s * 1e3 / steps,
               peak_bytes=peak,
               predicted_peak_bytes=mt_peak(cfg, cell)["peak_bytes"])
    if profile:
        batch = to_device(trainer.data.batch_at(steps), dev)
        collectives.reset()
        res["profile"] = profile_steps(
            lambda: trainer.step_fn(trainer.state, batch), 1,
            plain_ms=res["step_ms"][-1])
        res["profile"]["collective_host_ms_per_step"] = \
            collectives.seconds * 1e3
        collectives.reset()
    del trainer, model
    free_card()
    return res


def mt_warm(opt, gen):
    """A seeded moment of some steps: every state tensor |N(0, 1)| 1e-3,
    drawn whole in the state's order."""
    def one(t):
        return torch.randn(t.shape, generator=gen, dtype=torch.float32,
                           device=gen.device).abs_().mul_(1e-3)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return one(tree)
    return walk(opt)


def mt_against_one_device(cfg, seq, batch_n, opt_name, dev, m) -> dict:
    """One float32 step of ``cfg`` on the mesh against the one-device step
    on the card, both from the seeded leaves and the seeded moment
    (``mt_warm``); the step's collectives against the mesh dry run's
    plan.  Rank 0 compares."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import dryrun
    from repro_torch.models import build, collectives
    from repro_torch.models.convert import gather_leaves
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import TrainState, make_train_step

    batch = to_device(train_data(cfg, seq, batch_n, seed=5).batch_at(0), dev)
    opt = opt_lib.make(opt_name, TRAIN_LR)

    def warm(model):
        o = opt_lib.for_model(opt, model)
        whole = o.whole_state if hasattr(o, "whole_state") else o.init(
            model.leaves)
        st = mt_warm(whole, torch.Generator(device=dev).manual_seed(7))
        if hasattr(o, "shardings"):
            st = opt_lib.tree_pair(st, o.shardings,
                                   lambda t, ns: ns.shard_of(t).clone())
        return o, TrainState(MT_WARM_STEP, model.leaves, st)

    model = build(cfg, backend="torch", device=dev, layout="train",
                  mesh=m).init(torch.Generator(device=dev).manual_seed(0))
    o, state = warm(model)
    collectives.reset()
    t0 = time.perf_counter()
    _, met = make_train_step(model, o, cfg.microbatches)(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    recs = list(collectives.records)
    collectives.reset()
    grads = gather_leaves(model, model.grads)
    leaves = gather_leaves(model)
    plan, _ = dryrun.mesh_train_step(cfg, ShapeCell("t", seq, batch_n,
                                                    "train"), tp_desc())
    from repro_torch.analysis import roofline
    mine = roofline.parse_collectives(collectives.hlo_text(recs))
    want = roofline.parse_collectives(collectives.hlo_text(plan))
    res = dict(arch=cfg.name, n_layers=cfg.n_layers, rank=dist.get_rank(),
               loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
               step_s=step_s,
               collectives=dict(op_counts=mine.op_counts,
                                operand_bytes=mine.operand_bytes),
               planned=dict(op_counts=want.op_counts,
                            operand_bytes=want.operand_bytes))
    del model, state, o
    free_card()
    if dist.get_rank() == 0:
        one = build(cfg, backend="torch", device=dev, layout="train").init(
            torch.Generator(device=dev).manual_seed(0))
        o1, s1 = warm(one)
        _, m1 = make_train_step(one, o1, cfg.microbatches)(s1, batch)
        res["one_device_loss"] = float(m1["loss"])
        res["loss_rel"] = abs(res["loss"] - float(m1["loss"])) / abs(
            float(m1["loss"]))
        res["grad_norm_rel"] = abs(res["grad_norm"] - float(
            m1["grad_norm"])) / float(m1["grad_norm"])
        res["grad_leaf_rel"] = max(leaf_rel(grads[k], g)
                                   for k, g in one.grads.items())
        rels = {k: leaf_rel(leaves[k], v) for k, v in one.leaves.items()}
        res["worst_leaf"] = max(rels, key=rels.get)
        res["updated_leaf_rel"] = rels[res["worst_leaf"]]
        del one, o1, s1
    del grads, leaves
    free_card()
    dist.barrier()
    return res


def _whole_state(trainer) -> dict:
    """A trainer's leaves and optimizer state, whole, on the host."""
    from repro_torch.train.checkpoint import flatten
    sh = trainer.shardings()
    out = {}
    for k, v in flatten(trainer.state).items():
        if not isinstance(v, torch.Tensor):
            continue
        ns = None if sh is None else flatten(sh).get(k)
        out[k] = (v if ns is None else ns.gather(v)).detach().cpu().clone()
    return out


def mt_small_trainer(where, dev, ckpt, mesh, every=2):
    """19c and 19e's trainer: the reduced stablelm-1.6b (float32) on
    ``mesh`` (None: one device), AdamW, seeded data; from seeded weights
    (``where`` "init") or restored from ``ckpt``."""
    from repro_torch import configs
    from repro_torch.train import optimizer as opt_lib
    cfg = configs.get(TRAIN_ARCH).reduced()
    t = mt_trainer(cfg, dev, mesh, train_data(cfg, 64, 4, 11),
                   opt_lib.make("adamw", TRAIN_LR), ckpt, every)
    if where == "init":
        t.init_state(torch.Generator(device=dev).manual_seed(0))
    else:
        t.restore_or_init()
    return t


def mt_checkpoint(dev, m, work: str) -> dict:
    """19c, on the reduced stablelm-1.6b (float32) under deterministic
    algorithms: a mesh trainer saves at step 2 (whole leaves, rank 0
    writes) and runs on; a one-device trainer restores the file, bit for
    bit, and saves its own; a fresh mesh trainer restores that, bit for
    bit, and takes step 3 as the trainer that never stopped did.  Then
    19e's preemption (``mt_preempt``) against the same state and loss."""
    import torch.distributed as dist

    prior = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    rank = dist.get_rank()
    try:
        def trainer(where, ckpt, mesh):
            return mt_small_trainer(where, dev, ckpt, mesh)
        a = trainer("init", f"{work}/mesh", m)
        a.run(2)
        saved = _whole_state(a)
        a.ckpt_dir = None
        la = a.run(3)[-1]["loss"]
        one_differ = []
        if rank == 0:
            c = trainer("restore", f"{work}/mesh", None)
            got = _whole_state(c)
            one_differ = [k for k, v in saved.items()
                          if not torch.equal(got[k], v)]
            c.ckpt_dir = f"{work}/one"
            c.save()
            del c
        dist.barrier()
        b = trainer("restore", f"{work}/one", m)
        got = _whole_state(b)
        mesh_differ = [k for k, v in saved.items()
                       if not torch.equal(got[k], v)]
        b.ckpt_dir = None
        lb = b.run(3)[-1]["loss"]
        del a, b
        preempt = mt_preempt(dev, m, f"{work}/preempt", saved, la)
    finally:
        torch.use_deterministic_algorithms(False)
        if prior is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior
    return dict(rank=rank, arrays=len(saved), one_device_differ=one_differ,
                mesh_differ=mesh_differ, loss_uninterrupted=la,
                loss_restored=lb, preempt=preempt)


def mt_preempt(dev, m, ckpt: str, saved: dict, loss3: float) -> dict:
    """19e, the preemption: 19c's mesh trainer asked for 3 steps, whose
    rank 1 alone sends itself a real SIGTERM from its data's
    ``batch_at`` during step 2 (after step 1's vote).  Returns what it
    raised, the checkpoints written, the arrays that differ from 19c's
    uninterrupted state at step 2 (``saved``), and the step-3 loss of a
    mesh trainer restored from the checkpoint beside 19c's (``loss3``)."""
    import signal

    import numpy as np
    import torch.distributed as dist

    rank = dist.get_rank()
    t = mt_small_trainer("init", dev, ckpt, m, every=50)
    if rank == 1:
        batch_at = t.data.batch_at

        def signalled(step):
            if step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return batch_at(step)
        t.data.batch_at = signalled
    raised = None
    t0 = time.perf_counter()
    try:
        t.run(3)
    except KeyboardInterrupt as exc:
        raised = str(exc)
    run_s = time.perf_counter() - t0
    files = sorted(os.listdir(ckpt))
    res = dict(rank=rank, raised=raised, step=t.state.step, files=files,
               run_s=run_s, loss_uninterrupted=loss3,
               differ=["no checkpoint at step 2"], restored_step=None,
               loss_restored=None)
    del t
    if "ckpt_00000002.npz" in files:
        with np.load(f"{ckpt}/ckpt_00000002.npz") as z:
            res["differ"] = [k for k, v in saved.items()
                             if k not in z.files
                             or not np.array_equal(z[k], v.numpy())]
        r = mt_small_trainer("restore", dev, ckpt, m)
        r.ckpt_dir = None
        res["restored_step"] = r.state.step
        res["loss_restored"] = r.run(3)[-1]["loss"]
        del r
    free_card()
    return res


#: 19e: the host memory a rank may add to a save or restore beyond two
#: whole arrays (a gather's received blocks and their concatenation)
MT_HOST_SLACK = 0.5e9


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class HostGrowth:
    """The most this process's resident set grew above its size at entry
    while the block ran: ``/proc/self/statm`` sampled every 5 ms by a
    thread (``ru_maxrss`` keeps earlier phases' high-water mark)."""

    def __enter__(self):
        gc.collect()
        self.base = self.most = _rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        self.t0 = time.perf_counter()
        return self

    def _sample(self):
        while not self._stop.wait(0.005):
            self.most = max(self.most, _rss())

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self._stop.set()
        self._thread.join()
        self.most = max(self.most, _rss())
        self.bytes = self.most - self.base


def mt_memory(dev, m, work: str) -> dict:
    """19e, the host memory: the 2-layer cut (float32, AdamW) at its
    init, saved from the mesh (rank 0 writes) and restored onto a fresh
    mesh trainer; each rank's host growth during each call, its largest
    whole array (leaf or optimizer state), and the file's bytes."""
    import torch.distributed as dist
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import optimizer as opt_lib

    cfg = cut_config("float32")
    ckpt = f"{work}/memory"

    def trainer():
        return mt_trainer(cfg, dev, m, train_data(cfg, CUT_SEQ, CUT_BATCH),
                          opt_lib.make("adamw", TRAIN_LR), ckpt, 1 << 30)
    t = trainer()
    t.init_state(torch.Generator(device=dev).manual_seed(0))
    whole = dict(ckpt_lib.flatten(t.optimizer.whole_state), **{
        k: torch.empty(s, dtype=t.model.leaves[k].dtype, device="meta")
        for k, s in t.model.leaf_shapes.items()})
    largest = max(v.numel() * v.element_size() for v in whole.values())
    with HostGrowth() as save:
        t.save()
    state_bytes = sum(v.numel() * v.element_size() for v in whole.values())
    del t
    free_card()
    r = trainer()
    with HostGrowth() as restore:
        r.restore_or_init()
    step = r.state.step
    del r
    free_card()
    res = dict(rank=dist.get_rank(), writer=m.coordinate("model") == 0,
               n_layers=cfg.n_layers, largest_bytes=largest,
               state_bytes=state_bytes, step=step,
               file_bytes=os.path.getsize(f"{ckpt}/ckpt_00000000.npz"),
               save_bytes=save.bytes, save_s=save.seconds,
               restore_bytes=restore.bytes, restore_s=restore.seconds,
               bound_bytes=2 * largest + MT_HOST_SLACK)
    dist.barrier()
    return res


def mt_rank(dev_name: str, plan: dict) -> list:
    """Phase 19 on every rank of the 2-rank pool (mesh (1, 2))."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh as tmesh
    from repro_torch.train import optimizer as opt_lib

    dev = torch.device(dev_name)
    m = tmesh.device_mesh(TP_SIZES, device=dev.type)
    res = {"rank": dist.get_rank()}
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=MT_DEPTH)
    res["full"] = mt_bf16(TRAIN_ARCH, cfg, ShapeCell(
        "train", TRAIN_SEQ, TRAIN_BATCH, "train"), MT_STEPS,
        opt_lib.make("adamw", TRAIN_LR), dev, m, profile=True)
    res["f32"] = mt_against_one_device(cut_config("float32"), CUT_SEQ,
                                       CUT_BATCH, "adamw", dev, m)
    res["ckpt"] = mt_checkpoint(dev, m, plan["work"])
    res["memory"] = mt_memory(dev, m, plan["work"])
    full = configs.get(MOE_TRAIN_ARCH)
    moe = dataclasses.replace(full, n_layers=plan["moe_depth"])
    res["moe"] = mt_bf16(MOE_TRAIN_ARCH, moe, ShapeCell(
        "train", MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, "train"), MT_MOE_STEPS,
        opt_lib.make(moe.optimizer, moe.learning_rate), dev, m)
    res["moe_f32"] = mt_against_one_device(full.reduced(), 16, 4,
                                           "adafactor", dev, m)
    res["seconds"] = time.perf_counter() - t0
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, res)
    return out


def mt_require_f32(r: dict) -> None:
    require(r["collectives"]["op_counts"] == r["planned"]["op_counts"]
            and r["collectives"]["operand_bytes"]
            == r["planned"]["operand_bytes"],
            f"{r['arch']} rank {r['rank']}: collectives {r['collectives']} "
            f"!= the mesh dry run's {r['planned']}")
    if r["rank"] != 0:
        return
    require(r["loss_rel"] <= CPU_LOSS_RTOL, f"mesh vs one device: {r}")
    require(r["grad_norm_rel"] <= CPU_GRAD_RTOL
            and r["grad_leaf_rel"] <= CPU_GRAD_RTOL
            and r["updated_leaf_rel"] <= CPU_LEAF_RTOL,
            f"mesh vs one device: {r}")


def _share(v) -> str:
    """A busy share as printed: "not measured" (or None) as it is."""
    return v if v is None or isinstance(v, str) else f"{v:.3f}"


def mt_require_preempt(ranks: list) -> None:
    """19e's readings, printed, and its checks."""
    for r in (x["ckpt"]["preempt"] for x in ranks):
        print(f"  preemption, rank {r['rank']} (a SIGTERM to rank 1 alone "
              f"during step 2): raised {r['raised']!r} at step {r['step']} "
              f"after {r['run_s']:.1f} s; files {r['files']}; arrays "
              f"differing from the uninterrupted step-2 state "
              f"{len(r['differ'])}; restored at step {r['restored_step']}, "
              f"step 3 loss uninterrupted {r['loss_uninterrupted']!r}, "
              f"restored {r['loss_restored']!r}")
        require(r["raised"] == "preempted; emergency ckpt saved"
                and r["step"] == 2, f"preemption: {r}")
        require(r["files"] == ["ckpt_00000002.npz", "latest"],
                f"preemption: checkpoints {r['files']}")
        require(not r["differ"] and r["restored_step"] == 2
                and r["loss_restored"] == r["loss_uninterrupted"],
                f"preemption: the checkpoint or its restart differs: {r}")
    for r in (x["memory"] for x in ranks):
        who = "writes" if r["writer"] else "does not write"
        print(f"  host memory, rank {r['rank']} ({who}), {TRAIN_ARCH} at "
              f"{r['n_layers']} layers, float32 + AdamW "
              f"({r['state_bytes'] / 1e9:.3f} GB of whole arrays, the "
              f"largest {r['largest_bytes'] / 1e9:.3f} GB; file "
              f"{r['file_bytes'] / 1e9:.3f} GB): growth during the save "
              f"{r['save_bytes'] / 1e9:.3f} GB in {r['save_s']:.1f} s, "
              f"during the restore {r['restore_bytes'] / 1e9:.3f} GB in "
              f"{r['restore_s']:.1f} s; bound 2 x largest + "
              f"{MT_HOST_SLACK / 1e9:.1f} GB = {r['bound_bytes'] / 1e9:.3f} "
              f"GB")
        require(r["writer"] or r["save_bytes"] <= r["bound_bytes"],
                f"host memory: rank {r['rank']} grew "
                f"{r['save_bytes'] / 1e9:.3f} GB during a save it does not "
                f"write")
        require(r["restore_bytes"] <= r["bound_bytes"] and r["step"] == 0,
                f"host memory: rank {r['rank']} grew "
                f"{r['restore_bytes'] / 1e9:.3f} GB during the restore")
    require(sum(x["memory"]["writer"] for x in ranks) == 1,
            "host memory: not one writer")


def mesh_train(dev) -> dict:
    """Phase 19: training on 2 ranks sharing the card."""
    from repro_torch import configs
    from repro_torch import ranks as rank_lib
    from repro_torch.configs.base import ShapeCell

    t0 = time.perf_counter()
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)
    free_card()
    cell = ShapeCell("train", MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, "train")
    depth = mt_depth(MOE_TRAIN_ARCH, cell)
    work = tempfile.TemporaryDirectory()
    plan = {"moe_depth": max(1, depth), "work": work.name}
    print(f"  {MOE_TRAIN_ARCH}: {plan['moe_depth']} of "
          f"{configs.get(MOE_TRAIN_ARCH).n_layers} layers (the mesh train "
          f"dry run's deepest whose per-rank peak fits {TP_CARD_SHARE:.2f} "
          f"of the card: {depth})")
    rank_lib.share_devices(TP_SIZES[1])
    try:           # the pool of phases 17-18
        ranks = rank_lib.rank_pool(TP_SIZES[1], dev).run("chip_smoke:mt_rank",
                                                         dev.type, plan)
    finally:
        rank_lib.close_pool()
        work.cleanup()
        free_card()
    for key in ("full", "moe"):
        rs = [r[key] for r in ranks]
        for r in rs:
            pr = r.get("profile", {})
            busy = pr.get("unprofiled_busy_share")
            print(f"  {r['arch']} ({r['n_layers']} layers) rank {r['rank']}: "
                  f"built in {r['build_s']:.1f} s, {r['leaf_bytes'] / 1e9:.3f}"
                  f" GB of float32 leaves; losses {r['losses']}, grad norms "
                  f"{r['grad_norms']}, step ms "
                  f"{[round(x, 1) for x in r['step_ms']]}; collectives "
                  f"{r['collectives_per_step']:.0f} a step, host ms a step "
                  f"{r['collective_host_ms_per_step']:.1f}"
                  + (f"; a profiled step {pr['wall_ms_per_step']:.1f} ms, "
                     f"device busy {_share(pr['device_busy_share'])} of it "
                     f"and {_share(busy)} of the "
                     f"unprofiled step, collectives' host ms "
                     f"{pr['collective_host_ms_per_step']:.1f}" if pr else "")
                  + f"; memory, mesh train {r['arch']} rank {r['rank']}: "
                  f"mesh dry run {r['predicted_peak_bytes'] / 1e9:.3f} GB, "
                  f"max_memory_allocated {r['peak_bytes'] / 1e9:.3f} GB")
            require(all(math.isfinite(x) for x in r["losses"]
                        + r["grad_norms"]), f"{key}: not finite: {r}")
            require(not r["bad_grads"], f"{key} rank {r['rank']}: gradient "
                    f"blocks not finite or all zero: {r['bad_grads']}")
            require(r["peak_bytes"] <= r["predicted_peak_bytes"],
                    f"{key} rank {r['rank']}: peak {r['peak_bytes'] / 1e9:.2f}"
                    f" GB over the mesh dry run's "
                    f"{r['predicted_peak_bytes'] / 1e9:.2f}")
        require(rs[0]["losses"] == rs[1]["losses"]
                and rs[0]["grad_norms"] == rs[1]["grad_norms"],
                f"{key}: the ranks' losses or norms differ")
        MEMORY.extend(dict(run=f"mesh train {r['arch']} rank {r['rank']}",
                           predicted_bytes=r["predicted_peak_bytes"],
                           measured_bytes=r["peak_bytes"],
                           measured_over_predicted=r["peak_bytes"]
                           / r["predicted_peak_bytes"]) for r in rs)
    for key in ("f32", "moe_f32"):
        for r in (x[key] for x in ranks):
            line = (f"  float32 {r['arch']} ({r['n_layers']} layers) rank "
                    f"{r['rank']}: a step on the mesh in {r['step_s']:.2f} s;"
                    f" collectives {r['collectives']['op_counts']} "
                    f"{r['collectives']['operand_bytes'] / 1e6:.3f} MB "
                    f"(planned {r['planned']['op_counts']} "
                    f"{r['planned']['operand_bytes'] / 1e6:.3f} MB)")
            if r["rank"] == 0:
                line += (f"; against one device: loss rel "
                         f"{r['loss_rel']:.2e}, grad norm rel "
                         f"{r['grad_norm_rel']:.2e}, gradient leaves up to "
                         f"{r['grad_leaf_rel']:.2e}, updated leaves up to "
                         f"{r['updated_leaf_rel']:.2e} ({r['worst_leaf']})")
            print(line)
            mt_require_f32(r)
        require(ranks[0][key]["loss"] == ranks[1][key]["loss"],
                f"{key}: the ranks' losses differ")
    for r in (x["ckpt"] for x in ranks):
        print(f"  checkpoint, rank {r['rank']}: {r['arrays']} arrays; the "
              f"one-device restore differs in {len(r['one_device_differ'])},"
              f" the mesh restore in {len(r['mesh_differ'])}; step 3 loss "
              f"uninterrupted {r['loss_uninterrupted']!r}, restored "
              f"{r['loss_restored']!r}")
        require(not r["one_device_differ"] and not r["mesh_differ"],
                f"checkpoint round trip differs: {r}")
        require(r["loss_uninterrupted"] == r["loss_restored"],
                f"the restored loss differs: {r}")
    mt_require_preempt(ranks)
    return dict(moe_depth=plan["moe_depth"], dryrun_depth=depth, ranks=ranks,
                seconds=time.perf_counter() - t0)


def turn_prefills(arch: str, seed: int, dev) -> list:
    """Full-width ``arch`` with the weights its served check uses (seeded
    ``seed``), one prefill a served prompt: the kernel path's last
    logits against the plain path's (relative error, same argmax), the
    median wall ms of 5 prefills and one profiled prefill's device ms,
    all kernels' and the flash kernels'."""
    from repro_torch import configs
    from repro_torch.models import build

    cfg = configs.get(arch)
    model = build(cfg, backend="auto", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    out = []
    for p in make_prompts(cfg.vocab):
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        g, w = (last_logits(model, b, batch, None) for b in ("cuda", "torch"))
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        kernels = prefill_kernels(model, batch, None)
        out.append(dict(
            S=len(p), rel_err=rel_err(g, w),
            same_argmax=int(g.argmax()) == int(w.argmax()),
            wall_ms=statistics.median(walls),
            device_ms=sum(kernels.values()) if kernels else "not measured",
            flash_ms=(sum(v for k, v in kernels.items() if "flash" in k)
                      if kernels else "not measured")))
    del model
    free_card()
    return out


def flash_turn(args: list) -> int:
    """One turn of a comparison call on the flash routes.  ``args``:
    ``[ROOT] [-DNAME=VALUE ...]``.  The package under ``ROOT/src`` (this
    checkout's by default) builds its flash source with those nvcc
    defines added, times its kernels at SM90_ROWS and WIDE_ROWS (bf16)
    and F32_ROWS (float32) beside the library call
    (``flash_timing``: L2 flushed, the median of 15; each row names the
    kernel that served it), and prefills full-width stablelm-1.6b and
    llama3.2-3b with the weights of their served checks (phase 4's and
    the gateway's) at every served prompt (``turn_prefills``).  Prints
    the card's line and one
    ``{"flash_turn": ...}`` line.  Run each turn in a process of its own
    (parent, change, change, parent): the package is imported once."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    defines = [a for a in args if a.startswith("-D")]
    roots = [a for a in args if not a.startswith("-D")]
    require(len(roots) <= 1, f"--flash-turn takes one ROOT, got {roots}")
    root = Path(roots[0]).resolve() if roots else ROOT
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    require(Path(fa.__file__).is_relative_to(root / "src"),
            f"imported {fa.__file__}, not the package under {root}")
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, *defines)
    t0 = time.perf_counter()
    _build.load("flash_attention")
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(dev)
    rows = {k or "stablelm": flash_timing(fa, timer, gen, dev, *shape)
            for k, shape in {**SM90_ROWS, **WIDE_ROWS}.items()}
    rows.update({k or "f32": flash_timing(fa, timer, gen, dev, *shape)
                 for k, shape in F32_ROWS.items()})
    prefills = {arch: turn_prefills(arch, seed, dev)
                for arch, seed in (("stablelm-1.6b", 0), ("llama3.2-3b", 1))}
    print(card_line())
    print(json.dumps({"flash_turn": dict(
        root=str(root), defines=defines, build_s=build_s, rows=rows,
        prefills=prefills)}))
    return 0


#: ``--s1``'s depth: recurrentgemma-9b at 20 of its 38 layers, where phase
#: 9's verdict refused the 8-token prompt (PERF.md §6) while all 38 pass
S1_LAYERS = 20


def s1_paths(model, fa, batch) -> dict:
    """One prefill of ``batch`` on each path, as ``(last-position logits,
    [every block's output])``, all float32: ``cuda`` (the kernels),
    ``torch`` (the plain path), ``ref`` (the oracle) and ``mixed`` (the
    kernels, with the flash kernel, the local layers' attention, replaced
    by its plain version).  ``calls`` holds the plain path's attention
    inputs, one entry a local layer."""
    plain_attn = fa.attention_torch
    hidden, calls = [], []
    hooks = [layer.register_forward_hook(
        lambda _m, _i, out: hidden.append(out[0].float().clone()))
        for layer in model.layers]

    def recording(q, k, v, *, causal=True, window=None, block_kv=1024):
        calls.append((q.clone(), k.clone(), v.clone(), causal, window))
        return plain_attn(q, k, v, causal=causal, window=window,
                          block_kv=block_kv)

    def plain_for_kernel(q, k, v, *, causal=True, window=None):
        return plain_attn(q, k, v, causal=causal, window=window)

    out = {}
    try:
        for name in ("cuda", "torch", "ref", "mixed"):
            hidden.clear()
            before = fa.launches
            if name == "mixed":
                with swapped(fa, "flash_attention", plain_for_kernel):
                    logits = last_logits(model, "cuda", batch, None)
            elif name == "torch":
                with swapped(fa, "attention_torch", recording):
                    logits = last_logits(model, "torch", batch, None)
            else:
                logits = last_logits(model, name, batch, None)
            torch.cuda.synchronize()
            out[name] = dict(logits=logits.float(), hidden=list(hidden),
                             flash_launches=fa.launches - before)
    finally:
        for h in hooks:
            h.remove()
    out["calls"] = calls
    return out


def s1_check(args: list) -> int:
    """recurrentgemma-9b at full width, S1_LAYERS layers, phase 9's seeded
    weights (``build_recurrent``: PERTURBED filled) and its 8-token
    prompt.  bf16: every block's output (the residual stream) on the
    kernel, oracle and mixed paths (``s1_paths``) against the plain path,
    relative error layer by layer, and phase 9's verdict on the logits;
    each local layer's attention on the plain path's own inputs, the
    kernel's and the plain version's output against float64.  float32:
    the same depth, kernel path against plain path at every served
    recurrentgemma-9b prompt (E2E_F32_REL_TOL, same argmax: fatal), and
    layer by layer at 8 tokens.  Prints the card's line and one ``{"s1":
    ...}`` line."""
    require(not args, f"--s1 takes no arguments, got {args}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    full = configs.get("recurrentgemma-9b")
    prompts = make_prompts(full.vocab, RG_PROMPT_LENS)
    batch = {"token_ids": torch.as_tensor(prompts[0][None], device=dev)}
    result = {"n_layers": f"{S1_LAYERS} of {full.n_layers}",
              "S": len(prompts[0])}

    cfg = dataclasses.replace(full, n_layers=S1_LAYERS)
    model = build_recurrent(cfg, "auto", dev)
    paths = s1_paths(model, fa, batch)
    plain = paths["torch"]
    layers = []
    for i, kind in enumerate(cfg.layer_kinds):
        row = {"layer": i, "kind": kind}
        for name in ("cuda", "ref", "mixed"):
            row[name] = rel_err(paths[name]["hidden"][i], plain["hidden"][i])
        layers.append(row)
        print(f"  bf16 layer {i:2d} ({kind:5s}): residual stream rel err vs "
              f"plain: kernel {row['cuda']:.3e}, oracle {row['ref']:.3e}, "
              f"mixed {row['mixed']:.3e}")
    logits = {name: rel_err(paths[name]["logits"], plain["logits"])
              for name in ("cuda", "ref", "mixed")}
    v = argmax_verdict(paths["cuda"]["logits"], plain["logits"],
                       {"oracle": paths["ref"]["logits"]})
    launched = {n: paths[n]["flash_launches"] for n in ("cuda", "mixed")}
    print(f"  bf16 logits rel err vs plain: kernel {logits['cuda']:.3e}, "
          f"oracle {logits['ref']:.3e}, mixed {logits['mixed']:.3e}; "
          f"flash launches {launched}; verdict: {verdict_line(v)}")
    attention = []
    for i, (q, k, v_, causal, window) in enumerate(paths["calls"]):
        ref = attention_f64(q, k, v_, window, causal)
        got = fa.flash_attention(q, k, v_, causal=causal, window=window)
        want = fa.attention_torch(q, k, v_, causal=causal, window=window)
        torch.cuda.synchronize()
        row = dict(call=i, kernel=fa.kernel_for(q.dtype, q.shape[-1]),
                   kernel_f64=rel_err(got.double(), ref),
                   plain_f64=rel_err(want.double(), ref),
                   kernel_plain_max_abs=float((got.float() - want.float())
                                              .abs().max()),
                   kernel_plain_differ=float((got != want).float().mean()))
        attention.append(row)
        print(f"  local attention {i:2d} on the plain path's inputs "
              f"({row['kernel']}): rel err vs float64 kernel "
              f"{row['kernel_f64']:.3e}, plain {row['plain_f64']:.3e}; "
              f"kernel vs plain max |Δ| {row['kernel_plain_max_abs']:.3e}, "
              f"elements that differ {row['kernel_plain_differ']:.4f}")
    result["bf16"] = dict(layers=layers, logits_rel_err=logits,
                          verdict=v, attention=attention,
                          flash_launches=launched)
    del model, paths, plain
    free_card()

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                kv_cache_dtype="float32")
    model = build_recurrent(cfg32, "cuda", dev)
    rels, same = [], []
    for p in prompts:
        b = {"token_ids": torch.as_tensor(p[None], device=dev)}
        g = last_logits(model, "cuda", b, None)
        w = last_logits(model, "torch", b, None)
        rels.append(rel_err(g, w))
        same.append(int(g.argmax()) == int(w.argmax()))
        print(f"  f32 S={len(p)}: kernel-vs-plain logits rel err "
              f"{rels[-1]:.3e}, same argmax {same[-1]}")
    hidden = {}
    for name in ("cuda", "torch"):
        got = []
        hooks = [layer.register_forward_hook(
            lambda _m, _i, out: got.append(out[0].clone()))
            for layer in model.layers]
        try:
            last_logits(model, name, batch, None)
        finally:
            for h in hooks:
                h.remove()
        hidden[name] = got
    f32_layers = [rel_err(a, b) for a, b in zip(hidden["cuda"],
                                                hidden["torch"])]
    print(f"  f32 residual stream rel err by layer, kernel vs plain, S=8: "
          + ", ".join(f"{e:.2e}" for e in f32_layers))
    result["f32"] = dict(prompt_lens=list(RG_PROMPT_LENS),
                         logits_rel_err=rels, same_argmax=same,
                         layers=f32_layers)
    del model, hidden
    free_card()
    print(card_line())
    print(json.dumps({"s1": result}))
    require(all(same), "f32: the kernel path's argmax differs")
    require(max(rels) <= E2E_F32_REL_TOL,
            f"f32: rel err {max(rels)} > {E2E_F32_REL_TOL}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    host = HostWork()
    try:
        return run_phases(host)
    finally:
        host.close()


def run_phases(host) -> int:
    """``main``'s phases, ``host`` the host-work process beside them."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6 as rk
    from repro_torch.kernels import search as se
    from repro_torch.kernels import slowdown as sd
    from repro_torch.kernels import stream as st
    from repro_torch.profiling import probes
    from repro_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    phase_s = {}
    t_phase = time.perf_counter()

    def phase(name, number=None):
        """Close the running phase (its seconds) and start ``name``, the
        docstring's phase ``number`` (phase 20 runs after phase 14)."""
        nonlocal t_phase
        now = time.perf_counter()
        if phase_s:
            last = list(phase_s)[-1]
            phase_s[last] = now - t_phase
            print(f"  ({last}: {phase_s[last]:.1f} s)")
        t_phase = now
        if name is not None:
            phase_s[name] = None
            print(f"[{number}/{PHASES}] {name}")

    phase("environment", 1)
    print(f"  card: {card_line()}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase("build: one nvcc per source started, all at once", 2)
    t0 = time.perf_counter()
    built = {}

    def build(name):
        _build.load(name)
        built[name] = time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(KERNEL_SOURCES))
    builds = [pool.submit(build, name) for name in KERNEL_SOURCES]
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)}: {len(KERNEL_SOURCES)} "
          f"sources; phase 16 trains on the card while they build (it "
          f"launches no kernel of these)")
    # phase 16 needs no kernel of these (it trains on the torch backend)
    phase("train: stablelm-1.6b (AdamW) and dbrx-132b (Adafactor)", 16)
    trained = train(fa, da, dev)
    free_card()
    phase("build: the seven kernels joined", 2)
    t1 = time.perf_counter()
    for f in builds:
        f.result()
    pool.shutdown()
    build_s = max(built.values())
    print(f"  {len(KERNEL_SOURCES)} kernels built in {build_s:.1f} s "
          f"(each source's seconds: "
          f"{ {k: round(v, 1) for k, v in built.items()} }), "
          f"{time.perf_counter() - t1:.1f} s of them after phase 16")
    ptxas = {row: ptxas_rows(_build, name)
             for row, name in (("flash_attention", "flash_attention"),
                               ("decode_attention", "decode_attention"),
                               ("rwkv6_scan", "rwkv6"),
                               ("rglru_scan", "rglru"),
                               ("piecewise_slowdown", "slowdown"))}
    for name, rows in ptxas.items():
        for kernel, line in rows.items():
            print(f"  ptxas {name}: {kernel}: {line}")
    sm90 = sm90_sass(_build)
    print(f"  SASS flash_sm90 and flash_sm90_f32: {sm90}")

    mods = {"flash_attention": fa, "decode_attention": da,
            "rglru_scan": rg, "rwkv6_scan": rk}

    phase("kernels vs plain versions", 3)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = flash_checks(fa, gen, dev) + decode_checks(da, gen, dev)
    n += split_pass_checks(da, gen, dev)
    slowdown_checks(sd, gen, dev)
    n += 6 + select_checks(se, gen, dev)
    n += stream_checks(st, gen, dev)
    n += scan_checks(rg, gen, dev) + rwkv_checks(rk, gen, dev)
    timer = Timer(dev)
    # the orin fixture's search: 4096 chains x 2 workloads x 32 groups
    kernels = [time_flash(fa, timer, gen, dev),
               time_flash_f32(fa, timer, gen, dev),
               *time_reduced(fa, timer, gen, dev),
               time_decode(da, timer, gen, dev),
               time_slowdown(sd, timer, gen, dev, n=4096 * 2),
               time_select(se, timer, gen, dev, P=4096, L=2 * 32),
               time_stream(st, probes, timer, dev),
               time_rglru(rg, timer, gen, dev),
               time_rwkv6(rk, timer, gen, dev)]
    kernels += time_split_pass(da, timer, gen, dev)
    floor_ms = launch_floor(timer, dev)
    print(f"  timer launch floor (one-element add_, as every row is "
          f"timed): {floor_ms:.4f} ms")
    for kr in kernels:
        if kr["name"] in REDUCED_ROWS:
            kr["launch_floor_ms"] = floor_ms
    for kr in kernels:
        for row in [kr] + [v for k, v in kr.items() if k.startswith("at_")]:
            lib = ("none" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms")
            parent = ("" if "parent_ms" not in row
                      else f" [parent {row['parent_ms']:.4f} ms]")
            served = f" ({row['kernel']})" if "kernel" in row else ""
            tf32 = ("" if "bound_cuda_cores_ms" not in row else
                    (" at three TF32 products, CUDA cores' bound "
                     f"{row['bound_cuda_cores_ms']:.4f} ms "
                     f"({row['bound_cuda_cores_by']})"
                     if row["kernel"] == "flash_sm90_f32" else "")
                    + f"; against float64 {row['f64_err']:.3e}, plain "
                    f"{row['plain_f64_err']:.3e}")
            print(f"  {kr['name']} at {row['shape']}{served}: "
                  f"{row['ms']:.4f} ms{parent}, plain {row['plain_ms']:.4f} "
                  f"ms, library {lib}, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}){tf32}")
    print(f"  {n} comparisons passed")

    phase("serve full-width stablelm-1.6b (CUDA graph, then eager)", 4)
    result = serve(fa, da, dev)
    phase("float32 end to end, kernel path vs plain path", 5)
    result["e2e_f32"] = e2e_f32(dev)
    phase("reduced configs on the card (head size 16, float32)", 6)
    reduced = serve_reduced(mods, dev)
    phase("schedule search under PCCS on the golden fixtures", 7)
    found = search(sd, se, dev, host)
    phase("characterize full-width stablelm-1.6b (prefill, decode), "
          "calibrate, solve", 8)
    work = tempfile.TemporaryDirectory()
    bundle_path = Path(work.name) / "stablelm-1.6b.json"
    measured = characterize(fa, da, sd, se, st, bundle_path)
    measured["decode"] = characterize(
        fa, da, sd, se, st, Path(work.name) / "stablelm-1.6b-decode.json",
        kind="decode")
    torch.cuda.empty_cache()
    phase("serve full-width rwkv6-7b and recurrentgemma-9b", 9)
    recurrent = {}
    for arch in ("rwkv6-7b", "recurrentgemma-9b"):
        recurrent[arch] = serve_recurrent(arch, mods, dev)
        torch.cuda.empty_cache()
    phase("float32 end to end on both recurrent models", 10)
    for arch in ("rwkv6-7b", "recurrentgemma-9b"):
        recurrent[arch]["e2e_f32"] = e2e_f32_recurrent(arch, dev)
    torch.cuda.empty_cache()
    phase("gateway: full-width stablelm-1.6b + llama3.2-3b on one card", 11)
    served = gateway(fa, da, dev, bundle_path)
    phase("fleet: pool solved on the card, trace replayed", 12)
    replayed = fleet(sd, se, bundle_path)
    work.cleanup()
    free_card()
    phase("serve full-width dbrx-132b and qwen3-moe-235b-a22b, depth cut "
          "to the dry run's", 13)
    MOE_LAYERS.update(moe_layers())
    print(f"  depths, the dry run's for 4 slots of {MOE_CAPACITY}: "
          f"{MOE_LAYERS} (PR 21's by hand: {MOE_LAYERS_PR21})")
    moe_served = {arch: serve_moe(arch, mods, dev) for arch in MOE_LAYERS}
    phase("MoE in float32: the block against a per-expert oracle, and "
          "end to end", 14)
    for arch in MOE_LAYERS:
        moe_served[arch]["block_oracle"] = moe_block_oracle(arch, dev)
        moe_served[arch]["e2e_f32"] = e2e_f32_moe(arch, dev)
    phase("serve qwen1.5-32b, nemotron-4-15b, internvl2-2b; "
          "hubert-xlarge's encoder", 20)
    sliced = card_slice(mods, dev)
    phase("dry run: every architecture and shape on one card", 15)
    planned = dryrun_phase(host)
    phase("several ranks on the card: the ring search, the expert-parallel "
          "MoE block, --devices 2, a checkpoint on a mesh", 17)
    ranks = multidevice(fa, sd, se, dev)
    phase("tensor-parallel serving on 2 ranks sharing the card: "
          "llama3.2-3b, recurrentgemma-9b, rwkv6-7b, dbrx-132b", 18)
    tp = tensor_parallel(dev)
    phase("training on 2 ranks sharing the card: ZeRO-3 stablelm-1.6b, "
          "FSDP-TP dbrx-132b, a checkpoint, a preemption", 19)
    mt = mesh_train(dev)
    phase(None)

    tp_llama = tp["ranks"][0]["llama"]["launches"]
    launches = dict(result["launches"], **found["orin_x64_cuda"]["launches"],
                    decode_attention_partials=tp_llama[
                        "decode_attention_partials"],
                    decode_attention_combine=tp_llama[
                        "decode_attention_combine"],
                    stream=measured["launches"]["stream"],
                    rglru_scan=recurrent["recurrentgemma-9b"]["launches"][
                        "rglru_scan"],
                    rwkv6_scan=recurrent["rwkv6-7b"]["launches"][
                        "rwkv6_scan"],
                    flash_sm90_f32=measured["launches"]["flash_attention"],
                    # phase 6: the reduced configs (head size 16) in
                    # float32, and reduced stablelm-1.6b in bf16
                    **{kernel: sum(
                        r["launches"]["flash_attention"]
                        for r in reduced.values()
                        if isinstance(r, dict) and r.get("kernel") == kernel)
                       for kernel in REDUCED_ROWS})
    for kr in kernels:
        kr["launches"] = launches[kr["name"]]
        if kr["name"] in ptxas:
            kr["ptxas"] = ptxas[kr["name"]]
    kernels[0]["sass_flash_sm90"] = sm90
    # every float32 flash launch at head size 64, 80, 128 or 256 is
    # flash_sm90_f32's (route by dtype and head size alone; the profiles
    # of phases 5, 10 and 20 show it): the characterization's (float32
    # operands, heads of 64), and the float32 end-to-end phases'
    f32 = next(kr for kr in kernels if kr["name"] == "flash_sm90_f32")
    rg32 = recurrent["recurrentgemma-9b"]["e2e_f32"]
    enc = sliced[ENCODER_ARCH]
    f32["launches_by_path"] = {
        "characterize": measured["launches"]["flash_attention"],
        **{f"float32 end to end {name}": run["flash"]["launches"]
           for name, run in (("stablelm-1.6b", result["e2e_f32"]),
                             ("llama3.2-3b", served["llama_e2e_f32"]))},
        **{f"float32 end to end {arch} ({r['e2e_f32']['reduced']['n_layers']}"
           f" layers)": r["e2e_f32"]["flash"]["launches"]
           for arch, r in moe_served.items()},
        **{f"float32 end to end {arch} ({sliced[arch]['e2e_f32']['n_layers']}"
           f" layers)": sliced[arch]["e2e_f32"]["flash"]["launches"]
           for arch in SLICE_ARCHS},
        f"float32 end to end recurrentgemma-9b ({rg32['n_layers']} "
        f"layers)": rg32["flash"]["launches"],
        f"float32 encode {ENCODER_ARCH} ({enc['f32']['n_layers']} layers)":
            enc["f32"]["launches"]}
    for name in ("flash_attention", "decode_attention"):
        row = next(kr for kr in kernels if kr["name"] == name)
        row["launches_by_path"] = {
            "serve stablelm-1.6b": result["launches"][name],
            "serve recurrentgemma-9b":
                recurrent["recurrentgemma-9b"]["launches"][name],
            **({} if name == "flash_attention" else
               {"characterize": measured["launches"][name]}),
            "characterize decode": measured["decode"]["launches"][name],
            "gateway stablelm-1.6b + llama3.2-3b":
                served["launches"][name],
            **{f"serve {arch} ({r['reduced']['n_layers']} layers)":
               r["launches"][name] for arch, r in moe_served.items()},
            **{f"serve {arch} ({sliced[arch]['n_layers']} layers)":
               sliced[arch]["launches"][name] for arch in SLICE_ARCHS}}
        if name == "flash_attention":
            row["launches_by_path"].update({
                f"expert-parallel {EP_ARCH} prefill, rank {r['rank']}":
                r["prefill_flash_launches"]
                for r in ranks["expert_parallel"]["ranks"]})
            row["launches_by_path"].update({
                "internvl2-2b prefix prefill":
                    sliced["internvl2-2b"]["prefix"]["flash_launches"],
                f"encode {ENCODER_ARCH} ({enc['n_layers']} layers)":
                    enc["launches"]})
    for name in ("flash_attention", "decode_attention_partials",
                 "decode_attention_combine", "rglru_scan", "rwkv6_scan"):
        row = next(kr for kr in kernels if kr["name"] == name)
        row.setdefault("launches_by_path", {}).update({
            f"tensor-parallel {r[key]['arch']} ({r[key]['n_layers']} "
            f"layers), rank {r['rank']}": r[key]["launches"][name]
            for r in tp["ranks"]
            for key in ("llama", "rgemma", "rwkv", "dbrx")
            if r[key]["launches"][name]})
    for name, arch in (("rglru_scan", "recurrentgemma-9b"),
                       ("rwkv6_scan", "rwkv6-7b")):
        row = next(kr for kr in kernels if kr["name"] == name)
        row["launches_by_phase"] = recurrent[arch]["launches_by_phase"][name]
    for name in ("piecewise_slowdown", "anneal_select"):
        row = next(kr for kr in kernels if kr["name"] == name)
        row["launches_per_replay"] = found["orin_x64_cuda"][
            "launches_per_replay"]
        row["launches_by_path"] = {
            "search orin float64": found["orin_x64_cuda"]["launches"][name],
            "fleet pool solve (README)":
                replayed["runs"]["readme"]["launches"][name],
            "fleet pool solve (measured PCCS)":
                replayed["runs"]["measured"]["launches"][name],
            **{f"ring search on {n} ranks, rank {r['rank']}":
               r["launches"]["slowdown" if name == "piecewise_slowdown"
                             else "search"]
               for n, row_n in ranks["ring"]["rows"].items()
               if n not in ("1", "cpu") for r in row_n["ranks"]}}
    found["build_s"] = build_s
    print(json.dumps({"phase_s": phase_s}))
    print(json.dumps({"timer": {"launch_floor_ms": floor_ms}}))
    print(json.dumps({"serve": result}))
    print(json.dumps({"serve_reduced": reduced}))
    print(json.dumps({"search": found}))
    print(json.dumps({"characterize": measured}))
    print(json.dumps({"serve_recurrent": recurrent}))
    print(json.dumps({"gateway": served}))
    print(json.dumps({"fleet": replayed}))
    print(json.dumps({"serve_moe": moe_served}))
    print(json.dumps({"serve_slice": sliced}))
    print(json.dumps({"dryrun": planned}))
    print(json.dumps({"train": trained}))
    print(json.dumps({"multidevice": ranks}))
    print(json.dumps({"tensor_parallel": tp}))
    print(json.dumps({"mesh_train": mt}))
    print(json.dumps({"memory": MEMORY}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--flash-turn"]:
        sys.exit(flash_turn(sys.argv[2:]))
    if sys.argv[1:2] == ["--s1"]:
        sys.exit(s1_check(sys.argv[2:]))
    if sys.argv[1:2] == ["--host-work"]:
        sys.exit(host_work(sys.argv[2]))
    sys.exit(main())
