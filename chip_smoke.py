#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --mesh-ranks 4

Needs one CUDA card and ``nvcc``; exits non-zero without them, and outside a
checkout of the repository. ``--mesh-ranks 4`` builds the kernels and runs
only phase 13 on four NCCL ranks, one card each (``mesh4_phase``; it
raises with fewer than four cards). Phases (none catches its own failure):

1. build — every ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a), in
   parallel; each kernel entry's registers, shared memory and spills from
   ``ptxas -v``;
2. kernels — each hand-written kernel against its plain PyTorch version on
   the card at full-width shapes. Attention runs one table of cases a
   kernel (``FLASH_CASES``, ``DECODE_CASES`` over ``ATTN_LAYOUTS``), the
   timed ones marked: starcoder2-3b's layout (H=24, KV=2, hd=128; flash
   S=4608, window 4096; decode B=4 over L=4096, bs=16), timed, in bf16
   and f32, with int8 pools; jamba-1.5-large-398b's (H=64, KV=8, hd=128;
   flash S=4500 global and S=1024 global, its training microbatch; dense
   decode B=4 over 8192 slots), timed; softcap=50 and hd=256 cases; and
   each new family's layout in bf16: mixtral-8x22b (H=48, KV=8, window
   4096; flash also at S=8192, the 8192 bucket its 4500-token prompt is
   served in; B1 at group 6), timed; llama4-scout (H=40, KV=8, window
   8192; B1 at group 5); deepseek-coder/yi (H=56, KV=8); musicgen
   (H=KV=24, hd=64); paligemma (H=8, KV=1, hd=256 with its
   256-embedding prefix, S=256+513), B3 over 4 slots of 8192 positions.
   B1 runs on B3's cache through a shuffled page table and must equal it
   bit for bit. B2 with its softmax statistics (``stats=True``, the
   ``flash_attention_stats`` row) at phase 12's training shape (mixtral's
   layout, one 8192-token row), bf16 and f32: out, m and l against the
   plain chunked online softmax (512 x 1024 chunks), its output equal to
   the launch without statistics bit for bit, timed beside that launch.
   B3 with its softmax statistics (``stats=True``, the
   ``decode_attention_stats`` row; ``DECODE_STATS_CASES``) at phase 13's
   decode (mixtral's layout, 8 slots of 4096, timed beside the launch
   without statistics), at a rank's shard of the 4-rank decode
   (deepseek-coder's layout, 4 of 16384) and at hd 64 and 256 over ragged
   lengths with softcap, with NULL slots: its f32 o rounded to q's dtype
   equal to B3's o bit for bit, o at the dtype's tolerance, m within 2e-5
   and l within rtol 2e-5 of the plain version.
   Decode bounds count the visible keys only (the kernels read every
   position). Tolerances atol 2e-5 for f32 and int8-dequantised
   pools, 2e-2 for bf16. The RWKV-6 scan at rwkv6-3b's (H=40, hd=64): a
   4500-token prefill and a 4-slot decode step in bf16, an f32 prefill, and
   the plan's value-column split bitwise equal to two others (4 and 16);
   tolerance atol = rtol = 1e-3; its launch plan logged, its prefill and
   save_states calls, and B7, timed by profiler device time beside events.
   The Mamba selective scan at jamba's (Di=16384, N=16, f32): a 4500-token
   prefill, ragged S = 37 and 130, and a 4-slot decode step with the state
   updated in place, two runs bitwise equal; tolerance atol = rtol = 1e-4;
   its prefill and save_states calls, and B6, timed by profiler device
   time beside events.
   Times from CUDA events: kernel, plain version, and one PyTorch library
   call computing the same function where there is one (timed only; the
   port never calls it). The scans' decode steps and decode attention
   (B1/B3: its split pass and its combine, beside SDPA's kernels) are too
   short for events over back-to-back calls to see past the host; their
   device time comes from torch.profiler, the event times are logged beside;
3. serving — full width, bf16, seeded random weights, through
   ``ContinuousBatcher`` (4 slots, max_len 8192) for 8 requests of prompt
   lengths ``PROMPT_LENS`` and 24 new tokens each: starcoder2-3b paged,
   paged-int8 and dense (16-token pages, bucket 16), then rwkv6-3b dense
   (exact-length prefill), then jamba-1.5-large-398b dense (exact-length
   prefill) at ``JAMBA_SERVE``: 16 of its 72 layers (2 of its 8-layer
   blocks: 14 Mamba and 2 attention layers), experts off (one 8-layer
   block with its experts is ~90 GB, more than the card), every MoE FFN
   the dense SwiGLU the reference builds then, 16.9 B parameters, 33.86
   GB in bf16. The launch and plain-call counts are zeroed just
   before each run and read just after: every kernel of the run must have
   launched, no plain version may have run, and paged tokens must equal
   dense tokens;
4. f32 model check — starcoder2-3b, rwkv6-3b and jamba full width in
   f32: prefill logits of a 513-token prompt and the 4 dense decode steps
   after it, kernel path against the plain path on the card, within 2e-4
   of max |logit|. jamba runs one 8-layer block here (``JAMBA_BLOCK``: 7
   Mamba layers and 1 attention layer, 9.0 B parameters, 36.0 GB in f32):
   its 16 serving layers would take 68 GB in f32;
5. training — full-width rwkv6-3b in bf16 through ``ElasticTrainer``:
   global batch 4 x 2048 tokens in the config's 2 microbatches, remat
   "full", 3 steps at a constant learning rate, a revocation before step 1
   (blocking checkpoint of the whole state, 31 GB, to a temporary
   directory, the state released, restored onto the card; the run's
   closing checkpoint is not written, so the run writes one state to
   disk). Counts zeroed before the run:
   3 x 2 x 32 x 2 = 384 scan launches (forward and remat recompute), 192
   backward launches, no plain call; finite losses; step time, tokens/s,
   peak memory and the device's busy share of one step, with B5's and
   B7's device ms in that step as lines of their own. Then one
   full-width jamba block (``JAMBA_BLOCK``, bf16, 18.0 GB) with the
   config's bf16 gradient accumulation and int8 moments: global batch
   8 x 1024 tokens in its 8 microbatches, remat "full", 3 steps, no
   revocation and no checkpoint written (its state is 36 GB more). Counts:
   3 x 8 x 7 x 2 = 336 B4, 3 x 8 x 7 = 168 B6, 3 x 8 x 1 x 2 = 48 B2
   launches, 24 attention backward calls, no plain call; B4's and B6's
   device ms in one step as lines of their own;
6. f32 gradient check — full-width rwkv6-3b in f32, one 130-token sequence
   (a ragged last checkpoint chunk), within 2e-4 of each output's max:
   at full depth, every layer's B5 and B7 outputs on that layer's own
   inputs and incoming gradient against the plain versions; at depth 1,
   every parameter leaf, kernel path against plain path; every leaf at
   full depth within DEPTH_RATIO of the plain path's distance from an
   f64-scan path (``grad_phase`` says why; it also logs that ratio for
   the plain path with its f32 sums reordered, as a witness). Then the jamba block in f32
   (36.0 GB): every Mamba layer's B4 and B6 and the attention layer's B2
   and backward in place, and every mixer leaf, kernel path against plain
   path (``jamba_grad_phase``).

7. fleet — the paper's scheduler at its §4 scale (4000 servers, N_s = 80,
   24 h in 8,641 ten-second slots) through ``repro_torch.exp``: the fluid
   engine's run of coaster_r3 (yahoo_like, 23,653 jobs) and google_r3
   (google_like) and its 280-point (replace fraction x threshold x budget)
   cube on coaster_r3, each on the card and on the CPU from one trace, to
   rtol 1e-5 (series to 1e-5 of their max |value|; the cube's best point
   the same), then ``repro_torch.launch.sim`` on the card, its metrics equal
   to the card's ``exp.run``. The fluid engine is a lane-batched torch
   program with no kernel of its own, so it adds no row to the kernel
   table; its times, a profile of 48 minutes of the day (kernels a slot
   launches, the device's busy share) and the card go on a ``fleet`` line
   before the kernel table. The phase must end within 60 s.
8. serving fleet — the scheduler mapped onto serving
   (``repro_torch.runtime.serving``, the ``serving`` engine) through its
   entry points, on serve_batched_yahoo (4-slot replicas): (a) at the
   paper's scale on the host with no model (80 replicas, the 24 h trace,
   the fleet's 20,000-request cap, 36,531 ticks); (b) at quick scale with
   the trace cut to its first 600 s (``SERVE_FLEET_CUT``; 14 requests,
   521 ticks, 631 decode ticks of a replica), with
   ``repro_torch.examples.serve_bursty.build_decoder`` behind the fleet's
   decode hook: full-width starcoder2-3b, paged (4 slots, max_len 8192,
   16-token pages), prompts of lengths ``PROMPT_LENS``, ``MAX_NEW`` new
   tokens each. Counts zeroed just before (b) and read just after: one
   batcher step per hook call, as many as a host run of the same cut with
   a counting hook makes; B1 launched once per step and layer, B2 once per
   admitted request and layer; no plain version; the fleet's metrics and
   per-tick event counts equal the run with no hook. (c)
   ``launch.serve --scenario serve_yahoo --quick`` in-process, its metrics
   equal to ``exp.run``'s. Its times, (b)'s decode ms a step, tokens/s and
   peak memory and the card go on a ``serving_fleet`` line before the
   kernel table; (b)'s launches join the table's counts. The phase must end
   within 120 s.
9. serving_torch — the serving fleet as one device program
   (``repro_torch.runtime.serving_torch``, the ``serving_torch`` engine):
   one thread block a lane, the whole horizon in one launch of
   ``csrc/serving_fleet.cu``. (a) The kernel against its plain version on
   the chip machine's CPU (one torch thread), every output array and every
   metric bit for bit: the three deterministic cases of tests/test_obs.py,
   a seeded random workload with a pin window, and quick-scale
   serve_batched_yahoo, serve_spot (revocations, spot pricing) and
   serve_tenant_trio (tenant credits) at sim_seed 0. Then, counts zeroed
   just before and read just after: (b) ``exp.run`` of serve_batched_yahoo
   at the paper's scale (80 on-demand + 120 transient replicas, 4 slots,
   20,000 requests, 36,531 ticks), its metrics, fleet spec and the sha256
   of its per-tick event counts equal to the JAX package's serving_jax run
   (``SERVE_TORCH_GOLDEN*``, held to a fresh reference run by
   tests/test_torch_serving_torch.py); (c) ``exp.sweep`` of the (threshold
   x max_transient x max_slots) cube, 27 points x 2 sim_seeds, 54 lanes in
   one launch; (d) ``launch.sim --scenario serve_batched_yahoo --engine
   serving_torch``, its metrics equal to ``exp.run``'s: 4 launches, no
   plain call. Two of the cube's lanes are then held bitwise to their
   single-point runs. Times, us a tick, the host fleet's paper-scale time
   from phase 8 and the card go on a ``serving_torch`` line before the
   kernel table, which gets the ``serving_fleet`` row (its ms and plain_ms
   are the quick serve_batched_yahoo program on the card and on the CPU).
   The phase must end within 60 s.
10. arrivals — the arrival processes' slot-binned batch sampler
   (``repro_torch.workload.arrivals.batch_sample_counts``, the twin of the
   JAX package's vmapped ``sample_counts_jax``: threefry keys and
   ``jax.random``'s Poisson and binomial algorithms as eager torch ops, no
   kernel of its own), 24 h in 1,440 one-minute slots. (a)
   ``benchmarks/fig1_burstiness.py``'s batch demo on the card: 32 seeds of
   the google process (4000 servers), the first and a steady call against
   32 serial exact samples on the host, both mean rates, and a profile of
   the steady call (kernels, device ms, busy share). (b) 4,096 seeds of
   seven processes (google, yahoo at yahoo_like's default rate, and
   tests/test_workload.py's poisson, mmpp3, mmpp_trans, diurnal and
   modulated), the first 256 rows held to the port's CPU run of those
   seeds: rate grids bit for bit (rtol 1e-6 for diurnal and modulated,
   where sin is applied per slot), counts differing on at most 1e-4 of the
   entries; two card calls equal, seed 7 alone equal to row 7, the mean
   rate within 10% of ``mean_rate``; wall times, the rejection loops'
   iteration counts, peak memory. (c) The ``quickstart`` and
   ``trace_replay`` twins at quick scale on the host, their stdout equal
   to the JAX package's examples' (``EXAMPLES_GOLDEN``, held to fresh
   reference runs by tests/test_torch_examples.py). An ``arrivals`` JSON
   line goes before the kernel table. The phase must end within 60 s.
11. model families — (a) mixtral-8x22b at full width, bf16, 8 of its 56
   layers with all 8 experts (top-2; ``MIXTRAL_SERVE``: 20.43 B
   parameters, 40.9 GB), seeded random weights, through
   ``ContinuousBatcher`` (4 slots, max_len 8192, 16-token pages, bucket
   16) on ``PROMPT_LENS`` x ``MAX_NEW``, paged and dense. Counts zeroed
   before each run and read after: B2 once per admitted request and layer
   (64), B1 (paged) or B3 (dense) once per decode step and layer, no plain
   call, every request ``MAX_NEW`` tokens, each request's first token (the
   bucketed prefill's) equal across the layouts. The paged step routes
   its 4 rows as one group and the dense step each row alone, as the
   reference's batcher does, so only the first tokens must agree; the
   phase logs how many requests agree in full, with decode ms a step,
   tokens/s, prefill ms, peak memory and the dense step's profile, and the
   dropped expert assignments of each layout, counted in an untimed rerun
   of its requests with the MoE layer's record on. (b) f32 logits, kernel path
   against plain path, within 2e-4 of max |logit|: mixtral at 2 layers
   (21.6 GB), llama4-scout at one block (4 layers, 16 experts top-1 and
   the shared expert, 43.5 GB), musicgen-medium (48 layers, frame
   embeddings in) and paligemma-3b (18 layers, a 256-embedding prefix),
   each a 513-token prefill and 4 dense decode steps, the two MoE models
   also 4 paged steps of two rows; the routing choices that differ
   between the paths are logged (with the router margins if any).
   (c) ``repro_torch.launch.serve.main(["--arch", X])`` at full width for
   musicgen-medium and paligemma-3b: B2 once per layer, B3 once per layer
   and step. A ``families`` JSON line goes before the kernel table, and
   (a)'s and (c)'s launches join its counts. The phase must end within
   120 s.
12. MoE training — mixtral-8x22b at full width, 1 of its 56 layers with
   every expert (``MOE_TRAIN``: 2.907 B parameters, 5.8 GB bf16), under its
   optimized training variant (``configs/optimized.py``: 2 microbatches,
   flash_vjp), remat "full", f32 moments and accumulation. (a) bf16, 3
   steps of 2 x 8192 tokens through ``ElasticTrainer`` (``train_phase``; no
   revocation: its checkpoint would be ~29 GB). Counts zeroed before the
   run: 3 x 2 x 2 = 12 launches of B2 with statistics (forward and remat
   recompute), 6 chunked backward calls, no plain call; step time,
   tokens/s, peak memory, busy share and top kernels of one step; the
   first step's dropped expert assignments counted in an untimed forward
   with the MoE layer's record on. (c) One 8192-token microbatch of (a)'s
   model under remat "dots" against "full": loss and every gradient leaf
   within 2e-4 of its max, the peak bytes of each. (b) f32 gradients of
   one 2048-token row, kernel path (B2 with statistics, the chunked
   backward) against the plain path: every leaf within 2e-4 of its max, no
   routing choice differing. A ``moe_training`` JSON line goes before the
   kernel table, and (a)'s launches join its counts as the
   ``moe_training`` path. The phase must end within 120 s.
13. mesh — the port on a DeviceMesh: a one-rank NCCL process group (a
   ``FileStore`` in a temporary directory) and ``make_smoke_mesh((1, 1))``
   on the card; NCCL refuses two ranks on one device, so the checks that
   need more ranks run on the CPU under gloo (tests/test_torch_mesh.py).
   (a) deepseek-coder-33b at full width, 2 of its 62 layers (``MESH_TRAIN``:
   1.52 B parameters), bf16, 3 steps of 2 x 4096 tokens through the mesh
   ``ElasticTrainer`` (state and batches DTensors laid out by the layout
   rules, the kernels called on local shards), under its config's
   ``cp_fsdp`` (2 microbatches of one row) and under the
   ``configs/optimized.py`` train variant (``fsdp``, 1 microbatch,
   flash_vjp), each against the same steps through the meshless trainer on
   the same seed and batches: losses within 1e-4 (bitwise or not is
   logged), every kernel's launches and backward calls equal, no plain
   call; step ms and peak bytes of each. (b) mixtral-8x22b, 1 of 56 layers
   with every expert, bf16: one ``decode_step`` of 8 rows against a
   4096-slot cache under ``decode_ws`` rules (B3 with statistics, which a
   decode on a mesh takes, and the MoE layer's twin of ``_moe_smap`` in
   its ETP branch at tp 1) against the meshless step: logits within 3e-5
   (the reference's ``decode_ws`` tolerance), as many B3 launches. A
   ``mesh`` JSON line goes before the kernel table, and the mesh runs'
   launches join its counts as the ``mesh`` path. The phase must end
   within 90 s. With ``--mesh-ranks 4`` the phase runs instead on four
   NCCL ranks (``mesh4_phase``): (a) on (2, 2) and (1, 4), in f32 and in
   bf16, (b) f32 decodes
   over a 32,768-slot cache sharded over "model" and over both axes,
   (c) mixtral-8x22b's decode_ws step in f32 with expert parallelism
   (``all_to_all``), (d) an elastic 4 -> 2 -> 4 rescale beside the same on
   four gloo ranks; each held to one card, with the NCCL kernels' device
   time and a step's host ms, (e) phase 14's cp_fsdp step on (2, 2), each
   rank's count (its NCCL collectives' bytes included) equal to the meta
   count under a fake 4-rank group; a ``mesh4`` JSON line, the card, and
   the ``ok`` line (count 4). It must end within MESH4_BUDGET_S.
14. cost — what a step costs, counted by
   ``repro_torch.parallel.cost.CostMode`` (the twin of the reference's HLO
   walk: products' flops, every op's bytes, the collectives' wire bytes;
   each kernel op counted once by its formula, the formula each kernel
   row's bound comes from) on the card, through the kernels, and on meta
   tensors at the same shapes: the two counts must be equal. The steps are
   taken inside the phases that hold their weights: at the end of phase 3,
   starcoder2-3b's longest prompt prefilled in its 8192 bucket, a paged and
   a dense decode step of 4 slots; at the end of each phase 5 run, one
   more train step of rwkv6-3b (4 x 2048) and of the jamba block (8 x
   1024); in phase 13, deepseek-coder-33b's cp_fsdp step on the one-rank
   mesh. The meta counts run in a process of their own, started after the
   build (one thread; the mesh step under a fake process group), and are
   compared once phase 13 ends. Each step's line gives its counted flops
   and bytes, its device ms (CUDA events; for a train step, the profiled
   step's busy time) and wall ms, the achieved TFLOP/s and TB/s over the
   wall ms and their shares of the card's peaks, and the card; a ``cost``
   JSON line goes before the kernel table. The card-side work and any wait
   for the meta counts must stay within COST_BUDGET_S.

``--jamba-grad-study SEED [SEED ...]`` builds the kernels and runs only
``jamba_grad_phase`` for each seed, printing how far each mixer leaf lies
from an f64 path under five mixes of kernels and plain versions; it prints
no smoke result.

Phase 2 also holds the scans' backward kernels against their plain
versions at the training microbatches, with nonzero initial and final
state gradients, at ragged S = 37 and 130, two runs bitwise equal: B7 at
rwkv6-3b's (B=2, H=40, S=2048, hd=64, bf16 r/k/v in the model's layout,
and f32), B6 at jamba's
(B=1, S=1024, Di=16384, N=16, f32, and N=8) with B4's ``save_states``
checkpoints held first; tolerance atol = rtol = 1e-4
for f32 outputs, 2e-2 for bf16 ones (the reference's backward and bf16
tolerances).

TF32 is off throughout (``allow_tf32 = False`` for matmul and cuDNN). Every
phase releases what it allocated; the script checks that less than 1 GB is
left allocated before each model phase, so the 80 GB card holds one
phase's peak at a time. The last lines are the fleet summary (JSON), the
serving fleet's summary (JSON), the serving_torch summary (JSON), the
arrivals summary (JSON), the families summary (JSON), the MoE training
summary (JSON), the mesh summary (JSON), the step costs (JSON), the kernel
table (JSON), the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import atexit
import gc
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / f32 FMA
LOGIT_RTOL = 2e-4             # f32 kernel path vs plain path, of max |logit|
NEG_INF = -2.3819763e38
ARCH = "starcoder2-3b"
RWKV_ARCH = "rwkv6-3b"
JAMBA_ARCH = "jamba-1.5-large-398b"
# jamba with its experts needs ~90 GB an 8-layer block: phases 3-6 run it
# with experts off (every MoE FFN the dense SwiGLU the reference builds
# then); phase 11 runs the port's experts on mixtral-8x22b and llama4-scout
NO_MOE = dict(moe_period=0, num_experts=0, experts_per_token=0)
JAMBA_SERVE = dict(num_layers=16, **NO_MOE)   # 2 of 9 blocks, bf16: 33.86 GB
JAMBA_BLOCK = dict(num_layers=8, **NO_MOE)    # 1 block: 9.0 B params, 18.0 GB bf16, 36.0 GB f32
LEFT_OVER_BYTES = 1 << 30     # allocated memory a phase may find on entry
PROFILE_PAD_S = 0.05          # host idle at each end of a profiled window
PROFILE_TRIES = 3             # profiles a kernel's device time may take
PROMPT_LENS = (17, 100, 513, 1000, 2047, 4500, 31, 250)
MAX_NEW = 24
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 3
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # backward outputs, by dtype
DEPTH_RATIO = 4               # full-depth leaf: kernel path's distance from the
                              # f64-scan path over the plain f32 path's
TRAIN_BATCH_JAMBA, TRAIN_SEQ_JAMBA = 8, 1024  # the config's 8 microbatches of 1 row
TRAIN_STEP_KERNELS = {"rwkv6_scan": "rwkv6_kernel",        # op: its kernels' name in a
                      "rwkv6_scan_bwd": "rwkv6_bwd_kernel",  # profile (B5, B7, B4, B6)
                      "ssm_scan": "ssm_scan_kernel",
                      "ssm_scan_bwd": "ssm_scan_bwd_kernel"}


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# timing and bounds


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
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


def bound(cost, dtype_name):
    """The least time the card could take for ``cost`` (a kernel op's
    ``*_cost``: ``repro_torch.parallel.cost.Cost``, flops and bytes): the
    larger of the bytes over the memory rate and the operations over the
    peak rate of their type."""
    t_bytes, t_ops = cost.bytes / HBM_BYTES_PER_S, cost.flops / PEAK_FLOPS[dtype_name]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def log_ptxas(stem, path):
    """One line per kernel entry of a library from its ``ptxas -v`` log:
    registers, shared memory, barriers and spills."""
    entry, spills = None, ""
    for line in path.read_text(errors="replace").splitlines():
        if "Compiling entry function" in line:
            entry, spills = line.split("'")[1], ""
        elif "spill stores" in line and entry:
            spills = line.strip()
        elif line.startswith("ptxas info    : Used") and entry:
            log(f"  ptxas {stem} {entry}: {line.split(': ', 1)[1]}; {spills}")
            entry = None


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def _check(name, got, ref, tol):
    """The reference's criterion (tests/test_kernels.py: assert_allclose with
    atol = rtol = tol): |got - ref| <= tol + tol * |ref| everywhere."""
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - tol * (1 + ref.float().abs())).max().item()
    log(f"  {name:<46} max_abs_err={err:.3e} atol=rtol={tol:g}")
    if not excess <= 0:
        raise AssertionError(f"{name}: kernel vs plain exceeds atol=rtol={tol} "
                             f"(max_abs_err {err})")
    return err


def _prefixed(prefix, row):
    return {prefix + k: v for k, v in row.items()}


def _log_shape_row(label, row, prefix="jamba_"):
    lib = row[prefix + "library_ms"]
    log(f"  {label}: ms={row[prefix + 'ms']:.4f} plain_ms={row[prefix + 'plain_ms']:.4f} "
        f"library_ms={'none' if lib is None else f'{lib:.4f}'} "
        f"bound_ms={row[prefix + 'bound_ms']:.5f} ({row[prefix + 'bound_by']}) "
        f"at {row[prefix + 'shape']}")


def _log_event_row(label, row, prefix="jamba_"):
    log(f"  {label}: device ms={row[prefix + 'ms']:.5f} library (SDPA) "
        f"{row[prefix + 'library_ms']:.5f} (profiler); back-to-back calls "
        f"{row[prefix + 'event_ms']:.5f}, SDPA {row[prefix + 'event_library_ms']:.5f} "
        f"(CUDA events, paced by the host)")


# Phase 2's attention cases, one table a kernel. Every case is held to its
# plain version, bf16 (and f32 where ``f32``); a case with a ``row`` is also
# timed, its numbers joining the kernel's row under that key prefix ("" for
# the row's own keys). B2 runs one prompt of S tokens; B3 runs 4 slots of L
# cache positions, slot b seeing the keys below ``valid[b]`` (within the
# window; the prefix always), and with ``paged`` B1 runs on the same cache
# through a shuffled page table (bitwise equal to B3); ``shared_bias`` adds
# B3 with slot 1's bias row shared by every slot, ``int8`` B1 on int8 pools
# quantised from the f32 ones. Defaults: the longest serving prompt, and
# slots at its end, a short one, a full cache and one key.
LONG_PROMPT = max(PROMPT_LENS)
FAMILY_VALID = (LONG_PROMPT + MAX_NEW, 1013, 8192, 1)
ATTN_LAYOUTS = {  # name: (H, KV, hd, window, prefix_len)
    "starcoder2-3b": (24, 2, 128, 4096, 0),
    "jamba-1.5-large-398b": (64, 8, 128, 0, 0),
    "mixtral-8x22b": (48, 8, 128, 4096, 0),
    "llama4-scout-17b-a16e": (40, 8, 128, 8192, 0),
    "deepseek-coder-33b/yi-34b": (56, 8, 128, 0, 0),
    "musicgen-medium": (24, 24, 64, 0, 0),
    "paligemma-3b": (8, 1, 256, 0, 256),
}
FLASH_CASES = (
    dict(layout="starcoder2-3b", S=4608, f32=True, row=""),
    dict(layout="jamba-1.5-large-398b", row="jamba_"),
    dict(layout="jamba-1.5-large-398b", S=TRAIN_SEQ_JAMBA, row="train_", iters=10),
    dict(layout="starcoder2-3b", S=1024, window=0, softcap=50.0),
    dict(layout=(8, 4, 256, 1024, 0), S=2048, softcap=50.0),
    dict(layout="mixtral-8x22b", row="mixtral_"),
    # the longest prompt as the served path runs it: right-padded to its
    # 8192 bucket (the pad rows come last and see every real key)
    dict(layout="mixtral-8x22b", S=8192),
    dict(layout="llama4-scout-17b-a16e"),
    dict(layout="deepseek-coder-33b/yi-34b"),
    dict(layout="musicgen-medium"),
    dict(layout="paligemma-3b", S=256 + 513),
)
DECODE_CASES = (
    dict(layout="starcoder2-3b", L=4096, window=0, valid=(4096, 2071, 524, 41),
         f32=True, paged=True, int8=True, row="", copies=8),
    dict(layout="jamba-1.5-large-398b", valid=(8192, LONG_PROMPT + MAX_NEW, 1013, 41),
         row="jamba_"),
    dict(layout="starcoder2-3b", L=4096, window=0, valid=(4096, 2071, 524, 41),
         softcap=50.0, paged=True),
    dict(layout=(8, 4, 256, 0, 0), L=4096, valid=(4096, 2071, 524, 41),
         shared_bias=True, paged=True),
    dict(layout="mixtral-8x22b", paged=True, row="mixtral_"),
    dict(layout="llama4-scout-17b-a16e", paged=True),
    dict(layout="deepseek-coder-33b/yi-34b"),
    dict(layout="musicgen-medium"),
    dict(layout="paligemma-3b"),
)
# B3 with its softmax statistics (``stats=True``, the ``decode_attention_stats``
# row), which every decode on a mesh takes: at phase 13's one-rank decode
# (mixtral-8x22b's layout, 8 slots of 4096 positions, 4001 visible; timed),
# at one rank's shard of the 4-rank decode (``--mesh-ranks 4``: 4 rows of
# deepseek-coder-33b's 16384 slots), and at hd 64 and 256 over ragged
# lengths with softcap; every case but the timed one with a slot whose every
# position is masked. bf16, and f32 where ``f32``
DECODE_STATS_CASES = (
    dict(layout="mixtral-8x22b", B=8, L=4096, valid=(4001,) * 8, row=""),
    dict(layout="deepseek-coder-33b/yi-34b", B=4, L=16384, valid=(16384, 9000, 1, 0),
         f32=True),
    dict(layout="musicgen-medium", B=4, L=1000, valid=(1000, 517, 0, 3), f32=True),
    dict(layout=(8, 1, 256, 0, 0), B=4, L=777, valid=(777, 0, 300, 5), softcap=50.0,
         f32=True),
)
PAGE = 16                     # the batcher's KV block size
# B2 with its softmax statistics at phase 12's training shape: one row of
# mixtral-8x22b's 2 x 8192 batch in each of its 2 microbatches, against the
# plain chunked online softmax at the config's attention chunks
FLASH_STATS_CASE = dict(layout="mixtral-8x22b", S=8192, chunk_q=512, chunk_k=1024)


def _case_layout(case):
    """(label, H, KV, hd, window, prefix_len) of a case; its own ``window``
    overrides the layout's."""
    lay = case["layout"]
    H, KV, hd, W, prefix = ATTN_LAYOUTS[lay] if isinstance(lay, str) else lay
    label = lay if isinstance(lay, str) else f"H={H} KV={KV} hd={hd}"
    return label, H, KV, hd, case.get("window", W), prefix


def kernel_phase(dev):
    """B2, B3 and B1 over ``FLASH_CASES`` and ``DECODE_CASES``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_fwd, paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ops import (decode_attention_cost,
                                                         paged_decode_attention_cost)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import flash_attention_cost
    from repro_torch.kernels.flash_attention.ref import (allowed, attention_ref,
                                                        chunked_attention_ref)
    from repro_torch.optim.compress import quantize_int8

    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 2e-2, f32: 2e-5}
    rows, worst = {}, {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def held(kernel, name, got, ref, dtype):
        err = _check(name, got, ref, tol[dtype])
        worst[kernel] = max(err, worst.get(kernel, 0.0))
        return err

    def add_row(kernel, prefix, label, row, events=False):
        rows.setdefault(kernel, {}).update(_prefixed(prefix, row))
        _log_shape_row(f"{kernel} {label}", rows[kernel], prefix)
        if events:
            _log_event_row(f"{kernel} {label}", rows[kernel], prefix)

    log("kernel phase: flash_attention (B2)")
    for case in FLASH_CASES:
        label, H, KV, hd, W, prefix = _case_layout(case)
        S, cap = case.get("S", LONG_PROMPT), case.get("softcap", 0.0)
        kw = dict(window=W, prefix_len=prefix, softcap=cap)
        for dtype in (bf16, f32) if case.get("f32") else (bf16,):
            q, k, v = (randn((1, S, n, hd), dtype).transpose(1, 2) for n in (H, KV, KV))
            o = flash_attention_fwd(q, k, v, **kw)
            err = held("flash_attention", f"flash {dtype} {label} S={S} window={W} "
                       f"prefix={prefix} softcap={cap:g}", o,
                       attention_ref(q, k, v, **kw), dtype)
            if "row" in case and dtype == bf16:
                n, mask = case.get("iters", 5), allowed(S, S, dev, window=W,
                                                        prefix_len=prefix)
                if W or prefix:
                    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        q, k, v, attn_mask=mask, enable_gqa=True)
                else:
                    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        q, k, v, is_causal=True, enable_gqa=True)
                add_row("flash_attention", case["row"], f"{label} S={S}", dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw), n),
                    plain_ms=time_ms(lambda: attention_ref(q, k, v, **kw), -(-n // 2)),
                    library_ms=time_ms(lib, n),
                    **bound(flash_attention_cost(q, k, v, **kw), "bfloat16"),
                    shape=f"B=1 H={H} KV={KV} S={S} hd={hd} "
                          f"{f'window={W}' if W else 'global'} bf16"))
                del mask, lib
            del q, k, v, o

    log("kernel phase: flash_attention with softmax statistics (B2, stats=True)")
    label, H, KV, hd, W, prefix = _case_layout(FLASH_STATS_CASE)
    S, cq, ck = (FLASH_STATS_CASE[n] for n in ("S", "chunk_q", "chunk_k"))
    kw = dict(window=W, prefix_len=prefix)
    for dtype in (bf16, f32):
        q, k, v = (randn((1, S, n, hd), dtype).transpose(1, 2) for n in (H, KV, KV))
        got = flash_attention_fwd(q, k, v, **kw, stats=True)
        ref = chunked_attention_ref(q, k, v, chunk_q=cq, chunk_k=ck, **kw)
        err = max(held("flash_attention_stats", f"flash stats {dtype} {label} S={S} "
                       f"window={W} {part}", a, b, dtype)
                  for part, a, b in zip(("out", "m", "l"), got, ref))
        if not torch.equal(got[0], flash_attention_fwd(q, k, v, **kw)):
            raise AssertionError(f"flash stats {dtype}: the output differs from the "
                                 f"launch without statistics")
        if dtype == bf16:
            mask = allowed(S, S, dev, window=W, prefix_len=prefix)
            add_row("flash_attention_stats", "", f"{label} S={S} (training)", dict(
                max_abs_err=err,
                ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw, stats=True), 5),
                nostats_ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw), 5),
                plain_ms=time_ms(lambda: chunked_attention_ref(
                    q, k, v, chunk_q=cq, chunk_k=ck, **kw), 2),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True), 5),
                **bound(flash_attention_cost(q, k, v, **kw, stats=True), "bfloat16"),
                shape=f"B=1 H={H} KV={KV} S={S} hd={hd} window={W} bf16, m and l "
                      f"(B,H,S) f32"))
            log(f"  flash_attention_stats: the same call without statistics "
                f"{rows['flash_attention_stats']['nostats_ms']:.4f} ms")
            del mask
        del q, k, v, got, ref

    log("kernel phase: decode_attention (B3) and paged_decode_attention (B1)")
    for case in DECODE_CASES:
        label, H, KV, hd, W, prefix = _case_layout(case)
        L, cap = case.get("L", 8192), case.get("softcap", 0.0)
        B, P = 4, L // PAGE
        pos = torch.arange(L, device=dev)[None]
        valid = torch.tensor(case.get("valid", FAMILY_VALID), device=dev)
        ok = pos < valid[:, None]
        if W:
            ok &= pos >= valid[:, None] - W
        if prefix:
            ok |= pos < prefix
        bias = torch.where(ok, 0.0, NEG_INF).float()
        table = (torch.randperm(B * P, generator=gen, device=dev) + 2).reshape(B, P)
        for dtype in (bf16, f32) if case.get("f32") else (bf16,):
            timed = "row" in case and dtype == bf16
            q = randn((B, H, hd), dtype)
            caches = [(randn((B, L, KV, hd), dtype), randn((B, L, KV, hd), dtype))
                      for _ in range(case.get("copies", 2) if timed else 1)]
            kt, vt = (c.transpose(1, 2) for c in caches[0])
            o = decode_attention_fwd(q, kt, vt, bias, softcap=cap)
            name = f"{dtype} {label} B={B} L={L} window={W} prefix={prefix} softcap={cap:g}"
            err = held("decode_attention", f"decode {name}", o, decode_attention_ref(
                q, kt, vt, bias, softcap=cap), dtype)
            if case.get("shared_bias"):
                held("decode_attention", f"decode {name} shared bias",
                     decode_attention_fwd(q, kt, vt, bias[1], softcap=cap),
                     decode_attention_ref(q, kt, vt, bias[1], softcap=cap), dtype)
            # per copy, two caches of ``dtype``: rotating them keeps each timed
            # launch reading from HBM rather than L2
            views = [tuple(c.transpose(1, 2) for c in kv) for kv in caches]
            it = iter(range(10**9))
            # bounds count the keys the bias leaves visible (the kernels read
            # every position); the ops' count is every position
            visible = int(ok.sum())
            if timed:
                def kern():
                    return decode_attention_fwd(q, *views[next(it) % len(views)], bias)

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q[:, :, None], *views[next(it) % len(views)],
                        attn_mask=bias[:, None, None, :], enable_gqa=True)

                add_row("decode_attention", case["row"], label, dict(
                    max_abs_err=err,
                    ms=kernel_device_ms(kern, 40, "decode_kernel", "decode_attention", 2),
                    plain_ms=time_ms(lambda: decode_attention_ref(
                        q, *views[next(it) % len(views)], bias), 20),
                    library_ms=library_device_ms(sdpa, 40),
                    event_ms=time_ms(kern, 40), event_library_ms=time_ms(sdpa, 40),
                    **bound(decode_attention_cost(q, kt, vt, bias, visible=visible),
                            "bfloat16"),
                    shape=f"B={B} H={H} KV={KV} L={L} hd={hd} "
                          f"{f'window={W} ' if W else ''}bf16, per-slot bias, "
                          f"{visible} of {B * L} positions visible"), events=True)
            if case.get("paged"):
                idx = table.long()
                pools = []
                for kc, vc in caches:
                    kp = torch.zeros((2 + B * P, PAGE, KV, hd), dtype=dtype, device=dev)
                    vp = torch.zeros_like(kp)
                    kp[idx] = kc.reshape(B, P, PAGE, KV, hd)
                    vp[idx] = vc.reshape(B, P, PAGE, KV, hd)
                    pools.append((kp, vp))
                tab = table.to(torch.int32)
                po = paged_decode_attention_fwd(q, *pools[0], tab, bias, softcap=cap)
                perr = held("paged_decode_attention", f"paged {name} G={H // KV} bs={PAGE}",
                            po, paged_decode_attention_ref(q, *pools[0], tab, bias,
                                                           softcap=cap), dtype)
                if not torch.equal(po, o):
                    raise AssertionError(f"paged {name}: differs from dense on the same cache")
                if timed:
                    def kern():
                        return paged_decode_attention_fwd(
                            q, *pools[next(it) % len(pools)], tab, bias)

                    add_row("paged_decode_attention", case["row"], label, dict(
                        max_abs_err=perr,
                        ms=kernel_device_ms(kern, 40, "decode_kernel",
                                            "paged_decode_attention", 2),
                        event_ms=time_ms(kern, 40),
                        plain_ms=time_ms(lambda: paged_decode_attention_ref(
                            q, *pools[next(it) % len(pools)], tab, bias), 20),
                        library_ms=None,  # no single PyTorch call gathers through a page table
                        **bound(paged_decode_attention_cost(q, *pools[0], tab, bias,
                                                            visible=visible), "bfloat16"),
                        shape=f"B={B} H={H} KV={KV} P={P} bs={PAGE} hd={hd} "
                              f"{f'window={W} ' if W else ''}bf16 pool, "
                              f"{visible} of {B * L} positions visible"))
                    log(f"  paged_decode_attention {label}: event_ms="
                        f"{rows['paged_decode_attention'][case['row'] + 'event_ms']:.5f} "
                        f"(back-to-back calls)")
                if case.get("int8") and dtype == f32:
                    qk, ks = quantize_int8(pools[0][0])
                    qv, vs = quantize_int8(pools[0][1])
                    for qd in (f32, bf16):
                        q8 = q.to(qd)
                        o8 = paged_decode_attention_fwd(q8, qk, qv, tab, bias,
                                                        k_scale=ks, v_scale=vs)
                        held("paged_decode_attention", f"paged int8 pool, q {qd}", o8,
                             paged_decode_attention_ref(q8, qk, qv, tab, bias,
                                                        k_scale=ks, v_scale=vs), qd)
                    ms8 = kernel_device_ms(lambda: paged_decode_attention_fwd(
                        q8, qk, qv, tab, bias, k_scale=ks, v_scale=vs), 40,
                        "decode_kernel", "paged_decode_attention", 2)
                    # an int8 row: hd bytes and one f32 scale a kv head
                    b8 = bound(paged_decode_attention_cost(q8, qk, qv, tab, bias, k_scale=ks,
                                                           v_scale=vs, visible=visible),
                               "bfloat16")["bound_ms"]
                    log(f"  paged int8 pool (bf16 q): ms={ms8:.4f} bound_ms={b8:.5f} "
                        f"(L2-warm: one pool)")
                    del qk, qv, ks, vs, o8
                del pools, po
            del q, caches, views, o
    log("kernel phase: decode_attention with softmax statistics (B3, stats=True)")
    for case in DECODE_STATS_CASES:
        label, H, KV, hd, W, prefix = _case_layout(case)
        B, L, cap = case["B"], case["L"], case.get("softcap", 0.0)
        pos = torch.arange(L, device=dev)[None]
        valid = torch.tensor(case["valid"], device=dev)
        ok = (pos < valid[:, None]) & (pos >= valid[:, None] - W if W else True)
        bias = torch.where(ok, 0.0, NEG_INF).float()
        for dtype in (bf16, f32) if case.get("f32") else (bf16,):
            q = randn((B, H, hd), dtype)
            kt, vt = (randn((B, L, KV, hd), dtype).transpose(1, 2) for _ in range(2))
            got = decode_attention_fwd(q, kt, vt, bias, softcap=cap, stats=True)
            ref = decode_attention_ref(q, kt, vt, bias, softcap=cap, stats=True)
            name = f"decode stats {dtype} {label} B={B} L={L} softcap={cap:g}"
            if not torch.equal(got[0].to(dtype), decode_attention_fwd(q, kt, vt, bias,
                                                                      softcap=cap)):
                raise AssertionError(f"{name}: o rounded to {dtype} differs from the "
                                     f"launch without statistics")
            err = held("decode_attention_stats", f"{name} o", got[0], ref[0], dtype)
            held("decode_attention_stats", f"{name} m (atol 2e-5)", got[1], ref[1], f32)
            l_rel = float(((got[2] - ref[2]).abs() / ref[2]).max())
            log(f"  {name} l: max rel err {l_rel:.3e} (rtol 2e-5)")
            if not l_rel <= 2e-5:
                raise AssertionError(f"{name}: l off by {l_rel} relative")
            if "row" in case and dtype == bf16:
                visible = int(ok.sum())
                add_row("decode_attention_stats", case["row"], label, dict(
                    max_abs_err=err,
                    ms=kernel_device_ms(lambda: decode_attention_fwd(
                        q, kt, vt, bias, stats=True), 40, "decode_kernel",
                        "decode_attention_stats", 2),
                    nostats_ms=kernel_device_ms(lambda: decode_attention_fwd(
                        q, kt, vt, bias), 40, "decode_kernel", "decode_attention", 2),
                    plain_ms=time_ms(lambda: decode_attention_ref(
                        q, kt, vt, bias, stats=True), 20),
                    library_ms=library_device_ms(lambda: F.scaled_dot_product_attention(
                        q[:, :, None], kt, vt, attn_mask=bias[:, None, None, :],
                        enable_gqa=True), 40),
                    **bound(decode_attention_cost(q, kt, vt, bias, stats=True,
                                                  visible=visible), "bfloat16"),
                    shape=f"B={B} H={H} KV={KV} L={L} hd={hd} "
                          f"{f'window={W} ' if W else ''}bf16, o, m and l f32, "
                          f"{visible} of {B * L} positions visible"))
                log(f"  decode_attention_stats: the same call without statistics "
                    f"{rows['decode_attention_stats']['nostats_ms']:.5f} ms (profiler)")
            del q, kt, vt, got, ref
    for kernel, err in worst.items():
        rows[kernel]["max_abs_err"] = err
    torch.cuda.empty_cache()
    return rows


def rwkv_kernel_phase(dev):
    """B5 at rwkv6-3b full width: a prefill of the longest serving prompt
    (B=1, H=40, S=4500, hd=64) and a 4-slot decode step, r/k/v in bf16 as
    the model passes them ((B,H,S,hd) views of (B,S,H,hd) storage), w/u/s0
    f32, nonzero s0; plus an f32 prefill and a bitwise check across two
    value-column splits. Tolerance: the reference's RWKV atol = rtol = 1e-3
    (tests/test_kernels.py); both sides compute in f32 from the same widened
    inputs, so they differ only in summation order."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan.kernel import fwd_plan, rwkv6_scan_fwd
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan_cost
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    from repro_torch.parallel.cost import REF_CHUNK, ref_chunk_bytes

    gen = torch.Generator(device=dev).manual_seed(4321)
    n_sm = _build.sm_count(dev)
    bf16, f32 = torch.bfloat16, torch.float32
    tol = 1e-3
    H, hd = 40, 64

    def case(B, S, dtype):
        def seq(t):
            return t.reshape(B, S, H, hd).transpose(1, 2)

        r, k, v = (seq(torch.randn(B * S * H * hd, generator=gen, device=dev)
                       .to(dtype)) for _ in range(3))
        w = seq(0.2 + 0.799 * torch.rand(B * S * H * hd, generator=gen, device=dev))
        u = torch.randn((H, hd), generator=gen, device=dev)
        s0 = 0.5 * torch.randn((B, H, hd, hd), generator=gen, device=dev)
        return r, k, v, w, u, s0

    log("kernel phase: rwkv6_scan (B5)")
    B, S = 1, max(PROMPT_LENS)
    args = case(B, S, bf16)
    y, sT = rwkv6_scan_fwd(*args)
    y_ref, sT_ref = rwkv6_scan_ref(*args)
    err = max(_check(f"rwkv6 bf16 prefill B={B} H={H} S={S} y", y, y_ref, tol),
              _check(f"rwkv6 bf16 prefill B={B} H={H} S={S} sT", sT, sT_ref, tol))
    cols = fwd_plan(B, H, hd, n_sm)
    for other in (4, 16):  # two other column splits: the same bits
        yo, so = rwkv6_scan_fwd(*args, _cols=other)
        if not (torch.equal(yo, y) and torch.equal(so, sT)):
            raise AssertionError(f"rwkv6: {other} and {cols} value columns per CTA differ")
    log(f"  rwkv6 prefill: 4 == {cols} (the plan's, {B * H * hd // cols} CTAs) == 16 value "
        f"columns per CTA, bitwise")
    row = dict(
        max_abs_err=err,
        ms=time_ms(lambda: rwkv6_scan_fwd(*args), 10),
        device_ms=kernel_device_ms(lambda: rwkv6_scan_fwd(*args), 10, "rwkv6_kernel",
                                   "rwkv6_scan"),
        plain_ms=time_ms(lambda: rwkv6_scan_ref(*args), 1, warmup=1),
        library_ms=None,  # no single PyTorch call computes the WKV recurrence
        **bound(rwkv6_scan_cost(*args), "float32"),
        shape=f"prefill B={B} H={H} S={S} hd={hd}, r/k/v bf16, w/u/s0 f32, {cols} value "
              f"columns per CTA")
    del args, y, sT, y_ref, sT_ref, yo, so

    # decode: 4 slots, one step, the state updated in place as the model
    # does; states rotated over 32 copies (84 MB) so each launch reads HBM
    B, n_copies = 4, 32
    r, k, v, w, u, s0 = case(B, 1, bf16)
    y, sT = rwkv6_scan_fwd(r, k, v, w, u, s0)
    y_ref, sT_ref = rwkv6_scan_ref(r, k, v, w, u, s0)
    derr = max(_check(f"rwkv6 bf16 decode B={B} S=1 y", y, y_ref, tol),
               _check(f"rwkv6 bf16 decode B={B} S=1 sT", sT, sT_ref, tol))
    states = [s0.clone() for _ in range(n_copies)]
    it = iter(range(10**9))

    def step(fn):
        st = states[next(it) % n_copies]
        return fn(r, k, v, w, u, st, state_out=st)

    # the kernel's own time from the profiler; CUDA events over back-to-back
    # calls time how fast the wrapper issues launches, not the kernel
    row.update(
        max_abs_err=max(err, derr),
        decode_ms=kernel_device_ms(lambda: step(rwkv6_scan_fwd), 100,
                                   "rwkv6_kernel", "rwkv6_scan"),
        decode_issue_ms=time_ms(lambda: step(rwkv6_scan_fwd), 100),
        decode_plain_ms=time_ms(lambda: step(rwkv6_scan_ref), 50),
        decode_bound_ms=bound(rwkv6_scan_cost(r, k, v, w, u, s0), "float32")["bound_ms"])
    del r, k, v, w, u, s0, y, sT, states

    args = case(1, 513, f32)
    y, sT = rwkv6_scan_fwd(*args)
    y_ref, sT_ref = rwkv6_scan_ref(*args)
    _check("rwkv6 f32 prefill S=513 y", y, y_ref, tol)
    _check("rwkv6 f32 prefill S=513 sT", sT, sT_ref, tol)
    del args, y, sT, y_ref, sT_ref

    # training forward: the microbatch shape, with the chunk-start states
    B, S = 2, TRAIN_SEQ
    args = case(B, S, bf16)
    y, sT, starts = rwkv6_scan_fwd(*args, save_states=True)
    _, _, starts_ref = rwkv6_scan_ref(*args, save_states=True)
    _check(f"rwkv6 bf16 save_states B={B} S={S} starts", starts, starts_ref, tol)
    train_bound = bound(rwkv6_scan_cost(*args, save_states=True), "float32")
    cols = fwd_plan(B, H, hd, n_sm)
    row.update(
        train_ms=time_ms(lambda: rwkv6_scan_fwd(*args, save_states=True), 10),
        train_device_ms=kernel_device_ms(lambda: rwkv6_scan_fwd(*args, save_states=True), 10,
                                         "rwkv6_kernel", "rwkv6_scan"),
        train_bound_ms=train_bound["bound_ms"],
        train_bound_by=train_bound["bound_by"],
        train_shape=f"B={B} H={H} S={S} hd={hd} save_states, r/k/v bf16, {cols} value "
                    f"columns per CTA")
    extra = nbytes(starts) - ref_chunk_bytes(B, H, S, hd * hd)
    log(f"  rwkv6 with save_states (B={B}, S={S}): ms={row['train_ms']:.4f} (events) "
        f"device ms={row['train_device_ms']:.4f} (profiler), {cols} value "
        f"columns per CTA; bound_ms={row['train_bound_ms']:.4f} ({row['train_bound_by']}, "
        f"checkpoints at the reference's {REF_CHUNK}-step chunk); the port's "
        f"8-step checkpoints write {extra / 1e6:.1f} MB more "
        f"({1e3 * extra / HBM_BYTES_PER_S:.4f} ms at the memory rate)")
    log(f"  rwkv6 prefill ms={row['ms']:.4f} (events) device ms={row['device_ms']:.4f} "
        f"(profiler) plain_ms={row['plain_ms']:.2f} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}); decode device "
        f"ms={row['decode_ms']:.5f} (profiler) issue ms={row['decode_issue_ms']:.4f} "
        f"(events, back-to-back wrapper calls) plain_ms={row['decode_plain_ms']:.4f} "
        f"bound_ms={row['decode_bound_ms']:.5f}; library: none")
    del args, y, sT, starts, starts_ref
    torch.cuda.empty_cache()
    return {"rwkv6_scan": row}


def rwkv_bwd_kernel_phase(dev):
    """B7 at the training microbatch of rwkv6-3b (B=2, H=40, S=2048, hd=64):
    r/k/v bf16 and dy f32 as (B,H,S,hd) views of (B,S,H,hd) storage, w/u f32,
    nonzero s0 and dsT, the checkpoints from B5's save_states. Then f32 and
    ragged S = 37 and 130, and two runs bitwise equal."""
    import torch

    from repro_torch.kernels.rwkv6_scan.kernel import (CLUSTER, bwd_threads, rwkv6_scan_bwd,
                                                      rwkv6_scan_fwd)
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan_bwd_cost
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref
    from repro_torch.parallel.cost import ref_chunk_bytes

    gen = torch.Generator(device=dev).manual_seed(5432)
    H, hd = 40, 64
    names = ("dr", "dk", "dv", "dw", "du", "ds0")

    def case(B, S, dtype, heads=H):
        def seq(rand=torch.randn, scale=1.0, shift=0.0):
            t = rand((B, S, heads, hd), generator=gen, device=dev) * scale + shift
            return t.transpose(1, 2)

        r, k, v = (seq().to(dtype) for _ in range(3))
        w = seq(torch.rand, 0.799, 0.2)
        u = torch.randn((heads, hd), generator=gen, device=dev)
        s0 = 0.5 * torch.randn((B, heads, hd, hd), generator=gen, device=dev)
        dy = seq()
        dsT = 0.5 * torch.randn((B, heads, hd, hd), generator=gen, device=dev)
        _, _, starts = rwkv6_scan_fwd(r, k, v, w, u, s0, save_states=True)
        return (r, k, v, w, dy, u, starts, dsT)

    def check(label, args, **kw):
        got = rwkv6_scan_bwd(*args, **kw)
        ref = rwkv6_scan_bwd_ref(*args)
        return got, max(_check(f"{label} {n}", a, b, BWD_TOL[str(a.dtype)[6:]])
                        for n, a, b in zip(names, got, ref))

    log("kernel phase: rwkv6_scan_bwd (B7)")
    B, S = 2, TRAIN_SEQ
    log(f"  rwkv6 bwd launch: {CLUSTER} CTAs per (b, h) in a thread-block cluster, "
        f"{B * H * CLUSTER} CTAs of {bwd_threads(hd)} threads at B={B} H={H} hd={hd}")
    args = case(B, S, torch.bfloat16)
    got, err = check(f"rwkv6 bwd bf16 B={B} H={H} S={S}", args)
    r, k, v, w, dy, u, starts, dsT = args
    dr, dk, dv, dw, du, ds0 = got
    again = rwkv6_scan_bwd(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("rwkv6 bwd: two runs differ")
    log("  rwkv6 bwd: two runs bitwise equal")
    row = dict(
        max_abs_err=err,
        ms=time_ms(lambda: rwkv6_scan_bwd(*args), 10),
        device_ms=kernel_device_ms(lambda: rwkv6_scan_bwd(*args), 10, "rwkv6_bwd_kernel",
                                   "rwkv6_scan_bwd"),
        plain_ms=time_ms(lambda: rwkv6_scan_bwd_ref(*args), 1, warmup=1),
        library_ms=None,  # no single PyTorch call computes the WKV backward
        # the checkpoints read and the du partials written are counted at
        # the reference's 64-step chunk, not at the port's 8 steps
        **bound(rwkv6_scan_bwd_cost(*args), "float32"),
        shape=f"B={B} H={H} S={S} hd={hd}, r/k/v/dr/dk/dv bf16, w/dy/u/states f32, "
              f"checkpoints every 8 steps, clusters of {CLUSTER} CTAs")
    extra = nbytes(starts, du) - ref_chunk_bytes(B, H, S, hd * hd + hd)
    log(f"  rwkv6 bwd ms={row['ms']:.4f} (events) device ms={row['device_ms']:.4f} (profiler) "
        f"plain_ms={row['plain_ms']:.2f} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}); library: none; the "
        f"port's 8-step checkpoints and du partials read and write "
        f"{extra / 1e6:.1f} MB more ({1e3 * extra / HBM_BYTES_PER_S:.4f} ms)")
    del args, got, again, r, k, v, w, dy, u, starts, dsT, dr, dk, dv, dw, du, ds0
    for dtype, S in ((torch.float32, 130), (torch.float32, 37), (torch.bfloat16, 37)):
        _, e = check(f"rwkv6 bwd {str(dtype)[6:]} B=2 S={S}", case(2, S, dtype))
        row["max_abs_err"] = max(row["max_abs_err"], e)
    # its latency: 10 heads of one sequence put one CTA on each of 40 SMs,
    # so nothing on an SM hides one CTA's stalls
    alone = case(1, TRAIN_SEQ, torch.bfloat16, heads=10)
    row["event_alone_ms"] = time_ms(lambda: rwkv6_scan_bwd(*alone), 10)
    row["device_alone_ms"] = kernel_device_ms(lambda: rwkv6_scan_bwd(*alone), 10,
                                              "rwkv6_bwd_kernel", "rwkv6_scan_bwd")
    log(f"  rwkv6 bwd with one CTA per SM (B=1, H=10, S={TRAIN_SEQ}, {10 * CLUSTER} CTAs): "
        f"ms={row['event_alone_ms']:.4f} (events) device ms={row['device_alone_ms']:.4f} "
        f"(profiler)")
    del alone
    torch.cuda.empty_cache()
    return {"rwkv6_scan_bwd": row}


def ssm_kernel_phase(dev):
    """B4 at jamba's full width (Di=16384, N=16, all f32): a prefill of the
    longest serving prompt (B=1, S=4500), ragged S = 37 and 130 (B=2), and
    a 4-slot decode step (S=1) with hT aliasing h0 as the model runs it;
    inputs as the model makes them (dt a softplus, A < 0 in the S4D init's
    range, unit-scale x, B, C, D, nonzero h0); two runs bitwise equal.
    Tolerance: the reference's SSM atol = rtol = 1e-4 (tests/test_kernels.py);
    both sides compute in f32 from the same inputs and differ in the order
    of the sum over n and in the exponential's rounding."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_fwd
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_cost
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device=dev).manual_seed(6543)
    tol = 1e-4
    Di, N = 16384, 16

    def case(B, S):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        dt = F.softplus(randn(B, S, Di) - 1.0)
        A = -(0.5 + 15.5 * torch.rand((Di, N), generator=gen, device=dev))
        return (randn(B, S, Di), dt, A, randn(B, S, N), randn(B, S, N), randn(Di),
                0.5 * randn(B, Di, N))

    def check(label, args):
        y, hT = ssm_scan_fwd(*args)
        y_ref, hT_ref = ssm_scan_ref(*args)
        return (y, hT), max(_check(f"{label} y", y, y_ref, tol),
                            _check(f"{label} hT", hT, hT_ref, tol))

    log("kernel phase: ssm_scan (B4)")
    B, S = 1, max(PROMPT_LENS)
    args = case(B, S)
    (y, hT), err = check(f"ssm f32 prefill B={B} S={S} Di={Di} N={N}", args)
    again = ssm_scan_fwd(*args)
    if not (torch.equal(again[0], y) and torch.equal(again[1], hT)):
        raise AssertionError("ssm_scan: two runs differ")
    log("  ssm prefill: two runs bitwise equal")
    row = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ssm_scan_fwd(*args), 10),
        device_ms=kernel_device_ms(lambda: ssm_scan_fwd(*args), 10, "ssm_scan_kernel",
                                   "ssm_scan"),
        plain_ms=time_ms(lambda: ssm_scan_ref(*args), 1, warmup=1),
        library_ms=None,  # no single PyTorch call computes the selective scan
        **bound(ssm_scan_cost(*args), "float32"),
        shape=f"prefill B={B} S={S} Di={Di} N={N}, f32")
    del args, y, hT, again
    for S in (37, 130):
        _, e = check(f"ssm f32 ragged B=2 S={S}", case(2, S))
        row["max_abs_err"] = max(row["max_abs_err"], e)

    # decode: 4 slots, one step, the state updated in place as the model
    # does; states rotated over 32 copies (134 MB) so each launch reads HBM
    B, n_copies = 4, 32
    x, dt, A, Bc, Cc, D, h0 = case(B, 1)
    (y, hT), derr = check(f"ssm f32 decode B={B} S=1", (x, dt, A, Bc, Cc, D, h0))
    state = h0.clone()
    y2, _ = ssm_scan_fwd(x, dt, A, Bc, Cc, D, state, state_out=state)
    if not (torch.equal(y2, y) and torch.equal(state, hT)):
        raise AssertionError("ssm_scan: the in-place state differs from out of place")
    log("  ssm decode: hT written over h0 equals out of place, bitwise")
    states = [h0.clone() for _ in range(n_copies)]
    it = iter(range(10**9))

    def step(fn):
        st = states[next(it) % n_copies]
        return fn(x, dt, A, Bc, Cc, D, st, state_out=st)

    row.update(
        max_abs_err=max(row["max_abs_err"], derr),
        decode_ms=kernel_device_ms(lambda: step(ssm_scan_fwd), 100, "ssm_scan_kernel",
                                   "ssm_scan"),
        decode_issue_ms=time_ms(lambda: step(ssm_scan_fwd), 100),
        decode_plain_ms=time_ms(lambda: step(ssm_scan_ref), 50),
        decode_bound_ms=bound(ssm_scan_cost(x, dt, A, Bc, Cc, D, h0),
                              "float32")["bound_ms"])
    log(f"  ssm prefill ms={row['ms']:.4f} (events) device ms={row['device_ms']:.4f} "
        f"(profiler) plain_ms={row['plain_ms']:.2f} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}); decode device "
        f"ms={row['decode_ms']:.5f} (profiler) issue ms={row['decode_issue_ms']:.4f} "
        f"(events, back-to-back wrapper calls) plain_ms={row['decode_plain_ms']:.4f} "
        f"bound_ms={row['decode_bound_ms']:.5f}; library: none")
    del x, dt, A, Bc, Cc, D, h0, y, hT, states, state, y2
    torch.cuda.empty_cache()
    return {"ssm_scan": row}


def ssm_bwd_kernel_phase(dev):
    """B6 at jamba's training microbatch (B=1, S=1024, Di=16384, N=16, all
    f32), inputs as the model makes them and nonzero h0 and dhT, the
    checkpoints from B4's save_states; then ragged S = 37 and 130 (B=2) and
    N = 8; two runs bitwise equal. B4's checkpoints are held against the
    plain forward's first. Tolerance: the reference's backward atol = rtol =
    1e-4 (tests/test_kernels.py); both sides compute in f32 from the same
    inputs and checkpoints and differ in summation order and the
    exponential's rounding."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_bwd, ssm_scan_fwd
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_bwd_cost, ssm_scan_cost
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref
    from repro_torch.parallel.cost import ref_chunk_bytes

    gen = torch.Generator(device=dev).manual_seed(7654)
    tol = BWD_TOL["float32"]
    Di = 16384
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")

    def case(B, S, N):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        dt = F.softplus(randn(B, S, Di) - 1.0)
        A = -(0.5 + 15.5 * torch.rand((Di, N), generator=gen, device=dev))
        fwd = (randn(B, S, Di), dt, A, randn(B, S, N), randn(B, S, N), randn(Di),
               0.5 * randn(B, Di, N))
        return fwd, randn(B, S, Di), 0.5 * randn(B, Di, N)

    def check(label, fwd, dy, dhT):
        y, hT, starts = ssm_scan_fwd(*fwd, save_states=True)
        y_ref, _, starts_ref = ssm_scan_ref(*fwd, save_states=True)
        _check(f"{label} B4 y", y, y_ref, tol)
        _check(f"{label} B4 checkpoints", starts, starts_ref, tol)
        args = (*fwd[:6], dy, starts, dhT)
        got = ssm_scan_bwd(*args)
        ref = ssm_scan_bwd_ref(*args)
        return args, got, starts, max(_check(f"{label} {n}", a, b, tol)
                                      for n, a, b in zip(names, got, ref))

    log("kernel phase: ssm_scan_bwd (B6)")
    B, S, N = 1, TRAIN_SEQ_JAMBA, 16
    fwd, dy, dhT = case(B, S, N)
    args, got, starts, err = check(f"ssm bwd f32 B={B} S={S} Di={Di} N={N}", fwd, dy, dhT)
    again = ssm_scan_bwd(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("ssm_scan_bwd: two runs differ")
    log("  ssm bwd: two runs bitwise equal")
    ref_starts = ref_chunk_bytes(B, 1, S, Di * N)  # at the reference's 64-step chunk
    row = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ssm_scan_bwd(*args), 10),
        device_ms=kernel_device_ms(lambda: ssm_scan_bwd(*args), 10, "ssm_scan_bwd_kernel",
                                   "ssm_scan_bwd"),
        plain_ms=time_ms(lambda: ssm_scan_bwd_ref(*args), 1, warmup=1),
        library_ms=None,  # no single PyTorch call computes the selective-scan backward
        **bound(ssm_scan_bwd_cost(*args), "float32"),
        shape=f"B={B} S={S} Di={Di} N={N}, f32, checkpoints every 8 steps")
    train_bound = bound(ssm_scan_cost(*fwd, save_states=True), "float32")
    b4 = dict(
        train_ms=time_ms(lambda: ssm_scan_fwd(*fwd, save_states=True), 10),
        train_device_ms=kernel_device_ms(lambda: ssm_scan_fwd(*fwd, save_states=True), 10,
                                         "ssm_scan_kernel", "ssm_scan"),
        train_bound_ms=train_bound["bound_ms"], train_bound_by=train_bound["bound_by"],
        train_shape=f"B={B} S={S} Di={Di} N={N} save_states, f32")
    extra = nbytes(starts) - ref_starts
    log(f"  ssm bwd ms={row['ms']:.4f} (events) device ms={row['device_ms']:.4f} (profiler) "
        f"plain_ms={row['plain_ms']:.2f} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}); library: none; B4 with "
        f"save_states ms={b4['train_ms']:.4f} (events) device "
        f"ms={b4['train_device_ms']:.4f} (profiler) bound_ms={b4['train_bound_ms']:.4f} "
        f"({b4['train_bound_by']}); the port's 8-step checkpoints are {extra / 1e6:.1f} MB "
        f"more than the reference's 64-step chunk, written by B4 and read by B6 "
        f"({1e3 * extra / HBM_BYTES_PER_S:.4f} ms each at the memory rate)")
    del fwd, dy, dhT, args, got, again, starts
    for B, S, N in ((2, 37, 16), (2, 130, 16), (2, 130, 8), (1, 1, 8)):
        *_, e = check(f"ssm bwd f32 B={B} S={S} N={N}", *case(B, S, N))
        row["max_abs_err"] = max(row["max_abs_err"], e)
    torch.cuda.empty_cache()
    return row, b4


def profiled(fn, n):
    """torch.profiler over ``n`` calls of ``fn`` and a synchronisation, with
    the host idle for PROFILE_PAD_S at each end of the window. The profiler
    keeps only the device records that fall inside its window. Two runs of
    this script recorded 99 and 49 of B4's 100 back-to-back decode
    launches, where other runs recorded all; the cause was not found. The
    pads keep the launches away from the window's edges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return prof


def kernel_device_ms(fn, n, kernel, op, per_call=1):
    """Mean device time per call of the CUDA kernels whose name holds
    ``kernel``, from torch.profiler over ``n`` calls of ``fn``, each of
    which must launch the op once (the wrapper's counter ``LAUNCHES[op]``
    must rise by exactly ``n``) and ``per_call`` such kernels (decode
    attention: its split pass and its combine). The mean is over the
    launches the profiler recorded, which may drop some of its activity
    records (see ``profiled``); a profile that records fewer than nine in
    ten is taken again, up to PROFILE_TRIES profiles, and then fails, as
    does one that records more launches than were issued."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.kernels import LAUNCHES

    fn()
    torch.cuda.synchronize()
    want = per_call * n
    for attempt in range(1, PROFILE_TRIES + 1):
        before = LAUNCHES[op]
        prof = profiled(fn, n)
        issued = LAUNCHES[op] - before
        if issued != n:
            raise AssertionError(f"{n} calls launched {op} {issued} times")
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel in e.key]
        recorded = sum(e.count for e in events)
        if recorded > want:
            raise AssertionError(f"profiler recorded {recorded} launches of {kernel} "
                                 f"for {want} issued")
        if recorded >= want - want // 10:
            break
        log(f"  profile {attempt} of {PROFILE_TRIES} recorded {recorded} of {want} "
            f"launches of {kernel}")
    else:
        raise AssertionError(f"profiler recorded {recorded} launches of {kernel} "
                             f"for {want} issued, in each of {PROFILE_TRIES} profiles")
    if recorded != want:
        log(f"  profiler recorded {recorded} of {want} launches of {kernel}; "
            f"mean over those recorded")
    return sum(e.self_device_time_total for e in events) * per_call / recorded / 1e3


def library_device_ms(fn, n):
    """Mean device time per call of every CUDA kernel that ``n`` calls of a
    library function launch, from torch.profiler (SDPA beside decode
    attention, whose back-to-back calls the host paces)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    prof = profiled(fn, n)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n / 1e3


def decode_profile(fn, n=5, named=()):
    """The device's busy share of ``n`` calls of ``fn``: the CUDA kernels'
    time from torch.profiler over the wall time of ``n`` unprofiled calls
    (the profiler slows the host, so it does not time the wall), the
    kernels that take the most, and the ms per call of the kernels whose
    names hold each of ``named``. None where the profiler records no device
    time."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    prof = profiled(fn, n)
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(t for _, t in kernels)
    if device_us <= 0:
        return None
    top = sorted(kernels, key=lambda kt: -kt[1])[:5]
    return dict(busy_share=device_us / wall_us,
                wall_ms_per_step=wall_us / n / 1e3,
                device_ms_per_step=device_us / n / 1e3,
                top_kernels_ms={k[:72]: round(t / n / 1e3, 4) for k, t in top},
                named_ms={name: sum(t for k, t in kernels if name in k) / n / 1e3
                          for name in named})


# --------------------------------------------------------------------------
# phase 3: full-width serving through ContinuousBatcher


STARCODER_LAYOUTS = {  # layout: (batcher options, kernels it must launch)
    "paged": (dict(kv_layout="paged"), ("flash_attention", "paged_decode_attention")),
    "paged-int8": (dict(kv_layout="paged", kv_quant="int8"),
                   ("flash_attention", "paged_decode_attention")),
    "dense": (dict(kv_layout="dense"), ("flash_attention", "decode_attention")),
}
RWKV_LAYOUTS = {"dense": (dict(kv_layout="dense"), ("rwkv6_scan",))}
JAMBA_LAYOUTS = {"dense": (dict(kv_layout="dense"),
                           ("flash_attention", "decode_attention", "ssm_scan"))}


def check_released(dev, what):
    """Fail unless the earlier phases released their memory: each model
    phase needs the card to itself."""
    import torch

    left = torch.cuda.memory_allocated(dev)
    log(f"  memory allocated before {what}: {left} bytes")
    if left > LEFT_OVER_BYTES:
        raise AssertionError(f"{left} bytes still allocated before {what}")


def serving_phase(dev, seed, cfg, layouts, cost=False):
    """One ContinuousBatcher run per layout of the model ``cfg``, the counts
    zeroed just before and read just after each. A config with experts
    must launch B2 exactly once per admitted request and layer and the
    decode kernel once per decode step and layer; its layouts route their
    decode steps in different groups (see ``repro_torch.runtime.batching``),
    so only each request's first token must agree across layouts, and the
    dropped expert assignments of each layout are counted in a rerun of
    its requests outside the timed one (``repro_torch.models.mlp.RECORD``)
    and logged. With ``cost`` the phase ends with phase 14's serving steps
    counted and timed on its weights (``_serving_card``), in
    ``summary["cost"]``."""
    import numpy as np
    import torch

    from repro_torch.kernels import KERNEL_NAMES, LAUNCHES, PLAIN_CALLS, reset_counts
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.runtime.batching import ContinuousBatcher, GenRequest

    moe = any(spec.is_moe for spec in DecoderLM(cfg).specs)

    class TimedModel(DecoderLM):
        """Synchronised wall-clock per prefill (by bucket) and decode step."""

        def __init__(self, cfg):
            super().__init__(cfg)
            self.prefill_ms, self.decode_ms = {}, []

        def _timed(self, fn, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t0)

        def prefill(self, params, **kw):
            out, ms = self._timed(super().prefill, params, **kw)
            self.prefill_ms.setdefault(kw["tokens"].shape[1], []).append(ms)
            return out

        def decode_step(self, params, cache, **kw):
            out, ms = self._timed(super().decode_step, params, cache, **kw)
            self.decode_ms.append(ms)
            return out

        def decode_step_paged(self, params, pools, **kw):
            out, ms = self._timed(super().decode_step_paged, params, pools, **kw)
            self.decode_ms.append(ms)
            return out

    def counted_drops(name, kw, timed_tokens):
        """The run's expert assignments and dropped ones, apart for prefills
        (a group of a whole bucket, 16 tokens or more) and decode steps (a
        group of the slots or of one), from a rerun of the same requests
        with the MoE layer's record on; its tokens are compared with the
        timed run's."""
        from repro_torch.models import mlp

        rb, rerun = batcher(DecoderLM(cfg), kw)
        mlp.RECORD = calls = []
        try:
            with torch.inference_mode():
                rb.run()
        finally:
            mlp.RECORD = None
        if not calls or any(keep is None for _, _, keep in calls):
            raise AssertionError(f"{name}: the MoE layers recorded no capacity dispatch")
        out = {}
        for idx, _, keep in calls:
            kind = "prefill" if idx.shape[1] >= 16 else "decode"
            out[kind + "_assignments"] = out.get(kind + "_assignments", 0) + keep.numel()
            out[kind + "_dropped"] = out.get(kind + "_dropped", 0) + int((~keep).sum())
        if kw["kv_layout"] == "dense" and out["decode_dropped"]:
            # a row routed alone sends its k choices to k distinct
            # experts, each with room for one: nothing can drop
            raise AssertionError(f"{name}: the dense step dropped assignments; "
                                 f"its rows are not routed alone")
        out["rerun_tokens_equal"] = [r.tokens for r in rerun] == timed_tokens
        del rb, calls
        return out

    check_released(dev, f"serving {cfg.name}")
    log(f"serving phase: {cfg.name} full width: layers={cfg.num_layers} "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
        f"hd={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"window={cfg.window_size} mixers={cfg.mixer_pattern} "
        f"moe_period={cfg.moe_period} dtype={cfg.dtype}")
    t0 = time.perf_counter()
    probe = TimedModel(cfg)
    params = probe.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  seeded init: {n_params} params, {1e3 * (time.perf_counter() - t0):.0f} ms")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]

    def batcher(model, kw):
        b = ContinuousBatcher(model, params, max_slots=4, max_len=8192,
                              kv_block_size=16, prompt_bucket=16, device=dev, **kw)
        reqs = [GenRequest(i, p, MAX_NEW) for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        return b, reqs

    launches = {name: 0 for name in KERNEL_NAMES}
    tokens, summary = {}, {}
    for name, (kw, needed) in layouts.items():
        model = TimedModel(cfg)
        torch.cuda.reset_peak_memory_stats(dev)
        b, reqs = batcher(model, kw)
        with torch.inference_mode():
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
        if not all(r.finish_step is not None and len(r.tokens) == MAX_NEW for r in reqs):
            raise AssertionError(f"{name}: not every request finished")
        missing = [k for k in needed if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched: {missing}")
        if sum(plain.values()):
            raise AssertionError(f"{name}: plain versions ran on the card: {plain}")
        if moe:
            want = {needed[0]: len(reqs) * cfg.num_layers,
                    needed[1]: len(model.decode_ms) * cfg.num_layers}
            got = {k: counts[k] for k in want}
            if got != want:
                raise AssertionError(f"{name}: launches {got}, expected {want}")
        for k, n in counts.items():
            launches[k] += n
        tokens[name] = [r.tokens for r in reqs]
        n_tok = sum(len(r.tokens) for r in reqs)
        summary[name] = dict(
            requests=len(reqs), tokens=n_tok, steps=b.step_count,
            wall_s=wall, tokens_per_s=n_tok / wall,
            prefill_ms_by_bucket={k: round(sum(v) / len(v), 3)
                                  for k, v in sorted(model.prefill_ms.items())},
            decode_ms_per_step=sum(model.decode_ms) / len(model.decode_ms),
            decode_ms_median=float(np.median(model.decode_ms)),
            decode_steps=len(model.decode_ms),
            kv_cache_bytes=b.kv_cache_bytes(),
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            launches=counts, plain_calls=sum(plain.values()))
        if moe:
            summary[name].update(counted_drops(name, kw, tokens[name]))
        log(f"  {name}: {json.dumps(summary[name])}")
        if name == "dense":  # after the counted run: these launches go uncounted
            pos = torch.as_tensor(b.pos, device=dev)
            with torch.inference_mode():
                prof = decode_profile(lambda: DecoderLM.decode_step(
                    model, params, b.cache_slots, tokens=b.last_tok, pos=pos,
                    route_rows=True))
            log(f"  {name} decode step profile (4 slots): "
                f"{json.dumps(prof) if prof else 'not measured (no device time recorded)'}")
        del b, model
        torch.cuda.empty_cache()
    if cost:
        t0 = time.perf_counter()
        summary["cost"] = _serving_card(cfg, params, dev, seed)
        summary["cost_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    if moe:
        if [t[0] for t in tokens["paged"]] != [t[0] for t in tokens["dense"]]:
            raise AssertionError("first tokens (from the prefill) differ across layouts")
        same = sum(a == b for a, b in zip(tokens["paged"], tokens["dense"]))
        agree = np.mean([a == b for ra, rb in zip(tokens["paged"], tokens["dense"])
                         for a, b in zip(ra, rb)])
        summary["requests_equal_across_layouts"] = int(same)
        log(f"  first tokens equal across layouts; {same} of {len(prompts)} requests "
            f"equal in full, {agree:.4f} of tokens (the layouts route decode steps in "
            f"different groups, as the reference's do)")
    elif "paged" in tokens:
        if tokens["paged"] != tokens["dense"]:
            raise AssertionError("paged tokens differ from dense tokens")
        agree = np.mean([a == b for ra, rb in zip(tokens["paged-int8"], tokens["dense"])
                         for a, b in zip(ra, rb)])
        log(f"  paged tokens == dense tokens: True; paged-int8 agrees with dense "
            f"on {agree:.4f} of tokens")
    del params
    torch.cuda.empty_cache()
    return launches, summary


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# phase 4: full-width f32 logits, kernel path vs plain path


def f32_phase(dev, seed, cfg):
    """Prefill a 513-token prompt (attention: in a 1024 bucket; RWKV and
    Mamba stacks: exact length) and 4 dense decode steps of the model
    ``cfg`` in f32, kernel path against plain path."""
    import numpy as np
    import torch

    from repro_torch.models.decoder import DecoderLM
    from repro_torch.runtime.batching import ContinuousBatcher

    check_released(dev, f"the f32 phase of {cfg.name}")
    cfg = cfg.replace(dtype="float32", param_dtype="float32")
    kern, plain = DecoderLM(cfg), DecoderLM(cfg, plain=True)
    params = kern.init(torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
    rng = np.random.default_rng(seed + 1)
    bucketed = kern.bucketed_prefill
    plen, max_len = 513, 8192
    bucket = 1024 if bucketed else plen
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :plen] = rng.integers(1, cfg.vocab_size, plen)
    toks = torch.as_tensor(toks, device=dev)
    kw = dict(max_len=max_len, true_len=plen if bucketed else None)
    log(f"f32 phase: {cfg.name} full width in float32, {cfg.num_layers} layers, "
        f"prompt {plen} in bucket {bucket}")
    worst = 0.0
    with torch.inference_mode():
        lk, ck = kern.prefill(params, tokens=toks, **kw)
        lp, cp = plain.prefill(params, tokens=toks, **kw)
        for step in range(5):
            scale = lp.abs().max().item()
            rel = (lk - lp).abs().max().item() / scale
            worst = max(worst, rel)
            log(f"  {'prefill' if step == 0 else f'decode {step}'}: max|dlogit|/max|logit|"
                f"={rel:.3e} (max|logit|={scale:.3f})")
            if not rel <= LOGIT_RTOL:
                raise AssertionError(f"f32 kernel vs plain logits: {rel} > {LOGIT_RTOL}")
            if step == 4:
                break
            tok = torch.argmax(lk, -1)[:, None]
            lk, ck = kern.decode_step(params, ck, tokens=tok, pos=plen + step)
            lp, cp = plain.decode_step(params, cp, tokens=tok, pos=plen + step)
        del ck, cp
        if bucketed:
            pool_bytes = {}
            for quant in (None, "int8"):
                b = ContinuousBatcher(kern, params, max_slots=4, max_len=max_len,
                                      kv_layout="paged", kv_quant=quant, device=dev)
                pool_bytes["f32" if quant is None else "int8"] = b.kv_cache_bytes()
                del b
            log(f"  kv_cache_bytes (paged, 4 slots x 8192): {json.dumps(pool_bytes)} "
                f"ratio={pool_bytes['f32'] / pool_bytes['int8']:.3f}")
    del params
    torch.cuda.empty_cache()
    return worst


# --------------------------------------------------------------------------
# phase 5: full-width training through ElasticTrainer


def expected_train_counts(model, n_microbatch_steps):
    """Kernel launches and backward calls one training run must make: per
    microbatch, every scan and attention layer's forward once, twice under
    remat "full" or "dots" (the recompute), and its backward once. Under
    ``flash_vjp`` attention's forward is B2 with statistics and its
    backward the chunked recompute."""
    fwd = 1 if model.cfg.remat == "none" else 2
    vjp = model.cfg.flash_vjp
    mixers = [s.mixer for s in model.layer_specs]
    launches, bwd_calls = {}, {}
    for mixer, name, bwd in (("rwkv", "rwkv6_scan", "rwkv6_scan_bwd"),
                             ("mamba", "ssm_scan", "ssm_scan_bwd"),
                             ("attn", "flash_attention_stats" if vjp else "flash_attention",
                              None)):
        n = n_microbatch_steps * mixers.count(mixer)
        if n:
            launches[name] = fwd * n
            if bwd:
                launches[bwd] = n
            else:
                bwd_calls["flash_attention_bwd_chunked" if vjp else "flash_attention_bwd"] = n
    return launches, bwd_calls


def _trainer_classes():
    """(FewCheckpointer, TimedTrainer), the checkpointer and trainer of the
    training phases (defined here, after ``main`` has put ``src`` on the
    path)."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime.elastic import ElasticTrainer

    class FewCheckpointer(Checkpointer):
        """Writes the first ``n_writes`` checkpoints and no later one: a
        full-width state is 31 GB (rwkv6-3b) or 36 GB (one jamba block),
        and a run keeps its disk writes to one state."""

        def __init__(self, *a, n_writes=1, **kw):
            self.n_writes = n_writes
            super().__init__(*a, **kw)

        def save(self, step, state, *, blocking=False):
            if len(self.all_steps()) >= self.n_writes:
                log(f"  checkpoint at step {step} not written (at most {self.n_writes} "
                    f"per smoke run)")
                return
            t0 = time.perf_counter()
            super().save(step, state, blocking=blocking)
            self.wait()
            size = sum(f.stat().st_size for f in self.dir.rglob("*") if f.is_file())
            log(f"  checkpoint at step {step}: {size} bytes in "
                f"{time.perf_counter() - t0:.1f} s")

    class TimedTrainer(ElasticTrainer):
        """Synchronised wall clock per train step and per revocation."""

        def __init__(self, *a, **kw):
            self.step_ms, self.rescale_ms = [], []
            super().__init__(*a, **kw)

        def _build(self, devices):
            super()._build(devices)
            inner = self.raw_step_fn = self.step_fn

            def timed(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(state, batch)
                torch.cuda.synchronize()
                self.step_ms.append(1e3 * (time.perf_counter() - t0))
                return out

            self.step_fn = timed

        def rescale(self, devices, step, state):
            t0 = time.perf_counter()
            state = super().rescale(devices, step, state)
            torch.cuda.synchronize()
            self.rescale_ms.append(1e3 * (time.perf_counter() - t0))
            return state

    return FewCheckpointer, TimedTrainer


def train_phase(dev, seed, cfg, batch_rows, seq, preempt_at, cost=False):
    """``cfg`` at full width in bf16, global batch ``batch_rows`` x ``seq``
    in the config's microbatches, remat as configured, TRAIN_STEPS steps at
    a constant learning rate, the revocations ``preempt_at``; the counts
    zeroed just before the run and read just after. The run writes at most
    one checkpoint, the first revocation's: the trainer's closing
    checkpoint, and any after the first, are logged and not written. With
    ``cost`` one more step on the trained state is phase 14's, counted, in
    ``summary["cost"]`` beside the last step's wall ms and the profiled
    step's device busy ms."""
    import numpy as np
    import torch

    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import (BWD_CALLS, KERNEL_NAMES, LAUNCHES, PLAIN_CALLS,
                                     reset_counts)
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule

    FewCheckpointer, TimedTrainer = _trainer_classes()
    check_released(dev, f"training {cfg.name}")
    M = cfg.num_microbatches
    log(f"train phase: {cfg.name} full width {cfg.dtype}, {cfg.num_layers} layers "
        f"(mixers {[s.mixer for s in DecoderLM(cfg).layer_specs[:8]]}...), "
        f"moe_period={cfg.moe_period}, batch {batch_rows} x {seq} in {M} microbatches, "
        f"remat={cfg.remat}, grad_acc={cfg.grad_acc_dtype}, moments="
        f"{cfg.opt_moments_dtype}, {TRAIN_STEPS} steps, revocations {preempt_at}")
    model = DecoderLM(cfg)
    opt = AdamW(lr=constant_schedule(1e-4), moments_dtype=cfg.opt_moments_dtype)
    data = SyntheticBatches(cfg, batch_rows, seq, seed=seed)
    want, want_bwd = expected_train_counts(model, TRAIN_STEPS * M)
    want = {name: want.get(name, 0) for name in KERNEL_NAMES}
    want_bwd = {name: want_bwd.get(name, 0) for name in BWD_CALLS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        free = shutil.disk_usage(ckdir).free
        log(f"  checkpoints to a temporary directory, {free / 1e9:.1f} GB free")
        trainer = TimedTrainer(model, opt, data,
                               FewCheckpointer(ckdir, keep=1,
                                               n_writes=min(1, len(preempt_at))),
                               devices=[dev], log=lambda m: log(f"  {m}"))
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.run(TRAIN_STEPS, seed=seed, preempt_at=preempt_at,
                            checkpoint_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain, bwd = dict(LAUNCHES), dict(PLAIN_CALLS), dict(BWD_CALLS)
        peak = torch.cuda.max_memory_allocated(dev)
    losses = [h[1] for h in trainer.history]
    if ([h[0] for h in trainer.history] != list(range(TRAIN_STEPS))
            or trainer.rescales != len(preempt_at)):
        raise AssertionError(f"train: history {trainer.history}, rescales {trainer.rescales}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite losses {losses}")
    if counts != want or bwd != want_bwd or sum(plain.values()):
        raise AssertionError(f"train: launches {counts} (want {want}), backward calls "
                             f"{bwd} (want {want_bwd}), plain calls {plain}")
    steps_ms = list(trainer.step_ms)
    tokens = batch_rows * seq
    summary = dict(
        losses=losses, step_ms=steps_ms,
        tokens_per_s=[tokens / (ms / 1e3) for ms in steps_ms],
        revocation_ms=trainer.rescale_ms,
        run_overhead_ms=1e3 * wall - sum(steps_ms) - sum(trainer.rescale_ms),
        max_memory_allocated=peak,
        launches={k: n for k, n in counts.items() if n}, backward_calls=bwd,
        plain_calls=0)
    log(f"  {json.dumps(summary)}")
    batch = data.batch(TRAIN_STEPS)
    prof = decode_profile(lambda: trainer.step_fn(state, batch), n=1,
                          named=TRAIN_STEP_KERNELS.values())
    log(f"  train step profile: "
        f"{json.dumps(prof) if prof else 'not measured (no device time recorded)'}")
    for op, kernel in TRAIN_STEP_KERNELS.items():
        if prof and counts.get(op):
            log(f"  train step {op} ms={prof['named_ms'][kernel]:.4f} ({cfg.name}, profiler "
                f"device time of the {kernel} launches in one step)")
    summary["profile"] = prof
    if cost:
        t0 = time.perf_counter()
        summary["cost"] = (_count_dict(_counted(lambda: trainer.raw_step_fn(state, batch))),
                           prof["device_ms_per_step"] if prof else float("nan"), steps_ms[-1])
        summary["cost_s"] = time.perf_counter() - t0
    del state, trainer, opt
    torch.cuda.empty_cache()
    return counts, summary


# --------------------------------------------------------------------------
# phase 6: full-width f32 gradients, kernel path vs plain path


def _leaf_gaps(paths, got, ref, device=None):
    """(max|got - ref| / max|ref|, leaf) per leaf, worst first; each pair
    of leaves is compared on ``device`` where one is given."""
    from repro_torch.tree import key

    out = []
    for path, a, b in zip(paths, got, ref):
        if device is not None:
            a, b = a.to(device), b.to(device)
        scale = b.abs().max().item()
        diff = (a - b).abs().max().item()
        out.append((diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf")),
                    key(path)))
    return sorted(out, reverse=True)


def grad_phase(dev, seed):
    """f32 gradients at full width, one 130-token sequence:

    (a) full depth (32 layers): every layer's scan as the kernel path ran
        it, B5 (with its checkpoints) and B7, against the plain versions on
        that layer's own inputs and incoming gradient, within 2e-4 of each
        output's max |value|;
    (b) every parameter leaf, kernel path against plain path, at depth 1,
        within 2e-4 of each leaf's max |grad|;
    (c) every parameter leaf at full depth, against the plain path with its
        scan in float64, which rounds least. At this random init the model's gradient
        is ill-conditioned in depth: the f32 rounding of one layer's scan
        grows through the 32 layers until most leaves of any two f32 paths
        differ by 1e-2 or more, so 2e-4 between the kernel and plain paths
        cannot hold. Each leaf of the kernel path is held instead to within
        DEPTH_RATIO times the plain f32 path's own distance from that path
        (or 2e-4, where that is larger). The kernels' f32 instances carry
        their states and sums in float64 and round only what they store, so
        the kernel path lies near the f64-scan path and (c) reads far below
        its limit; a fault that shows only in depth, such as a gradient wired
        to the wrong layer or a wrong recompute, moves a leaf by O(1) of its
        max, far beyond it. The bf16 instances, the model's path, sum in f32:
        the kernel checks hold them to their plain versions. Two f32 paths
        are two draws of the same amplified rounding, and their distances'
        ratio spreads from leaf to leaf past DEPTH_RATIO: the phase logs, as a
        witness, the same ratio for the plain path with its scan's key rows
        and value columns permuted (reversed, and shuffled from the seed),
        which changes only the order of the f32 sums."""
    import torch

    import repro_torch.models.rwkv as R
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import LAUNCHES, reset_counts
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd, rwkv6_scan_fwd
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.tree import leaves_with_paths, unflatten

    check_released(dev, "the gradient phase")
    S = 130
    cfg = get_config(RWKV_ARCH).replace(dtype="float32", param_dtype="float32")
    tokens = torch.as_tensor(SyntheticBatches(cfg, 1, S, seed=seed).batch(0)["tokens"],
                             device=dev)

    def scan64(r, k, v, w, u, s0, **kw):
        y, sT = rwkv6_scan_ref(*(t.double() for t in (r, k, v, w, u, s0)))
        return y.float(), sT.float()

    def grads(model, params, scan_ref=None, sink=None):
        """Gradients of every leaf; ``scan_ref`` replaces the plain scan,
        ``sink`` collects each kernel-path scan's inputs and dL/dy."""
        def tap(r, k, v, w, u, s0, **kw):
            y, sT = originals[0](r, k, v, w, u, s0, **kw)
            if y.requires_grad:  # the remat recompute's y gets no gradient
                entry = {"in": [t.detach() for t in (r, k, v, w, u, s0)]}
                y.register_hook(lambda g, e=entry: e.update(dy=g.detach()))
                sink.append(entry)
            return y, sT

        flat = [leaf for _, leaf in leaves_with_paths(params)]
        live = [p.requires_grad_(True) for p in flat]
        originals = (R.rwkv6_scan, R.rwkv6_scan_ref)
        if sink is not None:
            R.rwkv6_scan = tap
        if scan_ref is not None:
            R.rwkv6_scan_ref = scan_ref
        try:
            reset_counts()
            loss, _ = model.loss(unflatten(params, live), {"tokens": tokens})
            out = torch.autograd.grad(loss, live)
        finally:
            R.rwkv6_scan, R.rwkv6_scan_ref = originals
        want = 0 if model.plain else model.cfg.num_layers
        if LAUNCHES["rwkv6_scan_bwd"] != want:
            raise AssertionError(f"grad phase: {LAUNCHES['rwkv6_scan_bwd']} backward "
                                 f"launches (want {want})")
        return loss.item(), out

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    # (a) full depth, every layer's scan in place
    log(f"grad phase: {RWKV_ARCH} full width in float32, one sequence of {S} tokens, "
        f"remat={cfg.remat}")
    kern, plain = DecoderLM(cfg), DecoderLM(cfg, plain=True)
    params = kern.init(torch.Generator(device=dev).manual_seed(seed + 2), device=dev)
    paths = [path for path, _ in leaves_with_paths(params)]
    taps = []
    loss_k, g_k = grads(kern, params, sink=taps)
    taps = [e for e in taps if "dy" in e]
    if len(taps) != cfg.num_layers:
        raise AssertionError(f"grad phase: {len(taps)} scans tapped")
    names = ("y", "dr", "dk", "dv", "dw", "du", "ds0")
    worst_in_place = dict.fromkeys(names, 0.0)
    for entry in taps:
        r, k, v, w, u, s0 = entry["in"]
        dy, dsT = entry["dy"].float().contiguous(), torch.zeros_like(s0)
        y_k, _, st_k = rwkv6_scan_fwd(r, k, v, w, u, s0, save_states=True)
        y_p, _, st_p = rwkv6_scan_ref(r, k, v, w, u, s0, save_states=True)
        got = (y_k, *rwkv6_scan_bwd(r, k, v, w, dy, u, st_k, dsT))
        ref = (y_p, *rwkv6_scan_bwd_ref(r, k, v, w, dy, u, st_p, dsT))
        for name, a, b in zip(names, got, ref):
            if name == "du":
                a, b = a.sum(dim=(0, 2)), b.sum(dim=(0, 2))
            worst_in_place[name] = max(worst_in_place[name], rel(a, b))
    log(f"  (a) {len(taps)} layers in place, B5/B7 vs plain, worst of max: "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst_in_place.items()}))
    del taps
    loss_p, g_p = grads(plain, params)
    _, g_64 = grads(plain, params, scan_ref=scan64)
    gap, floor, off = (_leaf_gaps(paths, a, b)
                       for a, b in ((g_k, g_p), (g_p, g_64), (g_k, g_64)))
    del g_k
    plain_off = {leaf: g for g, leaf in floor}

    def ratios(gaps):
        return sorted(((g / max(DEPTH_RATIO * plain_off[leaf], LOGIT_RTOL), g,
                        plain_off[leaf], leaf) for g, leaf in gaps), reverse=True)

    ratio = ratios(off)
    witness = {}
    for label, order in (("reversed", lambda n: torch.arange(n - 1, -1, -1)),
                         ("shuffled", lambda n: torch.randperm(
                             n, generator=torch.Generator().manual_seed(seed)))):
        _, g_q = grads(plain, params, scan_ref=_permuted_scan(order))
        witness[label] = ratios(_leaf_gaps(paths, g_q, g_64))
        del g_q
    del g_p, g_64, params
    torch.cuda.empty_cache()

    def over(gaps):
        return f"{sum(g > LOGIT_RTOL for g, _ in gaps)} of {len(gaps)} leaves over {LOGIT_RTOL}"

    log(f"  (c) every leaf at full depth: loss kernel {loss_k:.6f} plain {loss_p:.6f}; "
        f"kernel vs plain worst {gap[0][0]:.3e} ({gap[0][1]}), {over(gap)}; from the "
        f"f64-scan path: kernel worst {off[0][0]:.3e} ({off[0][1]}), plain f32 worst "
        f"{floor[0][0]:.3e} ({floor[0][1]}), {over(floor)}; kernel's distance over "
        f"max({DEPTH_RATIO} x plain's, {LOGIT_RTOL}), worst {ratio[0][0]:.3f} ({ratio[0][3]}: "
        f"{ratio[0][1]:.3e} vs {ratio[0][2]:.3e}), {sum(q > 1 for q, *_ in ratio)} "
        f"of {len(ratio)} leaves over 1")
    for label, q in witness.items():
        log(f"  (c) witness, the plain path with its scan's rows and columns {label} (f32 "
            f"sums in another order) from the f64-scan path: its distance over "
            f"max({DEPTH_RATIO} x plain's, {LOGIT_RTOL}), worst {q[0][0]:.3f} ({q[0][3]}: "
            f"{q[0][1]:.3e} vs {q[0][2]:.3e}), {sum(x > 1 for x, *_ in q)} of {len(q)} "
            f"leaves over 1")

    # (b) every leaf at depth 1
    cfg1 = cfg.replace(num_layers=1)
    kern, plain = DecoderLM(cfg1), DecoderLM(cfg1, plain=True)
    params = kern.init(torch.Generator(device=dev).manual_seed(seed + 3), device=dev)
    paths = [path for path, _ in leaves_with_paths(params)]
    _, g_k = grads(kern, params)
    _, g_p = grads(plain, params)
    _, g_64 = grads(plain, params, scan_ref=scan64)
    gap1, floor1 = _leaf_gaps(paths, g_k, g_p), _leaf_gaps(paths, g_p, g_64)
    log(f"  (b) every leaf at depth 1: kernel vs plain worst {gap1[0][0]:.3e} "
        f"({gap1[0][1]}); plain vs plain with an f64 scan worst {floor1[0][0]:.3e}")
    del params, g_k, g_p, g_64
    torch.cuda.empty_cache()
    worst = max(max(worst_in_place.values()), gap1[0][0])
    if not worst <= LOGIT_RTOL:
        raise AssertionError(f"f32 gradients, kernel vs plain: {worst} > {LOGIT_RTOL}: "
                             f"in place {worst_in_place}, depth 1 {gap1[:3]}")
    if not ratio[0][0] <= 1:
        raise AssertionError(f"f32 gradients at full depth: the kernel path is farther "
                             f"from the f64-scan path than {DEPTH_RATIO} x the plain path: "
                             f"{ratio[:5]}")
    return worst, ratio[0][0]


def _permuted_scan(order):
    """The plain RWKV-6 scan with the key rows and the value columns of its
    state permuted by ``order(hd)`` and put back after: the same function,
    its f32 sums over rows and columns taken in another order."""
    import torch

    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    def scan(r, k, v, w, u, s0, **kw):
        p = order(r.shape[-1]).to(r.device)
        back = torch.argsort(p)
        y, sT = rwkv6_scan_ref(r[..., p], k[..., p], v[..., p], w[..., p], u[:, p],
                               s0[:, :, p][..., p])
        return y[..., back], sT[:, :, back][..., back]

    return scan


def jamba_grad_phase(dev, seed, study=False):
    """f32 gradients of one full-width jamba block (JAMBA_BLOCK: 7 Mamba
    layers and 1 attention layer, 9.0 B parameters, 36.0 GB), one 130-token
    sequence (a ragged last checkpoint chunk), within 2e-4 of each output's
    max:

    (a) every Mamba layer's scan as the kernel path ran it, B4 (with its
        checkpoints) and B6, against the plain versions on that layer's own
        inputs and incoming gradient; the attention layer's B2 output and
        its backward's dq, dk, dv against autograd through the plain
        attention on its own q, k, v and incoming gradient;
    (b) every leaf of the 7 Mamba and 1 attention mixers (3.09 B
        parameters, 12.4 GB of f32 gradient a path), kernel path against
        plain path; the other leaves take no gradient, so both paths'
        gradients fit beside the parameters.

    ``study`` (``--jamba-grad-study``, not part of the smoke run) also
    prints, for (a), each kernel's and plain version's distance from
    float64 on the same inputs, and for (b) each mixer leaf's distance
    from an f64 path (the kernel model with its scans and attention
    computed in float64) for five paths: kernels throughout, the plain
    model, the scan kernels with plain attention, plain scans with the
    attention kernel, and the scan op running its plain versions (B4's and
    B6's algorithm in plain code) with plain attention, so that each
    kernel's share of (b) shows. It checks only after printing them."""
    import torch

    import repro_torch.kernels.ssm_scan.ops as SO
    import repro_torch.models.attention as A
    import repro_torch.models.mamba as M
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import BWD_CALLS, LAUNCHES, reset_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_bwd, ssm_scan_fwd
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.tree import leaves_with_paths, unflatten

    check_released(dev, "the jamba gradient phase")
    S = 130
    cfg = get_config(JAMBA_ARCH).replace(dtype="float32", param_dtype="float32",
                                         **JAMBA_BLOCK)
    tokens = torch.as_tensor(SyntheticBatches(cfg, 1, S, seed=seed).batch(0)["tokens"],
                             device=dev)
    kern, plain = DecoderLM(cfg), DecoderLM(cfg, plain=True)
    n_mamba = [s.mixer for s in kern.layer_specs].count("mamba")
    params = kern.init(torch.Generator(device=dev).manual_seed(seed + 4), device=dev)
    flat = list(leaves_with_paths(params))
    mixer = [i for i, (path, _) in enumerate(flat)
             if path[0] == "layers" and path[2] in ("mamba", "attn")]
    paths = [flat[i][0] for i in mixer]
    log(f"grad phase: {cfg.name} full width in float32, {cfg.num_layers} layers "
        f"({n_mamba} Mamba), one sequence of {S} tokens, remat={cfg.remat}, seed {seed}; "
        f"{sum(flat[i][1].numel() for i in mixer)} mixer parameters of "
        f"{sum(p.numel() for _, p in flat)}")

    def grads(model, scan=None, attn=None, sink=None):
        """Gradients of the mixer leaves; ``scan`` and ``attn`` replace the
        kernel model's scan op and flash op, ``sink`` collects each scan's
        and attention's inputs and incoming gradient."""
        def tap(orig, kind):
            def fn(*a, **kw):
                out = orig(*a, **kw)
                y = out[0] if kind == "ssm" else out
                if y.requires_grad:  # the remat recompute's output gets no gradient
                    entry = {"kind": kind, "in": [t.detach() for t in a], "kw": kw}
                    y.register_hook(lambda g, e=entry: e.update(dy=g.detach()))
                    sink.append(entry)
                return out
            return fn

        live = [p for _, p in flat]
        for i in mixer:
            live[i] = live[i].detach().requires_grad_(True)
        originals = (M.ssm_scan, A.flash_attention)
        M.ssm_scan, A.flash_attention = scan or M.ssm_scan, attn or A.flash_attention
        if sink is not None:
            M.ssm_scan = tap(M.ssm_scan, "ssm")
            A.flash_attention = tap(A.flash_attention, "attn")
        try:
            reset_counts()
            loss, _ = model.loss(unflatten(params, live), {"tokens": tokens})
            out = torch.autograd.grad(loss, [live[i] for i in mixer])
        finally:
            M.ssm_scan, A.flash_attention = originals
        want = (0, 0) if model.plain else (0 if scan else n_mamba, 0 if attn else 1)
        got = (LAUNCHES["ssm_scan_bwd"], BWD_CALLS["flash_attention_bwd"])
        if got != want:
            raise AssertionError(f"grad phase: (B6 launches, attention backward calls) "
                                 f"{got}, want {want}")
        return loss.item(), list(out)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    # (a) every layer's kernels in place
    taps = []
    loss_k, g_k = grads(kern, sink=taps)
    taps = [e for e in taps if "dy" in e]
    if [e["kind"] for e in taps].count("ssm") != n_mamba or len(taps) != n_mamba + 1:
        raise AssertionError(f"grad phase: tapped {[e['kind'] for e in taps]}")
    worst_in_place, from_f64 = {}, {}

    def note(name, value):
        worst_in_place[name] = max(worst_in_place.get(name, 0.0), value)

    def note64(name, got, ref, exact):
        """study: the kernel's and the plain version's distance from float64
        on the same inputs."""
        d = [((t.double() - exact).abs().max() / exact.abs().max()).item() for t in (got, ref)]
        from_f64[name] = [max(a, b) for a, b in zip(from_f64.get(name, (0.0, 0.0)), d)]

    for entry in taps:
        if entry["kind"] == "ssm":
            x, dt, A_, Bc, Cc, D, h0 = entry["in"]
            dy, dhT = entry["dy"].float().contiguous(), torch.zeros_like(h0)
            y_k, _, st_k = ssm_scan_fwd(x, dt, A_, Bc, Cc, D, h0, save_states=True)
            y_p, _, st_p = ssm_scan_ref(x, dt, A_, Bc, Cc, D, h0, save_states=True)
            got = (y_k, st_k, *ssm_scan_bwd(x, dt, A_, Bc, Cc, D, dy, st_k, dhT))
            ref = (y_p, st_p, *ssm_scan_bwd_ref(x, dt, A_, Bc, Cc, D, dy, st_p, dhT))
            names = ("y", "h_starts", "dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
            for name, a, b in zip(names, got, ref):
                note(name, rel(a, b))
            if study:
                a64 = [t.double() for t in (x, dt, A_, Bc, Cc, D, h0)]
                y64, _, st64 = ssm_scan_ref(*a64, save_states=True)
                exact = (y64, st64, *ssm_scan_bwd_ref(*a64[:6], dy.double(), st64,
                                                      dhT.double()))
                for name, a, b, c in zip(names, got, ref, exact):
                    note64(name, a, b, c)
        else:
            q, k, v = entry["in"]
            do, kw = entry["dy"], entry["kw"]
            o_k, o_p = flash_attention_fwd(q, k, v, **kw), attention_ref(q, k, v, **kw)
            note("attn o", rel(o_k, o_p))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            with torch.enable_grad():
                ref = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, do)
            got = flash_attention_bwd(q, k, v, do, **kw)
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                note(name, rel(a, b))
            if study:
                a64 = [t.double() for t in (q, k, v)]
                note64("attn o", o_k, o_p, _attention_f64(*a64, **kw))
                for name, a, b, c in zip(("dq", "dk", "dv"), got, ref,
                                         flash_attention_bwd(*a64, do.double(), **kw)):
                    note64(name, a, b, c)
    log(f"  (a) {n_mamba} Mamba layers and the attention layer in place, kernels vs "
        f"plain, worst of max: "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst_in_place.items()}))
    if study:
        log("  study (a): distance from float64 on the same inputs, worst of max, "
            "[kernel, plain]: " + json.dumps({k: [float(f"{d:.3e}") for d in v]
                                              for k, v in from_f64.items()}))
    del taps

    # (b) every mixer leaf, kernel path vs plain path
    loss_p, g_p = grads(plain)
    gap = _leaf_gaps(paths, g_k, g_p)
    log(f"  (b) every mixer leaf: loss kernel {loss_k:.6f} plain {loss_p:.6f}; kernel vs "
        f"plain worst {gap[0][0]:.3e} ({gap[0][1]}), next {gap[1][0]:.3e} ({gap[1][1]}); "
        f"{sum(g > LOGIT_RTOL for g, _ in gap)} of {len(gap)} leaves over {LOGIT_RTOL}")
    if study:  # each path's distance from the f64 path, whose gradients wait on the host
        done = {"kernels throughout": [t.cpu() for t in g_k],
                "plain model": [t.cpu() for t in g_p]}
        mixes = {  # name: (replaced ops, whether the scan op runs its plain versions)
            "scan kernels, plain attention": (dict(attn=attention_ref), False),
            "plain scans, attention kernel": (dict(scan=ssm_scan_ref), False),
            "the scan op on its plain versions, plain attention":
                (dict(scan=M.ssm_scan, attn=attention_ref), True)}
        del g_k, g_p
        torch.cuda.empty_cache()
        g_64 = [t.cpu() for t in grads(kern, scan=_scan_f64, attn=_attention_f64)[1]]
        torch.cuda.empty_cache()
        for name in list(done) + list(mixes):
            if name in done:
                g = done.pop(name)
            else:  # B4's and B6's algorithm in plain code on the card, where asked
                ops, twins = mixes[name]
                saved = SO.ssm_scan_fwd, SO.ssm_scan_bwd
                if twins:
                    SO.ssm_scan_fwd, SO.ssm_scan_bwd = ssm_scan_ref, ssm_scan_bwd_ref
                try:
                    g = grads(kern, **ops)[1]
                finally:
                    SO.ssm_scan_fwd, SO.ssm_scan_bwd = saved
            off = _leaf_gaps(paths, g, g_64, device=dev)
            at = {leaf: d for d, leaf in off}
            log(f"  study: {name} from the f64 path: worst {off[0][0]:.3e} ({off[0][1]}), "
                f"next {off[1][0]:.3e} ({off[1][1]}), at {gap[0][1]} {at[gap[0][1]]:.3e}; "
                f"{sum(d > LOGIT_RTOL for d, _ in off)} of {len(off)} leaves over "
                f"{LOGIT_RTOL}; top 5 "
                + json.dumps({leaf: float(f"{d:.3e}") for d, leaf in off[:5]}))
            del g
            torch.cuda.empty_cache()
        del g_64
    else:
        del g_k, g_p
    del params, flat
    torch.cuda.empty_cache()
    worst = max(worst_in_place.values())
    if not worst <= LOGIT_RTOL:
        raise AssertionError(f"jamba f32 gradients in place, kernels vs plain: {worst} > "
                             f"{LOGIT_RTOL}: {worst_in_place}")
    if not gap[0][0] <= LOGIT_RTOL:
        raise AssertionError(f"jamba f32 mixer gradients, kernel vs plain: {gap[:3]} over "
                             f"{LOGIT_RTOL}")
    return worst, gap[0][0]


def _scan_f64(x, dt, A, Bc, Cc, D, h0, **kw):
    """The plain selective scan computed in float64, returned in f32."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    y, hT = ssm_scan_ref(*(t.double() for t in (x, dt, A, Bc, Cc, D, h0)))
    return y.float(), hT.float()


def _attention_f64(q, k, v, *, causal=True, window=0, softcap=0.0, prefix_len=0,
                   q_offset=0):
    """The plain attention computed in float64 (probabilities not rounded
    to V's dtype), returned in q's dtype; differentiable by autograd."""
    import torch

    from repro_torch.kernels.flash_attention.ref import allowed

    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqh,bksh->bkgqs", q.double().reshape(B, KV, H // KV, Sq, hd),
                     k.double()) * hd**-0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ok = allowed(Sq, Sk, q.device, causal=causal, window=window, prefix_len=prefix_len,
                 q_offset=q_offset)
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bksh->bkgqh", p, v.double()).reshape(B, H, Sq, hd).to(q.dtype)


# --------------------------------------------------------------------------
# phase 7: the paper's scheduler, its fluid engine on the card


FLEET_SCENARIOS = ("coaster_r3", "google_r3")   # yahoo_like and google_like traces
FLEET_CUBE = {                                  # benchmarks/sweep_jax.py's grid: 280 points
    "replace_fraction": [0.0, 0.25, 0.5, 0.75, 1.0],
    "threshold": [float(x) for x in (0.85 + 0.02 * i for i in range(8))],
    "max_transient": [40.0 * i for i in range(7)],
}
FLEET_RTOL = 1e-5             # summaries; series to this share of their max |value|
FLEET_PROFILE_SLOTS = 288     # slots of coaster_r3 under the profiler (48 min of the day)
FLEET_BUDGET_S = 60.0


def _fleet_close(what, got, ref, *, series=False):
    """Largest miss of ``got`` against ``ref`` (dicts of metrics, or of
    series when ``series``), relative to each metric or to each series' max
    |value|; raises beyond FLEET_RTOL."""
    import numpy as np

    worst = 0.0
    for k, v in ref.items():
        g, v = np.asarray(got[k], np.float64), np.asarray(v, np.float64)
        scale = np.abs(v).max(initial=0.0) if series else np.abs(v)
        miss = float((np.abs(g - v) / np.maximum(scale, 1e-30)).max(initial=0.0))
        if g.shape != v.shape or not miss <= FLEET_RTOL:
            raise AssertionError(f"fleet {what} {k}: card vs CPU {miss:.3e} over "
                                 f"{FLEET_RTOL} (shapes {g.shape}, {v.shape})")
        worst = max(worst, miss)
    return worst


def fleet_phase(dev):
    """The scheduler at the paper's §4 scale (4000 servers, N_s = 80, 24 h in
    10 s slots) through its entry points: ``exp.run(name, "fluid")`` for the
    yahoo_like and google_like presets and ``exp.sweep`` over the 280-point
    (replace fraction x threshold x budget) cube, each on the card and on
    the CPU from one trace, and ``launch.sim.main`` on the card. Card and
    CPU must agree to FLEET_RTOL (series to that share of their max); the
    cube's best point must be the same. The run is enqueued without a host
    sync (checked under the sync debug mode that raises on one); a profile
    of its first FLEET_PROFILE_SLOTS slots gives the kernels a slot launches
    and the device's busy share. Wall times are host clocks around work
    that ends in a synchronisation. Returns the ``fleet`` summary."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from repro_torch import exp
    from repro_torch.core import simtorch
    from repro_torch.launch import sim as sim_launcher
    from repro_torch.sched import get_scenario

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    t_phase = time.perf_counter()
    summary = {"scenarios": {}}
    traces, card_runs = {}, {}
    for name in FLEET_SCENARIOS:
        t0 = time.perf_counter()
        traces[name] = tr = get_scenario(name).trace()
        trace_ms = 1e3 * (time.perf_counter() - t0)
        res, ms = {}, {}
        for d in (dev, "cpu"):
            res[d], ms[d] = timed(lambda: exp.run(name, "fluid", trace=tr, device=d))
        card_runs[name] = res[dev]
        n_slots = len(res["cpu"].series["lr"])
        row = dict(jobs=tr.n_jobs, tasks=tr.n_tasks, slots=n_slots, lanes=1,
                   trace_ms=trace_ms, card_ms=ms[dev], cpu_ms=ms["cpu"],
                   card_us_per_slot=1e3 * ms[dev] / n_slots,
                   max_rel_err_metrics=_fleet_close(f"{name} metrics", res[dev].metrics,
                                                    res["cpu"].metrics),
                   max_err_series=_fleet_close(f"{name} series", res[dev].series,
                                               res["cpu"].series, series=True),
                   short_avg_wait_s=res[dev].metrics["short_avg_wait_s"],
                   avg_active_transients=res[dev].metrics["avg_active_transients"])
        summary["scenarios"][name] = row
        log(f"  fleet {name}: {json.dumps(row)}")

    tr = traces["coaster_r3"]
    cube, ms = {}, {}
    for d in (dev, "cpu"):
        cube[d], ms[d] = timed(lambda: exp.sweep("coaster_r3", FLEET_CUBE, engine="fluid",
                                                 trace=tr, device=d))
    best = {d: cube[d].best("short_avg_wait_s") for d in cube}
    if cube[dev].shape != (5, 8, 7) or any(
            best[dev][a] != best["cpu"][a] for a in FLEET_CUBE):
        raise AssertionError(f"fleet cube: card's best point {best[dev]} is not the "
                             f"CPU's {best['cpu']}")
    summary["cube"] = dict(points=int(np.prod(cube[dev].shape)), slots=summary[
        "scenarios"]["coaster_r3"]["slots"], card_ms=ms[dev], cpu_ms=ms["cpu"],
        max_rel_err=_fleet_close("cube metrics", cube[dev].metrics, cube["cpu"].metrics),
        best=best[dev])
    log(f"  fleet cube: {json.dumps(summary['cube'])}")

    # the launcher synthesizes the same trace (seed 42) and runs the same
    # program on the card: its metrics equal exp.run's above, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        out_path = pathlib.Path(tmp) / "coaster_r3.runresult.json"
        _, ms_launch = timed(lambda: sim_launcher.main(
            ["--scenario", "coaster_r3", "--engine", "fluid", "--out", str(out_path)]))
        launched = json.loads(out_path.read_text())
    if launched["metrics"] != card_runs["coaster_r3"].metrics:
        raise AssertionError(f"fleet launcher: {launched['metrics']} is not exp.run's "
                             f"{card_runs['coaster_r3'].metrics}")
    summary["launcher"] = dict(card_ms=ms_launch, run_wall_s=launched["wall_time_s"])
    log(f"  fleet launcher: {json.dumps(summary['launcher'])}")

    # the slot loop never waits on the card, and what a slot costs there
    sc = get_scenario("coaster_r3")
    lw, sw, fcfg, ctrl = sc.fluid_setup(trace=tr)
    lw, sw = lw[:FLEET_PROFILE_SLOTS], sw[:FLEET_PROFILE_SLOTS]
    pol = sc.fluid_params()
    run = lambda: simtorch.simulate_fluid(lw, sw, fcfg, policy=pol, device=dev, **ctrl)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, wall_ms = timed(run)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t0 = time.perf_counter()
    prof = profiled(run, 1)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    summary["profile"] = dict(
        slots=FLEET_PROFILE_SLOTS, wall_us_per_slot=1e3 * wall_ms / FLEET_PROFILE_SLOTS,
        kernels_per_slot=sum(e.count for e in kernels) / FLEET_PROFILE_SLOTS,
        device_us_per_slot=device_us / FLEET_PROFILE_SLOTS,
        busy_share=device_us / (1e3 * wall_ms) if device_us > 0 else None,
        profile_s=time.perf_counter() - t0)
    log(f"  fleet profile: {json.dumps(summary['profile'])}")
    summary["phase_s"] = time.perf_counter() - t_phase
    if summary["phase_s"] > FLEET_BUDGET_S:
        raise AssertionError(f"fleet phase took {summary['phase_s']:.1f} s, over its "
                             f"{FLEET_BUDGET_S} s budget")
    return summary


# --------------------------------------------------------------------------
# phase 8: the elastic serving fleet, full-width starcoder2-3b behind its hook


SERVE_FLEET = "serve_batched_yahoo"
SERVE_FLEET_PAPER = dict(replicas=80, requests=20000, ticks=36531)
SERVE_FLEET_CUT = {"horizon": 600.0}   # run (b): quick scale, the first 10 minutes
SERVE_FLEET_BUDGET_S = 120.0


def serving_fleet_phase(dev, seed):
    """The elastic serving fleet through its entry points: (a) the paper's
    scale on the host, (b) the cut quick trace with full-width starcoder2-3b
    on the card behind ``decode_fn``, (c) the ``launch.serve`` fleet mode
    (see the module docstring, phase 8). A hook call ends in the batcher's
    read of the new tokens, which waits for the card, so host time around
    it is a step's time; a call that admitted requests holds their
    prefills too. Returns the ``serving_fleet`` summary and (b)'s launch
    counts."""
    import numpy as np
    import torch

    from repro_torch import exp
    from repro_torch.examples.serve_bursty import build_decoder
    from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models.decoder import DecoderLM

    check_released(dev, "the serving fleet")
    t_phase = time.perf_counter()
    summary = {}

    t0 = time.perf_counter()
    paper = exp.run(SERVE_FLEET, "serving")
    wl = paper.meta["workload"]
    got = dict(replicas=paper.config["n_replicas"], requests=wl["n_requests"],
               ticks=wl["max_ticks"])
    if got != SERVE_FLEET_PAPER:
        raise AssertionError(f"serving fleet at the paper's scale: {got}, not "
                             f"{SERVE_FLEET_PAPER}")
    summary["paper"] = dict(**got, dropped=wl["n_requests_dropped"],
                            wall_s=time.perf_counter() - t0, metrics=paper.metrics)
    log(f"  serving fleet (a) paper scale, host, no model: {json.dumps(summary['paper'])}")

    # (b): the cut trace on the host, with a hook that only counts its
    # calls and with none, then with the full-width model behind the hook
    cut = dict(quick=True, seed=0, sim_seed=0, trace_overrides=SERVE_FLEET_CUT,
               record_events=True)
    calls = []  # the replica of each hook call
    counted = exp.run(SERVE_FLEET, "serving", decode_fn=calls.append, **cut)
    bare = exp.run(SERVE_FLEET, "serving", **cut)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    decode_fn, stats = build_decoder("paged", arch=ARCH, smoke=False, device=dev,
                                     seed=seed, max_len=8192, prompt_lens=PROMPT_LENS,
                                     max_new=MAX_NEW)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b = stats["batcher"]
    step_ms, prefill_step_ms = [], []

    def timed_hook(rid):
        n_req = len(stats["requests"])
        t = time.perf_counter()
        decode_fn(rid)
        ms = 1e3 * (time.perf_counter() - t)
        (prefill_step_ms if len(stats["requests"]) > n_req else step_ms).append(ms)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = exp.run(SERVE_FLEET, "serving", decode_fn=timed_hook, **cut)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
    n_attn = sum(s.mixer == "attn" for s in b.model.layer_specs)
    n_req = len(stats["requests"])
    want = {"paged_decode_attention": b.step_count * n_attn,
            "flash_attention": n_req * n_attn}
    if not stats["calls"] == b.step_count == len(calls) > 0:
        raise AssertionError(f"serving fleet: {stats['calls']} hook calls and "
                             f"{b.step_count} batcher steps; the host run called "
                             f"its hook {len(calls)} times")
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"serving fleet: launches {counts}, want {want}")
    if sum(plain.values()):
        raise AssertionError(f"serving fleet: plain versions ran on the card: {plain}")
    for other in (counted, bare):
        if json.dumps(run.metrics) != json.dumps(other.metrics) or not np.array_equal(
                run.series["event_counts"], other.series["event_counts"]):
            raise AssertionError(f"serving fleet: metrics {run.metrics} or event counts "
                                 f"differ from the run without the model "
                                 f"{other.metrics}")
    hook_s = 1e-3 * (sum(step_ms) + sum(prefill_step_ms))
    summary["model"] = dict(
        cut=f"quick scale, trace horizon {SERVE_FLEET_CUT['horizon']} s", arch=ARCH,
        layout="paged", slots=b.max_slots, max_len=b.max_len,
        page_tokens=b.kv_block_size, requests=run.meta["workload"]["n_requests"],
        ticks=run.meta["workload"]["max_ticks"], hook_calls=stats["calls"],
        decoder_requests=n_req, tokens=stats["n"], wall_s=wall, init_s=init_s,
        hook_s=hook_s, fleet_host_s=wall - hook_s,
        decode_ms_per_step=float(np.mean(step_ms)),
        decode_ms_median=float(np.median(step_ms)),
        prefill_step_ms=float(np.mean(prefill_step_ms)) if prefill_step_ms else None,
        tokens_per_s=stats["n"] / hook_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        kv_cache_bytes=b.kv_cache_bytes(), launches=counts,
        plain_calls=sum(plain.values()),
        event_counts=run.meta["obs"]["events"], metrics=run.metrics)
    # after the counted run: these launches go uncounted
    t0 = time.perf_counter()
    pos = torch.as_tensor(b.pos, device=dev)
    table = torch.as_tensor(b.allocator.table, device=dev)
    with torch.inference_mode():
        prof = decode_profile(lambda: DecoderLM.decode_step_paged(
            b.model, b.params, b.pools, tokens=b.last_tok, pos_vec=pos, pages=table))
    summary["model"]["decode_profile"] = prof
    summary["model"]["profile_s"] = time.perf_counter() - t0
    log(f"  serving fleet (b) {summary['model']['cut']}, {ARCH} paged on the card "
        f"behind decode_fn: {json.dumps(summary['model'])}")
    del decode_fn, stats, b, timed_hook, pos, table
    gc.collect()  # the fleet's view holds the fleet, and the fleet the hook
    torch.cuda.empty_cache()

    # (c): the launcher's fleet mode synthesizes the same trace (seed 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = pathlib.Path(tmp) / "serve_yahoo.runresult.json"
        serve_launcher.main(["--scenario", "serve_yahoo", "--quick", "--out",
                             str(out_path)])
        launched = json.loads(out_path.read_text())
    launch_s = time.perf_counter() - t0
    direct = exp.run("serve_yahoo", "serving", quick=True, seed=0, sim_seed=0)
    if launched["metrics"] != direct.metrics:
        raise AssertionError(f"serving launcher: {launched['metrics']} is not "
                             f"exp.run's {direct.metrics}")
    summary["launcher"] = dict(wall_s=launch_s, run_wall_s=launched["wall_time_s"],
                               requests=direct.metrics["n_requests"])
    log(f"  serving fleet (c) launch.serve --scenario serve_yahoo --quick: "
        f"{json.dumps(summary['launcher'])}")
    summary["phase_s"] = time.perf_counter() - t_phase
    if summary["phase_s"] > SERVE_FLEET_BUDGET_S:
        raise AssertionError(f"serving fleet phase took {summary['phase_s']:.1f} s, "
                             f"over its {SERVE_FLEET_BUDGET_S} s budget")
    return summary, counts


# --------------------------------------------------------------------------
# phase 9: serving_torch, the serving fleet as one kernel launch on the card


SERVE_TORCH_SCENARIO = "serve_batched_yahoo"
#: the JAX package's serving_jax run of SERVE_TORCH_SCENARIO at the paper's
#: scale (quick=False, seed 42, sim_seed 0); the chip machine has no JAX, so
#: tests/test_torch_serving_torch.py holds these to a fresh reference run
SERVE_TORCH_GOLDEN = {
    "short_avg_wait_s": 3.05525, "short_max_wait_s": 302.0, "short_p50_wait_s": 0.0,
    "short_p90_wait_s": 0.0, "short_p99_wait_s": 81.0,
    "avg_active_transients": 43.82779009608278, "peak_active_transients": 80.0,
    "n_requests": 20000.0, "n_done": 20000.0, "n_unfinished": 0.0, "n_hedges": 0.0,
    "n_hedge_cancelled": 0.0, "n_revocations": 0.0, "n_transients_used": 2095.0,
    "avg_transient_lifetime_s": 756.7176355642404,
    "avg_slot_occupancy": 0.12391685324406966,
    "transient_slot_occupancy": 0.0941195917959978, "n_queue_overflow": 0.0,
    "n_throttled": 0.0}
SERVE_TORCH_GOLDEN_EVENTS = "3666acc7d5140de1f8898aa6c7bcf7f5949b79b65f06f5768bbd7fa75d5575f9"
SERVE_TORCH_PAPER_SPEC = {
    "n_ondemand": 80, "transient_cap": 120, "slot_cap": 4, "queue_cap": 16384,
    "route_cap": 256, "horizon": 36531, "n_requests": 32768, "pipe_len": 30,
    "probe_d": 2, "probe_retries": 3, "flush_cap": 128, "admit_window": 8,
    "hedge_scan": 8, "hedge_cap": 16, "lifetime_cap": 4096, "drain_code": 0,
    "spot_pricing": False, "n_tenants": 1}
#: run (a): the quick presets held bit for bit to the plain version
SERVE_TORCH_QUICK = ("serve_batched_yahoo", "serve_spot", "serve_tenant_trio")
#: run (c): the (threshold x max_transient x max_slots) cube x sim_seeds
SERVE_TORCH_CUBE = {"threshold": [0.25, 0.5, 0.75], "max_transient": [60, 120, 180],
                    "max_slots": [1, 2, 4]}
SERVE_TORCH_CUBE_SEEDS = (0, 1)
SERVE_TORCH_CUBE_LANES = (5, 40)   # lanes held to their single-point runs
SERVE_TORCH_BUDGET_S = 60.0
FLEET_TIMED_CALLS = 3              # event-timed launches of the fleet kernel at a shape


def event_counts_sha256(event_counts):
    """sha256 of a run's per-tick event counts as C-ordered int64."""
    import hashlib

    import numpy as np

    ev = np.ascontiguousarray(np.asarray(event_counts).astype(np.int64))
    return hashlib.sha256(ev.tobytes()).hexdigest()


def fleet_bound(spec, lanes=1):
    """The serving-fleet kernel's bound for ``lanes`` lanes of ``spec``: its
    op's count (``kernels/serving_fleet/ops.fleet_bytes``: every input read
    once, every output written once; no products)."""
    from repro_torch.kernels.serving_fleet.ops import fleet_bytes
    from repro_torch.parallel.cost import Cost

    return bound(Cost(0.0, float(fleet_bytes(spec, lanes))), "float32")


def fleet_kernel_ms(fn, n):
    """Mean device time of the serving-fleet kernel over ``n`` calls of
    ``fn`` (after one warm call), each of which must launch it once: CUDA
    events recorded by the wrapper just around each launch
    (``kernel.LAUNCH_EVENTS``). torch.profiler dropped one of three
    records of this kernel in most profiles taken on an H100, so
    ``kernel_device_ms``'s check would not hold here."""
    import torch

    from repro_torch.kernels.serving_fleet import kernel

    fn()
    kernel.LAUNCH_EVENTS = events = []
    try:
        for _ in range(n):
            fn()
    finally:
        kernel.LAUNCH_EVENTS = None
    torch.cuda.synchronize()
    if len(events) != n:
        raise AssertionError(f"{n} calls launched the serving-fleet kernel {len(events)} "
                             f"times")
    return sum(a.elapsed_time(b) for a, b in events) / n


def _fleet_point(name, quick, seed, sim_seed):
    """The program inputs of one ``serving_torch`` point, as ``exp.run``
    builds them: (cfg, spec, consts, params, key, requests, pinning)."""
    import numpy as np

    from repro_torch.exp.runner import _serving_torch_setup
    from repro_torch.runtime import serving_torch as st
    from repro_torch.sched import get_scenario

    sc = get_scenario(name)
    (_, cfg, requests, max_ticks, wl_meta, spot, (n_t, rate, burst)) = _serving_torch_setup(
        sc, quick=quick, seed=seed, trace=None, trace_overrides={}, sim_overrides={})
    pin = wl_meta["pinned_per_tick"]
    spec = st.make_spec(cfg, n_requests=len(requests), max_ticks=max_ticks,
                        max_arrivals_per_tick=int(np.bincount(
                            [q.arrival for q in requests]).max()),
                        drain_preference=sc.drain_preference, spot_pricing=spot,
                        n_tenants=n_t)
    consts = st.build_consts(spec, requests, pin)
    params = st.make_params(cfg, n_tenants=n_t, credit_rate=rate, credit_burst=burst)
    return cfg, spec, consts, params, st._seed_key(sim_seed), requests, pin


def _fleet_equal(what, got, ref):
    """Every output array of the card's program equal to the plain one's."""
    import numpy as np

    if sorted(got) != sorted(ref):
        raise AssertionError(f"serving_torch {what}: outputs {sorted(got)} vs {sorted(ref)}")
    for k, v in ref.items():
        g = np.asarray(got[k])
        if g.dtype != v.dtype or g.shape != v.shape or not np.array_equal(g, v):
            bad = np.argwhere(g != v)[:3].tolist() if g.shape == v.shape else "shape"
            raise AssertionError(f"serving_torch {what}: {k} differs from the plain "
                                 f"version ({g.dtype}{g.shape} vs {v.dtype}{v.shape}; "
                                 f"first at {bad})")


def serving_torch_phase(dev, fleet_host_s):
    """The serving fleet as one device program (``serving_torch``): (a) the
    kernel against the plain version on the chip machine's CPU, bit for
    bit, (b) the paper's scale on the card against the JAX package's golden
    values, (c) the 54-lane cube, (d) the launcher (module docstring,
    phase 9). ``fleet_host_s`` is phase 8's host-fleet time at the paper's
    scale. Returns the ``serving_torch`` summary, the kernel table's row
    and the counted run's launches."""
    import numpy as np
    import torch

    from repro_torch import exp
    from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from repro_torch.kernels.serving_fleet.kernel import smem_bytes
    from repro_torch.launch import sim as sim_launcher
    from repro_torch.runtime import serving_torch as st
    from repro_torch.runtime.serving import Request, ServingFleetConfig

    t_phase = time.perf_counter()
    n_threads = torch.get_num_threads()
    summary = {"plain_device": "cpu of the chip machine, one torch thread"}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def both(what, spec, params, consts, key, cfg=None):
        card, card_ms = timed(lambda: st.get_program(spec, device=dev)(params, consts, key))
        torch.set_num_threads(1)
        try:
            plain, plain_ms = timed(lambda: st.get_program(spec, device="cpu")(
                params, consts, key))
        finally:
            torch.set_num_threads(n_threads)
        _fleet_equal(what, card, plain)
        row = dict(ticks=spec.horizon, replicas=spec.n_replicas, card_ms=card_ms,
                   plain_ms=plain_ms, card_us_per_tick=1e3 * card_ms / max(spec.horizon, 1))
        if cfg is not None:
            m_card, _ = st.summarize(spec, card, consts, cfg.tick_s)
            m_plain, _ = st.summarize(spec, plain, consts, cfg.tick_s)
            if json.dumps(m_card) != json.dumps(m_plain):
                raise AssertionError(f"serving_torch {what}: metrics {m_card} vs {m_plain}")
            row["events"] = int(card["event_counts"].sum())
        return row

    # (a) the kernel against the plain version, bit for bit
    det = []
    cfg1 = ServingFleetConfig(n_replicas=1, max_transient=0, threshold=0.5,
                              provisioning_delay=3.0, tick_s=1.0)
    cfg2 = ServingFleetConfig(n_replicas=1, max_transient=1, threshold=0.5,
                              provisioning_delay=3.0, tick_s=1.0)
    cfg3 = ServingFleetConfig(n_replicas=1, max_transient=1, max_slots=2, threshold=0.5,
                              provisioning_delay=3.0)
    six = [(0, 3), (2, 4), (6, 2), (8, 3), (12, 2), (21, 1)]
    pin = np.zeros(40, int)
    pin[5:20] = 1
    det.append((cfg1, [Request(0, 0, 3), Request(1, 0, 2), Request(2, 4, 1)],
                np.zeros(30, int), 30))
    det.append((cfg2, [Request(i, a, g) for i, (a, g) in enumerate(six)], pin, 40))
    det.append((cfg3, [Request(i, a, g) for i, (a, g) in enumerate(six)], pin, 40))
    rng = np.random.default_rng(0)   # tests/test_serving_jax.py:_rand_workload(0)
    arr = np.sort(rng.integers(0, 380, 80))
    reqs = [Request(i, int(arr[i]), int(rng.integers(1, 6))) for i in range(80)]
    rpin = np.zeros(400, int)
    rpin[50:150] = int(rng.integers(1, 3))
    rpin[300:] = 2
    det.append((ServingFleetConfig(n_replicas=2, max_transient=2, threshold=0.5,
                                   provisioning_delay=3.0, tick_s=1.0), reqs, rpin, 400))
    summary["small"] = []
    for i, (cfg, reqs, pin_i, T) in enumerate(det):
        spec = st.make_spec(cfg, n_requests=len(reqs), max_ticks=T,
                            max_arrivals_per_tick=int(np.bincount(
                                [q.arrival for q in reqs]).max()))
        consts = st.build_consts(spec, reqs, pin_i)
        summary["small"].append(both(f"case {i}", spec, st.make_params(cfg), consts,
                                     st._seed_key(0), cfg))
    summary["quick"], quick_specs = {}, {}
    for name in SERVE_TORCH_QUICK:
        cfg, spec, consts, params, key, _, _ = _fleet_point(name, True, 42, 0)
        row = both(name, spec, params, consts, key, cfg)
        row["smem_bytes"] = smem_bytes(spec)
        row["bound_ms"] = fleet_bound(spec)["bound_ms"]
        if name == SERVE_TORCH_SCENARIO:
            row["device_ms"] = fleet_kernel_ms(
                lambda: st.get_program(spec, device=dev)(params, consts, key),
                FLEET_TIMED_CALLS)
        summary["quick"][name], quick_specs[name] = row, spec
        log(f"  serving_torch (a) {name} quick, kernel vs plain bitwise: {json.dumps(row)}")
    a_s = time.perf_counter() - t_phase

    # the counted run: (b) the paper's scale, (c) the cube, (d) the launcher
    reset_counts()
    torch.cuda.synchronize()
    paper, ms_b = timed(lambda: exp.run(SERVE_TORCH_SCENARIO, "serving_torch", quick=False,
                                        seed=42, sim_seed=0, device=dev))
    if (json.dumps(paper.metrics) != json.dumps(SERVE_TORCH_GOLDEN)
            or event_counts_sha256(paper.series["event_counts"]) != SERVE_TORCH_GOLDEN_EVENTS
            or paper.meta["fleet_spec"] != SERVE_TORCH_PAPER_SPEC):
        raise AssertionError(f"serving_torch (b) paper scale: {paper.metrics} / "
                             f"{event_counts_sha256(paper.series['event_counts'])} are not "
                             f"the JAX package's golden values")
    obs = paper.meta["obs"]
    ticks = paper.meta["workload"]["max_ticks"]
    summary["paper"] = dict(
        replicas=SERVE_TORCH_PAPER_SPEC["n_ondemand"] + SERVE_TORCH_PAPER_SPEC[
            "transient_cap"], requests=paper.meta["workload"]["n_requests"], ticks=ticks,
        wall_ms=ms_b, kernel_call_ms=1e3 * obs["exec_s"],
        us_per_tick=1e6 * obs["exec_s"] / ticks, host_fleet_s=fleet_host_s,
        host_fleet_over_wall=1e3 * fleet_host_s / ms_b,
        bound_ms=fleet_bound(st.FleetSpec(**SERVE_TORCH_PAPER_SPEC))["bound_ms"],
        golden="equal", metrics=paper.metrics)
    log(f"  serving_torch (b) paper scale on the card: {json.dumps(summary['paper'])}")

    sweep, ms_c = timed(lambda: exp.sweep(
        SERVE_TORCH_SCENARIO, SERVE_TORCH_CUBE, engine="serving_torch", quick=False,
        seed=42, sim_seeds=SERVE_TORCH_CUBE_SEEDS, device=dev))
    n_lanes = int(np.prod(sweep.shape)) * len(SERVE_TORCH_CUBE_SEEDS)
    cube_obs = sweep.meta["obs"]
    best = sweep.best("short_avg_wait_s")
    summary["cube"] = dict(lanes=n_lanes, shape=list(sweep.shape), wall_ms=ms_c,
                           kernel_call_ms=1e3 * cube_obs["exec_s"],
                           points_per_s=n_lanes / cube_obs["exec_s"],
                           us_per_tick_lane=1e6 * cube_obs["exec_s"] / ticks / n_lanes,
                           best=best)
    log(f"  serving_torch (c) cube: {json.dumps(summary['cube'], default=float)}")

    with tempfile.TemporaryDirectory() as tmp:
        out_path = pathlib.Path(tmp) / "serve_batched_yahoo.runresult.json"
        _, ms_d = timed(lambda: sim_launcher.main(
            ["--scenario", SERVE_TORCH_SCENARIO, "--engine", "serving_torch",
             "--out", str(out_path)]))
        launched = json.loads(out_path.read_text())
    direct = exp.run(SERVE_TORCH_SCENARIO, "serving_torch", quick=False, seed=42,
                     sim_seed=42, device=dev)
    if launched["metrics"] != direct.metrics:
        raise AssertionError(f"serving_torch (d) launcher: {launched['metrics']} is not "
                             f"exp.run's {direct.metrics}")
    torch.cuda.synchronize()
    counts, plain_calls = dict(LAUNCHES), dict(PLAIN_CALLS)
    if counts["serving_fleet"] != 4 or sum(plain_calls.values()):
        raise AssertionError(f"serving_torch: launches {counts}, plain calls {plain_calls}; "
                             f"want 4 serving_fleet launches ((b), (c), (d) twice), no plain")
    summary["launcher"] = dict(wall_ms=ms_d, run_wall_s=launched["wall_time_s"])
    log(f"  serving_torch (d) launch.sim: {json.dumps(summary['launcher'])}")

    # the cube's lanes against their single-point runs (uncounted)
    cfg, _, _, _, _, requests, pin = _fleet_point(SERVE_TORCH_SCENARIO, False, 42, 0)
    grid = [(s, t, k, m) for s in SERVE_TORCH_CUBE_SEEDS
            for t in np.asarray(SERVE_TORCH_CUBE["threshold"], np.float32)
            for k in SERVE_TORCH_CUBE["max_transient"] for m in SERVE_TORCH_CUBE["max_slots"]]
    cube_spec = st.FleetSpec(**{**sweep.meta["fleet_spec"]})
    cube_consts = st.build_consts(cube_spec, requests, pin)
    params = st.cube_params(cfg, grid)
    keys = np.stack([st._seed_key(g[0]) for g in grid])
    cube = st.get_program(cube_spec, batch="map", device=dev)(params, cube_consts, keys)
    for lane in SERVE_TORCH_CUBE_LANES:
        one = st.get_program(cube_spec, device=dev)(
            {k: v[lane] for k, v in params.items()}, cube_consts, keys[lane])
        _fleet_equal(f"cube lane {lane} vs its single point",
                     {k: v[lane] for k, v in cube.items()}, one)
    summary["cube"]["lanes_checked"] = list(SERVE_TORCH_CUBE_LANES)
    summary["cube"]["bound_ms"] = fleet_bound(cube_spec, n_lanes)["bound_ms"]
    # the paper-scale kernel alone (uncounted): the launch's device time,
    # without the program call's uploads, allocations and host copies
    _, spec_b, consts_b, params_b, key_b, _, _ = _fleet_point(
        SERVE_TORCH_SCENARIO, False, 42, 0)
    summary["paper"]["device_ms"] = fleet_kernel_ms(
        lambda: st.get_program(spec_b, device=dev)(params_b, consts_b, key_b),
        FLEET_TIMED_CALLS)
    summary["paper"]["device_over_bound"] = (summary["paper"]["device_ms"]
                                             / summary["paper"]["bound_ms"])
    summary["launches"] = counts["serving_fleet"]
    summary["a_s"] = a_s
    summary["phase_s"] = time.perf_counter() - t_phase
    if summary["phase_s"] > SERVE_TORCH_BUDGET_S:
        raise AssertionError(f"serving_torch phase took {summary['phase_s']:.1f} s, over "
                             f"its {SERVE_TORCH_BUDGET_S} s budget")
    q, quick_spec = summary["quick"][SERVE_TORCH_SCENARIO], quick_specs[SERVE_TORCH_SCENARIO]
    row = dict(max_abs_err=0, ms=q["device_ms"], plain_ms=q["plain_ms"],
               plain_device=summary["plain_device"], library_ms=None,
               shape=f"{SERVE_TORCH_SCENARIO} quick: {quick_spec.n_replicas} replicas x "
                     f"{quick_spec.slot_cap} slots, {quick_spec.horizon} ticks, 1 lane",
               **fleet_bound(quick_spec))
    return summary, row, counts


# --------------------------------------------------------------------------
# phase 10: the arrival processes' batch sampler on the card


ARRIVALS_HORIZON = 24 * 3600.0
ARRIVALS_DT = 60.0                 # 1,440 slots
ARRIVALS_DEMO_SEEDS = 32           # benchmarks/fig1_burstiness.py's BATCH_SEEDS
ARRIVALS_SEEDS = 4096              # a sweep's batch of seed variants
ARRIVALS_CPU_SEEDS = 256           # the card's rows held to a CPU run of these seeds
ARRIVALS_ROW = 7                   # the seed run alone against its row of the batch
ARRIVALS_MAX_MISS = 1e-4           # share of compared counts the card and CPU may differ on
ARRIVALS_RATE_RTOL = 1e-6          # Diurnal and Modulated grids (sin on the card)
ARRIVALS_MEAN_RTOL = 0.10          # batch mean rate against process.mean_rate
ARRIVALS_BUDGET_S = 60.0
#: stdout of the JAX package's examples/quickstart.py and examples/trace_replay.py
#: (quick scale, default flags); the chip machine has no JAX, so
#: tests/test_torch_examples.py holds these to fresh reference runs
EXAMPLES_GOLDEN = {
    "quickstart": """\
generating Yahoo-calibrated bursty trace ...
  528 jobs, 10138 tasks, utilization 1.59

Eagle baseline (static 8-server short partition):
  short-task queueing delay avg=688.4s max=2260s

CloudCoaster (p=0.5, r=3, L_r^T=0.95, 120s provisioning):
  short-task queueing delay avg=56.1s max=484s
  -> 12.3x average improvement (paper: 4.8x at full scale)
  transients: avg active=6.9, avg lifetime=1.38h (paper: ~0.8h, far below spot MTTF)
  dynamic-partition cost saving=42.9% (paper: 29.5%)
  long-job delay unchanged: 3685s -> 3685s
""",
    "trace_replay": """\
trace: 356 jobs / 5271 tasks / util 0.81

config            avg wait  max wait act transients  life h    save
eagle                227.5      1210            0.0    0.00    0.0%
coaster_r1           296.0      1303            0.9    0.46   78.6%
coaster_r2           161.9      1195            2.0    0.51   75.2%
coaster_r3           110.4      1195            3.1    0.49   74.3%

avg improvement coaster_r3 vs eagle: 2.1x (paper r=3: 4.8x) | max: 1.0x (paper: 1.83x)
""",
}


def arrival_processes():
    """Phase 10 (b)'s processes: the fig1 google process, the yahoo process
    at yahoo_like's default rate (4000 servers, 80 short), and five of
    tests/test_workload.py's ``PROCESSES`` (both Poisson branches, both
    binomial branches, a cyclic and a ``trans`` chain, sin)."""
    from repro_torch.workload import (MMPP, Diurnal, Modulated, Poisson,
                                      TwoClassLognormalMix, google_arrivals,
                                      yahoo_arrivals, yahoo_rate)

    return {
        "google": google_arrivals(),
        "yahoo": yahoo_arrivals(yahoo_rate(4000, 80, ARRIVALS_HORIZON, 0.97, 0.65,
                                           TwoClassLognormalMix())),
        "poisson": Poisson(rate=0.05),
        "mmpp3": MMPP(rates=(0.02, 0.1, 0.3), dwells=(3600.0, 1200.0, 300.0)),
        "mmpp_trans": MMPP(rates=(0.02, 0.2), dwells=(1800.0, 600.0),
                           trans=((0.3, 0.7), (0.9, 0.1))),
        "diurnal": Diurnal(rate=0.05, rel_amplitude=0.7, period=4 * 3600.0),
        "modulated": Modulated(base=MMPP.from_burst(0.05),
                               envelope=Diurnal(rate=1.0, rel_amplitude=0.5,
                                                period=4 * 3600.0)),
    }


def arrivals_phase(dev):
    """The slot-binned batch sampler (``repro_torch.workload.arrivals``) on
    the card (module docstring, phase 10): (a) fig1's demo, 32 seeds of the
    google process against 32 serial exact samples on the host; (b) 4,096
    seeds x 1,440 slots of seven processes, the first 256 rows held to the
    port's CPU run of the same seeds (rate grids bitwise, or to rtol 1e-6
    where sin is applied per slot; counts on all but at most 1e-4 of the
    entries), two card calls equal, seed 7 alone equal to its row, the mean
    rate within 10% of ``mean_rate``; (c) the two example twins' stdout
    against the JAX package's. Wall times are host clocks around work that
    ends in a synchronisation. Returns the ``arrivals`` summary."""
    import contextlib
    import io

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from repro_torch.examples import quickstart, trace_replay
    from repro_torch.runtime import threefry
    from repro_torch.workload import (Diurnal, Modulated, batch_sample_counts,
                                      google_arrivals, slot_counts)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def busy(fn, wall_s):
        """Kernels one call launches, their device ms (torch.profiler) and
        that time's share of the call's unprofiled wall time."""
        t0 = time.perf_counter()
        kernels = [e for e in profiled(fn, 1).key_averages()
                   if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        return dict(kernels=sum(e.count for e in kernels), device_ms=device_ms,
                    busy_share=device_ms / (1e3 * wall_s),
                    profile_s=time.perf_counter() - t0)

    t_phase = time.perf_counter()
    H, dt = ARRIVALS_HORIZON, ARRIVALS_DT
    summary = {"horizon_s": H, "dt_s": dt}

    # (a) benchmarks/fig1_burstiness.py's batch_generation_demo, on the card
    proc = google_arrivals()
    seeds = np.arange(ARRIVALS_DEMO_SEEDS)
    serial, t_serial = timed(lambda: np.stack(
        [slot_counts(proc.sample(int(s), H), H, dt) for s in seeds]))
    _, t_first = timed(lambda: batch_sample_counts(proc, seeds, H, dt, device=dev))
    batch, t_batch = timed(lambda: batch_sample_counts(proc, seeds, H, dt, device=dev))
    summary["fig1"] = dict(
        n_seeds=ARRIVALS_DEMO_SEEDS, n_slots=int(batch.shape[1]), serial_32_s=t_serial,
        card_batch_first_call_s=t_first, card_batch_32_s=t_batch,
        card_batch_speedup_x=t_serial / t_batch,
        card_batch_speedup_incl_first_call_x=t_serial / t_first,
        serial_mean_rate=float(serial.mean() / dt), card_mean_rate=float(batch.mean() / dt),
        profile=busy(lambda: batch_sample_counts(proc, seeds, H, dt, device=dev), t_batch))
    log(f"  arrivals fig1: {json.dumps(summary['fig1'])}")

    # (b) the sweep scale: the card against the port's own CPU run
    seeds = np.arange(ARRIVALS_SEEDS)
    n = int(np.ceil(H / dt))
    summary["processes"] = {}
    for name, proc in arrival_processes().items():
        exact = not isinstance(proc, (Diurnal, Modulated))
        grids = []
        for d in (dev, torch.device("cpu")):
            key = threefry.split(threefry.seed_key(
                torch.arange(ARRIVALS_CPU_SEEDS, device=d)), 3)[0]   # sample_counts' k_path
            t_grid = (torch.arange(n, dtype=torch.float32, device=d) + 0.5) * dt
            grids.append(proc.rate_grid(key, t_grid, dt).cpu().numpy())
        g, c = grids
        rate_miss = float(np.abs(g - c).max() / np.abs(c).max())
        if (exact and not np.array_equal(g.view(np.uint32), c.view(np.uint32))) or (
                not rate_miss <= ARRIVALS_RATE_RTOL):
            raise AssertionError(f"arrivals {name}: the card's rate grid is not the CPU's "
                                 f"({'bitwise' if exact else ARRIVALS_RATE_RTOL}; "
                                 f"largest relative miss {rate_miss:.3e})")
        torch.cuda.reset_peak_memory_stats(dev)
        stats = {}
        card, card_s = timed(lambda: batch_sample_counts(proc, seeds, H, dt, device=dev,
                                                         stats=stats))
        peak = torch.cuda.max_memory_allocated(dev)
        again, again_s = timed(lambda: batch_sample_counts(proc, seeds, H, dt, device=dev))
        t0 = time.perf_counter()
        cpu = batch_sample_counts(proc, seeds[:ARRIVALS_CPU_SEEDS], H, dt, device="cpu")
        cpu_s = time.perf_counter() - t0
        alone = batch_sample_counts(proc, [ARRIVALS_ROW], H, dt, device=dev)
        misses = int((card[:ARRIVALS_CPU_SEEDS] != cpu).sum())
        mean_rate, expect = float(card.mean() / dt), float(proc.mean_rate(H))
        row = dict(seeds=ARRIVALS_SEEDS, slots=n, card_s=card_s, card_again_s=again_s,
                   cpu_seeds=ARRIVALS_CPU_SEEDS, cpu_s=cpu_s, count_misses=misses,
                   compared=int(cpu.size), rate_grid="bitwise" if exact else rate_miss,
                   loop_iters=stats, peak_mem_gb=peak / 1e9, mean_rate=mean_rate,
                   expected_mean_rate=expect)
        summary["processes"][name] = row
        log(f"  arrivals {name}: {json.dumps(row)}")
        if card.shape != (ARRIVALS_SEEDS, n) or card.dtype != np.int32:
            raise AssertionError(f"arrivals {name}: counts {card.shape} {card.dtype}")
        if misses > ARRIVALS_MAX_MISS * cpu.size:
            raise AssertionError(f"arrivals {name}: the card's counts differ from the CPU's "
                                 f"on {misses} of {cpu.size} entries")
        if not np.array_equal(card, again):
            raise AssertionError(f"arrivals {name}: two card calls differ")
        if not np.array_equal(alone[0], card[ARRIVALS_ROW]):
            raise AssertionError(f"arrivals {name}: seed {ARRIVALS_ROW} alone is not its "
                                 f"row of the batch")
        if not abs(mean_rate - expect) <= ARRIVALS_MEAN_RTOL * expect:
            raise AssertionError(f"arrivals {name}: mean rate {mean_rate} is not within "
                                 f"{ARRIVALS_MEAN_RTOL} of {expect}")

    # (c) the example twins on the host, against the JAX package's stdout
    summary["examples_s"] = {}
    for name, mod in (("quickstart", quickstart), ("trace_replay", trace_replay)):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main([])
        summary["examples_s"][name] = time.perf_counter() - t0
        if out.getvalue() != EXAMPLES_GOLDEN[name]:
            raise AssertionError(f"arrivals: examples/{name} twin printed\n{out.getvalue()}"
                                 f"not the JAX package's\n{EXAMPLES_GOLDEN[name]}")
    log(f"  arrivals examples: {json.dumps(summary['examples_s'])}")
    summary["phase_s"] = time.perf_counter() - t_phase
    if summary["phase_s"] > ARRIVALS_BUDGET_S:
        raise AssertionError(f"arrivals phase took {summary['phase_s']:.1f} s, over its "
                             f"{ARRIVALS_BUDGET_S} s budget")
    return summary


# --------------------------------------------------------------------------
# phase 11: the model families, mixtral-8x22b's experts at full width


MIXTRAL_ARCH = "mixtral-8x22b"
LLAMA4_ARCH = "llama4-scout-17b-a16e"
MUSICGEN_ARCH = "musicgen-medium"
PALIGEMMA_ARCH = "paligemma-3b"
MIXTRAL_SERVE = dict(num_layers=8)    # 8 of 56 layers, every expert: 20.43 B params, 40.9 GB bf16
MIXTRAL_F32 = dict(num_layers=2)      # 5.4 B params, 21.6 GB in f32
LLAMA4_BLOCK = dict(num_layers=4)     # one block (3 local, 1 global): 10.9 B params, 43.5 GB f32
MOE_LAYOUTS = {
    "paged": (dict(kv_layout="paged"), ("flash_attention", "paged_decode_attention")),
    "dense": (dict(kv_layout="dense"), ("flash_attention", "decode_attention")),
}
SERVE_GEN = 32                        # launch.serve's default --gen
FAMILIES_BUDGET_S = 120.0


def _routes_recorded():
    """Turn on the MoE layer's record (``repro_torch.models.mlp.RECORD``);
    returns the list each MoE call appends its (idx, probs, keep) to, and
    a function that turns the record off."""
    from repro_torch.models import mlp

    mlp.RECORD = calls = []

    def restore():
        mlp.RECORD = None

    return calls, restore


def _route_gaps(kern_calls, plain_calls):
    """Routing choices that differ between the two paths, and the kernel
    path's router margin (k-th minus (k+1)-th probability) at each token
    where they differ."""
    import torch

    if len(kern_calls) != len(plain_calls):
        raise AssertionError(f"{len(kern_calls)} router calls on the kernel path, "
                             f"{len(plain_calls)} on the plain path")
    differ, margins = 0, []
    for (ik, pk, _), (ip, _, _) in zip(kern_calls, plain_calls):
        bad = (ik != ip).any(-1)
        differ += int((ik != ip).sum())
        if bad.any():
            k = ik.shape[-1]
            top = torch.sort(pk[bad], dim=-1, descending=True).values
            nxt = top[..., k] if top.shape[-1] > k else torch.zeros_like(top[..., 0])
            margins += (top[..., k - 1] - nxt).flatten().tolist()
    return differ, margins


def families_f32(dev, seed, cfg):
    """f32 logits of the kernel path against the plain path on the card: a
    513-token prefill (tokens, frame embeddings or text after the image
    prefix; attention-only token stacks in a 1024 bucket, so MoE layers
    route the pads too) and 4 dense decode steps; a config with experts
    also prefills two prompts into a 2-slot paged batcher and takes 4
    paged steps of both rows (routed together). Returns (worst relative
    gap, routing choices that differ)."""
    import numpy as np
    import torch

    from repro_torch.models.decoder import DecoderLM
    from repro_torch.runtime.batching import ContinuousBatcher, GenRequest

    check_released(dev, f"the f32 phase of {cfg.name}")
    cfg = cfg.replace(dtype="float32", param_dtype="float32")
    kern, plain = DecoderLM(cfg), DecoderLM(cfg, plain=True)
    params = kern.init(torch.Generator(device=dev).manual_seed(seed + 2), device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed + 2)
    moe = any(spec.is_moe for spec in kern.specs)
    plen, max_len = 513, 8192

    def emb(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    kw = dict(max_len=max_len)
    if cfg.family == "audio":
        kw["embeds"] = emb(1, plen, cfg.d_model)
    else:
        bucket = 1024 if kern.bucketed_prefill else plen
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = rng.integers(1, cfg.vocab_size, plen)
        kw["tokens"] = torch.as_tensor(toks, device=dev)
        if kern.bucketed_prefill:
            kw["true_len"] = plen
    if cfg.family == "vlm":
        kw["prefix_embeds"] = emb(1, cfg.prefix_len, cfg.d_model)
    pos0 = plen + cfg.prefix_len
    log(f"f32 phase: {cfg.name} in float32, {cfg.num_layers} layers, {n_params} params, "
        f"prompt {plen}{' after a ' + str(cfg.prefix_len) + '-embedding prefix' if cfg.prefix_len else ''}"
        f"{', bucket 1024' if 'true_len' in kw else ''}")
    worst, differ, margins = 0.0, 0, []

    def compare(what, lk, lp, ck, cp):
        nonlocal worst, differ
        scale = lp.abs().max().item()
        rel = (lk - lp).abs().max().item() / scale
        worst = max(worst, rel)
        if moe and not ck:
            raise AssertionError(f"{cfg.name} {what}: the MoE layers recorded no routing")
        d, m = _route_gaps(ck, cp)
        differ += d
        margins.extend(m)
        log(f"  {what}: max|dlogit|/max|logit|={rel:.3e} (max|logit|={scale:.3f})"
            + (f"; routing choices differing {d}" if moe else ""))
        if not rel <= LOGIT_RTOL:
            raise AssertionError(f"{cfg.name} f32 kernel vs plain logits: {rel} > "
                                 f"{LOGIT_RTOL}")

    calls, restore = _routes_recorded()
    try:
        with torch.inference_mode():
            lk, ck = kern.prefill(params, **kw)
            rk = calls[:]
            calls.clear()
            lp, cp = plain.prefill(params, **kw)
            compare("prefill", lk, lp, rk, calls[:])
            for step in range(4):
                if cfg.family == "audio":
                    inp = dict(embeds=emb(1, 1, cfg.d_model))
                else:
                    inp = dict(tokens=torch.argmax(lk, -1)[:, None])
                calls.clear()
                lk, ck = kern.decode_step(params, ck, pos=pos0 + step, **inp)
                rk = calls[:]
                calls.clear()
                lp, cp = plain.decode_step(params, cp, pos=pos0 + step, **inp)
                compare(f"dense decode {step + 1}", lk, lp, rk, calls[:])
            del ck, cp
            if moe:
                prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                           for n in (plen, 100)]
                bats = [ContinuousBatcher(m, params, max_slots=2, max_len=max_len,
                                          kv_layout="paged", device=dev)
                        for m in (kern, plain)]
                for slot, p in enumerate(prompts):
                    for b in bats:
                        b._admit(slot, GenRequest(slot, p, 8))
                bk, bp = bats
                if not (np.array_equal(bk.allocator.table, bp.allocator.table)
                        and bk.last_tok.equal(bp.last_tok)):
                    raise AssertionError(f"{cfg.name}: the paged admissions differ")
                table = torch.as_tensor(bk.allocator.table, device=dev)
                pos = torch.as_tensor(bk.pos, device=dev)
                tok = bk.last_tok
                for step in range(4):
                    calls.clear()
                    lk, _ = kern.decode_step_paged(params, bk.pools, tokens=tok,
                                                   pos_vec=pos, pages=table)
                    rk = calls[:]
                    calls.clear()
                    lp, _ = plain.decode_step_paged(params, bp.pools, tokens=tok,
                                                    pos_vec=pos, pages=table)
                    compare(f"paged decode {step + 1} (2 rows)", lk, lp, rk, calls[:])
                    tok = torch.argmax(lk, -1)[:, None]
                    pos = pos + 1
                del bats, bk, bp
    finally:
        restore()
    if margins:
        log(f"  router margins where the paths differ: {sorted(margins)[:16]}")
    del params
    torch.cuda.empty_cache()
    return worst, differ


def families_phase(dev, seed):
    """Phase 11: (a) mixtral-8x22b at 8 of its 56 layers with every expert,
    bf16, served paged and dense through ContinuousBatcher; (b) f32 logits,
    kernel path against plain path, of mixtral at 2 layers, llama4-scout
    at one block, musicgen-medium and paligemma-3b at full depth; (c)
    ``launch.serve --arch`` at full width for musicgen-medium and
    paligemma-3b, B2 once per layer for the prefill and B3 once per layer
    and step. Returns (launches of (a) and (c), summary)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNEL_NAMES, LAUNCHES, PLAIN_CALLS, reset_counts
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    mixtral = get_config(MIXTRAL_ARCH)
    launches, serving = serving_phase(dev, seed, mixtral.replace(**MIXTRAL_SERVE),
                                      MOE_LAYOUTS)
    summary = {"mixtral_serving": serving}
    f32 = {}
    for cfg in (mixtral.replace(**MIXTRAL_F32), get_config(LLAMA4_ARCH).replace(**LLAMA4_BLOCK),
                get_config(MUSICGEN_ARCH), get_config(PALIGEMMA_ARCH)):
        t0 = time.perf_counter()
        worst, differ = families_f32(dev, seed, cfg)
        f32[cfg.name] = dict(layers=cfg.num_layers, worst_rel=worst,
                             routing_choices_differing=differ,
                             s=time.perf_counter() - t0)
    summary["f32"] = f32
    summary["serve_launcher"] = {}
    for arch in (MUSICGEN_ARCH, PALIGEMMA_ARCH):
        cfg = get_config(arch)
        check_released(dev, f"launch.serve --arch {arch}")
        reset_counts()
        t0 = time.perf_counter()
        serve.main(["--arch", arch])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
        want = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * SERVE_GEN}
        got = {k: n for k, n in counts.items() if n}
        if got != want or sum(plain.values()):
            raise AssertionError(f"launch.serve --arch {arch}: launches {got}, expected "
                                 f"{want}; plain calls {plain}")
        for name, n in counts.items():
            launches[name] += n
        summary["serve_launcher"][arch] = dict(wall_s=wall, launches=got)
        gc.collect()
        torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"families phase: {json.dumps(summary, default=float)}")
    if summary["phase_s"] > FAMILIES_BUDGET_S:
        raise AssertionError(f"families phase took {summary['phase_s']:.1f} s > "
                             f"{FAMILIES_BUDGET_S} s")
    return {name: launches.get(name, 0) for name in KERNEL_NAMES}, summary


# --------------------------------------------------------------------------
# phase 12: MoE training at full width


MOE_TRAIN = dict(num_layers=1)   # 1 of 56 layers, every expert: 2.907 B params, 5.8 GB bf16
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 8192  # the config's 2 microbatches of one 8192-token row
MOE_GRAD_SEQ = 2048              # the f32 gradient check's one row (11.6 GB of f32 params)
MOE_TRAIN_BUDGET_S = 120.0


def _moe_drops(calls):
    """(dropped, total) expert assignments over the record's MoE calls."""
    kept = [keep for _, _, keep in calls if keep is not None]
    return (sum(int((~k).sum()) for k in kept), sum(k.numel() for k in kept))


def _grads(model, params, batch):
    """(loss, gradient leaves) of ``model.loss`` at ``params``."""
    import torch

    from repro_torch.tree import leaves, unflatten

    live = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss, _ = model.loss(unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), grads


def moe_train_phase(dev, seed):
    """Phase 12: full-width mixtral-8x22b at 1 of its 56 layers with every
    expert, under its optimized training variant (2 microbatches,
    flash_vjp). (a) bf16, 3 steps of 2 x 8192 tokens through
    ElasticTrainer (``train_phase``), then its dropped expert assignments
    in an untimed forward of the first batch with the record on; (b) f32
    gradients of one 2048-token row, kernel path (B2 with statistics, the
    chunked backward) against the plain path, every leaf within 2e-4 of
    its max and no routing choice differing; (c) one 8192-token
    microbatch of (a)'s model under remat "dots" against "full", loss and
    every leaf within 2e-4, the peak bytes of each. Returns ((a)'s
    launches, summary)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.optimized import OPTIMIZED
    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import BWD_CALLS, LAUNCHES, PLAIN_CALLS, reset_counts
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.tree import leaves_with_paths

    t_phase = time.perf_counter()
    cfg = get_config(MIXTRAL_ARCH).replace(**MOE_TRAIN, **OPTIMIZED[MIXTRAL_ARCH]["train"])
    launches, summary = train_phase(dev, seed, cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, {})
    summary = {"train": summary}

    # (a) the dropped assignments of the first step's forward, untimed
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    batch = SyntheticBatches(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, seed=seed).batch(0)
    calls, restore = _routes_recorded()
    try:
        with torch.inference_mode():
            for row in torch.as_tensor(batch["tokens"], device=dev).split(1):
                model.loss(params, {"tokens": row})
    finally:
        restore()
    dropped, total = _moe_drops(calls)
    summary["dropped_assignments"] = dict(dropped=dropped, of=total,
                                          capacity=cfg.capacity_factor)
    log(f"moe train phase: step 0's forward drops {dropped} of {total} expert assignments "
        f"(capacity factor {cfg.capacity_factor}, {MOE_TRAIN_SEQ} tokens a microbatch)")
    del params, calls

    # (c) remat "dots" against "full" on one microbatch of (a)
    row = {"tokens": torch.as_tensor(batch["tokens"][:1], device=dev)}
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    remat = {}
    for policy in ("full", "dots"):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, grads = _grads(DecoderLM(cfg.replace(remat=policy)), params, row)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        remat[policy] = (loss, grads, dict(loss=loss, ms=1e3 * (time.perf_counter() - t0),
                                           max_memory_allocated=peak))
    (lf, gf, full), (ld, gd, dots) = remat["full"], remat["dots"]
    worst = _leaf_gaps([path for path, _ in leaves_with_paths(params)], gd, gf)[0][0]
    summary["remat"] = dict(full=full, dots=dots, worst_rel=worst,
                            bitwise=all(torch.equal(d, f) for d, f in zip(gd, gf)))
    log(f"  remat dots vs full: {json.dumps(summary['remat'])}")
    if not (abs(ld - lf) <= LOGIT_RTOL * abs(lf) and worst <= LOGIT_RTOL):
        raise AssertionError(f"remat dots vs full: loss {ld} vs {lf}, worst leaf {worst}")
    del params, remat, gf, gd, grads
    torch.cuda.empty_cache()

    # (b) f32 gradients, kernel path against plain path
    check_released(dev, "the f32 MoE gradient check")
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    kern, plain = DecoderLM(cfg32), DecoderLM(cfg32, plain=True)
    params = kern.init(torch.Generator(device=dev).manual_seed(seed + 3), device=dev)
    paths = [p for p, _ in leaves_with_paths(params)]
    toks = SyntheticBatches(cfg32, 1, MOE_GRAD_SEQ, seed=seed + 3).batch(0)["tokens"]
    row = {"tokens": torch.as_tensor(toks, device=dev)}
    calls, restore = _routes_recorded()
    try:
        reset_counts()
        lk, gk = _grads(kern, params, row)
        counts = (dict(LAUNCHES), dict(BWD_CALLS), sum(PLAIN_CALLS.values()))
        rk = calls[:]
        calls.clear()
        lp, gp = _grads(plain, params, row)
        rp = calls[:]
    finally:
        restore()
    want, want_bwd = expected_train_counts(kern, 1)
    want = ({n: want.get(n, 0) for n in LAUNCHES}, {n: want_bwd.get(n, 0) for n in BWD_CALLS}, 0)
    if counts != want:
        raise AssertionError(f"f32 MoE gradients: launches, backward and plain calls "
                             f"{counts}, expected {want}")
    if len(rk) != 1:
        raise AssertionError(f"f32 MoE gradients: {len(rk)} routing records of one MoE call")
    differ, margins = _route_gaps(rk, rp)
    gaps = _leaf_gaps(paths, gk, gp)
    summary["grad_check"] = dict(seq=MOE_GRAD_SEQ, loss=lk, plain_loss=lp,
                                 worst_rel=gaps[0][0], worst_leaf=gaps[0][1],
                                 routing_choices_differing=differ,
                                 leaves=len(gaps), params=sum(g.numel() for g in gk))
    log(f"  f32 gradients kernel vs plain: {json.dumps(summary['grad_check'])}; "
        f"worst leaves {gaps[:4]}")
    if margins:
        log(f"  router margins where the paths differ: {sorted(margins)[:16]}")
    if differ or not gaps[0][0] <= LOGIT_RTOL or not abs(lk - lp) <= LOGIT_RTOL * abs(lp):
        raise AssertionError(f"f32 MoE gradients: worst leaf {gaps[0]}, loss {lk} vs {lp}, "
                             f"{differ} routing choices differ")
    del params, gk, gp, rk, rp, calls
    torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"moe train phase: {summary['phase_s']:.1f} s")
    if summary["phase_s"] > MOE_TRAIN_BUDGET_S:
        raise AssertionError(f"moe train phase took {summary['phase_s']:.1f} s > "
                             f"{MOE_TRAIN_BUDGET_S} s")
    return launches, summary


# --------------------------------------------------------------------------
# phase 14: a step's counted work, on the card and on meta tensors (inside phases 3,
# 5 and 13)

COST_BUDGET_S = 30.0     # 8.4-11.0 s measured (H100 80GB HBM3, 700 W), meta counts aside
COST_SLOTS, COST_MAX_LEN = 4, 8192     # the serving phase's batcher: slots, max_len
COST_DECODE_POS = (LONG_PROMPT + MAX_NEW - 1, 2070, 523, 40)  # the slots' positions
COST_MESH = "deepseek-coder-33b mesh train"


def _counted(run):
    """A ``CostMode`` that counted one call of ``run``."""
    from repro_torch.parallel.cost import CostMode

    with CostMode() as cm:
        run()
    return cm


def _count_dict(cm):
    return {"totals": cm.totals(), "by_op": {k: list(v) for k, v in cm.by_op.items()}}


def _timed_step(run):
    """(device ms, wall ms) of one call of ``run``: CUDA events around it
    on the current stream, and the host's clock from a synchronised start
    to a synchronised end."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)


def cost_row(name, card, meta, device_ms, wall_ms, dtype_name, smi, device_how="CUDA events"):
    """Hold the card's count of one step (``card``: its totals and by-op
    rows) to the meta count of the same step, exactly: flops, bytes,
    ``bytes_min``, collective bytes by kind and kernel calls. Log the
    step's line: its counted work, device ms (measured as ``device_how``
    says) and wall ms, and the achieved rates over the wall ms, with their
    shares of the card's peaks."""
    if card["totals"] != meta["totals"]:
        diff = [f"{k}: {card['by_op'].get(k)} vs {meta['by_op'].get(k)}"
                for k in sorted(set(card["by_op"]) | set(meta["by_op"]))
                if card["by_op"].get(k) != meta["by_op"].get(k)]
        raise AssertionError(f"cost {name}: the card counts {card['totals']}, meta tensors "
                             f"{meta['totals']}; ops that differ (card vs meta: calls, "
                             f"flops, bytes): {diff[:12]}")
    t = card["totals"]
    sec = wall_ms / 1e3
    row = dict(flops=t["flops"], bytes=t["bytes"], bytes_min=t["bytes_min"],
               collectives=t["collectives"], kernel_calls=t["kernel_calls"],
               device_ms=device_ms, device_ms_from=device_how, wall_ms=wall_ms,
               tflops_per_s=t["flops"] / sec / 1e12, tb_per_s=t["bytes"] / sec / 1e12,
               peak_tflops=PEAK_FLOPS[dtype_name] / 1e12, peak_tb_per_s=HBM_BYTES_PER_S / 1e12)
    row["flops_share"] = row["tflops_per_s"] / row["peak_tflops"]
    row["bytes_share"] = row["tb_per_s"] / row["peak_tb_per_s"]
    log(f"  cost {name}: card == meta; flops={t['flops']:.6e} bytes={t['bytes']:.6e} "
        f"bytes_min={t['bytes_min']:.6e} collective bytes={t['collectives']} | device "
        f"{device_ms:.3f} ms ({device_how}), wall {wall_ms:.3f} ms | over the wall: "
        f"{row['tflops_per_s']:.2f} TFLOP/s = {row['flops_share']:.4f} of "
        f"{row['peak_tflops']:g} ({dtype_name}), {row['tb_per_s']:.3f} TB/s = "
        f"{row['bytes_share']:.4f} of {row['peak_tb_per_s']:g} | {smi}")
    return row


def _serving_steps(cfg, device, params, seed):
    """Phase 14's serving steps of ``cfg`` (starcoder2-3b) on ``device``
    with ``params``: the longest prompt's prefill in its 8192 bucket (B2),
    a paged decode step (B1) and a dense decode step (B3) of COST_SLOTS
    slots at COST_DECODE_POS, from the batcher's page size and max_len;
    {step name: a call of it}."""
    import numpy as np
    import torch

    from repro_torch.models.decoder import DecoderLM

    model = DecoderLM(cfg)
    B, L = COST_SLOTS, COST_MAX_LEN
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, L)).astype(np.int32))
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32))
    pos = torch.tensor(COST_DECODE_POS)
    pages = (torch.from_numpy(rng.permutation(B * (L // PAGE))) + 2).reshape(B, -1).int()
    pools = model.init_paged_cache(2 + B * (L // PAGE), PAGE, device=device)
    cache = model.init_cache(B, L, device=device)
    t, p, tab, pr = (x.to(device) for x in (tok, pos, pages, prompt))

    def inference(fn):
        def run():
            with torch.inference_mode():
                fn()
        return run

    return {f"{cfg.name} prefill": inference(lambda: model.prefill(
                params, tokens=pr, max_len=L, true_len=LONG_PROMPT)),
            f"{cfg.name} paged_decode": inference(lambda: model.decode_step_paged(
                params, pools, tokens=t, pos_vec=p, pages=tab)),
            f"{cfg.name} dense_decode": inference(lambda: model.decode_step(
                params, cache, tokens=t, pos=p))}


def _serving_card(cfg, params, dev, seed):
    """Phase 14's serving steps on the card: {step: (count, device ms by CUDA
    events, wall ms)}, each counted once, then timed once."""
    return {name: (_count_dict(_counted(run)), *_timed_step(run))
            for name, run in _serving_steps(cfg, dev, params, seed).items()}


def train_runs():
    """Phase 5's runs: (config, global batch rows, sequence length,
    revocations)."""
    from repro_torch.configs import get_config

    return ((get_config(RWKV_ARCH), TRAIN_BATCH, TRAIN_SEQ, {1: 1}),
            (get_config(JAMBA_ARCH).replace(**JAMBA_BLOCK), TRAIN_BATCH_JAMBA,
             TRAIN_SEQ_JAMBA, {}))


def cost_meta_counts(seed):
    """{step: count} of phase 14's steps on meta tensors: starcoder2-3b's
    serving steps on the model's meta tree, and a train step of each phase
    5 run on the optimizer's meta state (the trainer's own abstract state)
    and the same host batch."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule

    cfg = get_config(ARCH)
    out = {name: _count_dict(_counted(run)) for name, run in _serving_steps(
        cfg, torch.device("meta"), DecoderLM(cfg).init_shape(), seed).items()}
    for cfg, rows, seq, _ in train_runs():  # as train_phase builds them
        model = DecoderLM(cfg)
        opt = AdamW(lr=constant_schedule(1e-4), moments_dtype=cfg.opt_moments_dtype)
        batch = SyntheticBatches(cfg, rows, seq, seed=seed).batch(TRAIN_STEPS)
        state, step = opt.init_state(model.init_shape()), make_train_step(model, opt)
        out[f"{cfg.name} train"] = _count_dict(_counted(lambda: step(state, batch)))
    return out


def _meta_counts_main(argv):
    """Phase 14's meta counts in a process of their own, started with the
    run (``cost_meta_start``): ``cost_meta_counts``, then phase 13's
    deepseek-coder-33b cp_fsdp step on a mesh of a fake process group
    (process-global) seen from one rank (a rank's local shards, and so its
    attention's visible pairs under context parallelism, depend on its
    place in the mesh), run once to fill DTensor's sharding-propagation
    cache (see ``dryrun.trace_cell``) and counted. Writes {step: count,
    "mesh": count} as JSON."""
    t0 = time.perf_counter()
    spec = json.loads(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh

    torch.set_num_threads(1)
    out = cost_meta_counts(spec["seed"]) if spec["steps"] else {}
    shape = tuple(spec["mesh"])
    dryrun._fake_group(math.prod(shape), spec["rank"])
    run = dryrun.cell_step(DEEPSEEK_ARCH, "train_4k", make_smoke_mesh(shape),
                           overrides=COST_MESH_TRAIN, seq_len=MESH_TRAIN_SEQ,
                           global_batch=MESH_TRAIN_BATCH)
    run()
    out["mesh"] = _count_dict(_counted(run))
    out["seconds"] = time.perf_counter() - t0
    pathlib.Path(spec["out"]).write_text(json.dumps(out))


def cost_meta_start(seed, mesh=(1, 1), rank=0, steps=True):
    """Start ``_meta_counts_main`` (one torch thread: it shares the host
    with the run); returns (process, its output file's directory)."""
    import os

    out = tempfile.TemporaryDirectory(prefix="chip_smoke_meta_")
    spec = json.dumps(dict(seed=seed, mesh=list(mesh), rank=rank, steps=steps,
                           out=f"{out.name}/meta.json"))
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke._meta_counts_main({spec!r})"],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1",
                           PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")])),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())  # a failed run stops it
    return proc, out


def cost_meta_result(started):
    """The meta counts of ``cost_meta_start``'s process (waited for)."""
    proc, out = started
    text, _ = proc.communicate(timeout=600)
    with out:
        if proc.returncode != 0:
            raise AssertionError(f"the meta counts failed:\n{text[-4000:]}")
        return json.loads(pathlib.Path(out.name, "meta.json").read_text())


def _cost_cell_card(dev, seed, mesh):
    """Phase 13's deepseek-coder-33b cp_fsdp step on ``mesh`` (NCCL ranks),
    run once to fill DTensor's sharding-propagation cache (see
    ``dryrun.trace_cell``), then counted once and timed once: (count,
    device ms by CUDA events, wall ms)."""
    import torch

    from repro_torch.launch.dryrun import cell_step

    run = cell_step(DEEPSEEK_ARCH, "train_4k", mesh, overrides=COST_MESH_TRAIN,
                    seq_len=MESH_TRAIN_SEQ, global_batch=MESH_TRAIN_BATCH, device=dev,
                    seed=seed)
    run()
    card = _count_dict(_counted(run))
    device_ms, wall_ms = _timed_step(run)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return card, device_ms, wall_ms


# --------------------------------------------------------------------------
# phase 13: the port on a DeviceMesh (one NCCL rank), against the meshless path

MESH_BUDGET_S = 90.0
DEEPSEEK_ARCH = "deepseek-coder-33b"
MESH_TRAIN = dict(num_layers=2)  # 2 of 62 layers: 1.52 B params, ~18 GB with f32 moments
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 4096
# phase 14's step in phase 13: the cp_fsdp run's config (one row a microbatch)
COST_MESH_TRAIN = dict(MESH_TRAIN, num_microbatches=MESH_TRAIN_BATCH)
MESH_DECODE = dict(num_layers=1)  # mixtral-8x22b, 1 of 56 layers, every expert
MESH_DECODE_B, MESH_DECODE_L, MESH_DECODE_POS = 8, 4096, 4000


def _mesh_train_run(dev, seed, cfg, ranks=None, model_par=1, extra=False):
    """TRAIN_STEPS steps of MESH_TRAIN_BATCH x MESH_TRAIN_SEQ through
    ``ElasticTrainer``: on one card (``ranks`` None, no process group) or
    on a (len(ranks) / model_par, model_par) mesh of those ranks. No
    checkpoint is written. Returns (losses, step ms, peak bytes, launches,
    backward calls, plain calls, and with ``extra`` the ``_extra_step``
    measurements of two more steps)."""
    import torch

    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import BWD_CALLS, LAUNCHES, PLAIN_CALLS, reset_counts
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule

    FewCheckpointer, TimedTrainer = _trainer_classes()
    check_released(dev, f"mesh training {cfg.layout}")
    model = DecoderLM(cfg)
    opt = AdamW(lr=constant_schedule(1e-4), moments_dtype=cfg.opt_moments_dtype)
    data = SyntheticBatches(cfg, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, seed=seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as ckdir:
        trainer = TimedTrainer(model, opt, data, FewCheckpointer(ckdir, n_writes=0),
                               devices=[dev] if ranks is None else ranks,
                               model_par=model_par)
        if (trainer.mesh is None) != (ranks is None):
            raise AssertionError(f"trainer mesh {trainer.mesh}, ranks {ranks}")
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        state = trainer.run(TRAIN_STEPS, seed=seed, checkpoint_every=0)
        torch.cuda.synchronize()
        out = ([h[1] for h in trainer.history], list(trainer.step_ms),
               torch.cuda.max_memory_allocated(dev), dict(LAUNCHES), dict(BWD_CALLS),
               dict(PLAIN_CALLS))
        if extra:
            out += (_extra_step(trainer, state, data.batch(TRAIN_STEPS)),)
    del state, trainer, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _nccl_ms(prof, n=1):
    """Device ms per call of each NCCL kernel in a torch.profiler profile
    of ``n`` calls, by kernel name (cut at its argument list). A kernel's
    time includes its wait for the other ranks."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.key.startswith("ncclDevKernel"):
            name = e.key.split("(")[0][:64]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / n / 1e3
    return out


def _extra_step(trainer, state, batch):
    """Two more steps of a trained ``TimedTrainer`` on ``batch``: the host
    ms from a synchronised start to the step's return (every kernel and
    collective enqueued, none waited for) and the step's synchronised ms;
    then one under torch.profiler: its device busy ms and each NCCL
    kernel's device ms (empty off a mesh)."""
    import contextlib

    import torch

    from repro_torch.parallel import use_sharding_ctx
    from repro_torch.parallel.distribute import distribute_tree

    ctx = contextlib.nullcontext()
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if trainer.mesh is not None:
        batch = distribute_tree(batch, trainer.batch_shardings)
        ctx = use_sharding_ctx(trainer.mesh, trainer.rules)
    with ctx:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.raw_step_fn(state, batch)
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        prof = profiled(lambda: trainer.raw_step_fn(state, batch), 1)
    from torch.autograd import DeviceType

    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return dict(host_ms=host_ms, step_ms=step_ms, device_busy_ms=busy,
                nccl_ms=_nccl_ms(prof))


def _mesh_decode(dev, seed, cfg, mesh, B=None, L=None, pos=None, layout="decode_ws",
                 extra=False):
    """One ``decode_step`` of B rows (default MESH_DECODE_B) at position pos
    (MESH_DECODE_POS) against an L-slot (MESH_DECODE_L) dense cache holding
    seeded keys and values at positions 0..pos-1; on one card, or on
    ``mesh`` under ``layout``'s decode rules (None: the config's). Returns
    (f32 logits, launches, plain calls, the collectives of the step, and
    with ``extra`` the NCCL kernels' device ms of one more step under
    torch.profiler)."""
    import torch

    from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from repro_torch.models.decoder import DecoderLM

    B = B or MESH_DECODE_B
    L, pos = L or MESH_DECODE_L, pos or MESH_DECODE_POS
    check_released(dev, "mesh decode")
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    cache = model.init_cache(B, L, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for entry in cache:
        for name in ("k", "v"):
            entry[name][:, :pos] = torch.randn(entry[name][:, :pos].shape, generator=gen,
                                               device=dev).to(entry[name].dtype)
        entry["pos"][:, :pos] = torch.arange(pos, dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    comms, nccl = {}, None
    with torch.inference_mode():
        if mesh is None:
            reset_counts()
            logits, _ = model.decode_step(params, cache, tokens=toks, pos=pos)
            counts = (dict(LAUNCHES), dict(PLAIN_CALLS))
        else:
            from torch.distributed.tensor import Replicate, distribute_tensor
            from torch.distributed.tensor.debug import CommDebugMode

            from repro_torch.parallel import use_sharding_ctx
            from repro_torch.parallel.distribute import distribute_tree
            from repro_torch.parallel.layouts import (cache_specs, layout_rules,
                                                      param_specs, to_shardings)

            rules = layout_rules(mesh, cfg, "decode", global_batch=B, layout=layout)
            dparams = distribute_tree(params, to_shardings(param_specs(params, mesh, rules),
                                                           mesh))
            dcache = distribute_tree(cache, to_shardings(
                cache_specs(model, mesh, rules, B, L, shapes=cache), mesh))
            del params, cache
            params = cache = None
            dtoks = distribute_tensor(toks, mesh, [Replicate()] * mesh.ndim,
                                      src_data_rank=None)
            reset_counts()
            comm = CommDebugMode()
            with use_sharding_ctx(mesh, rules), comm:
                logits, _ = model.decode_step(dparams, dcache, tokens=dtoks, pos=pos)
            comms = {str(o).split(".")[-1]: int(n) for o, n in comm.get_comm_counts().items()}
            logits = logits.full_tensor()
            counts = (dict(LAUNCHES), dict(PLAIN_CALLS))
            if extra:
                with use_sharding_ctx(mesh, rules):
                    nccl = _nccl_ms(profiled(lambda: model.decode_step(
                        dparams, dcache, tokens=dtoks, pos=pos + 1), 1))
            del dparams, dcache
        torch.cuda.synchronize()
        out = (logits.float(), *counts, comms)
        if extra:
            out += (nccl,)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_train_cfgs():
    """Phase 13's two training runs of deepseek-coder-33b at MESH_TRAIN
    depth: its config's ``cp_fsdp`` (one row a microbatch) and the
    ``configs/optimized.py`` train variant (``fsdp``, flash_vjp)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.optimized import OPTIMIZED

    base = get_config(DEEPSEEK_ARCH).replace(**MESH_TRAIN)
    return {"cp_fsdp": base.replace(num_microbatches=MESH_TRAIN_BATCH),
            "optimized": base.replace(**OPTIMIZED[DEEPSEEK_ARCH]["train"])}


def _b3_as_stats(counts):
    """Meshless launch counts with B3's moved to B3 with statistics, which
    every decode on a mesh takes."""
    return dict(counts, decode_attention=0,
                decode_attention_stats=counts.get("decode_attention_stats", 0)
                + counts.get("decode_attention", 0))


def mesh_phase(dev, seed):
    """Phase 13: the port on a one-rank NCCL DeviceMesh, (data, model) =
    (1, 1), held to the meshless path on the same seed and batches. (a)
    deepseek-coder-33b at full width, 2 of 62 layers, bf16, TRAIN_STEPS
    steps of 2 x 4096 tokens through ``ElasticTrainer``, under its config's
    ``cp_fsdp`` (2 microbatches of one row) and under
    ``configs/optimized.py``'s train variant (``fsdp``, 1 microbatch,
    flash_vjp): losses within 1e-4 (bitwise expected; which is logged),
    every kernel's launches and backward calls equal, no plain call; step
    ms and peak bytes of each. (b) mixtral-8x22b, 1 of 56 layers with every
    expert, bf16: one ``decode_step`` of 8 rows against a 4096-slot cache
    under ``decode_ws`` (B3 with statistics, whose f32 o rounds to B3's,
    and the MoE twin of ``_moe_smap``, its ETP branch at tp 1), logits
    within 3e-5 of the meshless step's (bitwise expected), B3's launches
    those of the meshless step. The meshless runs come first, before the
    process group exists (the trainer trains on one card when there is
    none). NCCL failing to initialise, a DTensor reaching a kernel, or a
    kernel failing fails the phase. (c) Phase 14's last step: the cp_fsdp
    step on the mesh, counted and timed on the card (``_cost_cell_card``),
    in ``summary["cost"]``. Returns (the mesh runs' launches, summary)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh

    t_phase = time.perf_counter()
    torch.cuda.init()  # the phase may run alone: its first calls read the allocator
    runs = _mesh_train_cfgs()
    dcfg = get_config(MIXTRAL_ARCH).replace(**MESH_DECODE)
    log(f"mesh phase: {DEEPSEEK_ARCH} {MESH_TRAIN} train runs "
        f"{ {k: (c.layout, c.num_microbatches, c.flash_vjp) for k, c in runs.items()} }, "
        f"{MIXTRAL_ARCH} {MESH_DECODE} decode_ws decode")
    plain = {name: _mesh_train_run(dev, seed, cfg) for name, cfg in runs.items()}
    plain_decode = _mesh_decode(dev, seed, dcfg, None)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as store_dir:
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.FileStore(f"{store_dir}/store", 1),
                                rank=0, world_size=1, device_id=dev)
        try:
            meshed = {name: _mesh_train_run(dev, seed, cfg, ranks=[0])
                      for name, cfg in runs.items()}
            mesh_decode = _mesh_decode(dev, seed, dcfg,
                                       make_smoke_mesh((1, 1), device_type="cuda"))
            t_cost = time.perf_counter()
            cost_card = _cost_cell_card(dev, seed, make_smoke_mesh((1, 1), device_type="cuda"))
            t_cost = time.perf_counter() - t_cost
        finally:
            dist.destroy_process_group()

    summary, launches = {}, {}
    for name in runs:
        (pl, pms, ppeak, pcount, pbwd, _), (ml, mms, mpeak, mcount, mbwd, mplain) = (
            plain[name], meshed[name])
        gap = max(abs(a - b) for a, b in zip(ml, pl))
        summary[name] = dict(
            layout=runs[name].layout, microbatches=runs[name].num_microbatches,
            flash_vjp=runs[name].flash_vjp, losses=ml, meshless_losses=pl,
            max_loss_gap=gap, bitwise=ml == pl, step_ms=mms, meshless_step_ms=pms,
            max_memory_allocated=mpeak, meshless_max_memory_allocated=ppeak,
            launches={k: n for k, n in mcount.items() if n},
            backward_calls={k: n for k, n in mbwd.items() if n})
        log(f"  mesh train {name}: {json.dumps(summary[name])}")
        if not (len(ml) == len(pl) == TRAIN_STEPS and gap <= 1e-4):
            raise AssertionError(f"mesh train {name}: losses {ml} vs meshless {pl}")
        if mcount != pcount or mbwd != pbwd or sum(mplain.values()):
            raise AssertionError(f"mesh train {name}: launches {mcount} / {pcount}, backward "
                                 f"{mbwd} / {pbwd}, plain calls {mplain}")
        for k, n in mcount.items():
            launches[k] = launches.get(k, 0) + n
    (ml, mcount, mplain, _), (pl, pcount, _, _) = mesh_decode, plain_decode
    gap = float((ml - pl).abs().max())
    summary["decode_ws"] = dict(max_abs_logit_gap=gap, bitwise=bool(torch.equal(ml, pl)),
                                max_abs_logit=float(pl.abs().max()),
                                launches={k: n for k, n in mcount.items() if n})
    log(f"  mesh decode_ws: {json.dumps(summary['decode_ws'])}")
    if not (torch.isfinite(ml).all() and gap <= 3e-5) or mcount != _b3_as_stats(pcount) \
            or sum(mplain.values()) or not mcount.get("decode_attention_stats"):
        raise AssertionError(f"mesh decode: gap {gap}, launches {mcount} / {pcount}, "
                             f"plain {mplain}")
    for k, n in mcount.items():
        launches[k] = launches.get(k, 0) + n
    summary["cost"], summary["cost_s"] = cost_card, t_cost
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh phase: {summary['phase_s']:.1f} s")
    if summary["phase_s"] > MESH_BUDGET_S:
        raise AssertionError(f"mesh phase took {summary['phase_s']:.1f} s > "
                             f"{MESH_BUDGET_S} s")
    return launches, summary


# --------------------------------------------------------------------------
# phase 13 on four NCCL ranks (``--mesh-ranks 4``): the mesh's collectives

MESH4_RANKS = 4
# the phase on four H100s, build aside: ~150 s measured for (a)-(c) in f32,
# 62 s for the elastic runs, ~45 s more for bf16; 1.6 times their sum
MESH4_BUDGET_S = 420.0
MESH4_SHAPES = ((2, 2), (1, 4))
# phase 13's training runs on four ranks, in f32 (held at 1e-4) and in the
# port's bf16. bf16 losses move with any change of reduction order, and
# AdamW's first update (about lr * sign(g)) carries a flipped sign of a
# near-zero gradient into the second step's loss. Readings on one H100
# (700 W): one card's cp_fsdp (2 microbatches) and fsdp (1 microbatch) bf16
# runs differ by 3.84e-4 at step 2 and 2.44e-4 at step 3, 0 at step 1;
# cp_fsdp on (2, 2) of four H100s differed from one card by 1.5e-3 at step 2
# and 4.5e-5 at step 1. The bf16 runs are held at 5e-3: 13 times the
# one-card reading (which the run logs again as ``witness_gap``), 3.3 times
# the four-card one, and far under the 4.04 by which a skipped first update
# would move the second step's loss (10.76 -> 14.80)
MESH4_TRAIN_DTYPES = {"": (dict(dtype="float32", param_dtype="float32"), 1e-4),
                      " bf16": (dict(), 5e-3)}
# deepseek-coder-33b decode in f32, 2 of 62 layers (1.52 B params, 6.1 GB)
# against a 32,768-slot cache holding keys at 0..31,999, on (2, 2): 8 rows
# shard ``cache_len`` over "model", 1 row over both axes
MESH4_DECODE = dict(num_layers=2, dtype="float32", param_dtype="float32")
MESH4_DECODE_L, MESH4_DECODE_POS, MESH4_DECODE_ROWS = 32768, 32000, (8, 1)
# mixtral-8x22b decode_ws in f32, 1 of 56 layers (11.6 GB), no dropped
# assignment (a rank routes its own rows, so capacity must not bind)
MESH4_MOE = dict(num_layers=1, dtype="float32", param_dtype="float32",
                 capacity_factor=8.0)
MESH4_LOGIT_TOL = 3e-5         # the reference's decode_ws bound (atol = rtol)
ELASTIC_LOSS_TOL = 5e-4        # tests/test_torch_mesh.py's elastic bound
ELASTIC_DUMP_S = 60            # a rank still in the elastic run then prints its stacks


def _mesh4_train_cfgs():
    """{run name: (config, loss bound)}: phase 13's runs in each of
    MESH4_TRAIN_DTYPES."""
    return {name + sfx: (cfg.replace(**kw), tol) for sfx, (kw, tol) in MESH4_TRAIN_DTYPES.items()
            for name, cfg in _mesh_train_cfgs().items()}


def _elastic_ranks(rank, ckpt_dir):
    """``ElasticTrainer`` 4 -> 2 -> 4 at smoke size: starcoder2-3b's smoke
    config, 8 x 32 tokens in 2 microbatches, model_par 2; 16 steps with a
    revocation to 2 ranks at step 8, a resume on 2 to step 18, a cold
    restore onto 4 to step 20. The weights are the port's seeded init on
    the host, so gloo and NCCL ranks start alike. A rank still running
    after ELASTIC_DUMP_S prints every thread's stack. Returns the three
    trainers' histories (step, loss, ranks) and the first's rescales."""
    import faulthandler

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticBatches
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule
    from repro_torch.parallel.distribute import distribute_tree
    from repro_torch.runtime.elastic import ElasticTrainer

    cfg = smoke_config(ARCH).replace(num_microbatches=2)
    model = build_model(cfg)

    class Trainer(ElasticTrainer):
        def _init_state(self, seed):
            params = model.init(torch.Generator().manual_seed(seed), device="cpu")
            return self.opt.init_state(distribute_tree(params,
                                                       self.state_shardings["params"]))

    opt = AdamW(lr=constant_schedule(3e-3))
    data = SyntheticBatches(cfg, global_batch=8, seq_len=32, seed=0)
    ck = Checkpointer(ckpt_dir, keep=2)
    trainers = []
    faulthandler.dump_traceback_later(ELASTIC_DUMP_S)
    for n, steps, kw in ((4, 16, dict(preempt_at={8: 2}, checkpoint_every=5)),
                         (2, 18, dict(checkpoint_every=0)), (4, 20, dict(checkpoint_every=0))):
        tr = Trainer(model, opt, data, ck, model_par=2, devices=list(range(n)))
        tr.run(steps, **kw)
        trainers.append(tr)
    faulthandler.cancel_dump_traceback_later()
    return [tr.history for tr in trainers], trainers[0].rescales


def mesh4_rank(rank, seed):
    """One of ``mesh4_phase``'s NCCL ranks, on card ``rank``: the phase 13
    training runs on each mesh of MESH4_SHAPES, then the f32 decodes and
    mixtral's decode_ws step on (2, 2). Returns what it measured; rank 0
    adds its logits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh

    dev = torch.device("cuda", rank)
    ranks = list(range(MESH4_RANKS))
    out = {"train": {}, "decode": {}}
    for shape in MESH4_SHAPES:
        for name, (cfg, _) in _mesh4_train_cfgs().items():
            t0 = time.perf_counter()
            out["train"][name, shape] = _mesh_train_run(dev, seed, cfg, ranks, shape[1],
                                                         extra="bf16" not in name)
            log(f"  rank {rank}: train {name} on {shape} in {time.perf_counter() - t0:.1f} s")
    mesh = make_smoke_mesh((2, 2), device_type="cuda")
    dcfg = get_config(DEEPSEEK_ARCH).replace(**MESH4_DECODE)
    for B in MESH4_DECODE_ROWS:
        out["decode"][B] = _mesh_decode(dev, seed, dcfg, mesh, B, MESH4_DECODE_L,
                                        MESH4_DECODE_POS, layout=None, extra=B == 8)
    out["moe"] = _mesh_decode(dev, seed, get_config(MIXTRAL_ARCH).replace(**MESH4_MOE),
                              mesh)
    out["cost"] = _cost_cell_card(dev, seed, mesh)
    # the logits go back as a numpy array (a tensor would cross to the parent
    # by a handle into this process's memory, which ends with it); one rank's
    # are enough, as every rank gathers the same
    for key, run in list(out["decode"].items()) + [("moe", out["moe"])]:
        slim = (None if rank else run[0].cpu().numpy(),) + run[1:]
        if key == "moe":
            out["moe"] = slim
        else:
            out["decode"][key] = slim
    return out


def mesh4_phase(seed, smi=""):
    """Phase 13 on MESH4_RANKS NCCL ranks, one card each (``--mesh-ranks
    4``), held to the meshless path on card 0, on the same seed: (a) phase
    13's two deepseek-coder-33b training runs (2 of 62 layers, TRAIN_STEPS
    steps of 2 x 4096 tokens, ``cp_fsdp`` and the ``fsdp`` variant), each in
    f32 and in bf16 (MESH4_TRAIN_DTYPES), on (2, 2) and on (1, 4): losses
    within their dtype's bound, every kernel's launches and backward calls
    equal on every rank, no plain call; in f32 also the step ms, peak bytes,
    the host ms of a step (to its return) and each NCCL kernel's device ms
    in a profiled step, beside one card's. (b)
    deepseek-coder-33b in f32 (MESH4_DECODE), one decode step of 8 rows
    (``cache_len`` over "model") and of 1 row (over both axes) at position
    MESH4_DECODE_POS of a MESH4_DECODE_L-slot cache, so that every shard
    holds keys: logits within MESH4_LOGIT_TOL, B3 with statistics on every
    rank and layer, all-reduces and no plain call; the NCCL kernels of a
    profiled 8-row step. (c) mixtral-8x22b's decode_ws step, 1 layer, f32
    (MESH4_MOE), on (2, 2): expert parallelism over the 4 ranks, so
    ``_moe_smap``'s all_to_all runs; logits within MESH4_LOGIT_TOL. (d)
    once (a)-(c) are checked and logged, ``_elastic_ranks`` on 4 NCCL ranks
    of a group of their own and, at the same time, on 4 gloo ranks on the
    host (after the timed runs, so those share the host with nothing): the
    same step and rank history, the first three losses within
    ELASTIC_LOSS_TOL. (e) Phase 14's step on four ranks: phase 13's
    cp_fsdp step (COST_MESH_TRAIN) on (2, 2), counted on each rank, its NCCL
    collectives included, and held to the meta count of the step seen from
    that rank of a fake 4-rank group (a process of its own a rank, started
    with the phase).
    Raises with fewer than MESH4_RANKS
    cards, and when the phase takes more than MESH4_BUDGET_S. Returns the
    summary."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.parallel.spawn import Ranks

    n_cards = torch.cuda.device_count()
    if n_cards < MESH4_RANKS:
        raise RuntimeError(f"--mesh-ranks {MESH4_RANKS} needs {MESH4_RANKS} cards, "
                           f"{n_cards} visible")
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    runs = _mesh4_train_cfgs()
    dcfg = get_config(DEEPSEEK_ARCH).replace(**MESH4_DECODE)
    mcfg = get_config(MIXTRAL_ARCH).replace(**MESH4_MOE)
    log(f"mesh phase on {MESH4_RANKS} NCCL ranks: train {list(runs)} on {MESH4_SHAPES}; "
        f"{DEEPSEEK_ARCH} {MESH4_DECODE} decode of {MESH4_DECODE_ROWS} rows over "
        f"{MESH4_DECODE_L} slots; {MIXTRAL_ARCH} {MESH4_MOE} decode_ws; elastic 4 -> 2 -> 4")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh4_")
    metas = [cost_meta_start(seed, mesh=(2, 2), rank=r, steps=False)
             for r in range(MESH4_RANKS)]
    plain = {name: _mesh_train_run(dev, seed, cfg, extra="bf16" not in name)
             for name, (cfg, _) in runs.items()}
    plain_decode = {B: _mesh_decode(dev, seed, dcfg, None, B, MESH4_DECODE_L,
                                    MESH4_DECODE_POS, layout=None)
                    for B in MESH4_DECODE_ROWS}
    plain_moe = _mesh_decode(dev, seed, mcfg, None)
    t_plain = time.perf_counter() - t_phase
    for sub in ("gloo", "nccl", "elastic"):  # one FileStore a group
        pathlib.Path(tmp.name, sub).mkdir()
    got = Ranks(mesh4_rank, MESH4_RANKS, (seed,), store_dir=f"{tmp.name}/nccl",
                timeout_s=600, backend="nccl").results(timeout=MESH4_BUDGET_S)

    # the one-card gap of a reduction order changed by microbatching alone,
    # the witness of the bf16 bound
    witness = max(abs(a - b) for a, b in zip(plain["cp_fsdp bf16"][0],
                                             plain["optimized bf16"][0]))
    summary = {"meshless_s": t_plain, "train": {}, "decode": {}, "witness_gap": witness}
    log(f"  mesh4 bf16 witness: one card's cp_fsdp vs fsdp losses {witness:.3e} apart")
    for (name, shape), _ in got[0]["train"].items():
        pl, pms, ppeak, pcount, pbwd, pplain, *pextra = plain[name]
        per_rank = [r["train"][name, shape] for r in got]
        ml, mms, mpeak, mcount, mbwd, mplain, *mextra = per_rank[0]
        cfg, tol = runs[name]
        gap = max(abs(a - b) for a, b in zip(ml, pl))
        row = dict(layout=cfg.layout, dtype=cfg.dtype, mesh=list(shape), losses=ml,
                   meshless_losses=pl, max_loss_gap=gap, loss_bound=tol, step_ms=mms,
                   meshless_step_ms=pms, max_memory_allocated=[r[2] for r in per_rank],
                   meshless_max_memory_allocated=ppeak,
                   launches={k: n for k, n in mcount.items() if n})
        if mextra:
            row.update(extra=mextra[0], meshless_extra=pextra[0],
                       rank_extra=[r[6] for r in per_rank[1:]])
        summary["train"][f"{name} {shape[0]}x{shape[1]}"] = row
        log(f"  mesh4 train {name} {shape}: {json.dumps(row, default=float)}")
        if not (len(ml) == len(pl) == TRAIN_STEPS and gap <= tol):
            raise AssertionError(f"mesh4 train {name} {shape}: losses {ml} vs meshless {pl} "
                                 f"(bound {tol})")
        for r, run in enumerate(per_rank):
            if (run[3] != pcount or run[4] != pbwd or sum(run[5].values())
                    or sum(pplain.values()) or run[0] != ml):
                raise AssertionError(f"mesh4 train {name} {shape} rank {r}: launches "
                                     f"{run[3]} / {pcount}, backward {run[4]} / {pbwd}, "
                                     f"plain {run[5]}, losses {run[0]} / {ml}")
    n_attn = sum(s.mixer == "attn" for s in _layer_specs(dcfg))
    for key, ref, cfg in [(B, plain_decode[B], dcfg) for B in MESH4_DECODE_ROWS] + [
            ("moe", plain_moe, mcfg)]:
        per_rank = [r["decode"][key] if key != "moe" else r["moe"] for r in got]
        err = _check(f"mesh4 decode {key} logits vs one card",
                     torch.from_numpy(per_rank[0][0]), ref[0].cpu(), MESH4_LOGIT_TOL)
        row = dict(max_abs_logit_gap=err, max_abs_logit=float(ref[0].abs().max()),
                   collectives=[r[3] for r in per_rank],
                   launches=[{k: n for k, n in r[1].items() if n} for r in per_rank])
        if key == 8:
            row["nccl_ms"] = [r[4] for r in per_rank]
        summary["decode"][str(key)] = row
        log(f"  mesh4 decode {key}: {json.dumps(row, default=float)}")
        want_stats = n_attn if key != "moe" else sum(s.mixer == "attn"
                                                     for s in _layer_specs(cfg))
        collective = "all_to_all_single" if key == "moe" else "all_reduce"
        for r, run in enumerate(per_rank):
            if (run[1].get("decode_attention_stats") != want_stats
                    or run[1].get("decode_attention") or sum(run[2].values())
                    or not run[3].get(collective)):
                raise AssertionError(f"mesh4 decode {key} rank {r}: launches {run[1]}, "
                                     f"plain {run[2]}, collectives {run[3]}")
    summary["cost"] = [
        cost_row(f"{DEEPSEEK_ARCH} cp_fsdp train on (2, 2), rank {r}", card,
                 cost_meta_result(meta)["mesh"], device_ms, wall_ms, "bfloat16", smi)
        for r, ((card, device_ms, wall_ms), meta) in enumerate(
            zip((x["cost"] for x in got), metas))]
    if not summary["cost"][0]["collectives"]:
        raise AssertionError("mesh4 cost: the (2, 2) step counted no collective bytes")
    # the elastic run in a group of its own, after the measurements above
    # are logged, with a short collective timeout: a rank that waits on one
    # the others never join fails the run in a minute and a half, and
    # prints its stacks before
    t0 = time.perf_counter()
    with tmp:
        gloo = Ranks(_elastic_ranks, MESH4_RANKS, (f"{tmp.name}/gloo_ck",),
                     store_dir=f"{tmp.name}/gloo", timeout_s=600, backend="gloo")
        hist, rescales = Ranks(_elastic_ranks, MESH4_RANKS, (f"{tmp.name}/nccl_ck",),
                               store_dir=f"{tmp.name}/elastic", timeout_s=90,
                               backend="nccl").results(timeout=120)[0]
        t_nccl = time.perf_counter() - t0
        ghist, grescales = gloo.results(timeout=240)[0]
    summary["elastic"] = dict(history=hist, gloo_history=ghist, rescales=rescales,
                              nccl_s=t_nccl, seconds=time.perf_counter() - t0)
    log(f"  mesh4 elastic: {json.dumps(summary['elastic'])}")
    steps = [[(s, d) for s, _, d in h] for h in hist]
    if (steps != [[(s, d) for s, _, d in h] for h in ghist] or (rescales, grescales) != (1, 1)
            or steps != [[(s, 4 if s < 8 else 2) for s in range(16)],
                         [(16, 2), (17, 2)], [(18, 4), (19, 4)]]
            or not all(math.isfinite(v) for h in hist for _, v, _ in h)
            or max(abs(a[1] - b[1]) for a, b in zip(hist[0][:3], ghist[0][:3]))
            > ELASTIC_LOSS_TOL):
        raise AssertionError(f"mesh4 elastic: NCCL {hist} ({rescales} rescales) vs gloo "
                             f"{ghist} ({grescales})")
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh4 phase: {summary['phase_s']:.1f} s")
    if summary["phase_s"] > MESH4_BUDGET_S:
        raise AssertionError(f"mesh4 phase took {summary['phase_s']:.1f} s > "
                             f"{MESH4_BUDGET_S} s")
    return summary


def _layer_specs(cfg):
    from repro_torch.models.decoder import DecoderLM

    return DecoderLM(cfg).layer_specs


# --------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jamba-grad-study", type=int, nargs="+", metavar="SEED",
                    help="build the kernels, then run only the jamba f32 gradient phase "
                         "once per SEED, with each mixer leaf's distance from an f64 path "
                         "under five mixes of kernels and plain versions; no smoke result")
    ap.add_argument("--mesh-ranks", type=int, choices=(MESH4_RANKS,),
                    help="build the kernels, then run only the mesh phase, on this many "
                         "NCCL ranks, one card each (raises with fewer cards)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} | {smi} | tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    meta_counts = (None if args.jamba_grad_study or args.mesh_ranks
                   else cost_meta_start(args.seed))  # phase 14's, beside the run
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s (nvcc "
        f"{' '.join(_build.NVCC_FLAGS)})")
    for stem, path in sorted(libs.items()):
        log_ptxas(stem, path.with_suffix(".log"))
    if args.jamba_grad_study:
        for seed in args.jamba_grad_study:
            jamba_grad_phase(dev, seed, study=True)
        log(f"jamba gradient study done: {smi}; total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.mesh_ranks:
        mesh4 = mesh4_phase(args.seed, smi)
        log(f"mesh on {MESH4_RANKS} NCCL ranks held to one card in "
            f"{mesh4['phase_s']:.1f} s; total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"mesh4": {**mesh4, "card": smi}}, default=float))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    rows = kernel_phase(dev)
    rows.update(rwkv_kernel_phase(dev))
    rows.update(rwkv_bwd_kernel_phase(dev))
    rows.update(ssm_kernel_phase(dev))
    rows["ssm_scan_bwd"], b4_train = ssm_bwd_kernel_phase(dev)
    rows["ssm_scan"].update(b4_train)

    from repro_torch.configs import get_config

    jamba = get_config(JAMBA_ARCH)
    launches, summary = serving_phase(dev, args.seed, get_config(ARCH), STARCODER_LAYOUTS,
                                      cost=True)
    cards = {name: (*got, "CUDA events") for name, got in summary["cost"].items()}
    cost_s = [summary["cost_s"]]
    by_path = {"serving": dict(launches)}
    for cfg, layouts in ((get_config(RWKV_ARCH), RWKV_LAYOUTS),
                         (jamba.replace(**JAMBA_SERVE), JAMBA_LAYOUTS)):
        more, _ = serving_phase(dev, args.seed, cfg, layouts)
        for name, n in more.items():
            launches[name] += n
            by_path["serving"][name] += n
    worst = max(f32_phase(dev, args.seed, cfg) for cfg in (
        get_config(ARCH), get_config(RWKV_ARCH), jamba.replace(**JAMBA_BLOCK)))
    by_path["training"] = {name: 0 for name in launches}
    for cfg, n_rows, seq, preempt in train_runs():
        more, summary = train_phase(dev, args.seed, cfg, n_rows, seq, preempt, cost=True)
        cards[f"{cfg.name} train"] = (*summary["cost"], "profiler busy time of one step")
        cost_s.append(summary["cost_s"])
        for name, n in more.items():
            launches[name] += n
            by_path["training"][name] += n
    worst_grad, depth_ratio = grad_phase(dev, args.seed)
    jamba_in_place, jamba_leaves = jamba_grad_phase(dev, args.seed)
    fleet = fleet_phase(dev)
    serving_fleet, more = serving_fleet_phase(dev, args.seed)
    by_path["serving_fleet"] = dict(more)
    for name, n in more.items():
        launches[name] += n
    serving_torch, rows["serving_fleet"], more = serving_torch_phase(
        dev, serving_fleet["paper"]["wall_s"])
    by_path["serving_torch"] = dict(more)
    for name, n in more.items():
        launches[name] += n
    arrivals = arrivals_phase(dev)
    families_launches, families = families_phase(dev, args.seed)
    by_path["families"] = dict(families_launches)
    for name, n in families_launches.items():
        launches[name] += n
    moe_launches, moe_training = moe_train_phase(dev, args.seed)
    by_path["moe_training"] = dict(moe_launches)
    for name, n in moe_launches.items():
        launches[name] += n
    mesh_launches, mesh = mesh_phase(dev, args.seed)
    cards[COST_MESH] = (*mesh.pop("cost"), "CUDA events")
    cost_s.append(mesh.pop("cost_s"))
    t0 = time.perf_counter()
    metas = cost_meta_result(meta_counts)
    metas[COST_MESH] = metas.pop("mesh")
    cost_s.append(time.perf_counter() - t0)  # waiting for the meta counts, if at all
    log(f"phase 14: each counted step on the card against its meta count (the meta "
        f"counts took {metas.pop('seconds'):.1f} s beside the run, waited {cost_s[-1]:.1f} s)")
    cost = {name: cost_row(name, card, metas[name], dms, wms, "bfloat16", smi, how)
            for name, (card, dms, wms, how) in cards.items()}  # every counted step is bf16
    cost["seconds"] = sum(cost_s)
    log(f"cost: {len(cost) - 1} steps counted on the card and on meta tensors in "
        f"{cost['seconds']:.1f} s of the phases they ran in")
    if cost["seconds"] > COST_BUDGET_S:
        raise AssertionError(f"the counted steps took {cost['seconds']:.1f} s > "
                             f"{COST_BUDGET_S} s")
    by_path["mesh"] = dict(mesh_launches)
    for name, n in mesh_launches.items():
        launches[name] += n

    meta = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:97"),
        "flash_attention_stats": ("src/repro_torch/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention/kernel.py:97 (B2; "
                                  "with the row statistics of "
                                  "src/repro/models/attention.py:70 _chunked_attention)"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:91"),
        "decode_attention_stats": ("src/repro_torch/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:91 (B3; "
                                   "with the row statistics that the reference's sharded "
                                   "decode merges, src/repro/parallel/layouts.py:17)"),
        "paged_decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:175"),
        "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan/kernel.py:61"),
        "rwkv6_scan_bwd": ("src/repro_torch/csrc/rwkv6_scan.cu",
                           "src/repro/kernels/rwkv6_scan/kernel.py:166"),
        "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:62"),
        "ssm_scan_bwd": ("src/repro_torch/csrc/ssm_scan.cu",
                         "src/repro/kernels/ssm_scan/kernel.py:180"),
        "serving_fleet": ("src/repro_torch/csrc/serving_fleet.cu",
                          "src/repro/runtime/serving_jax.py:222 (_simulate, XLA; no Pallas)"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            "launches_by_path": {path: n.get(name, 0) for path, n in by_path.items()},
            **{k: v for k, v in r.items()
               if k.startswith(("decode_", "train_", "jamba_", "event_", "device_",
                                "plain_device", "mixtral_", "nostats_"))}})
    log(f"f32 logits check passed: worst {worst:.3e} <= {LOGIT_RTOL}; f32 gradient "
        f"check passed: rwkv6-3b worst {worst_grad:.3e} <= {LOGIT_RTOL}, full depth "
        f"{depth_ratio:.3f} <= 1 of its limit; jamba block in place "
        f"{jamba_in_place:.3e} <= {LOGIT_RTOL}, every mixer leaf {jamba_leaves:.3e} <= "
        f"{LOGIT_RTOL}; fleet card vs CPU within {FLEET_RTOL} in "
        f"{fleet['phase_s']:.1f} s; serving fleet with and without the model equal "
        f"in {serving_fleet['phase_s']:.1f} s; serving_torch kernel bitwise equal to "
        f"the plain version and the JAX package's golden values in "
        f"{serving_torch['phase_s']:.1f} s; arrivals sampler card vs CPU and example "
        f"twins in {arrivals['phase_s']:.1f} s; model families (mixtral-8x22b served "
        f"paged and dense, f32 logits of four families, the serve launcher) in "
        f"{families['phase_s']:.1f} s; MoE training (mixtral-8x22b 1 layer, f32 "
        f"gradients {moe_training['grad_check']['worst_rel']:.3e} <= {LOGIT_RTOL}, "
        f"remat dots vs full {moe_training['remat']['worst_rel']:.3e}) in "
        f"{moe_training['phase_s']:.1f} s; mesh (deepseek-coder-33b training, "
        f"mixtral-8x22b decode_ws on a one-rank NCCL mesh, held to the meshless "
        f"path) in {mesh['phase_s']:.1f} s; step costs on the card equal to meta "
        f"tensors' ({len(cost) - 1} steps) in {cost['seconds']:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"fleet": {**fleet, "card": smi}}))
    print(json.dumps({"serving_fleet": {**serving_fleet, "card": smi}}, default=float))
    print(json.dumps({"serving_torch": {**serving_torch, "card": smi}}, default=float))
    print(json.dumps({"arrivals": {**arrivals, "card": smi}}))
    print(json.dumps({"families": {**families, "card": smi}}, default=float))
    print(json.dumps({"moe_training": {**moe_training, "card": smi}}, default=float))
    print(json.dumps({"mesh": {**mesh, "card": smi}}, default=float))
    print(json.dumps({"cost": {**cost, "card": smi}}, default=float))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
