#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and ``nvcc``; exits non-zero without them, and outside a
checkout of the repository. Phases (none catches its own failure):

1. build — every ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a), in
   parallel; each kernel entry's registers, shared memory and spills from
   ``ptxas -v``;
2. kernels — each hand-written kernel against its plain PyTorch version on
   the card at full-width shapes. Attention at starcoder2-3b's (H=24, KV=2,
   hd=128, bs=16, B=4, L=4096; flash S=4608, window 4096), and at
   jamba-1.5-large-398b's (H=64, KV=8, hd=128, bf16; flash S=4500 global
   and S=1024 global, its training microbatch; dense decode B=4 over 8192
   slots), plus softcap=50
   and hd=256 cases; tolerances atol 2e-5 for f32 and int8-dequantised
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
   blocks: 14 Mamba and 2 attention layers), experts off, every MoE FFN the
   dense SwiGLU the reference builds then, 16.9 B parameters, 33.86 GB in
   bf16. The launch and plain-call counts are zeroed just
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
kernel table (JSON), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
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
REF_CHUNK = 64                # the TPU scan's default chunk (B4-B7)
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


def bound(n_bytes, flops, dtype_name):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def ref_chunk_bytes(B, H, S, row_floats):
    """f32 bytes of one row of ``row_floats`` per (b, h) and 64-step chunk:
    the chunk-start states and du partials that the replaced TPU scan keeps
    at its default chunk. The port's 8-step checkpoints are its own design,
    so a bound counts them at the reference's interval."""
    return B * H * -(-S // REF_CHUNK) * row_floats * 4


def flash_pairs(S, window):
    """Visible (q, k) pairs of causal self-attention with a sliding window."""
    import numpy as np

    q = np.arange(S)
    return int(np.minimum(q + 1, window if window else S).sum())


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
    log(f"  {label}: ms={row[prefix + 'ms']:.4f} plain_ms={row[prefix + 'plain_ms']:.4f} "
        f"library_ms={row[prefix + 'library_ms']:.4f} "
        f"bound_ms={row[prefix + 'bound_ms']:.5f} ({row[prefix + 'bound_by']}) "
        f"at {row[prefix + 'shape']}")


def _log_event_row(label, row, prefix="jamba_"):
    log(f"  {label}: device ms={row[prefix + 'ms']:.5f} library (SDPA) "
        f"{row[prefix + 'library_ms']:.5f} (profiler); back-to-back calls "
        f"{row[prefix + 'event_ms']:.5f}, SDPA {row[prefix + 'event_library_ms']:.5f} "
        f"(CUDA events, paced by the host)")


def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_fwd, paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.optim.compress import quantize_int8

    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 2e-2, f32: 2e-5}
    rows = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- B2 flash prefill: starcoder2 full width, one 4608-token prompt
    B, H, KV, hd, S, W = 1, 24, 2, 128, 4608, 4096
    log("kernel phase: flash_attention (B2)")
    for dtype in (bf16, f32):
        q, k, v = (randn((B, S, n, hd), dtype).transpose(1, 2) for n in (H, KV, KV))
        o = flash_attention_fwd(q, k, v, window=W)
        ref = attention_ref(q, k, v, window=W)
        err = _check(f"flash {dtype} S={S} window={W}", o, ref, tol[dtype])
        if dtype == bf16:
            pairs = flash_pairs(S, W)
            mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
            mask &= ~torch.ones(S, S, dtype=torch.bool, device=dev).tril(-W)
            rows["flash_attention"] = dict(
                max_abs_err=err,
                ms=time_ms(lambda: flash_attention_fwd(q, k, v, window=W), 5),
                plain_ms=time_ms(lambda: attention_ref(q, k, v, window=W), 3),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True), 5),
                **bound(nbytes(q, k, v, o), 4 * B * H * hd * pairs, "bfloat16"),
                shape=f"B={B} H={H} KV={KV} S={S} hd={hd} window={W} bf16")
        del q, k, v, o, ref
    # jamba's attention layers: H=64, KV=8 (G=8), global, the longest
    # serving prompt, bf16 as the serving path runs them
    JH, JKV, JS = 64, 8, max(PROMPT_LENS)
    q, k, v = (randn((B, JS, n, hd), bf16).transpose(1, 2) for n in (JH, JKV, JKV))
    o = flash_attention_fwd(q, k, v)
    err = _check(f"flash bf16 jamba H={JH} KV={JKV} S={JS} global", o,
                 attention_ref(q, k, v), tol[bf16])
    rows["flash_attention"].update(_prefixed("jamba_", dict(
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention_fwd(q, k, v), 5),
        plain_ms=time_ms(lambda: attention_ref(q, k, v), 3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 5),
        **bound(nbytes(q, k, v, o), 4 * B * JH * hd * flash_pairs(JS, 0), "bfloat16"),
        shape=f"B={B} H={JH} KV={JKV} S={JS} hd={hd} global bf16")))
    _log_shape_row("flash_attention jamba", rows["flash_attention"])
    rows["flash_attention"]["max_abs_err"] = max(err, rows["flash_attention"]["max_abs_err"])
    del q, k, v, o
    # the same layer on jamba's training path: one microbatch row of
    # TRAIN_SEQ_JAMBA tokens, bf16 (the forward and its remat recompute)
    q, k, v = (randn((B, TRAIN_SEQ_JAMBA, n, hd), bf16).transpose(1, 2)
               for n in (JH, JKV, JKV))
    o = flash_attention_fwd(q, k, v)
    err = _check(f"flash bf16 jamba H={JH} KV={JKV} S={TRAIN_SEQ_JAMBA} global", o,
                 attention_ref(q, k, v), tol[bf16])
    rows["flash_attention"].update(_prefixed("train_", dict(
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention_fwd(q, k, v), 10),
        plain_ms=time_ms(lambda: attention_ref(q, k, v), 5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10),
        **bound(nbytes(q, k, v, o), 4 * B * JH * hd * flash_pairs(TRAIN_SEQ_JAMBA, 0),
                "bfloat16"),
        shape=f"B={B} H={JH} KV={JKV} S={TRAIN_SEQ_JAMBA} hd={hd} global bf16")))
    _log_shape_row("flash_attention jamba training", rows["flash_attention"], "train_")
    rows["flash_attention"]["max_abs_err"] = max(err, rows["flash_attention"]["max_abs_err"])
    del q, k, v, o
    q, k, v = (randn((1, 1024, n, hd), bf16).transpose(1, 2) for n in (H, KV, KV))
    _check("flash bf16 S=1024 softcap=50", flash_attention_fwd(q, k, v, softcap=50.0),
           attention_ref(q, k, v, softcap=50.0), tol[bf16])
    q, k, v = (randn((1, 2048, n, 256), bf16).transpose(1, 2) for n in (8, 4, 4))
    _check("flash bf16 hd=256 S=2048 softcap=50 window=1024",
           flash_attention_fwd(q, k, v, softcap=50.0, window=1024),
           attention_ref(q, k, v, softcap=50.0, window=1024), tol[bf16])
    del q, k, v

    # ---- B3 dense decode: 4 slots against a 4096-slot rolling cache
    B, L = 4, 4096
    lens = torch.tensor([L, 2071, 524, 41], device=dev)
    bias = torch.where(torch.arange(L, device=dev)[None] < lens[:, None],
                       0.0, NEG_INF).float()
    log("kernel phase: decode_attention (B3)")
    n_copies = 8  # rotate caches so each timed launch reads from HBM, not L2
    for dtype in (bf16, f32):
        q = randn((B, H, hd), dtype)
        caches = [(randn((B, L, KV, hd), dtype).transpose(1, 2),
                   randn((B, L, KV, hd), dtype).transpose(1, 2))
                  for _ in range(n_copies if dtype == bf16 else 1)]
        k, v = caches[0]
        o = decode_attention_fwd(q, k, v, bias)
        err = _check(f"decode {dtype} B={B} L={L}", o,
                     decode_attention_ref(q, k, v, bias), tol[dtype])
        if dtype == bf16:
            it = iter(range(10**9))
            mask4 = bias[:, None, None, :]

            def kern():
                return decode_attention_fwd(q, *caches[next(it) % n_copies], bias)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q[:, :, None], *caches[next(it) % n_copies], attn_mask=mask4,
                    enable_gqa=True)

            rows["decode_attention"] = dict(
                max_abs_err=err,
                ms=kernel_device_ms(kern, 40, "decode_kernel", "decode_attention", 2),
                plain_ms=time_ms(lambda: decode_attention_ref(
                    q, *caches[next(it) % n_copies], bias), 20),
                library_ms=library_device_ms(sdpa, 40),
                event_ms=time_ms(kern, 40), event_library_ms=time_ms(sdpa, 40),
                **bound(nbytes(q, k, v, bias, o), 4 * B * H * hd * L,
                        "bfloat16"),
                shape=f"B={B} H={H} KV={KV} L={L} hd={hd} bf16, per-slot bias")
            _log_event_row("decode_attention", rows["decode_attention"], "")
        del caches, k, v
    # jamba's attention layers: 4 slots of its serving run's 8192-slot
    # cache, H=64, KV=8 (G=8); two caches of 134 MB, each beyond L2
    JL = 8192
    jlens = torch.tensor([JL, max(PROMPT_LENS) + MAX_NEW, 1013, 41], device=dev)
    jbias = torch.where(torch.arange(JL, device=dev)[None] < jlens[:, None],
                        0.0, NEG_INF).float()
    q = randn((B, JH, hd), bf16)
    caches = [tuple(randn((B, JL, JKV, hd), bf16).transpose(1, 2) for _ in range(2))
              for _ in range(2)]
    k, v = caches[0]
    o = decode_attention_fwd(q, k, v, jbias)
    err = _check(f"decode bf16 jamba B={B} H={JH} KV={JKV} L={JL}", o,
                 decode_attention_ref(q, k, v, jbias), tol[bf16])
    it = iter(range(10**9))

    def kern():
        return decode_attention_fwd(q, *caches[next(it) % 2], jbias)

    def sdpa():
        return F.scaled_dot_product_attention(
            q[:, :, None], *caches[next(it) % 2], attn_mask=jbias[:, None, None, :],
            enable_gqa=True)

    rows["decode_attention"].update(_prefixed("jamba_", dict(
        max_abs_err=err,
        ms=kernel_device_ms(kern, 40, "decode_kernel", "decode_attention", 2),
        plain_ms=time_ms(lambda: decode_attention_ref(
            q, *caches[next(it) % 2], jbias), 20),
        library_ms=library_device_ms(sdpa, 40),
        event_ms=time_ms(kern, 40), event_library_ms=time_ms(sdpa, 40),
        **bound(nbytes(q, k, v, jbias, o), 4 * B * JH * hd * JL, "bfloat16"),
        shape=f"B={B} H={JH} KV={JKV} L={JL} hd={hd} bf16, per-slot bias")))
    _log_shape_row("decode_attention jamba", rows["decode_attention"])
    _log_event_row("decode_attention jamba", rows["decode_attention"])
    rows["decode_attention"]["max_abs_err"] = max(err, rows["decode_attention"]["max_abs_err"])
    del caches, k, v, o
    q = randn((B, H, hd), bf16)
    k, v = (randn((B, L, KV, hd), bf16).transpose(1, 2) for _ in range(2))
    _check("decode bf16 softcap=50", decode_attention_fwd(q, k, v, bias, softcap=50.0),
           decode_attention_ref(q, k, v, bias, softcap=50.0), tol[bf16])
    q = randn((B, 8, 256), bf16)
    k, v = (randn((B, L, 4, 256), bf16).transpose(1, 2) for _ in range(2))
    _check("decode bf16 hd=256 shared bias", decode_attention_fwd(q, k, v, bias[1]),
           decode_attention_ref(q, k, v, bias[1]), tol[bf16])
    del q, k, v

    # ---- B1 paged decode: the batcher's pool (4 slots x 512 pages + 2)
    bs, P, n_phys = 16, L // 16, 2 + 4 * 512
    table = (torch.randperm(4 * 512, generator=gen, device=dev)[:B * P] + 2)
    table = table.reshape(B, P).to(torch.int32)
    log("kernel phase: paged_decode_attention (B1)")

    def pools(dtype, n):
        return [(randn((n_phys, bs, KV, hd), dtype), randn((n_phys, bs, KV, hd), dtype))
                for _ in range(n)]

    for dtype in (bf16, f32):
        q = randn((B, H, hd), dtype)
        pl = pools(dtype, n_copies if dtype == bf16 else 1)
        kp, vp = pl[0]
        o = paged_decode_attention_fwd(q, kp, vp, table, bias)
        err = _check(f"paged {dtype} B={B} P={P} bs={bs}", o,
                     paged_decode_attention_ref(q, kp, vp, table, bias),
                     tol[dtype])
        if dtype == bf16:
            it = iter(range(10**9))
            gathered = B * P * bs * KV * hd * 2 * 2

            def kern():
                return paged_decode_attention_fwd(q, *pl[next(it) % n_copies], table, bias)

            rows["paged_decode_attention"] = dict(
                max_abs_err=err,
                ms=kernel_device_ms(kern, 40, "decode_kernel", "paged_decode_attention", 2),
                event_ms=time_ms(kern, 40),
                plain_ms=time_ms(lambda: paged_decode_attention_ref(
                    q, *pl[next(it) % n_copies], table, bias), 20),
                library_ms=None,  # no single PyTorch call gathers through a page table
                **bound(nbytes(q, table, bias, o) + gathered,
                        4 * B * H * hd * L, "bfloat16"),
                shape=f"B={B} H={H} KV={KV} P={P} bs={bs} hd={hd} bf16 pool")
            log(f"  paged_decode_attention: ms={rows['paged_decode_attention']['ms']:.5f} "
                f"(profiler, both kernels) event_ms="
                f"{rows['paged_decode_attention']['event_ms']:.5f} (back-to-back calls)")
        del pl, kp, vp
    kf, vf = pools(f32, 1)[0]
    qk, ks = quantize_int8(kf)
    qv, vs = quantize_int8(vf)
    del kf, vf
    for dtype in (f32, bf16):
        q = randn((B, H, hd), dtype)
        o = paged_decode_attention_fwd(q, qk, qv, table, bias, k_scale=ks, v_scale=vs)
        _check(f"paged int8 pool, q {dtype}", o,
               paged_decode_attention_ref(q, qk, qv, table, bias, k_scale=ks,
                                          v_scale=vs), tol[dtype])
    ms8 = kernel_device_ms(lambda: paged_decode_attention_fwd(
        q, qk, qv, table, bias, k_scale=ks, v_scale=vs), 40, "decode_kernel",
        "paged_decode_attention", 2)
    b8 = bound(nbytes(q, table, bias, o) + B * P * bs * KV * (hd + 4) * 2,
               4 * B * H * hd * L, "bfloat16")["bound_ms"]
    log(f"  paged int8 pool (bf16 q): ms={ms8:.4f} bound_ms={b8:.4f} "
        f"(L2-warm: one pool)")
    q = randn((B, H, hd), bf16)
    kp, vp = pools(bf16, 1)[0]
    _check("paged bf16 softcap=50", paged_decode_attention_fwd(
        q, kp, vp, table, bias, softcap=50.0), paged_decode_attention_ref(
        q, kp, vp, table, bias, softcap=50.0), tol[bf16])
    q = randn((B, 8, 256), bf16)
    kp, vp = (randn((n_phys, bs, 4, 256), bf16) for _ in range(2))
    _check("paged bf16 hd=256", paged_decode_attention_fwd(q, kp, vp, table, bias),
           paged_decode_attention_ref(q, kp, vp, table, bias), tol[bf16])
    del q, kp, vp, qk, qv
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
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

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

    def flops(B, S):
        # the least the function needs per (b, h, t): r.S is one FMA and
        # w*S + k*v a multiply and an FMA per state element (5 flops); the
        # bonus factors as (r . (u*k)) v, 5 flops per key row
        return B * H * S * (5 * hd * hd + 5 * hd)

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
        **bound(nbytes(*args, y, sT), flops(B, S), "float32"),
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
        decode_bound_ms=bound(nbytes(r, k, v, w, u, s0, y, sT), flops(B, 1),
                              "float32")["bound_ms"])
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
    train_bound = bound(nbytes(*args, y, sT) + ref_chunk_bytes(B, H, S, hd * hd),
                        flops(B, S), "float32")
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
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref

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

    def flops(B, S):
        # per state element and step: replay (mul + FMA), dr, dk, dw, dv (an
        # FMA each), the G update (mul + FMA): 14; per row ~15 for the bonus
        # and du terms
        return B * H * S * (14 * hd * hd + 15 * hd)

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
        **bound(nbytes(r, k, v, w, dy, u, dsT, dr, dk, dv, dw, ds0)
                + ref_chunk_bytes(B, H, S, hd * hd + hd), flops(B, S), "float32"),
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

    def flops(B, S):
        # per (d, n, t): dt*A, exp (counted as one), da*h, dtx*B and their
        # sum, h*C and the running sum; per (d, t): dt*x, D*x and its add
        return B * S * Di * (7 * N + 3)

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
        **bound(nbytes(*args, y, hT), flops(B, S), "float32"),
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
        decode_bound_ms=bound(nbytes(x, dt, A, Bc, Cc, D, h0, y, hT), flops(B, 1),
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
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

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

    def flops(B, S, N):
        # per (d, n, t): the replay's 5 (dt*A, exp, dt x * B and its FMA)
        # and the backward's 20; ~9 per (d, t) (see ssm_scan.cu)
        return B * S * Di * (25 * N + 9)

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
        **bound(nbytes(*args[:7], dhT, *got) + ref_starts, flops(B, S, N), "float32"),
        shape=f"B={B} S={S} Di={Di} N={N}, f32, checkpoints every 8 steps")
    x, h0 = fwd[0], fwd[6]  # y is shaped like x, hT like h0
    train_bound = bound(nbytes(*fwd, x, h0) + ref_starts, B * S * Di * (7 * N + 3),
                        "float32")
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
    del fwd, dy, dhT, args, got, again, starts, x, h0
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


def serving_phase(dev, seed, cfg, layouts):
    """One ContinuousBatcher run per layout of the model ``cfg``, the counts
    zeroed just before and read just after each."""
    import numpy as np
    import torch

    from repro_torch.kernels import KERNEL_NAMES, LAUNCHES, PLAIN_CALLS, reset_counts
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.runtime.batching import ContinuousBatcher, GenRequest

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

    launches = {name: 0 for name in KERNEL_NAMES}
    tokens, summary = {}, {}
    for name, (kw, needed) in layouts.items():
        model = TimedModel(cfg)
        torch.cuda.reset_peak_memory_stats(dev)
        b = ContinuousBatcher(model, params, max_slots=4, max_len=8192,
                              kv_block_size=16, prompt_bucket=16, device=dev, **kw)
        reqs = [GenRequest(i, p, MAX_NEW) for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
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
            decode_steps=len(model.decode_ms),
            kv_cache_bytes=b.kv_cache_bytes(),
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            launches=counts, plain_calls=sum(plain.values()))
        log(f"  {name}: {json.dumps(summary[name])}")
        if name == "dense":  # after the counted run: these launches go uncounted
            pos = torch.as_tensor(b.pos, device=dev)
            with torch.inference_mode():
                prof = decode_profile(lambda: DecoderLM.decode_step(
                    model, params, b.cache_slots, tokens=b.last_tok, pos=pos))
            log(f"  {name} decode step profile (4 slots): "
                f"{json.dumps(prof) if prof else 'not measured (no device time recorded)'}")
        del b, model
        torch.cuda.empty_cache()
    if "paged" in tokens:
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
    remat "full" (the recompute), and its backward once."""
    fwd = 2 if model.cfg.remat == "full" else 1
    mixers = [s.mixer for s in model.layer_specs]
    launches, bwd_calls = {}, {}
    for mixer, name, bwd in (("rwkv", "rwkv6_scan", "rwkv6_scan_bwd"),
                             ("mamba", "ssm_scan", "ssm_scan_bwd"),
                             ("attn", "flash_attention", None)):
        n = n_microbatch_steps * mixers.count(mixer)
        if n:
            launches[name] = fwd * n
            if bwd:
                launches[bwd] = n
            else:
                bwd_calls["flash_attention_bwd"] = n
    return launches, bwd_calls


def train_phase(dev, seed, cfg, batch_rows, seq, preempt_at):
    """``cfg`` at full width in bf16, global batch ``batch_rows`` x ``seq``
    in the config's microbatches, remat as configured, TRAIN_STEPS steps at
    a constant learning rate, the revocations ``preempt_at``; the counts
    zeroed just before the run and read just after. The run writes at most
    one checkpoint, the first revocation's: the trainer's closing
    checkpoint, and any after the first, are logged and not written."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import (BWD_CALLS, KERNEL_NAMES, LAUNCHES, PLAIN_CALLS,
                                     reset_counts)
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule
    from repro_torch.runtime.elastic import ElasticTrainer

    n_writes = min(1, len(preempt_at))

    class FewCheckpointer(Checkpointer):
        """Writes the first ``n_writes`` checkpoints and no later one: a
        full-width state is 31 GB (rwkv6-3b) or 36 GB (one jamba block),
        and a run keeps its disk writes to one state."""

        def save(self, step, state, *, blocking=False):
            if len(self.all_steps()) >= n_writes:
                log(f"  checkpoint at step {step} not written (at most {n_writes} "
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
            inner = self.step_fn

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
        trainer = TimedTrainer(model, opt, data, FewCheckpointer(ckdir, keep=1),
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jamba-grad-study", type=int, nargs="+", metavar="SEED",
                    help="build the kernels, then run only the jamba f32 gradient phase "
                         "once per SEED, with each mixer leaf's distance from an f64 path "
                         "under five mixes of kernels and plain versions; no smoke result")
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

    rows = kernel_phase(dev)
    rows.update(rwkv_kernel_phase(dev))
    rows.update(rwkv_bwd_kernel_phase(dev))
    rows.update(ssm_kernel_phase(dev))
    rows["ssm_scan_bwd"], b4_train = ssm_bwd_kernel_phase(dev)
    rows["ssm_scan"].update(b4_train)

    from repro_torch.configs import get_config

    jamba = get_config(JAMBA_ARCH)
    launches, _ = serving_phase(dev, args.seed, get_config(ARCH), STARCODER_LAYOUTS)
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
    for cfg, rows_seq, preempt in (
            (get_config(RWKV_ARCH), (TRAIN_BATCH, TRAIN_SEQ), {1: 1}),
            (jamba.replace(**JAMBA_BLOCK), (TRAIN_BATCH_JAMBA, TRAIN_SEQ_JAMBA), {})):
        more, _ = train_phase(dev, args.seed, cfg, *rows_seq, preempt)
        for name, n in more.items():
            launches[name] += n
            by_path["training"][name] += n
    worst_grad, depth_ratio = grad_phase(dev, args.seed)
    jamba_in_place, jamba_leaves = jamba_grad_phase(dev, args.seed)
    fleet = fleet_phase(dev)

    meta = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:97"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:91"),
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
            "launches_by_path": {path: n[name] for path, n in by_path.items()},
            **{k: v for k, v in r.items()
               if k.startswith(("decode_", "train_", "jamba_", "event_", "device_"))}})
    log(f"f32 logits check passed: worst {worst:.3e} <= {LOGIT_RTOL}; f32 gradient "
        f"check passed: rwkv6-3b worst {worst_grad:.3e} <= {LOGIT_RTOL}, full depth "
        f"{depth_ratio:.3f} <= 1 of its limit; jamba block in place "
        f"{jamba_in_place:.3e} <= {LOGIT_RTOL}, every mixer leaf {jamba_leaves:.3e} <= "
        f"{LOGIT_RTOL}; fleet card vs CPU within {FLEET_RTOL} in "
        f"{fleet['phase_s']:.1f} s; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"fleet": {**fleet, "card": smi}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
