"""Hand-written CUDA kernels for Hopper, one per Pallas kernel of the
reference on the ported path, and one for the serving fleet's simulator
(``serving_fleet``: the reference runs it as an XLA program, with no
Pallas kernel).

Each kernel ships three files, as in ``repro.kernels``:
  kernel.py — the launch wrapper around the CUDA C++ source in ``csrc/``
              (checks device, dtype, shape and strides; raises on what the
              kernel does not take; counts its launches);
  ref.py    — the plain PyTorch version, computing what the reference's
              ``ref.py`` computes (counts its calls);
  ops.py    — the public op: a CPU tensor goes to the plain version, a CUDA
              tensor to the kernel. There is no fallback from one to the other.

A kernel reads its tensors' ``data_ptr()``; a DTensor has no storage of
its own, so every op and kernel wrapper refuses one (``refuse_dtensor``).
On a mesh the models call the ops on local shards
(``repro_torch.parallel.local``).

``LAUNCHES`` and ``PLAIN_CALLS`` are plain integer counters keyed by op
name, so a run can show which path it went through: each kernel wrapper
adds one where it launches its kernel, each plain version where it runs.
``BWD_CALLS`` counts the backward passes that are plain PyTorch math by
design, since the reference has no kernel for them either: attention's
backward recomputes through its oracle (``flash_attention_bwd``), or, under
``cfg.flash_vjp``, chunk by chunk from the forward's softmax statistics
(``flash_attention_bwd_chunked``). ``flash_attention_stats`` is B2 launched
with those statistics as extra outputs (its plain version the chunked
online softmax), ``decode_attention_stats`` B3 launched with its rows'
(m, l) beside an f32 output, which a decode over a sharded cache merges
across ranks.
"""

from __future__ import annotations

from typing import Dict

KERNEL_NAMES = ("flash_attention", "flash_attention_stats", "decode_attention",
                "decode_attention_stats", "paged_decode_attention",
                "rwkv6_scan", "rwkv6_scan_bwd", "ssm_scan", "ssm_scan_bwd",
                "serving_fleet")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}
# plus the model-level plain attention (``models.attention.plain=True``)
PLAIN_CALLS: Dict[str, int] = {name: 0 for name in KERNEL_NAMES + ("model_attention",)}
BWD_CALLS: Dict[str, int] = {"flash_attention_bwd": 0, "flash_attention_bwd_chunked": 0}


def refuse_dtensor(name: str, *tensors) -> None:
    from repro_torch.parallel.sharding import is_dtensor

    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{name}: got a DTensor; a kernel takes local tensors "
                        f"(call it on to_local() shards, repro_torch.parallel.local)")


def reset_counts() -> None:
    for table in (LAUNCHES, PLAIN_CALLS, BWD_CALLS):
        for name in table:
            table[name] = 0
