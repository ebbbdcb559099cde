"""End-to-end elastic training driver (the port's twin of the JAX package's
``examples/train_elastic.py``, with the same presets).

Trains a llama-style decoder with the full production stack — a (data,
model) DeviceMesh of 8 ranks, grad-accum AdamW, async checkpointing — and
exercises the CloudCoaster fault-tolerance path: a simulated transient-pod
revocation mid-run triggers drain -> checkpoint -> mesh rebuild on the
survivors (8 -> 4 ranks) -> resharded resume.

The ranks are NCCL ranks on 8 cards, one each (the default, ``--device
cuda``; it raises without them), or with ``--device cpu`` 8 gloo ranks on
the host's CPU.

Presets:
  tiny  (default) — ~3M params, 120 steps.
  100m            — ~100M-param model, 300 steps.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_elastic --device cpu [--preset 100m]
"""

from __future__ import annotations

import argparse
import tempfile

PRESETS = {
    "tiny": dict(num_layers=4, d_model=192, num_heads=4, num_kv_heads=2,
                 head_dim=48, d_ff=512, vocab_size=2048, steps=120,
                 batch=8, seq=128, preempt_step=50),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab_size=32768, steps=300,
                 batch=16, seq=512, preempt_step=120),
}
RANKS = 8


def train(rank: int, preset: str, p: dict, ckpt_dir: str, log=None):
    """One rank's run; every rank of the default group calls it. Returns
    (history, rescales, params) on rank 0, None elsewhere."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticBatches
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.runtime.elastic import ElasticTrainer

    say = (log or print) if rank == 0 else (lambda s: None)
    cfg = ModelConfig(
        name=f"llama-{preset}", family="dense",
        num_layers=p["num_layers"], d_model=p["d_model"],
        num_heads=p["num_heads"], num_kv_heads=p["num_kv_heads"],
        head_dim=p["head_dim"], d_ff=p["d_ff"], vocab_size=p["vocab_size"],
        dtype="float32", param_dtype="float32", remat="none",
        num_microbatches=2, attn_chunk_q=128, attn_chunk_k=128)
    model = build_model(cfg)
    say(f"model: {model.param_count()/1e6:.1f}M params; devices: {RANKS}")
    opt = AdamW(lr=cosine_schedule(3e-3, 20, p["steps"]))
    data = SyntheticBatches(cfg, global_batch=p["batch"], seq_len=p["seq"])
    trainer = ElasticTrainer(model, opt, data, Checkpointer(ckpt_dir, keep=3),
                             model_par=2, devices=list(range(RANKS)), log=say)
    say(f"training {p['steps']} steps; simulated revocation of one pod "
        f"(8 -> 4 devices) at step {p['preempt_step']}")
    trainer.run(p["steps"], preempt_at={p["preempt_step"]: 4}, checkpoint_every=40)
    if rank != 0:
        return None
    return trainer.history, trainer.rescales, model.param_count()


def main(argv=None):
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.parallel.spawn import run_ranks

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help=f"cuda (default: {RANKS} NCCL ranks, one a card) or cpu "
                         f"({RANKS} gloo ranks)")
    args = ap.parse_args(argv)
    backend = "nccl" if resolve_device(args.device).type == "cuda" else "gloo"
    if backend == "nccl" and torch.cuda.device_count() < RANKS:
        raise RuntimeError(f"the {RANKS} -> {RANKS // 2} scenario runs {RANKS} NCCL ranks, "
                           f"one a card, and {torch.cuda.device_count()} cards are "
                           f"visible; pass --device cpu for {RANKS} gloo ranks on the CPU")
    p = PRESETS[args.preset]
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="coaster_ckpt_")
    hist, rescales, _ = run_ranks(train, RANKS, (args.preset, p, ckpt_dir),
                                  backend=backend)[0]
    print("\nstep  loss    devices")
    for s, loss, d in hist[:: max(1, len(hist) // 12)]:
        print(f"{s:5d}  {loss:.4f}  {d}")
    first, last = hist[0][1], hist[-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} across {rescales} "
          f"rescale(s); checkpoints in {ckpt_dir}")
    assert last < first
    return hist


if __name__ == "__main__":
    main()
