"""Training launcher of the port (twin of ``repro.launch.train``):
``--arch`` selects a config, ``ElasticTrainer`` runs the steps, takes the
checkpoints and handles simulated revocations.

  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
      --steps 3 --batch 4 --seq 2048                 # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b --smoke \
      --steps 3 --device cpu                          # plain PyTorch path

Every registry id trains: attention, RWKV-6 and Mamba/attention stacks,
MoE layers (mixtral-8x22b, llama4-scout-17b-a16e, jamba-1.5-large-398b
with its experts), the audio family over frame embeddings
(musicgen-medium) and the vlm family with its image prefix
(paligemma-3b); e.g. ``--arch mixtral-8x22b --smoke --device cpu``.
Weights are the port's own seeded init (``--seed``). ``--preempt 8:1``
revokes the card at step 8 and resumes on a replacement (one device only:
meshes are ROADMAP Queue A item 11).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced widths")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--preempt", default="",
                    help="step:n_devices[,step:n] simulated revocations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticBatches
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.runtime.elastic import ElasticTrainer

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    opt = AdamW(lr=cosine_schedule(args.lr, 20, args.steps),
                moments_dtype=cfg.opt_moments_dtype)
    data = SyntheticBatches(cfg, args.batch, args.seq, seed=args.seed)
    preempt = {}
    for part in filter(None, args.preempt.split(",")):
        s, n = part.split(":")
        preempt[int(s)] = int(n)
    trainer = ElasticTrainer(model, opt, data, Checkpointer(args.ckpt_dir),
                             devices=[device], log=print)
    print(f"arch={args.arch} smoke={args.smoke} device={device} "
          f"batch={args.batch} seq={args.seq} microbatches={cfg.num_microbatches} "
          f"remat={cfg.remat}")
    t0 = time.perf_counter()
    trainer.run(args.steps, seed=args.seed, preempt_at=preempt,
                checkpoint_every=args.ckpt_every)
    wall = time.perf_counter() - t0
    for s, loss, d in trainer.history[:: max(1, len(trainer.history) // 10)]:
        print(f"step {s:5d} loss {loss:.4f} devices {d}")
    n = len(trainer.history)
    print(f"{n} steps in {wall:.2f} s (checkpoints included): "
          f"{n * args.batch * args.seq / wall:.1f} tokens/s")


if __name__ == "__main__":
    main()
