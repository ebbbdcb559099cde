"""Serving launcher of the port (twin of ``repro.launch.serve``): batched
prefill + dense decode for one ``--arch``, or a scenario-driven elastic
serving fleet through the experiment API.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --batch 4 --prompt 32 --gen 32              # on the card (default)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --smoke --device cpu                         # plain PyTorch path
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b  # RWKV-6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --smoke --device cpu                         # MoE
  PYTHONPATH=src python -m repro_torch.launch.serve --scenario serve_yahoo \
      --quick --out artifacts/serve_yahoo.runresult.npz

``--arch`` takes every id of ``repro_torch.configs.ARCH_IDS``. Weights are
the port's own seeded init (``--seed``). As in the reference's launcher, an
audio config (musicgen-medium) prefills random frame embeddings and takes a
fresh random embedding each decode step, and a vlm config (paligemma-3b)
prefills ``prefix_len`` random image embeddings before the prompt and
decodes from position ``prompt + prefix_len``; the random inputs come from
``numpy.random.default_rng(--seed)``.

``--scenario`` runs ``repro_torch.exp.run(scenario, engine="serving")`` on
the host (no card needed): the scenario's trace becomes the request stream
+ pinning signal and the fleet metrics print like ``repro_torch.launch.sim``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _run_fleet(args) -> None:
    from repro_torch.exp import run as exp_run

    res = exp_run(args.scenario, engine="serving", quick=args.quick,
                  seed=args.seed, sim_seed=args.seed)
    print(f"scenario: {args.scenario} | engine: serving | "
          f"workload: {res.meta['workload']}")
    print(json.dumps(res.metrics, indent=1, default=float))
    if args.out:
        path = res.save(args.out)
        print(f"RunResult saved to {path}", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="raw decode benchmark for one model config")
    ap.add_argument("--scenario", default=None,
                    help="serving-fleet scenario (repro_torch.sched registry) "
                         "run through repro_torch.exp with engine='serving'")
    ap.add_argument("--smoke", action="store_true", help="reduced widths")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized scenario scale (with --scenario)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="persist the RunResult (with --scenario)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (with --arch)")
    args = ap.parse_args(argv)

    if args.scenario:
        _run_fleet(args)
        return
    if not args.arch:
        ap.error("one of --arch or --scenario is required")

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device=device)
    rng = np.random.default_rng(args.seed)
    B, P, G = args.batch, args.prompt, args.gen
    max_len = P + G + (cfg.prefix_len or 0)

    def embeds(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=device)

    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = embeds(B, cfg.prefix_len, cfg.d_model)
    if cfg.family == "audio":
        kw["embeds"] = embeds(B, P, cfg.d_model)
    else:
        kw["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                                       device=device)
    pos0 = P + (cfg.prefix_len if cfg.family == "vlm" else 0)
    with torch.inference_mode():
        logits, cache = model.prefill(params, max_len=max_len, **kw)
        tok = torch.argmax(logits, -1)[:, None]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        outs = []
        for i in range(G):
            if cfg.family == "audio":
                step = dict(embeds=embeds(B, 1, cfg.d_model))
            else:
                step = dict(tokens=tok)
            logits, cache = model.decode_step(params, cache, pos=pos0 + i, **step)
            tok = torch.argmax(logits, -1)[:, None]
            outs.append(tok[:, 0])
        outs = torch.stack(outs).cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
    print(f"arch={args.arch} smoke={args.smoke} device={device} batch={B} "
          f"prompt={P} gen={G}")
    print(f"decode throughput: {B * G / dt:.1f} tok/s ({dt / G * 1e3:.2f} ms/step)")
    print("sample continuation (seq 0):", [int(o) for o in outs[:16, 0]])


if __name__ == "__main__":
    main()
