"""Serving launcher of the port: batched prefill + dense decode for one
``--arch`` (twin of the ``--arch`` mode of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --batch 4 --prompt 32 --gen 32              # on the card (default)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --smoke --device cpu                         # plain PyTorch path
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b  # RWKV-6

``--arch`` takes every id of ``repro_torch.configs.ARCH_IDS`` (starcoder2-3b,
gemma2-2b, rwkv6-3b; jamba-1.5-large-398b raises: its MoE layers are not
ported, see ``repro_torch.models.decoder``). Weights are the port's own
seeded init (``--seed``).
The reference's ``--scenario`` fleet mode is not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="model config id")
    ap.add_argument("--smoke", action="store_true", help="reduced widths")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

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
    max_len = P + G
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                             device=device)
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens=prompt, max_len=max_len)
        tok = torch.argmax(logits, -1)[:, None]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        outs = []
        for i in range(G):
            logits, cache = model.decode_step(params, cache, tokens=tok, pos=P + i)
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
