"""Multi-pod dry-run (twin of ``repro.launch.dryrun``): build every
(arch x shape x mesh) cell on the production meshes and write its static
accounting to ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>[__tag].json``.

Each mesh is built under the ``"fake"`` process group of
``torch.testing._internal.distributed.fake_pg`` at 256 (single pod) or 512
(multi-pod) ranks, in the dry-run's own process, as the reference forces
its host device count in its own process; every tensor is on the ``meta``
device, so no cell allocates its state. A cell writes ``params``,
``active_params``, ``state_bytes_per_device`` (the bytes of the train state,
or of the params, plus the decode cache, that one rank holds under the
cell's partition specs: ``_bytes_per_device``), ``tokens_per_step``,
``n_devices``, ``kind``, ``layout``, ``seq_len`` and ``global_batch``; they
equal the reference's artifacts (``artifacts/dryrun/``). The port's live
trees hold a little more than the reference's accounting, and
``state_bytes_per_device_live`` counts it: the f32 accumulation buffers a
train step allocates when it has more than one microbatch, and a row of
cache positions per sequence where the reference keeps one row.

A decode cell also writes ``decode_kv_bytes_per_device``, the attention
layers' K and V bytes one rank holds under the cache specs, and
``decode_kv_bytes_per_device_gathered``, the K and V bytes a rank holds
while a decode step attends. The two are equal: the step attends each
rank's own slots and merges the ranks' softmax statistics with
all-reduces of (batch, heads) and (batch, heads, head_dim + 1) f32 values
a layer (``models.attention._mesh_attention``), so no layer's cache is
gathered.

``--trace`` also runs the cell's step on meta DTensors laid out by the
cell's rules (once uncounted, see ``trace_cell``, then once under
``parallel.cost.CostMode``) and records what one rank's
local shards cost in that step, under the reference's names:
``flops_per_device``, ``bytes_per_device``, ``bytes_min_per_device``,
``collectives`` (wire bytes by kind, ``total``, ``total_native`` and
``top_ops``), ``collective_counts`` (the count of each collective op) and
``top_dots``. The model is the one a user runs (``build_model(cfg)``): on
meta tensors each kernel op takes its plain version and counts by its own
formula, as on the card. A production cell's trace runs the full-size step
op by op on meta tensors; ``--smoke`` traces the arch's smoke config
instead, and ``--mesh-shape 2,4`` a small mesh.

The reference's fields that only XLA has get no twin: ``t_lower_s``,
``t_compile_s``, the ``xla_*`` cost analysis, the memory analysis
(``argument/output/temp/generated_code_size_in_bytes``) and ``hlo_bytes``.
The traced counts follow ``repro.parallel.hlo``'s rules, but XLA's
rematerialisation and dot rewrites are its compiler's choices, so the
ratio of a cell's count to the reference's is recorded, not held to 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x22b \\
      --shape train_4k --mesh single --tag tp_variant --layout tp
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x22b \\
      --shape train_4k --smoke --mesh-shape 2,4 --trace --out-dir /tmp/dr
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import traceback
import warnings

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def _bytes_per_device(struct_tree, spec_tree, mesh) -> float:
    from repro_torch.parallel.layouts import axis_size
    from repro_torch.parallel.sharding import P

    structs, specs = [], []

    def walk(s, p):
        if isinstance(p, P):
            structs.append(s)
            specs.append(p)
        elif isinstance(p, dict):
            for k in p:
                walk(s[k], p[k])
        else:
            for a, b in zip(s, p):
                walk(a, b)

    walk(struct_tree, spec_tree)
    total = 0.0
    for t, spec in zip(structs, specs):
        n = math.prod(t.shape) * t.element_size()
        shards = 1
        for ax in spec:
            shards *= axis_size(mesh, ax)
        total += n / shards
    return total


def _kv_bytes_per_device(cstruct, cspec, mesh) -> float:
    """K and V bytes of the attention layers' caches on one rank."""
    total = 0.0
    for struct, spec in zip(cstruct, cspec):
        if "k" not in spec:  # RWKV and Mamba state
            continue
        for name in ("k", "v"):
            total += _bytes_per_device(struct[name], spec[name], mesh)
    return total


def _model_and_rules(arch, shape_name, mesh, layout, overrides, smoke, global_batch):
    """(cfg, shape, global batch, model, rules) of a cell."""
    from repro_torch.configs import SHAPES, get_config, smoke_config
    from repro_torch.models import build_model
    from repro_torch.parallel.layouts import layout_rules

    cfg = smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    B = global_batch or shape.global_batch
    rules = layout_rules(mesh, cfg, shape.kind, global_batch=B, layout=layout)
    return cfg, shape, B, build_model(cfg), rules


def _opt(cfg):
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import cosine_schedule

    return AdamW(lr=cosine_schedule(3e-4, 100, 10000),
                 moments_dtype=cfg.opt_moments_dtype)


def build_cell(arch: str, shape_name: str, mesh, *, layout=None, overrides=None,
               smoke: bool = False, seq_len=None, global_batch=None) -> dict:
    """The cell's static accounting on ``mesh`` (a ``DeviceMesh`` or a
    ``MeshShape``)."""
    from repro_torch.launch.specs import batch_partition, batch_struct, fix_divisibility
    from repro_torch.launch.steps import (grad_acc_struct, train_state_specs,
                                          train_state_struct)
    from repro_torch.parallel.layouts import cache_specs, param_specs

    cfg, shape, B, model, rules = _model_and_rules(arch, shape_name, mesh, layout,
                                                   overrides, smoke, global_batch)
    S = seq_len or shape.seq_len
    pshape = model.init_shape()
    pspec = param_specs(pshape, mesh, rules)
    meta = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "layout": layout or cfg.layout, "seq_len": S, "global_batch": B,
        "params": model.param_count(), "active_params": model.active_param_count(),
    }
    if shape.kind == "train":
        opt = _opt(cfg)
        sstruct = train_state_struct(model, opt)
        sspec = train_state_specs(pspec, opt)
        meta["state_bytes_per_device"] = _bytes_per_device(sstruct, sspec, mesh)
        acc = grad_acc_struct(model)
        meta["state_bytes_per_device_live"] = meta["state_bytes_per_device"] + (
            _bytes_per_device(acc, pspec, mesh) if acc else 0.0)
        meta["tokens_per_step"] = B * S
    elif shape.kind == "prefill":
        meta["state_bytes_per_device"] = _bytes_per_device(pshape, pspec, mesh)
        meta["state_bytes_per_device_live"] = meta["state_bytes_per_device"]
        meta["tokens_per_step"] = B * S
    else:  # decode
        cstruct = model.cache_shape(B, S)
        cspec = cache_specs(model, mesh, rules, B, S)
        pbytes = _bytes_per_device(pshape, pspec, mesh)
        meta["state_bytes_per_device"] = pbytes + _bytes_per_device(cstruct, cspec, mesh)
        live = model.init_cache(B, S, device="meta")
        lspec = cache_specs(model, mesh, rules, B, S, shapes=live)
        meta["state_bytes_per_device_live"] = pbytes + _bytes_per_device(live, lspec, mesh)
        meta["tokens_per_step"] = B
        meta["decode_kv_bytes_per_device"] = _kv_bytes_per_device(cstruct, cspec, mesh)
        meta["decode_kv_bytes_per_device_gathered"] = meta["decode_kv_bytes_per_device"]
    # the batch's specs are checked to lay out on the mesh
    bstruct = batch_struct(cfg, shape.kind, B, S)
    fix_divisibility(batch_partition(cfg, shape.kind, rules), bstruct, mesh)
    return meta


# ---------------------------------------------------------------------------
# traced step on meta DTensors


def _materialize(tree, device, seed: int, vocab: int):
    """``tree``'s meta leaves as tensors on ``device``, seeded: integer
    leaves uniform in [1, vocab), float leaves standard normal (the same on
    every rank)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen, device=device).to(t.dtype)
        return torch.randint(1, vocab, t.shape, generator=gen, device=device).to(t.dtype)

    return {k: leaf(t) for k, t in tree.items()}


def cell_step(arch: str, shape_name: str, mesh, *, layout=None, overrides=None,
              smoke: bool = False, seq_len=None, global_batch=None, device="meta",
              seed: int = 0):
    """The cell's step laid out on ``mesh`` (a ``DeviceMesh`` of the current
    process group), ready to run: returns ``run``, which takes one step
    (a train step, a prefill or a decode step) on DTensors on ``device``.
    On ``meta`` nothing is allocated; on a real device the params are the
    port's seeded init and the batch seeded, the same on every rank."""
    import torch

    from repro_torch.launch.specs import batch_partition, batch_struct, fix_divisibility
    from repro_torch.launch.steps import make_train_step
    from repro_torch.parallel import use_sharding_ctx
    from repro_torch.parallel.distribute import distribute_tree
    from repro_torch.parallel.layouts import cache_specs, param_specs, to_shardings

    cfg, shape, B, model, rules = _model_and_rules(arch, shape_name, mesh, layout,
                                                   overrides, smoke, global_batch)
    S = seq_len or shape.seq_len
    meta = str(device) == "meta"
    params = model.init_shape()
    psh = to_shardings(param_specs(params, mesh, rules), mesh)
    if not meta:
        params = model.init(torch.Generator(device=device).manual_seed(seed), device=device)
    bstruct = batch_struct(cfg, shape.kind, B, S)
    bsh = to_shardings(fix_divisibility(batch_partition(cfg, shape.kind, rules),
                                        bstruct, mesh), mesh)
    if not meta:
        bstruct = _materialize(bstruct, device, seed + 1, cfg.vocab_size)
    with use_sharding_ctx(mesh, rules):
        params = distribute_tree(params, psh)
        batch = distribute_tree(bstruct, bsh)
        if shape.kind == "train":
            opt = _opt(cfg)
            state = opt.init_state(params)
            step = make_train_step(model, opt)
        elif shape.kind == "decode":
            cache = model.init_cache(B, S, device=device)
            cache = distribute_tree(cache, to_shardings(
                cache_specs(model, mesh, rules, B, S, shapes=cache), mesh))

    def run():
        with use_sharding_ctx(mesh, rules):
            if shape.kind == "train":
                return step(state, batch)
            with torch.no_grad():
                if shape.kind == "prefill":
                    return model.prefill(params, max_len=S, **batch)
                return model.decode_step(params, cache, pos=S - 1, **batch)

    return run


def trace_cell(arch: str, shape_name: str, mesh, **kw) -> dict:
    """Run the cell's step (``cell_step``; meta DTensors by default) under
    ``parallel.cost.CostMode``. Returns what one rank's local shards cost
    in it, under the reference dry-run's names.

    The step runs once uncounted first: DTensor propagates an op's
    sharding by running it on fake tensors the first time it meets the op's
    signature, and caches the result; the warm run fills that cache, so the
    counted run holds the rank's own ops alone, as a step in a running
    program does."""
    from repro_torch.parallel.cost import CostMode

    run = cell_step(arch, shape_name, mesh, **kw)
    run()
    with CostMode() as cost:
        run()
    a = cost.summary()
    return {"flops_per_device": a["flops"], "bytes_per_device": a["bytes"],
            "bytes_min_per_device": a["bytes_min"], "collectives": a["collectives"],
            "collective_counts": a["collective_counts"], "top_dots": a["top_dots"]}


# ---------------------------------------------------------------------------
# driver


def cell_path(arch, shape_name, multi_pod, tag="", out_dir=None) -> pathlib.Path:
    sub = "multi" if multi_pod else "single"
    name = f"{arch}__{shape_name}" + (f"__{tag}" if tag else "") + ".json"
    return pathlib.Path(out_dir or ART) / sub / name


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out or None


def _fake_group(n: int, rank: int = 0):
    """The ``"fake"`` process group of ``n`` ranks, seen from ``rank``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable
    from repro_torch.launch.mesh import (make_production_mesh, make_smoke_mesh,
                                         production_shape)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--mesh-shape", default="",
                    help="a small (data,model) mesh, e.g. 2,4, in place of the "
                         "production meshes")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--layout", default=None)
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--seq", type=int, default=0, help="override the shape's seq_len")
    ap.add_argument("--batch", type=int, default=0,
                    help="override the shape's global batch")
    ap.add_argument("--trace", action="store_true",
                    help="also run the step on meta DTensors: FLOPs, bytes, "
                         "collective bytes")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    args = ap.parse_args(argv)
    warnings.filterwarnings("ignore", message=".*sequential all_gather.*")

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    small = tuple(int(n) for n in args.mesh_shape.split(",")) if args.mesh_shape else None
    overrides = _parse_overrides(args.overrides)
    kw = dict(layout=args.layout, overrides=overrides, smoke=args.smoke,
              seq_len=args.seq or None, global_batch=args.batch or None)

    n_ok = n_skip = n_fail = 0
    for multi in meshes:
        n = math.prod(small) if small else production_shape(multi_pod=multi).size
        _fake_group(n)
        mesh = (make_smoke_mesh(small) if small
                else make_production_mesh(multi_pod=multi))
        for arch in archs:
            for shape_name in shapes:
                path = cell_path(arch, shape_name, multi, args.tag, args.out_dir)
                if not cell_applicable(arch, shape_name):
                    print(f"SKIP (inapplicable) {arch} {shape_name}")
                    n_skip += 1
                    continue
                if path.exists() and not args.force:
                    print(f"CACHED {path.name} ({'multi' if multi else 'single'})")
                    n_ok += 1
                    continue
                label = f"{arch} x {shape_name} [{'multi' if multi else 'single'}]"
                print(f"RUN  {label} ...", flush=True)
                try:
                    meta = build_cell(arch, shape_name, mesh, **kw)
                    meta["mesh"] = "multi" if multi else "single"
                    meta["n_devices"] = mesh.size()
                    if args.trace:
                        meta.update(trace_cell(arch, shape_name, mesh, **kw))
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_text(json.dumps(meta, indent=1))
                    print(f"  OK state/dev={meta['state_bytes_per_device']:.6e} B"
                          + (f" flops/dev={meta['flops_per_device']:.4e} bytes/dev="
                             f"{meta['bytes_per_device']:.4e} collective bytes/dev="
                             f"{meta['collectives']['total']:.4e} "
                             f"counts={meta['collective_counts']}" if args.trace else ""),
                          flush=True)
                    n_ok += 1
                except Exception:
                    n_fail += 1
                    print(f"  FAIL {label}\n{traceback.format_exc()}", flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"dryrun done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
