"""Sharding layouts: logical-axis rule tables per (layout, step kind), and
partition-spec trees for params and caches (twin of
``repro.parallel.layouts``; the rule tables are the reference's, name for
name).

Layouts (selected per arch in its config):

  cp_fsdp — context parallelism + FSDP. Activations are sequence-sharded over
            "model" (works for any head count, incl. 56H/8KV archs that don't
            divide a 16-wide axis); weights are stored d_model-sharded over
            the DP axes and vocab/ff/head-sharded over "model" (FSDP storage).
  tp      — Megatron-style tensor parallelism: heads/ff/inner sharded over
            "model", sequence unsharded (required by SSM/RWKV recurrences and
            by head-TP attention); FSDP storage over DP axes.
  tp_ffn  — TP only for the FFN/channel-mix (RWKV: 40 heads don't divide 16,
            time-mix compute is replicated, weights FSDP-stored).
  fsdp    — pure FSDP: the batch over every mesh axis where it divides,
            attention and MLP local.

Step kinds: "train"/"prefill" use the layout's compute rules; "decode" shards
the KV-cache length over "model", falling back to all-axes cache sharding
when the batch can't cover the DP axes (long_500k's batch=1); ``decode_ws``
keeps weights in their compute sharding (weight-stationary decode).

The layout code needs only axis names and sizes: every function takes a
``MeshShape`` or a ``torch.distributed.device_mesh.DeviceMesh`` (through
``mesh_shape``), so the specs of the production meshes are computed without
256 ranks. The reference stacks each block position's weights under a
leading ``n_blocks`` axis; the port keeps one leaf per layer, and a leaf's
spec is the reference's without that leading ``None``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import P, ShardingRules
from repro_torch.tree import map_tree


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Mapping[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_shape(mesh) -> MeshShape:
    if isinstance(mesh, MeshShape):
        return mesh
    names = mesh.mesh_dim_names  # a DeviceMesh
    if names is None:
        raise ValueError("the mesh needs named dimensions")
    return MeshShape(tuple(names), tuple(mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_shape(mesh).axis_names if a in ("pod", "data"))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh).shape
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _weight_rules(mesh, cfg: ModelConfig) -> Dict[str, Any]:
    """Storage sharding for weights — common to all layouts."""
    dp = dp_axes(mesh)
    tp_size = mesh_shape(mesh).shape["model"]
    ep_ok = cfg.num_experts > 0 and cfg.num_experts % tp_size == 0
    return {
        "w_dmodel": dp,
        "w_vocab": "model",
        "w_heads": "model",
        "w_kv": "model",
        "w_ff": None if ep_ok else "model",  # EP: full expert per device
        "w_expert": "model" if ep_ok else None,
        "w_inner": "model",
        "w_inner2": "model",
    }


def layout_rules(mesh, cfg: ModelConfig, step_kind: str,
                 global_batch: Optional[int] = None,
                 layout: Optional[str] = None) -> ShardingRules:
    layout = layout or cfg.layout
    dp = dp_axes(mesh)
    axis_names = mesh_shape(mesh).axis_names
    rules: Dict[str, Any] = dict(_weight_rules(mesh, cfg))
    rules["moe_tp"] = "model"

    if step_kind == "decode":
        batch_ok = global_batch is not None and global_batch % axis_size(mesh, dp) == 0
        batch = dp if batch_ok else None
        cache = "model" if batch_ok else tuple(axis_names)
        rules.update(
            batch=batch,
            act_seq=None,
            act_kv_seq=None,
            act_seq_mlp=None,
            heads=None,
            kv_heads=None,
            act_ff="model",
            vocab=None,
            cache_len=cache,
            ssm_inner="model",
            ssm_inner2="model",
        )
        if layout == "decode_ws":
            # Weight-stationary decode: weights live permanently in their
            # compute sharding — no per-token FSDP gathers. Dense/attention
            # weights shard output dims over "model"; MoE experts go
            # expert-TP over the FULL device grid (ff over data x model,
            # tokens broadcast inside the MoE block).
            rules.update(
                w_dmodel=None,
                w_heads="model",
                w_kv="model",
                w_ff=("data", "model") if cfg.num_experts else "model",
                w_expert=None,
                w_inner="model",
                w_inner2="model",
                w_vocab="model",
                vocab="model",
                moe_tp=("data", "model"),
            )
        return ShardingRules(rules)

    if layout == "fsdp":
        # pure FSDP: batch over every mesh axis when divisible (falls back to
        # DP axes); attention/MLP fully local — no CP/TP collectives, only
        # per-block weight gathers + gradient reduction.
        all_axes = tuple(axis_names)
        batch_all = (global_batch is not None
                     and global_batch % axis_size(mesh, all_axes) == 0)
        rules.update(
            batch=all_axes if batch_all else dp,
            act_seq=None,
            act_kv_seq=None,
            act_seq_mlp=None,
            heads=None,
            kv_heads=None,
            act_ff=None,
            vocab=None,
            cache_len=None,
            ssm_inner=None,
            ssm_inner2=None,
        )
        return ShardingRules(rules)

    if layout == "cp_fsdp":
        rules.update(
            batch=dp,
            act_seq="model",
            act_kv_seq=None,
            act_seq_mlp="model",
            heads=None,
            kv_heads=None,
            act_ff=None,
            vocab=None,
            cache_len="model",
            ssm_inner=None,
            ssm_inner2=None,
        )
    elif layout == "tp":
        rules.update(
            batch=dp,
            act_seq=None,
            act_kv_seq=None,
            act_seq_mlp=None,
            heads="model",
            kv_heads=None,
            act_ff="model",
            vocab="model",
            cache_len="model",
            ssm_inner="model",
            ssm_inner2="model",
        )
    elif layout == "tp_ffn":
        rules.update(
            batch=dp,
            act_seq=None,
            act_kv_seq=None,
            act_seq_mlp=None,
            heads=None,
            kv_heads=None,
            act_ff="model",
            vocab="model",
            cache_len="model",
            ssm_inner=None,
            ssm_inner2=None,
        )
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return ShardingRules(rules)


# ---------------------------------------------------------------------------
# params / cache partition-spec trees

# (parent, leaf) -> logical axes; parent "" matches any. The reference
# prepends the leading n_blocks dim for leaves under "blocks"; the port's
# per-layer leaves have none.
_LEAF_AXES = {
    ("", "embed"): ("w_vocab", "w_dmodel"),
    ("", "lm_head"): ("w_dmodel", "w_vocab"),
    ("attn", "wq"): ("w_dmodel", "w_heads"),
    ("attn", "wk"): ("w_dmodel", "w_kv"),
    ("attn", "wv"): ("w_dmodel", "w_kv"),
    ("attn", "wo"): ("w_heads", "w_dmodel"),
    ("attn", "bq"): ("w_heads",),
    ("attn", "bk"): ("w_kv",),
    ("attn", "bv"): ("w_kv",),
    ("attn", "bo"): (None,),
    ("mlp", "w_gate"): ("w_dmodel", "w_ff_dense"),
    ("mlp", "w_up"): ("w_dmodel", "w_ff_dense"),
    ("mlp", "w_in"): ("w_dmodel", "w_ff_dense"),
    ("mlp", "w_out"): ("w_ff_dense", "w_dmodel"),
    ("mlp", "b_in"): ("w_ff_dense",),
    ("mlp", "b_out"): (None,),
    ("shared", "w_gate"): ("w_dmodel", "w_ff_dense"),
    ("shared", "w_up"): ("w_dmodel", "w_ff_dense"),
    ("shared", "w_out"): ("w_ff_dense", "w_dmodel"),
    ("moe", "router"): ("w_dmodel", None),
    ("moe", "w_gate"): ("w_expert", "w_dmodel", "w_ff"),
    ("moe", "w_up"): ("w_expert", "w_dmodel", "w_ff"),
    ("moe", "w_out"): ("w_expert", "w_ff", "w_dmodel"),
    ("mamba", "in_proj"): ("w_dmodel", "w_inner2"),
    ("mamba", "conv_w"): (None, "w_inner"),
    ("mamba", "conv_b"): ("w_inner",),
    ("mamba", "x_proj"): ("w_inner", None),
    ("mamba", "dt_proj"): (None, "w_inner"),
    ("mamba", "dt_bias"): ("w_inner",),
    ("mamba", "A_log"): ("w_inner", None),
    ("mamba", "D"): ("w_inner",),
    ("mamba", "out_proj"): ("w_inner", "w_dmodel"),
    ("tm", "tm_w1"): ("w_dmodel", None),
    ("tm", "tm_w2"): (None, None, "w_dmodel"),
    ("tm", "decay_w1"): ("w_dmodel", None),
    ("tm", "decay_w2"): (None, "w_dmodel"),
    ("tm", "wr"): ("w_dmodel", None),
    ("tm", "wk"): ("w_dmodel", None),
    ("tm", "wv"): ("w_dmodel", None),
    ("tm", "wg"): ("w_dmodel", None),
    ("tm", "wo"): ("w_dmodel", None),
    ("cm", "wk"): ("w_dmodel", "w_ff_dense"),
    ("cm", "wv"): ("w_ff_dense", "w_dmodel"),
    ("cm", "wr"): ("w_dmodel", None),
}


def _leaf_axes(path, leaf) -> Tuple:
    keys = [p for p in path if isinstance(p, str)]
    name = keys[-1] if keys else ""
    parent = keys[-2] if len(keys) >= 2 else ""
    spec = _LEAF_AXES.get((parent, name))
    if spec is None:
        spec = _LEAF_AXES.get(("", name))
    if spec is None:
        spec = (None,) * leaf.ndim  # norms, scalar leaves, misc
    if len(spec) != leaf.ndim:
        spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        spec = spec[: leaf.ndim]
    return tuple(spec)


def divisible(spec, shape, mesh) -> P:
    """``spec`` with every sharded dim that does not divide its mesh axes
    evenly replicated (trailing dims padded with None)."""
    out = []
    for ax, dim in zip(tuple(spec) + (None,) * (len(shape) - len(spec)), shape):
        if ax is not None and dim % axis_size(mesh, ax) != 0:
            ax = None
        out.append(ax)
    return P(*out)


def param_specs(params_shape, mesh, rules: ShardingRules):
    """Partition-spec tree matching the params tree."""
    rules = rules.with_overrides(w_ff_dense="model")

    def one(path, leaf):
        axes = _leaf_axes(path, leaf)
        return divisible(tuple(rules.resolve(ax) for ax in axes), tuple(leaf.shape), mesh)

    return map_tree(one, params_shape)


def cache_specs(model, mesh, rules: ShardingRules, batch: int, max_len: int,
                shapes=None):
    """Partition-spec tree matching ``model.cache_shape`` (or ``shapes``, a
    cache tree such as ``init_cache``'s): one dict per layer (attention k/v
    (B, L, KV, hd) and its positions, one row (L,) or a row per sequence
    (B, L); Mamba conv and ssm; RWKV shifts and wkv state)."""
    if shapes is None:
        shapes = model.cache_shape(batch, max_len)
    b, c = rules.resolve("batch"), rules.resolve("cache_len")

    def entry_spec(spec, shape):
        if spec.mixer == "attn":
            out = {"k": P(b, c, rules.resolve("kv_heads"), None)}
            out["v"] = out["k"]
            out["pos"] = P(c) if shape["pos"].ndim == 1 else P(b, c)
        elif spec.mixer == "mamba":
            out = {"conv": P(b, None, rules.resolve("ssm_inner")),
                   "ssm": P(b, rules.resolve("ssm_inner"), None)}
        else:  # rwkv
            out = {"shift_tm": P(b, None), "shift_cm": P(b, None),
                   "wkv": P(b, None, None, None)}
        return {k: divisible(out[k], tuple(shape[k].shape), mesh) for k in shape}

    return [entry_spec(s, shp) for s, shp in zip(model.layer_specs, shapes)]


def placements(spec, mesh):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every mesh
    dim that tensor dim ``d`` is sharded over, ``Replicate()`` elsewhere.
    A dimension sharded over several axes must name them in mesh order
    (major first), which is JAX's order; DTensor has no plain placement
    for any other order. A mesh dim of size 1 holds the whole tensor either
    way and is given ``Replicate()`` (DTensor's views refuse some reshapes
    of a dim sharded there)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_shape(mesh).axis_names
    sizes = mesh_shape(mesh).sizes
    used = {}  # mesh dim -> tensor dim
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in "
                             f"mesh order {names}")
        for i in idx:
            if i in used:
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} used twice")
            used[i] = d
    return tuple(Shard(used[i]) if i in used and sizes[i] > 1 else Replicate()
                 for i in range(len(names)))


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and the DTensor placements of one tensor on it (the
    counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    placements: Tuple


def to_shardings(spec_tree, mesh):
    """The ``NamedSharding`` tree of a spec tree."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, placements(spec_tree, mesh))
    if isinstance(spec_tree, dict):
        return {k: to_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return [to_shardings(v, mesh) for v in spec_tree]
    raise TypeError(f"not a spec tree leaf: {spec_tree!r}")
