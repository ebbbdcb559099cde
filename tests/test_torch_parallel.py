"""The port's sharding layer (``repro_torch.parallel``, ``launch.specs``,
``launch.steps``' spec helpers, ``configs.shapes``) against the reference's,
with no rank and no device: rule tables, param / cache / batch partition
specs and the train state's specs, for every arch of the registry, every
layout and step kind, on the (16, 16) and (2, 16, 16) production meshes.

The reference stacks each block position's leaves under a leading
``n_blocks`` axis (``params["blocks"][j]``); the port keeps one leaf per
layer. A port leaf ``layers[i * block_size + j]/...`` is held to the
reference's ``blocks[j]/...`` spec without its leading ``None``, the path
mapping of ``convert.params_from_jax``.
"""

from __future__ import annotations

import functools
import math
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES, cell_applicable, get_config  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import build_model as r_build  # noqa: E402
from repro.optim import AdamW as RAdamW  # noqa: E402
from repro.optim.schedule import constant_schedule as r_const  # noqa: E402
from repro.parallel import layouts as rlay  # noqa: E402

import torch  # noqa: E402

from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import cell_applicable as t_cell_applicable  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.optimized import OPTIMIZED  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import production_shape  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.config import block_structure  # noqa: E402
from repro_torch.optim import AdamW as TAdamW  # noqa: E402
from repro_torch.optim.schedule import constant_schedule as t_const  # noqa: E402
from repro_torch.parallel import P, layouts as tlay  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
LAYOUTS = ("cp_fsdp", "tp", "tp_ffn", "fsdp")


class _FakeDev:
    def __init__(self, i):
        self.id = i

    def __repr__(self):
        return f"d{self.id}"


@functools.lru_cache(maxsize=None)
def _ref_mesh(multi):
    ms = production_shape(multi_pod=multi)
    devs = np.array([_FakeDev(i) for i in range(math.prod(ms.sizes))]).reshape(ms.sizes)
    return Mesh(devs, ms.axis_names)


@functools.lru_cache(maxsize=None)
def _models(arch):
    rm, tm = r_build(get_config(arch)), t_build(t_get_config(arch))
    return rm, rm.init_shape(), tm, tm.init(torch.Generator(), device="meta")


def _flat_ref(spec_tree):
    """{path of str keys and int indices: spec tuple} of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP))
    out = {}
    for path, spec in flat:
        keys = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        out[keys] = tuple(spec)
    return out


def _ref_params_as_port(spec_tree, cfg):
    """The reference's param specs keyed by the port's leaf paths."""
    bs, nb, _ = block_structure(cfg)
    out = {}
    for keys, spec in _flat_ref(spec_tree).items():
        if keys[0] == "blocks":
            j, rest = keys[1], keys[2:]
            assert spec[0] is None, (keys, spec)
            for i in range(nb):
                out[("layers", i * bs + j) + rest] = spec[1:]
        else:
            out[keys] = spec
    return out


def _spec_leaves(tree):
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_leaves(v)]
    return [s for v in tree for s in _spec_leaves(v)]


def _port_specs(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, P):
            out[path] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(t):
                walk(v, path + (i,))
    walk(tree, ())
    return out


def _cases():
    for kind in ("train", "prefill"):
        for layout in LAYOUTS:
            yield kind, layout, SHAPES[f"{kind}_4k" if kind == "train" else "prefill_32k"].global_batch
    yield "decode", None, 128
    yield "decode", "decode_ws", 128
    yield "decode", None, 1


CASES = list(_cases())


def test_shapes_copy_is_the_reference_text():
    ref = (SRC / "repro/configs/shapes.py").read_text()
    port = (SRC / "repro_torch/configs/shapes.py").read_text()
    assert port == ref.replace("repro.", "repro_torch.")
    assert T_SHAPES == {k: type(T_SHAPES[k])(**vars(v)) for k, v in SHAPES.items()}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert t_cell_applicable(arch, shape) == cell_applicable(arch, shape)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind,layout,gb", CASES,
                         ids=[f"{k}-{lay}-{gb}" for k, lay, gb in CASES])
def test_layout_specs_equal_reference(arch, multi, kind, layout, gb):
    mesh = _ref_mesh(multi)
    tmesh = production_shape(multi_pod=multi)
    rcfg, tcfg = get_config(arch), t_get_config(arch)
    rr = rlay.layout_rules(mesh, rcfg, kind, global_batch=gb, layout=layout)
    tr = tlay.layout_rules(tmesh, tcfg, kind, global_batch=gb, layout=layout)
    norm = lambda v: tuple(JP(v))[0] if v is not None else None  # noqa: E731
    assert {k: norm(v) for k, v in rr.rules.items()} == \
        {k: P(v)[0] for k, v in tr.rules.items()}

    rm, rshape, tm, tshape = _models(arch)
    rp = rlay.param_specs(rshape, mesh, rr)
    tp = tlay.param_specs(tshape, tmesh, tr)
    assert _port_specs(tp) == _ref_params_as_port(rp, rcfg)
    for spec in _spec_leaves(tp):  # every layout maps onto DTensor placements
        tlay.placements(spec, tmesh)

    skind = "train" if kind == "train" else kind
    seq = 4096 if kind == "train" else 32768
    rb = rspecs.fix_divisibility(rspecs.batch_partition(rcfg, skind, rr),
                                 rspecs.batch_struct(rcfg, skind, gb, seq), mesh)
    tb = tspecs.fix_divisibility(tspecs.batch_partition(tcfg, skind, tr),
                                 tspecs.batch_struct(tcfg, skind, gb, seq), tmesh)
    assert _port_specs(tb) == {k: v for k, v in _flat_ref(rb).items()}
    rs = rspecs.batch_struct(rcfg, skind, gb, seq)
    ts = tspecs.batch_struct(tcfg, skind, gb, seq)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in rs.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in ts.items()}

    if kind == "decode":
        if gb == 1 and not cell_applicable(arch, "long_500k"):
            return  # full-attention archs skip long_500k
        L = 32768 if gb > 1 else 524288
        rc = rlay.cache_specs(rm, mesh, rr, gb, L)
        tc = tlay.cache_specs(tm, tmesh, tr, gb, L)
        bs, nb, _ = block_structure(rcfg)
        for i, entry in enumerate(tc):
            ref = {k: tuple(v)[1:] for k, v in rc[i % bs].items()}
            assert {k: tuple(v) for k, v in entry.items()} == ref, (i, entry, ref)
        rcs, tcs = rm.cache_shape(gb, L), tm.cache_shape(gb, L)
        for i, entry in enumerate(tcs):
            assert {k: tuple(v.shape) for k, v in entry.items()} == \
                {k: tuple(v.shape)[1:] for k, v in rcs[i % bs].items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_specs_and_struct_equal_reference(arch):
    """int8 moments with error feedback: every slot of the state (the f32
    moments' specs are the params', covered by the dry-run's byte counts)."""
    moments = "int8"
    mesh, tmesh = _ref_mesh(False), production_shape()
    rcfg, tcfg = get_config(arch), t_get_config(arch)
    rm, rshape, tm, tshape = _models(arch)
    rr = rlay.layout_rules(mesh, rcfg, "train", global_batch=256)
    tr = tlay.layout_rules(tmesh, tcfg, "train", global_batch=256)
    ropt = RAdamW(lr=r_const(1e-4), moments_dtype=moments, error_feedback=True)
    topt = TAdamW(lr=t_const(1e-4), moments_dtype=moments, error_feedback=True)
    rss = rsteps.train_state_specs(rlay.param_specs(rshape, mesh, rr), ropt)
    tss = tsteps.train_state_specs(tlay.param_specs(tshape, tmesh, tr), topt)
    assert tuple(tss["step"]) == tuple(rss["step"]) == ()
    assert _port_specs(tss["params"]) == _ref_params_as_port(rss["params"], rcfg)
    for name in ("m", "v", "ef"):
        assert _port_specs(tss["opt"][name]) == _ref_params_as_port(rss["opt"][name], rcfg)
    # the struct is the live constructor's tree, leaf for leaf
    struct = tsteps.train_state_struct(tm, topt)
    live = topt.init_state(tm.init(torch.Generator(), device="meta"))
    assert [p for p, _ in leaves_with_paths(struct["opt"])] == \
        [p for p, _ in leaves_with_paths(live["opt"])]
    n_ref = sum(math.prod(x.shape) * x.dtype.itemsize
                for x in jax.tree.leaves(rsteps.train_state_struct(rm, ropt)))
    n_port = sum(x.numel() * x.element_size()
                 for _, x in leaves_with_paths(struct))
    assert n_port == n_ref


def test_placements_refuse_axes_out_of_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    ms = production_shape(multi_pod=True)
    assert tlay.placements(P(("pod", "data"), "model"), ms) == (Shard(0), Shard(0), Shard(1))
    assert tlay.placements(P(None, None), ms) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tlay.placements(P(("data", "pod")), ms)
    with pytest.raises(ValueError, match="used twice"):
        tlay.placements(P("model", "model"), ms)


def test_optimized_docstring_usage_runs():
    """``configs/optimized.py``'s usage: every variant's ``layout`` is a
    layout the ported ``layout_rules`` takes, and equals the reference's."""
    from repro.configs.optimized import OPTIMIZED as R_OPT

    mesh, tmesh = _ref_mesh(False), production_shape()
    for arch, kinds in OPTIMIZED.items():
        for kind, over in kinds.items():
            cfg = t_get_config(arch).replace(**over)
            rules = tlay.layout_rules(tmesh, cfg, kind, layout=cfg.layout)
            rcfg = get_config(arch).replace(**R_OPT[arch][kind])
            ref = rlay.layout_rules(mesh, rcfg, kind, layout=rcfg.layout)
            assert {k: P(v)[0] for k, v in rules.rules.items()} == \
                {k: tuple(JP(v))[0] if v is not None else None for k, v in ref.rules.items()}
